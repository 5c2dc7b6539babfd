"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` into its own shared library under ``_build/`` (listed in
``.gitignore``) at first use, for ``sm_90a``; the library is loaded with
``ctypes`` and every pointer and the stream cross as ``c_void_p``. The
library's file name carries a hash of its source, so an edited kernel is
rebuilt and a stale one is never loaded. Nothing here runs on import: the
CPU tests import this module on machines with no ``nvcc`` and no card.

Every launch wrapper checks its tensors, launches on PyTorch's current
stream, raises on a non-zero launch status and adds one to its entry in
:data:`LAUNCHES`. It never synchronises: a fault during the run surfaces
at the caller's next synchronisation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# kernel name -> CUDA source; one shared library per source
SOURCES: Dict[str, str] = {"flash_fwd": "flash_fwd.cu"}

# kernel name -> launches since the last reset (see reset_launches)
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
_LAUNCH_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def library_path(name: str) -> str:
    src = os.path.join(SRC_DIR, SOURCES[name])
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start_build(name: str) -> Optional[Tuple[subprocess.Popen, str, str]]:
    """Start ``nvcc`` for one kernel unless its library is built already;
    it writes to a private temporary name, renamed into place when done."""
    target = library_path(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, SOURCES[name])]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, target


def build_all(names: Optional[List[str]] = None) -> float:
    """Compile every named kernel (default: all), one ``nvcc`` per source,
    all started together. Returns the wall seconds; raises with the
    compiler's output on failure."""
    started = time.perf_counter()
    running = []
    try:
        for name in names or list(SOURCES):
            job = _start_build(name)
            if job is not None:
                running.append((name, *job))
        for name, proc, tmp, target in running:
            output, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {SOURCES[name]} (exit {proc.returncode}):\n"
                    f"{output}"
                )
            os.replace(tmp, target)
    finally:
        for _, proc, tmp, _ in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return time.perf_counter() - started


def _library(name: str) -> ctypes.CDLL:
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(library_path(name))
            lib.gordo_cuda_error_string.argtypes = [ctypes.c_int]
            lib.gordo_cuda_error_string.restype = ctypes.c_char_p
            _bind(name, lib)
            _LIBS[name] = lib
    return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    if name == "flash_fwd":
        ptr = ctypes.c_void_p
        lib.gordo_flash_fwd.argtypes = [
            ptr, ptr, ptr, ptr, ptr,  # q, k, v, out, lse
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bh, seq, d
            ctypes.c_float, ctypes.c_int, ptr,  # scale, dtype, stream
        ]
        lib.gordo_flash_fwd.restype = ctypes.c_int


def _raise_on(lib: ctypes.CDLL, status: int, what: str) -> None:
    if status != 0:
        message = lib.gordo_cuda_error_string(status).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {status} ({message})")


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_fwd_cuda(
    q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_fwd.cu`` on ``(BH, S, D)`` CUDA tensors →
    ``(out (BH, S, D) in q's dtype, lse (BH, S) float32)``."""
    for name, t in (("q", q3), ("k", k3), ("v", v3)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_fwd_cuda: {name} is on {t.device}, not CUDA")
        if t.dim() != 3:
            raise ValueError(f"flash_fwd_cuda: {name} must be (BH, S, D), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd_cuda: {name} must be contiguous")
    if not (q3.shape == k3.shape == v3.shape):
        raise ValueError(
            "flash_fwd_cuda: self-attention needs equal q/k/v shapes, got "
            f"{tuple(q3.shape)}, {tuple(k3.shape)}, {tuple(v3.shape)}"
        )
    if not (q3.dtype == k3.dtype == v3.dtype) or q3.dtype not in _DTYPE_CODES:
        raise ValueError(
            "flash_fwd_cuda: q/k/v must share one dtype of float32 or bfloat16, "
            f"got {q3.dtype}, {k3.dtype}, {v3.dtype}"
        )
    if not (q3.device == k3.device == v3.device):
        raise ValueError("flash_fwd_cuda: q/k/v must be on one device")
    bh, seq, d = q3.shape
    if d > 128 or d % 4 != 0:
        raise ValueError(f"flash_fwd_cuda: head_dim must be a multiple of 4 up to 128, got {d}")
    if bh == 0 or seq == 0:
        raise ValueError(f"flash_fwd_cuda: empty input {tuple(q3.shape)}")
    lib = _library("flash_fwd")
    out = torch.empty_like(q3)
    lse = torch.empty((bh, seq), dtype=torch.float32, device=q3.device)
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        status = lib.gordo_flash_fwd(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, seq, d, float(scale), _DTYPE_CODES[q3.dtype],
            stream,
        )
    _raise_on(lib, status, "flash_fwd")
    _count("flash_fwd")
    return out, lse
