"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` into its own shared library under ``_build/`` (listed in
``.gitignore``) at first use, for ``sm_90a``; the library is loaded with
``ctypes`` and every pointer and the stream cross as ``c_void_p``. The
library's file name carries a hash of its source, so an edited kernel is
rebuilt and a stale one is never loaded; the hash covers the ``csrc/*.cuh``
headers the source includes, so an edited header rebuilds every library
that includes it. Nothing here runs on import: the
CPU tests import this module on machines with no ``nvcc`` and no card.

With ``CUDA_KERNEL_DEBUG=1`` in the environment of the build, the sources
are compiled with ``-DCUDA_KERNEL_DEBUG`` into libraries of their own: the
bf16 kernel's pipeline waits then trap after seconds instead of waiting
without a limit, so that a pipeline fault fails its launch rather than
hanging the card (the GPU tests build so).

Every launch wrapper checks its tensors, launches on PyTorch's current
stream, raises on a non-zero launch status and adds one to its entry in
:data:`LAUNCHES`. It never synchronises: a fault during the run surfaces
at the caller's next synchronisation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


def nvcc_flags() -> List[str]:
    """The flags of a build: :data:`NVCC_FLAGS`, and ``-DCUDA_KERNEL_DEBUG``
    when ``CUDA_KERNEL_DEBUG=1``."""
    debug = os.environ.get("CUDA_KERNEL_DEBUG") == "1"
    return NVCC_FLAGS + (["-DCUDA_KERNEL_DEBUG"] if debug else [])

# library name -> CUDA source; one shared library per source. The flash
# forward and backward have one design per dtype each: fp32 on CUDA cores,
# bf16 on wgmma + TMA (the bf16 sources share csrc/hopper.cuh).
SOURCES: Dict[str, str] = {
    "flash_fwd_f32": "flash_fwd_f32.cu",
    "flash_fwd_bf16": "flash_fwd_bf16.cu",
    "flash_bwd_f32": "flash_bwd_f32.cu",
    "flash_bwd_bf16": "flash_bwd_bf16.cu",
}

# kernel name -> launches since the last reset (see reset_launches); a
# kernel is one dtype's wrapper, one launch per call; "flash_fwd" and
# "flash_bwd" count both dtypes
KERNEL_NAMES = ("flash_fwd_f32", "flash_fwd_bf16", "flash_bwd_f32", "flash_bwd_bf16")
LAUNCHES: Dict[str, int] = {
    "flash_fwd": 0, "flash_bwd": 0, **{name: 0 for name in KERNEL_NAMES}
}
_LAUNCH_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(*names: str) -> None:
    with _LAUNCH_LOCK:
        for name in names:
            LAUNCHES[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _source_bytes(filename: str, seen: Optional[set] = None) -> bytes:
    """A source's bytes followed by those of every ``csrc`` header it
    includes (``#include "..."``), recursively, each once."""
    seen = set() if seen is None else seen
    seen.add(filename)
    with open(os.path.join(SRC_DIR, filename), "rb") as fh:
        text = fh.read()
    parts = [text]
    for header in _INCLUDE.findall(text):
        header = header.decode()
        if header not in seen:
            parts.append(_source_bytes(header, seen))
    return b"".join(parts)


def library_path(name: str) -> str:
    """The library's path: its name, and a hash of its source, the headers
    that source includes and the build flags."""
    digest = hashlib.sha256(_source_bytes(SOURCES[name]) + " ".join(nvcc_flags()).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start_build(name: str) -> Optional[Tuple[subprocess.Popen, str, str]]:
    """Start ``nvcc`` for one kernel unless its library is built already;
    it writes to a private temporary name, renamed into place when done."""
    target = library_path(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *nvcc_flags(), "-o", tmp, os.path.join(SRC_DIR, SOURCES[name])]
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
            backward = name in _BWD_FOR_DTYPE.values()
            for entry in _ENTRIES[name]:
                (bind_flash_bwd_entry if backward else bind_flash_entry)(getattr(lib, entry))
            if backward:
                workspace = getattr(lib, f"gordo_{name}_workspace")
                workspace.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
                workspace.restype = ctypes.c_longlong
            _LIBS[name] = lib
    return lib


# library name -> its C entries; a forward's take (q, k, v, out, lse, bh,
# seq, d, scale, stream), a backward's see bind_flash_bwd_entry
_ENTRIES: Dict[str, Tuple[str, ...]] = {
    "flash_fwd_f32": ("gordo_flash_fwd_f32",),
    "flash_fwd_bf16": ("gordo_flash_fwd_bf16", "gordo_flash_fwd_bf16_single_stage"),
    "flash_bwd_f32": ("gordo_flash_bwd_f32",),
    "flash_bwd_bf16": ("gordo_flash_bwd_bf16",),
}


def bind_flash_entry(entry) -> None:
    """Set the argument and result types of a flash forward's C entry."""
    ptr = ctypes.c_void_p
    entry.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # q, k, v, out, lse
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bh, seq, d
        ctypes.c_float,  # scale
        ptr,  # stream
    ]
    entry.restype = ctypes.c_int


def bind_flash_bwd_entry(entry) -> None:
    """Set the argument and result types of a flash backward's C entry."""
    ptr = ctypes.c_void_p
    entry.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # q, k, v, out, dout
        ptr, ptr,  # lse, dlse (null when absent)
        ptr, ptr, ptr, ptr,  # dq, dk, dv, workspace (null when it needs none)
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bh, seq, d
        ctypes.c_float,  # scale
        ptr,  # stream
    ]
    entry.restype = ctypes.c_int


def _raise_on(lib: ctypes.CDLL, status: int, what: str) -> None:
    if status != 0:
        message = lib.gordo_cuda_error_string(status).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {status} ({message})")


_KERNEL_FOR_DTYPE = {torch.float32: "flash_fwd_f32", torch.bfloat16: "flash_fwd_bf16"}


def flash_fwd_cuda(
    q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the flash forward of q's dtype (``csrc/flash_fwd_f32.cu`` or
    ``csrc/flash_fwd_bf16.cu``) on ``(BH, S, D)`` CUDA tensors → ``(out
    (BH, S, D) in q's dtype, lse (BH, S) float32)``. A tensor is never cast
    to the other dtype's kernel."""
    return _launch_flash(q3, k3, v3, scale)


def flash_fwd_bf16_single_stage(
    q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 kernel's first build-up step (one consumer warpgroup, one
    stage, one bh per block: its products and swizzled layouts without the
    ring or persistence), kept as a check on the card."""
    if q3.dtype != torch.bfloat16:
        raise ValueError(f"flash_fwd_bf16_single_stage takes bfloat16, got {q3.dtype}")
    return _launch_flash(q3, k3, v3, scale, "gordo_flash_fwd_bf16_single_stage")


def _launch_flash(q3, k3, v3, scale, entry: Optional[str] = None):
    for name, t in (("q", q3), ("k", k3), ("v", v3)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_fwd_cuda: {name} is on {t.device}, not CUDA")
        if t.dim() != 3:
            raise ValueError(f"flash_fwd_cuda: {name} must be (BH, S, D), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd_cuda: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_fwd_cuda: {name} must start on a 16-byte boundary")
    if not (q3.shape == k3.shape == v3.shape):
        raise ValueError(
            "flash_fwd_cuda: self-attention needs equal q/k/v shapes, got "
            f"{tuple(q3.shape)}, {tuple(k3.shape)}, {tuple(v3.shape)}"
        )
    if not (q3.dtype == k3.dtype == v3.dtype) or q3.dtype not in _KERNEL_FOR_DTYPE:
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
    name = _KERNEL_FOR_DTYPE[q3.dtype]
    lib = _library(name)
    out = torch.empty_like(q3)
    lse = torch.empty((bh, seq), dtype=torch.float32, device=q3.device)
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        status = getattr(lib, entry or f"gordo_{name}")(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(), lse.data_ptr(),
            bh, seq, d, float(scale), stream,
        )
    _raise_on(lib, status, name)
    _count("flash_fwd", name)
    return out, lse


_BWD_FOR_DTYPE = {torch.float32: "flash_bwd_f32", torch.bfloat16: "flash_bwd_bf16"}


def flash_bwd_cuda(
    q3: torch.Tensor,
    k3: torch.Tensor,
    v3: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    scale: float,
    dlse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the flash backward of q's dtype (``csrc/flash_bwd_f32.cu`` or
    ``csrc/flash_bwd_bf16.cu``, one kernel launch) on ``(BH, S, D)`` CUDA
    tensors: the forward's q, k, v, out and lse, the output cotangent
    ``dout`` and, when given, the lse cotangent ``dlse`` ``(BH, S)`` →
    ``(dq, dk, dv)`` in q's dtype."""
    tensors = {"q": q3, "k": k3, "v": v3, "out": out, "dout": dout}
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"flash_bwd_cuda: {name} is on {t.device}, not CUDA")
        if tuple(t.shape) != tuple(q3.shape) or t.dim() != 3:
            raise ValueError(
                f"flash_bwd_cuda: {name} must be (BH, S, D) like q {tuple(q3.shape)}, "
                f"got {tuple(t.shape)}"
            )
        if t.dtype != q3.dtype:
            raise ValueError(f"flash_bwd_cuda: {name} is {t.dtype}, q is {q3.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_bwd_cuda: {name} must be contiguous")
        if t.device != q3.device:
            raise ValueError("flash_bwd_cuda: all tensors must be on one device")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_bwd_cuda: {name} must start on a 16-byte boundary")
    if q3.dtype not in _BWD_FOR_DTYPE:
        raise ValueError(f"flash_bwd_cuda: q/k/v must be float32 or bfloat16, got {q3.dtype}")
    bh, seq, d = q3.shape
    if bh == 0 or seq == 0:
        raise ValueError(f"flash_bwd_cuda: empty input {tuple(q3.shape)}")
    if d > 128 or d % 4 != 0:
        raise ValueError(f"flash_bwd_cuda: head_dim must be a multiple of 4 up to 128, got {d}")
    for name, t in (("lse", lse), ("dlse", dlse)):
        if t is None:
            continue
        if (t.device != q3.device or t.dtype != torch.float32 or tuple(t.shape) != (bh, seq)
                or not t.is_contiguous()):
            raise ValueError(
                f"flash_bwd_cuda: {name} must be contiguous float32 ({bh}, {seq}) on "
                f"{q3.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    name = _BWD_FOR_DTYPE[q3.dtype]
    lib = _library(name)
    dq, dk, dv = torch.empty_like(q3), torch.empty_like(q3), torch.empty_like(q3)
    with torch.cuda.device(q3.device):
        nbytes = getattr(lib, f"gordo_{name}_workspace")(bh, seq, d)
        if nbytes < 0:
            raise RuntimeError(f"{name}: the card's SM count could not be read")
        workspace = (torch.empty(nbytes, dtype=torch.uint8, device=q3.device)
                     if nbytes else None)
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        status = getattr(lib, f"gordo_{name}")(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), None if dlse is None else dlse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if workspace is None else workspace.data_ptr(),
            bh, seq, d, float(scale), stream,
        )
    _raise_on(lib, status, name)
    _count("flash_bwd", name)
    return dq, dk, dv
