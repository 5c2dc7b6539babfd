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

A process may instead resolve its libraries through a compile-cache store
beside the models (:mod:`..compile_cache`; :func:`resolve`, or
:func:`use_store` for the libraries first launched in a block): a verified
entry is loaded with no ``nvcc`` at all, a missing, stale or damaged one is
built into a private file, written back and loaded. Loaded libraries are
process-wide, kept by name and source hash; a store that asks for one
already loaded reports ``loaded`` and receives a copy if it lacks one.

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

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import torch

from ..analysis import lockcheck

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
_LAUNCH_LOCK = lockcheck.named_lock("kernels.launch")
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = lockcheck.named_lock("kernels.load")


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(*names: str) -> None:
    with _LAUNCH_LOCK:
        for name in names:
            LAUNCHES[name] += 1


def _nvcc() -> str:
    """The compiler: ``nvcc`` on ``PATH``, else ``$CUDA_HOME/bin/nvcc``
    (``CUDA_HOME`` defaults to ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


_NVCC_VERSION: Dict[str, Optional[str]] = {}


def nvcc_version() -> Optional[str]:
    """The compiler's version line (``Cuda compilation tools, release
    12.4, V12.4.131``), or None where it cannot be read; kept in a store
    entry's metadata, never in its key."""
    nvcc = _nvcc()
    if nvcc not in _NVCC_VERSION:
        try:
            out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                 timeout=60).stdout
            lines = [line for line in out.splitlines() if "release" in line]
            _NVCC_VERSION[nvcc] = (lines or [out.strip() or None])[-1]
        except (OSError, subprocess.SubprocessError):
            _NVCC_VERSION[nvcc] = None
    return _NVCC_VERSION[nvcc]


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


_IDENTITIES: Dict[Tuple[str, str, Tuple[str, ...]], str] = {}


def _identity(name: str) -> str:
    """What a loaded library is kept under in :data:`_LIBS`: its name and
    the hash of its source and flags, so that a debug build is a library of
    its own in one process. Hashed once per source directory and flags:
    every launch looks its library up through this."""
    key = (name, SRC_DIR, tuple(nvcc_flags()))
    ident = _IDENTITIES.get(key)
    if ident is None:
        ident = _IDENTITIES.setdefault(key, os.path.basename(library_path(name))[: -len(".so")])
    return ident


# the rung each library serves: the dtype of the tensors it takes
_PRECISION = {"flash_fwd_f32": "f32", "flash_fwd_bf16": "bf16",
              "flash_bwd_f32": "f32", "flash_bwd_bf16": "bf16"}


def library_key(name: str) -> Dict[str, Any]:
    """The program half of a library's compile-cache key: its name, the
    rung it serves, the SHA-256 of its source and included headers, and
    the build flags (the store adds the backend fingerprint)."""
    return {
        "kind": "kernel-library",
        "library": name,
        "precision": _PRECISION[name],
        "source": hashlib.sha256(_source_bytes(SOURCES[name])).hexdigest(),
        "flags": nvcc_flags(),
    }


def _compile(jobs: List[Tuple[str, str]]) -> Dict[str, float]:
    """Run ``nvcc`` for each ``(name, target path)``, all started together;
    each writes to a private temporary name, renamed into place when done.
    Returns each library's seconds from the start to its compiler's exit;
    raises with the compiler's output on failure."""
    started = time.perf_counter()
    running = []
    seconds: Dict[str, float] = {}
    try:
        for name, target in jobs:
            os.makedirs(os.path.dirname(target), exist_ok=True)
            tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
            cmd = [_nvcc(), *nvcc_flags(), "-o", tmp, os.path.join(SRC_DIR, SOURCES[name])]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            running.append((name, proc, tmp, target))
        for name, proc, tmp, target in running:
            output, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {SOURCES[name]} (exit {proc.returncode}):\n"
                    f"{output}"
                )
            os.replace(tmp, target)
            seconds[name] = time.perf_counter() - started
    finally:
        for _, proc, tmp, _ in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return seconds


def build_all(names: Optional[List[str]] = None) -> float:
    """Compile every named kernel (default: all) into :data:`BUILD_DIR`
    unless its library is there already, one ``nvcc`` per source, all
    started together. Returns the wall seconds; raises with the compiler's
    output on failure."""
    started = time.perf_counter()
    _compile([(name, library_path(name)) for name in names or list(SOURCES)
              if not os.path.exists(library_path(name))])
    return time.perf_counter() - started


def _load_library(path: str, name: str) -> ctypes.CDLL:
    """``dlopen`` one library and declare its entries' types."""
    lib = ctypes.CDLL(path)
    lib.gordo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gordo_cuda_error_string.restype = ctypes.c_char_p
    backward = name in _BWD_FOR_DTYPE.values()
    for entry in _ENTRIES[name]:
        (bind_flash_bwd_entry if backward else bind_flash_entry)(getattr(lib, entry))
    if backward:
        workspace = getattr(lib, f"gordo_{name}_workspace")
        workspace.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        workspace.restype = ctypes.c_longlong
    return lib


# the probe of a library loaded from a store: one launch at this shape,
# held against the plain version within these tolerances, relative to the
# plain version's largest magnitude (at least 1)
_PROBE_SHAPE = (2, 136, 32)
_PROBE_TOL = {"f32": 1e-4, "bf16": 5e-2}


def _probe_library(name: str, lib: ctypes.CDLL) -> None:
    """Launch a loaded library once on a tiny input on the current card
    and hold it against its plain version; raises if it disagrees. The
    launch calls the library directly and is not counted in
    :data:`LAUNCHES`."""
    from .flash_attention import flash_bwd_reference, flash_fwd_reference

    dtype = torch.float32 if _PRECISION[name] == "f32" else torch.bfloat16
    gen = torch.Generator(device="cpu").manual_seed(0)
    q, k, v, dout = (torch.randn(_PROBE_SHAPE, generator=gen).to("cuda", dtype)
                     for _ in range(4))
    scale = _PROBE_SHAPE[-1] ** -0.5
    if name in _KERNEL_FOR_DTYPE.values():
        got = _launch_flash(q, k, v, scale, lib=lib, count=False)[0]
        want = flash_fwd_reference(q, k, v, scale)[0]
    else:
        out, lse = flash_fwd_reference(q, k, v, scale)
        got = torch.cat(_launch_flash_bwd(q, k, v, out, lse, dout, scale, None,
                                          lib=lib, count=False))
        want = torch.cat(flash_bwd_reference(q, k, v, out, lse, dout, scale))
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = _PROBE_TOL[_PRECISION[name]] * max(1.0, want.float().abs().max().item())
    if not err <= tol:
        raise RuntimeError(f"{name}: probe differs from the plain version by {err:.3g} "
                           f"(limit {tol:.3g})")


# identity -> the file a loaded library was loaded from, the seconds its
# build took in this process (None if it was not built here) and the
# compiler's version: a write-back into another store copies that file
_LIB_FILES: Dict[str, Tuple[str, Optional[float], Optional[str]]] = {}
# the stores through which a library that is not loaded yet is resolved
# at its first launch (use_store; the innermost wins); none: the
# package's build directory
_ACTIVE_STORE: List[Any] = []


@contextlib.contextmanager
def use_store(store: Any) -> Iterator[None]:
    """Resolve every library first launched inside the block through
    ``store`` (a :class:`~..compile_cache.store.CompileCacheStore`; None
    changes nothing): a build's fit launches the forward and backward
    libraries through the build's store."""
    if store is None:
        yield
        return
    _ACTIVE_STORE.append(store)
    try:
        yield
    finally:
        _ACTIVE_STORE.pop()


def resolve(names: Iterable[str], store: Any = None) -> Dict[str, str]:
    """Load the named libraries, through ``store`` when one is given, and
    report what that took for each: ``hit`` (loaded from the store),
    ``miss``/``stale``/``invalid`` (the store could not serve it: built
    with ``nvcc`` and written back over the bad entry), ``loaded`` (already
    loaded in this process; written into ``store`` if it lacks it). With
    no store: ``built`` (``nvcc`` ran into :data:`BUILD_DIR`) or ``cached``
    (the library was there). Raises if a library must be built and
    ``nvcc`` cannot be found, naming the store."""
    with _LOAD_LOCK:
        return _resolve_locked(list(dict.fromkeys(names)), store)


def _require_nvcc(store: Any, missing: Dict[str, str]) -> None:
    """Raise, naming the store too, if ``nvcc`` cannot be found for the
    libraries that must be built (``{name: why}``)."""
    try:
        _nvcc()
    except RuntimeError as exc:
        where = (f"the compile cache at {store.root} holds no usable entry for "
                 + ", ".join(f"{name} ({why})" for name, why in missing.items())
                 if store is not None else "no compile cache was given")
        raise RuntimeError(f"{exc}, and {where}") from exc


def _build_into(store: Any, why: Dict[str, str]) -> Dict[str, Tuple[str, float, Optional[str]]]:
    """Build the libraries named in ``why`` (``{name: why it is built}``)
    with ``nvcc``, all at once, each into a private file, and write each
    into ``store``; returns ``{name: (file, build seconds, nvcc version)}``."""
    from ..compile_cache.store import private_path

    _require_nvcc(store, why)
    targets = {name: private_path(_identity(name)) for name in why}
    seconds = _compile(list(targets.items()))
    compiler = nvcc_version()
    for name, target in targets.items():
        store.put(library_key(name), target, compile_seconds=seconds[name], compiler=compiler)
    return {name: (targets[name], seconds[name], compiler) for name in why}


def _copy_loaded(name: str, store: Any) -> None:
    """Write the file this process loaded ``name`` from into ``store``."""
    path, seconds, compiler = _LIB_FILES[_identity(name)]
    store.put(library_key(name), path, compile_seconds=seconds, compiler=compiler)


def _resolve_locked(names: List[str], store: Any) -> Dict[str, str]:
    outcomes: Dict[str, str] = {}
    to_build: List[str] = []
    for name in names:
        ident = _identity(name)
        if ident in _LIBS:
            if store is not None and not store.holds(library_key(name)):
                _copy_loaded(name, store)
            outcomes[name] = "loaded"
        elif store is None:
            outcomes[name] = "cached" if os.path.exists(library_path(name)) else "built"
            to_build.append(name)
        else:
            outcome, loaded = store.lookup(
                library_key(name),
                load=lambda path, name=name: (_load_library(path, name), path),
                probe=lambda loaded, name=name: _probe_library(name, loaded[0]))
            outcomes[name] = outcome
            if loaded is not None:
                _LIBS[ident], path = loaded
                _LIB_FILES[ident] = (path, None, None)
            else:
                to_build.append(name)
    if store is not None:
        files = _build_into(store, {name: outcomes[name] for name in to_build}) if to_build else {}
    else:
        missing = [name for name in to_build if outcomes[name] == "built"]
        if missing:
            _require_nvcc(None, {name: "built" for name in missing})
        seconds = _compile([(name, library_path(name)) for name in missing])
        compiler = nvcc_version() if missing else None
        files = {name: (library_path(name), seconds.get(name), compiler if name in seconds else None)
                 for name in to_build}
    for name, record in files.items():
        _LIBS[_identity(name)] = _load_library(record[0], name)
        _LIB_FILES[_identity(name)] = record
    return outcomes


def fill_store(names: Iterable[str], store: Any) -> Dict[str, str]:
    """Make ``store`` hold the named libraries without loading any (a
    build host with ``nvcc`` and no card): ``present`` (a verified entry
    is there), ``loaded`` (copied from this process's loaded library) or
    ``built`` (``nvcc`` ran and the library was written). Raises if one
    must be built and ``nvcc`` cannot be found."""
    with _LOAD_LOCK:
        outcomes: Dict[str, str] = {}
        for name in dict.fromkeys(names):
            if store.holds(library_key(name), deep=True):
                outcomes[name] = "present"
            elif _identity(name) in _LIBS:
                _copy_loaded(name, store)
                outcomes[name] = "loaded"
            else:
                outcomes[name] = "missing"
        missing = {name: why for name, why in outcomes.items() if why == "missing"}
        if missing:
            _build_into(store, missing)
            outcomes.update(dict.fromkeys(missing, "built"))
        return outcomes


def libraries_for(module: torch.nn.Module, backward: bool = False) -> List[str]:
    """The libraries that ``module``'s forward launches on the card (and,
    with ``backward``, its gradient): one per flash dtype its submodules
    report through ``flash_dtype()``. A dense or LSTM module launches none."""
    names = set()
    for sub in module.modules():
        flash_dtype = getattr(sub, "flash_dtype", None)
        dtype = flash_dtype() if callable(flash_dtype) else None
        if dtype is not None:
            names.add(_KERNEL_FOR_DTYPE[dtype])
            if backward:
                names.add(_BWD_FOR_DTYPE[dtype])
    return sorted(names)


def _library(name: str) -> ctypes.CDLL:
    ident = _identity(name)
    lib = _LIBS.get(ident)
    if lib is None:
        with _LOAD_LOCK:
            if ident not in _LIBS:
                _resolve_locked([name], _ACTIVE_STORE[-1] if _ACTIVE_STORE else None)
            lib = _LIBS[ident]
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


def _launch_flash(q3, k3, v3, scale, entry: Optional[str] = None,
                  lib: Optional[ctypes.CDLL] = None, count: bool = True):
    """Check and launch a forward: the process's library of q's dtype, or
    ``lib`` (a store entry's probe, which is not counted)."""
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
    lib = lib or _library(name)
    out = torch.empty_like(q3)
    lse = torch.empty((bh, seq), dtype=torch.float32, device=q3.device)
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        status = getattr(lib, entry or f"gordo_{name}")(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(), lse.data_ptr(),
            bh, seq, d, float(scale), stream,
        )
    _raise_on(lib, status, name)
    if count:
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
    return _launch_flash_bwd(q3, k3, v3, out, lse, dout, scale, dlse)


def _launch_flash_bwd(q3, k3, v3, out, lse, dout, scale, dlse,
                      lib: Optional[ctypes.CDLL] = None, count: bool = True):
    """Check and launch a backward: the process's library of q's dtype, or
    ``lib`` (a store entry's probe, which is not counted)."""
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
    lib = lib or _library(name)
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
    if count:
        _count("flash_bwd", name)
    return dq, dk, dv
