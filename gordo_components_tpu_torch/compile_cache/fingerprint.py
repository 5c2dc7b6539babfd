"""Cache keys of the port's kernel libraries (the counterpart of
``gordo_components_tpu/compile_cache/fingerprint.py:51-93``).

The reference keys a serialized XLA executable; the port keys a shared
library that ``nvcc`` built from one ``csrc/*.cu`` source. Every key has
the reference's two halves:

- the **program identity** the caller supplies: for a kernel library
  (:func:`library_key` in :mod:`..ops._kernels`) its name, the rung it
  serves (``f32`` or ``bf16``), the SHA-256 of its source and the headers
  it includes, and the build flags; and
- the **backend fingerprint** computed here: what decides whether a
  library built on one host can be loaded on another — torch's version,
  the CUDA version torch was built for, the host's machine type, the
  target architecture of the build and whether it is a
  ``CUDA_KERNEL_DEBUG`` build.

The fingerprint needs neither ``nvcc`` nor the card: a warm store serves a
host with no toolkit, and ``cache list`` runs where there is no card. The
compiler's version is measured where the library is built and rides in
the entry's ``META.json``, not in the key.

The entry name hashes the canonical JSON of the whole key, so a torch
upgrade or a flag change simply misses; the stored ``KEY.json`` is
compared on load as the second line of defence (a mismatch reads
*stale*, never as a library). :func:`canonical` and :func:`entry_name`
render as the reference's do.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import re
from typing import Any, Dict

ENTRY_PREFIX = "cc-"

_ARCH = re.compile(r"code=(sm_[0-9]+[a-z]?)")


def target_arch() -> str:
    """The architecture the libraries are built for, read from the build
    flags (``sm_90a``)."""
    from ..ops import _kernels

    for flag in _kernels.NVCC_FLAGS:
        match = _ARCH.search(flag)
        if match:
            return match.group(1)
    raise ValueError(f"no code=sm_* target in the build flags {_kernels.NVCC_FLAGS}")


def backend_fingerprint() -> Dict[str, Any]:
    """The environment half of every key. Computed on each call: the debug
    flag is read from the environment, and the rest is cheap."""
    import torch

    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "machine": platform.machine(),
        "arch": target_arch(),
        "debug": os.environ.get("CUDA_KERNEL_DEBUG") == "1",
    }


def full_key(program_key: Dict[str, Any]) -> Dict[str, Any]:
    """Program identity + backend fingerprint, the complete key one entry
    is stored and validated under."""
    return {"program": dict(program_key), "backend": backend_fingerprint()}


def canonical(key: Dict[str, Any]) -> str:
    """The one rendering of a key: sorted keys, no whitespace."""
    return json.dumps(key, sort_keys=True, separators=(",", ":"), default=str)


def entry_name(key: Dict[str, Any]) -> str:
    """Directory name for a full key: ``cc-`` and 32 hex digits of the
    SHA-256 of its canonical rendering."""
    digest = hashlib.sha256(canonical(key).encode()).hexdigest()
    return f"{ENTRY_PREFIX}{digest[:32]}"
