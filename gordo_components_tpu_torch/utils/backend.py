"""Device resolution: the one place that decides where the port runs.

The port runs on the card. ``device=None`` means ``cuda``; a machine
without one raises instead of quietly scoring on the CPU. The CPU is taken
only when a caller asks for it by name (the CPU tests do, and so does the
plain-path comparison in ``chip_smoke.py``).

Float32 on the card is full float32: TF32 is switched off for matrix
products and for cuDNN, so a served score does not depend on a library
default (TF32 keeps about three decimal digits).

The numeric sanitizer (the counterpart of the reference's
``jax_debug_nans``, its ``gordo --debug-nans``): :func:`set_debug_nans`
turns it on for the whole process, as ``jax.config`` does, and the
process starts with ``GORDO_DEBUG_NANS`` (``utils/debug_flags.py``). While
it is on, :func:`nan_guard` checks the floating
outputs of every operator a thread runs inside it (every ``aten`` op and
the ``gordo::`` kernels' operators, the CUDA kernels themselves, never
their plain versions in their place) and raises ``FloatingPointError``
naming the first one that made a NaN. Eager PyTorch runs op by op, so the
check is the reference's op-by-op re-run without the re-run. A dispatch
mode is thread-local: the engine's dispatch paths and collector, the spill
tier, the estimators' ``fit`` and ``predict`` (the host path's, a build's),
the fit loop and the fleet trainer enter the guard; autograd carries it to
the thread that runs a CUDA backward. Each check reads its
verdict back to the host, so on the card every op synchronizes: a large
slowdown, for diagnostics only.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Union

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from .debug_flags import debug_nans_enabled, set_debug_nans

__all__ = ["DeviceLike", "NanSanitizer", "debug_nans_enabled", "nan_guard", "resolve_device",
           "set_debug_nans"]

DeviceLike = Union[str, torch.device, None]

# the threads that run under the sanitizer now
_guarded = threading.local()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"`` → the CPU; anything on CUDA requires
    a visible card. Raises ``RuntimeError`` rather than falling back."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gordo_components_tpu_torch runs on a CUDA device, and none "
                "is available; pass device='cpu' to run the plain path on "
                "the CPU explicitly"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif resolved.type != "cpu":
        raise ValueError(f"unsupported device {resolved}; use 'cuda' or 'cpu'")
    return resolved


# operators whose output is memory not yet written: whatever NaN bit
# patterns it holds are no value (what writes it is checked)
_UNWRITTEN = frozenset(("aten::empty", "aten::empty_like", "aten::empty_strided",
                        "aten::empty_permuted", "aten::new_empty", "aten::new_empty_strided",
                        "aten::resize_", "aten::resize_as_"))


class NanSanitizer(TorchDispatchMode):
    """Runs each operator, then tests its floating outputs for NaN (not for
    inf: the reference's ``jax_debug_infs`` is a flag of its own). A view
    is skipped: it computes nothing, and whatever reads it is checked; so
    is an allocation, whose memory is not yet written."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func._schema.name not in _UNWRITTEN:
            for leaf in pytree.tree_leaves(out):
                if (isinstance(leaf, torch.Tensor) and leaf.layout == torch.strided
                        and (leaf.is_floating_point() or leaf.is_complex())
                        and leaf.device.type != "meta" and leaf.numel()
                        and bool(torch.isnan(leaf).any())):
                    raise FloatingPointError(f"invalid value (nan) encountered in {func.name()}")
        return out


@contextlib.contextmanager
def nan_guard() -> Iterator[None]:
    """The sanitizer on this thread for the block while the process flag is
    on; a no-op when it is off or this thread is already guarded."""
    if not debug_nans_enabled() or getattr(_guarded, "on", False):
        yield
        return
    _guarded.on = True
    try:
        with NanSanitizer():
            yield
    finally:
        _guarded.on = False

