"""Where the fleet axis runs (the port's copy of
``gordo_components_tpu/parallel/mesh.py:1-45``).

The reference maps the stacked machine axis onto a ``jax.sharding.Mesh``
(``fleet_mesh``/``fleet_sharding``). A single-process build of the port
runs the whole stack on one card, so its counterpart is a list of
``torch.device``s of length one: the world size a later multi-process
slice raises. There is no ``Mesh`` object.
"""

from __future__ import annotations

from typing import List

import torch

from ..utils.backend import DeviceLike, resolve_device


def fleet_devices(device: DeviceLike = None) -> List[torch.device]:
    """The devices the fleet axis spans: ``[cuda]`` (or ``[cpu]`` when the
    caller asks for it), world size 1."""
    return [resolve_device(device)]


def pad_to_multiple(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` ≥ ``n`` (machine-axis padding so the
    fleet divides evenly across devices)."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return ((n + multiple - 1) // multiple) * multiple
