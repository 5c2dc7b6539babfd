"""Where the fleet axis runs (the port's copy of
``gordo_components_tpu/parallel/mesh.py:1-45``).

The reference maps the stacked machine axis onto a ``jax.sharding.Mesh``
(``fleet_mesh``/``fleet_sharding``). A process of the port runs its stack
on one card, so its counterpart is a list of one ``torch.device``; the
machine axis spreads over the ranks of a ``torch.distributed`` group
instead (:mod:`.distributed`), each rank a contiguous block. There is no
``Mesh`` object.
"""

from __future__ import annotations

from typing import List

import torch

from ..utils.backend import DeviceLike
from .distributed import global_fleet_devices


def fleet_devices(device: DeviceLike = None) -> List[torch.device]:
    """The devices this process's share of the fleet axis spans: its rank's
    one device (:func:`.distributed.global_fleet_devices`), ``cuda`` unless
    the caller asks for ``"cpu"``."""
    return [global_fleet_devices(device).device]


def pad_to_multiple(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` ≥ ``n`` (machine-axis padding so the
    fleet divides evenly across ranks)."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return ((n + multiple - 1) // multiple) * multiple
