"""Where the fleet axis runs (the port's copy of
``gordo_components_tpu/parallel/mesh.py:1-45``).

The reference maps the stacked machine axis onto a ``jax.sharding.Mesh``
(``fleet_mesh``/``fleet_sharding``). The port has no ``Mesh`` object: its
counterpart of a mesh is a list of ``torch.device``. :func:`fleet_mesh`
is the local devices a host-sharded serving engine (``ServingEngine(
mesh=...)``) spreads each bucket's stack over, one contiguous chunk per
device (so ``fleet_sharding`` has no counterpart); :func:`fleet_devices`
is the one device of this process's rank when the machine axis spreads
over the ranks of a ``torch.distributed`` group (:mod:`.distributed`).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..utils.backend import DeviceLike, resolve_device
from .distributed import global_fleet_devices


def fleet_mesh(n_devices: Optional[int] = None, device: DeviceLike = None) -> List[torch.device]:
    """The local devices the fleet axis spans, ``cuda:0`` … ``cuda:n-1``
    (default: every visible card). More than ``torch.cuda.device_count()``
    raises ``ValueError``, as the reference does past ``jax.devices()``.
    With ``device="cpu"``: ``n_devices`` entries of the CPU device (default
    1), the counterpart of XLA's virtual CPU devices, so that the chunking,
    the padding and the gather across chunks run without a card."""
    resolved = resolve_device(device)
    if resolved.type == "cpu":
        available = None
        n = 1 if n_devices is None else int(n_devices)
    else:
        available = torch.cuda.device_count()
        n = available if n_devices is None else int(n_devices)
        if n > available:
            raise ValueError(f"Requested {n} devices but only {available} exist")
    if n < 1:
        raise ValueError(f"a fleet mesh needs at least one device, got {n}")
    if available is None:
        return [resolved] * n
    return [torch.device("cuda", i) for i in range(n)]


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
