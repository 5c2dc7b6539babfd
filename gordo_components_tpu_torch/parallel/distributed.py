"""Multi-process fleet builds over ``torch.distributed`` (the port's copy
of ``gordo_components_tpu/parallel/distributed.py:1-97``).

The reference joins N hosts into one JAX runtime and spans one global
mesh; its own docstring notes that the fleet program has no collective
between machines, so in steady state nothing crosses hosts. What does
cross processes is host-side control traffic: the agreement on a slice's
row count, on whether a slice checkpoint exists, and the barrier before a
checkpoint is deleted. The port carries exactly that over a ``gloo``
group of CPU tensors. Each rank trains its own contiguous block of every
slice's machines on its own device (``cuda`` unless the caller asks for
the CPU), so several ranks may share one card, and no tensor on a card is
ever exchanged (NCCL, which cannot put two ranks on one GPU, is not
needed).

Restart semantics are the reference's: a dead or wedged rank ends every
survivor with the retryable exit code 75, and a re-run of all ranks
resumes from the registry, the journals and the slice checkpoints.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..utils.backend import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

# what a rendezvous waits for its peers before it gives up, in seconds:
# jax.distributed.initialize's default, for the same job
DEFAULT_TIMEOUT_S = 300.0
# what a collective of the build waits for its peers, in seconds. A gloo
# group's timeout bounds every collective, and a rank whose block of a
# slice is padding or cached waits in one while its peers train, for as
# long as the slice takes. So the build's collectives run in a group of
# their own with a bound no healthy slice reaches: liveness is the slice
# watchdog's (GORDO_SLICE_TIMEOUT_S), as in the reference, and a peer that
# dies still fails a collective at once (its sockets close)
COLLECTIVE_TIMEOUT_S = 30 * 24 * 3600.0
# the variables torchrun sets (the env:// rendezvous): the port's
# counterpart of the reference's cluster autodetection
_ENV_RENDEZVOUS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


class RankFailure(RuntimeError):
    """The ranks of a build can no longer agree: a collective failed (a
    peer died, the transport broke), their build plans differ, or a slice
    checkpoint one of them needs is unreadable. The CLI exits 75
    (retryable) on it."""


class FleetRanks(NamedTuple):
    """This process's place in a fleet build: the device it trains on, the
    group's size and its rank (1 and 0 without a group)."""

    device: torch.device
    world_size: int
    rank: int


# the group the build's collectives run in (None: the default group, as
# when the caller made the group itself)
_COLLECTIVES: Optional[Any] = None


def _initialized() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The ranks of this process's group, 1 without one: the port's
    ``jax.process_count()``."""
    return torch.distributed.get_world_size() if _initialized() else 1


def rank() -> int:
    """This process's rank, 0 without a group: ``jax.process_index()``."""
    return torch.distributed.get_rank() if _initialized() else 0


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join this process to the build's ``gloo`` group.

    A named coordinator (``host:port``; rank 0 listens there) needs
    ``num_processes`` and ``process_id``, and failing to join it raises.
    With no coordinator the ``env://`` variables that ``torchrun`` sets
    are read (``num_processes``/``process_id`` override ``WORLD_SIZE``/
    ``RANK``); when they are absent the process logs and stays single. A
    no-op when the group already exists.

    ``timeout_s`` bounds the rendezvous only: the build's collectives run
    in a second group of the same ranks whose bound is
    :data:`COLLECTIVE_TIMEOUT_S`."""
    global _COLLECTIVES
    dist = torch.distributed
    if _initialized():
        logger.info("torch.distributed already initialized")
        return
    timeout = datetime.timedelta(seconds=float(timeout_s))
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs the number of processes and this "
                             "process's id (--num-processes, --process-id)")
        if not dist.is_available():
            raise RuntimeError("this torch build has no torch.distributed")
        # the caller named a coordinator: failing to join it is an error,
        # never a single-process fallback
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id),
                                timeout=timeout)
    elif dist.is_available() and all(os.environ.get(key) for key in _ENV_RENDEZVOUS):
        kwargs = {}
        if num_processes is not None:
            kwargs["world_size"] = int(num_processes)
        if process_id is not None:
            kwargs["rank"] = int(process_id)
        dist.init_process_group("gloo", init_method="env://", timeout=timeout, **kwargs)
    else:
        logger.info("torch.distributed not initialized: no coordinator address and no "
                    "torchrun environment (%s); building as one process",
                    ", ".join(_ENV_RENDEZVOUS))
        return
    _COLLECTIVES = dist.new_group(backend="gloo",
                                  timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    logger.info("Distributed build: rank %d of %d (gloo)", rank(), world_size())


def global_fleet_devices(device: DeviceLike = None) -> FleetRanks:
    """The counterpart of ``global_fleet_mesh``: this rank's own device
    (``cuda`` unless the caller says ``"cpu"``), the group's size and this
    process's rank. Ranks share a lone card (time-sliced); on a host of
    several cards, ``cuda`` without an index is the card of the rank's
    ``LOCAL_RANK`` (torchrun's), else of its rank, modulo the count."""
    resolved = resolve_device(device)
    count = torch.cuda.device_count() if resolved.type == "cuda" else 0
    if resolved.index is None and count > 1 and world_size() > 1:
        local = int(os.environ.get("LOCAL_RANK", rank()))
        resolved = torch.device("cuda", local % count)
        torch.cuda.set_device(resolved)
    return FleetRanks(resolved, world_size(), rank())


def allgather_ints(values: Sequence[int]) -> np.ndarray:
    """Every rank's ``values`` (equal lengths), ``(world, len)`` int64, in
    rank order; one row without a group. A failed collective raises
    :class:`RankFailure`."""
    local = torch.as_tensor(np.asarray(values, np.int64).reshape(-1))
    if world_size() == 1:
        return local.numpy()[None]
    gathered = [torch.zeros_like(local) for _ in range(world_size())]
    try:
        torch.distributed.all_gather(gathered, local, group=_COLLECTIVES)
    except RuntimeError as exc:
        raise RankFailure(f"all_gather across {world_size()} ranks failed: {exc}") from exc
    return torch.stack(gathered).numpy()


def barrier() -> None:
    """Every rank reaches this point before any leaves it (a no-op
    without a group); a failed barrier raises :class:`RankFailure`."""
    if world_size() == 1:
        return
    try:
        torch.distributed.barrier(group=_COLLECTIVES)
    except RuntimeError as exc:
        raise RankFailure(f"barrier across {world_size()} ranks failed: {exc}") from exc
