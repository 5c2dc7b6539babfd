"""Fleet building on the card (port of ``gordo_components_tpu/parallel/``):
machines of one architecture are stacked on a leading machine axis and a
bucket trains as one program (:func:`train_fleet_arrays`); the builder
(:func:`build_fleet`) turns a fleet config into per-machine artifacts.
One process drives one card; a build of several processes joins one
``torch.distributed`` group (:mod:`.distributed`), each rank building a
contiguous block of every slice."""

from .build_fleet import FleetMachineConfig, build_fleet
from .distributed import (
    FleetRanks,
    RankFailure,
    global_fleet_devices,
    initialize_multihost,
)
from .fleet import (
    FleetResult,
    FleetSpec,
    MachineBatch,
    MachineResult,
    fleet_flops_accounting,
    train_fleet_arrays,
)
from .mesh import fleet_devices, pad_to_multiple

__all__ = [
    "fleet_devices",
    "pad_to_multiple",
    "initialize_multihost",
    "global_fleet_devices",
    "FleetRanks",
    "RankFailure",
    "FleetSpec",
    "MachineBatch",
    "MachineResult",
    "FleetResult",
    "fleet_flops_accounting",
    "train_fleet_arrays",
    "build_fleet",
    "FleetMachineConfig",
]
