"""Fleet building on the card (port of ``gordo_components_tpu/parallel/``):
machines of one architecture are stacked on a leading machine axis and a
bucket trains as one program (:func:`train_fleet_arrays`); the builder
(:func:`build_fleet`) turns a fleet config into per-machine artifacts.
One process, one card; the reference's multi-host mesh is a later slice."""

from .build_fleet import FleetMachineConfig, build_fleet
from .fleet import FleetResult, FleetSpec, MachineBatch, MachineResult, train_fleet_arrays
from .mesh import fleet_devices, pad_to_multiple

__all__ = [
    "fleet_devices",
    "pad_to_multiple",
    "FleetSpec",
    "MachineBatch",
    "MachineResult",
    "FleetResult",
    "train_fleet_arrays",
    "build_fleet",
    "FleetMachineConfig",
]
