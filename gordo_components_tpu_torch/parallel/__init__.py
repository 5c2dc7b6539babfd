"""Fleet building on the card (port of ``gordo_components_tpu/parallel/``):
machines of one architecture are stacked on a leading machine axis and a
bucket trains as one program (:func:`train_fleet_arrays`); the builder
(:func:`build_fleet`) turns a fleet config into per-machine artifacts.
One process drives one card; a build of several processes joins one
``torch.distributed`` group (:mod:`.distributed`), each rank building a
contiguous block of every slice. :mod:`.shard_plan` lays a fleet out over
the processes of a serving mesh.

The names below load on first use: the router's process imports
:mod:`.shard_plan`, and so this package, and must not import ``torch``.
"""

import importlib
import sys
import types

_EXPORTS = {
    "FleetMachineConfig": "build_fleet",
    "build_fleet": "build_fleet",
    "FleetRanks": "distributed",
    "RankFailure": "distributed",
    "global_fleet_devices": "distributed",
    "initialize_multihost": "distributed",
    "FleetResult": "fleet",
    "FleetSpec": "fleet",
    "MachineBatch": "fleet",
    "MachineResult": "fleet",
    "fleet_flops_accounting": "fleet",
    "train_fleet_arrays": "fleet",
    "fleet_devices": "mesh",
    "fleet_mesh": "mesh",
    "pad_to_multiple": "mesh",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    setattr(sys.modules[__name__], name, value)
    return value


class _Package(types.ModuleType):
    """Importing the submodule ``build_fleet`` binds it on the package under
    the name of the function it exports: keep the function there, as an
    eager ``from .build_fleet import build_fleet`` did."""

    def __setattr__(self, name, value):
        if name == "build_fleet" and isinstance(value, types.ModuleType):
            value = value.build_fleet
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Package
