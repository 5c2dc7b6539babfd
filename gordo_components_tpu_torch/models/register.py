"""Factory registry: ``kind`` string → model factory (port of
``gordo_components_tpu/models/register.py``).

Unlike the reference, a kind is never resolved as a dotted import path:
the port loads definitions from artifacts, and an artifact's data must not
name arbitrary importables.
"""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_model_factory(kind: str) -> Callable:
    """Decorator registering ``factory`` under ``kind``."""

    def decorator(factory: Callable) -> Callable:
        if kind in _REGISTRY and _REGISTRY[kind] is not factory:
            raise ValueError(f"Model kind {kind!r} already registered")
        _REGISTRY[kind] = factory
        return factory

    return decorator


def get_factory(kind: str) -> Callable:
    # the factories register on import of their module
    from . import factories  # noqa: F401

    if kind in _REGISTRY:
        return _REGISTRY[kind]
    raise ValueError(
        f"Unknown model kind {kind!r}; the port has: {sorted(_REGISTRY)} "
        "(the other kinds are queued in ROADMAP.md)"
    )
