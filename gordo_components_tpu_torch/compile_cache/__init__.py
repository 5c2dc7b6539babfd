"""A compile cache for the port: its built kernel libraries in a checksummed
store beside the models (the counterpart of
``gordo_components_tpu/compile_cache/``).

A boot, a reload or a respawned worker against a warm store loads each
CUDA kernel library it launches instead of building it with ``nvcc``, and
needs no CUDA toolkit to do so. :mod:`.fingerprint` keys an entry,
:mod:`.store` keeps it (the never-fatal fallback contract is there), and
:func:`export_serving_cache` fills a store with the libraries a boot over
a models tree resolves, read by the boot's own rule; it needs no card.
"""

from .fingerprint import backend_fingerprint, canonical, entry_name, full_key
from .store import STORE_ENV, CompileCacheStore, default_root, resolve_store

__all__ = [
    "CompileCacheStore",
    "STORE_ENV",
    "backend_fingerprint",
    "canonical",
    "default_root",
    "entry_name",
    "export_serving_cache",
    "full_key",
    "resolve_store",
]


def export_serving_cache(*args, **kwargs):
    """Lazy proxy for :func:`.export.export_serving_cache` (it pulls in the
    serving engine, which the store itself must not need)."""
    from .export import export_serving_cache as _export

    return _export(*args, **kwargs)
