"""Fill the kernel-library store for a models tree, off the serving path
(the counterpart of ``gordo_components_tpu/compile_cache/export.py:33-110``).

The fleet builder knows the whole fleet, so it is the place to pay the
library builds once, into the store a server over the same tree defaults
to; that server then boots with no ``nvcc`` run.

It loads the built models as a server does (``server._Machine``) and
builds a throwaway :class:`~..server.engine.ServingEngine` over them on
the CPU, only to read which libraries they launch on the card by the
boot's own rule (``ServingEngine.required_libraries``: the buckets' and
the host-path machines'). :func:`~..ops._kernels.fill_store` then makes
the store hold each: already there, copied from a library this process
loaded, or built with ``nvcc``. No card is needed, and what is stored
does not depend on a request's rows or on the engine variant (the
reference's ``rows`` and ``shard_fleet`` warm-up options have no
counterpart: a ``run-server --shard-fleet`` boot over this store runs no
``nvcc``). Best effort end to end: a failed export costs the next boot its
builds, never the build its artifacts.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any, Dict

logger = logging.getLogger(__name__)


def export_serving_cache(model_dirs: Dict[str, str], cache_root: str) -> Dict[str, Any]:
    """Fill the store at ``cache_root`` for the fleet in ``model_dirs``
    (``{machine_name: model_dir}``). Returns the reference's summary (the
    machines' buckets, machines, the machines skipped and why, the store's
    root and counters, the wall); what each library took is logged. A
    machine that fails to load is skipped and named."""
    from ..ops import _kernels
    from ..server.engine import ServingEngine
    from ..server.server import _Machine
    from .store import CompileCacheStore

    started = time.perf_counter()
    machines: Dict[str, Any] = {}
    skipped: Dict[str, str] = {}
    for name, model_dir in sorted(model_dirs.items()):
        try:
            machines[name] = _Machine(name, model_dir)
        except Exception as exc:  # noqa: BLE001 - one bad artifact must not stop the export
            skipped[name] = f"{type(exc).__name__}: {exc}"
    if not machines:
        return {"buckets": 0, "machines": 0, "skipped": skipped}
    store = CompileCacheStore(cache_root)
    engine = ServingEngine(
        {name: m.model for name, m in machines.items()},
        target_cols={name: m.target_columns for name, m in machines.items()},
        precisions={name: m.precision for name, m in machines.items()},
        quantized={name: m.quantized for name, m in machines.items()
                   if m.quantized is not None},
        device="cpu",
    )
    try:
        buckets = engine.stats()["buckets"]
        libraries = _kernels.fill_store(engine.required_libraries(), store)
    finally:
        engine.close()
    summary = {
        "buckets": buckets,
        "machines": len(machines),
        "skipped": skipped,
        "cache_root": store.root,
        "cache": dict(store.counters),
        "duration_s": round(time.perf_counter() - started, 3),
    }
    logger.info(
        "Kernel-library store export: %s for %d bucket(s) over %d machine(s) in %.1fs "
        "(hits %d, writes %d) -> %s", json.dumps(libraries, sort_keys=True), buckets,
        len(machines), summary["duration_s"], store.counters.get("hit", 0),
        store.counters.get("write", 0), store.root,
    )
    return summary
