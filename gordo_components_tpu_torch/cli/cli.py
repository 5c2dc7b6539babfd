"""``python -m gordo_components_tpu_torch.cli``: the ``build``,
``fleet-build``, ``rollback``, ``cache``, ``run-server``,
``run-fleet-server``, ``run-watchman``, ``trace``, ``slo``, ``tenants``,
``autopilot``, ``fleet``, ``telemetry``, ``incidents``, ``layout``,
``workflow generate``, ``client predict`` and ``lint`` commands of the
reference's CLI (``gordo_components_tpu/cli/cli.py:164-1546``), on
``argparse``.

The arguments, environment variables (``MODEL_CONFIG``, ``DATA_CONFIG``,
``OUTPUT_DIR``, ``MODEL_REGISTER_DIR``, ``METADATA``, ``GORDO_TRACE_DIR``,
``GORDO_LOG_LEVEL``, ``GORDO_LOG_FORMAT``, ``GORDO_DEBUG_NANS``, ``MODEL_LOCATION``,
``GORDO_MAX_INFLIGHT``, ``GORDO_TENANTS``, ``GORDO_FAULTS``) and exit codes
are the reference's: 0 ok, 2 a bad command line, 64 a bad config
(permanent), 66 data unavailable or short (retryable), 70 a deterministic
device failure (an out-of-memory on the card), 75 another device failure,
a failed collective of a build of several ranks or its tripped slice
watchdog (retryable), 1 anything else. The root's ``--debug-nans/--no-debug-nans``
(default ``GORDO_DEBUG_NANS``) turns on the numeric sanitizer for the process
(``utils/backend.py``), whose guarded paths (fits, predictions, a server's
dispatches) then check every op. Configs are JSON, or YAML read through
``yaml`` (imported only there). ``--device`` picks the card (default) or
the CPU; there is no silent fallback. ``run-server`` offers the flags
whose machinery the port has, ``--worker-id`` among them, and
``--lazy-boot/--no-lazy-boot`` (exported as ``GORDO_LAZY_BOOT``, which a
fleet tier's workers inherit; it needs ``--models-dir``, whose
``FLEET_INDEX.json`` then names the fleet) and ``--compile-cache-store``
(the kernel-library store, :mod:`..compile_cache`, which ``fleet-build
--serving-cache`` fills and ``cache list|warm|purge`` manage; ``build`` and
``fleet-build`` fit through ``--compile-cache-dir``) and ``--mesh-shards``/
``--mesh-shard`` (one shard of a fleet-sharded serving mesh, exported as
``GORDO_MESH_SHARDS``/``GORDO_MESH_SHARD``) and ``--shard-fleet`` (the
host-sharded capacity mode: every bucket's stack split over the visible
cards, megabatching off) and ``--megabatch/--no-megabatch`` (exported as
``GORDO_MEGABATCH``, so that every reload agrees) and ``--fill-window-us``
(exported as ``GORDO_FILL_WINDOW_US``); ``cache warm`` accepts
``--shard-fleet`` as the reference does, and stores the same libraries
with it or without it.
``run-fleet-server`` spawns ``--workers`` such servers (``--device`` and
``--megabatch/--no-megabatch`` passed on; with ``--mesh-shards N`` worker i serves shard i mod N, and
more shards than workers exits 2) behind a router that never touches the
card; SIGTERM drains the router, then each worker, and leaves no worker
behind. ``run-watchman`` probes each machine's ``/healthz`` at a target
URL (``GORDO_FAULTS='probe:<machine>:error'`` fails one probe on
purpose), or follows a fleet build's manifest with ``--watch``. ``trace``,
``slo``, ``tenants``, ``autopilot``, ``fleet``, ``telemetry``, ``incidents``
and ``layout`` read (or, ``autopilot enable|disable``, ``fleet
apply|rollback`` and ``layout apply``, POST to) a running server or router
over HTTP (``urllib``), print its JSON and exit 1 when it cannot be
reached or answers an error (``telemetry export`` also when the document
fails ``validate_layout_input``, ``layout explain|apply`` when the plan
fails ``validate_layout_plan``; ``layout plan`` compiles locally, ``layout
explain PLAN_FILE`` works offline); ``client predict`` scores a range through
:class:`~gordo_components_tpu_torch.client.Client`, prints ``{machine:
rows}`` as JSON and exits 1 on a :class:`~gordo_components_tpu_torch.
client.ClientError`.

    python -m gordo_components_tpu_torch.cli build NAME --model-config M \\
        --data-config D --output-dir OUT [--model-register-dir REG] \\
        [--cv-mode build_only] [--precision int8] [--compile-cache-dir DIR|off]
        [--device cpu]
    python -m gordo_components_tpu_torch.cli fleet-build --machine-config FLEET \\
        --output-dir OUT [--model-register-dir REG] [--n-splits 3] [--seed 0] \\
        [--slice-size 256] [--precision int8] [--precision-map a=f32,b=int8] \\
        [--no-serving-cache] [--compile-cache-dir DIR|off] [--device cpu] \\
        [--coordinator-address HOST:PORT --num-processes N --process-id R]
    python -m gordo_components_tpu_torch.cli rollback [--list] MODEL_DIR
    python -m gordo_components_tpu_torch.cli cache list --store STORE
    python -m gordo_components_tpu_torch.cli cache warm --models-dir DIR [--store STORE]
        [--shard-fleet]
    python -m gordo_components_tpu_torch.cli cache purge --store STORE [--stale]
    python -m gordo_components_tpu_torch.cli run-server (--model-dir DIR ... |
        --models-dir DIR) [--host H] [--port N] [--project P] [--max-inflight N]
        [--tenants SPEC] [--faults SPEC] [--worker-id N] [--lazy-boot]
        [--compile-cache-store STORE|off] [--mesh-shards N [--mesh-shard I]]
        [--shard-fleet] [--megabatch|--no-megabatch] [--fill-window-us US] [--device cpu]
    python -m gordo_components_tpu_torch.cli run-fleet-server --models-dir DIR
        [--workers 2] [--host H] [--port 5555] [--worker-base-port 5600]
        [--project P] [--replicas 2] [--hot-rps 50] [--probe-interval 2]
        [--megabatch|--no-megabatch] [--max-inflight N] [--tenants SPEC]
        [--mesh-shards N] [--device cpu]
    python -m gordo_components_tpu_torch.cli run-watchman --project P --machine M ...
        --target-url URL [--host H] [--port 5556] [--manifest FILE]
    python -m gordo_components_tpu_torch.cli run-watchman --watch --manifest FILE
        [--interval 5]
    python -m gordo_components_tpu_torch.cli trace list --base-url URL [--limit N]
    python -m gordo_components_tpu_torch.cli trace dump TRACE_ID --base-url URL
        [--format chrome|json] [-o FILE]
    python -m gordo_components_tpu_torch.cli slo --base-url URL
    python -m gordo_components_tpu_torch.cli tenants --base-url URL
    python -m gordo_components_tpu_torch.cli autopilot status|enable|disable --base-url URL
    python -m gordo_components_tpu_torch.cli fleet apply SPEC_FILE --base-url URL
    python -m gordo_components_tpu_torch.cli fleet diff|status|rollback --base-url URL
    python -m gordo_components_tpu_torch.cli layout plan (--base-url URL | --input DOC)
        [--window 10m] [--cap N] [--parity-budget B] [-o FILE]
    python -m gordo_components_tpu_torch.cli layout explain (PLAN_FILE | --base-url URL)
    python -m gordo_components_tpu_torch.cli layout apply PLAN_FILE --base-url URL
    python -m gordo_components_tpu_torch.cli telemetry traffic|costs --base-url URL
    python -m gordo_components_tpu_torch.cli lint [--jobs N] [--format json]
        [--show-baselined] [--write-knob-table]
        [--window SECONDS]
    python -m gordo_components_tpu_torch.cli telemetry export --base-url URL
        [--window 5m] [-o FILE]
    python -m gordo_components_tpu_torch.cli incidents list --base-url URL
    python -m gordo_components_tpu_torch.cli incidents show ID --base-url URL
    python -m gordo_components_tpu_torch.cli incidents ledger --base-url URL
        [--window 10m] [--limit 200]
    python -m gordo_components_tpu_torch.cli workflow generate --machine-config FLEET
        [--output-file F] [--image I] [--parallelism 10] [--tpu] [--tpu-chips 16]
        [--tpu-hosts 1] [--slice-timeout-s 1800] [--active-deadline-s 86400]
    python -m gordo_components_tpu_torch.cli client predict START END --base-url URL
        [--project P] [--machine M ...] [--max-interval 1D] [--parallelism 10]
        [--output-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Any, List, Optional

from ..precision import PRECISIONS
from ..utils.debug_flags import parse_flag, set_debug_nans

EXIT_USAGE = 2
EXIT_CONFIG = 64
EXIT_DATA = 66
# EX_SOFTWARE: a deterministic device failure (an out-of-memory on the
# card, the reference's RESOURCE_EXHAUSTED); restarting cannot help
EXIT_PERMANENT = 70
# EX_TEMPFAIL: any other device runtime failure, retried by the job layer
EXIT_RETRYABLE = 75

logger = logging.getLogger(__name__)


def _parse_text(text: str, kind: str) -> Any:
    """JSON, else YAML through a lazily imported ``yaml``."""
    try:
        return json.loads(text)
    except ValueError:
        pass
    try:
        import yaml
    except ImportError as exc:
        raise ValueError(f"{kind} is not JSON, and reading it as YAML needs the 'yaml' "
                          "package (PyYAML), which is not installed") from exc
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError as exc:
        raise ValueError(f"{kind} is neither JSON nor YAML: {exc}") from exc


def _load_config(value: Optional[str], kind: str) -> dict:
    """An inline JSON/YAML mapping, or the path of a file holding one."""
    if not value:
        raise ValueError(f"Missing {kind} (flag or env var)")
    if os.path.exists(value):
        with open(value) as fh:
            value = fh.read()
    parsed = _parse_text(value, kind)
    if not isinstance(parsed, dict):
        raise ValueError(f"{kind} must parse to a mapping")
    return parsed


def _build_store(output_dir: str, cache_dir: Optional[str]):
    """The kernel-library store a build's fit resolves its libraries
    through: ``--compile-cache-dir`` (``off``: none, the package's build
    directory), else the one a server over ``output_dir`` defaults to."""
    from ..compile_cache import CompileCacheStore, default_root

    if cache_dir == "off":
        return None
    return CompileCacheStore(cache_dir or default_root(output_dir))


def build(args: argparse.Namespace) -> int:
    """Build one machine's model (idempotent through the config-hash
    cache) and print its model dir."""
    from ..builder import provide_saved_model
    from ..dataset.dataset import InsufficientDataError
    from ..serializer import load_metadata
    from ..utils.profiling import device_trace

    try:
        model_cfg = _load_config(args.model_config, "MODEL_CONFIG")
        data_cfg = _load_config(args.data_config, "DATA_CONFIG")
        user_meta = _parse_text(args.metadata, "METADATA") if args.metadata else {}
        with device_trace(args.trace_dir):
            model_dir = provide_saved_model(
                args.name, model_cfg, data_cfg, args.output_dir,
                metadata=user_meta,
                model_register_dir=args.model_register_dir,
                evaluation_config={"cv_mode": args.cv_mode, "n_splits": args.n_splits},
                precision=args.precision,
                device=args.device,
                compile_cache_store=_build_store(args.output_dir, args.compile_cache_dir),
            )
    except InsufficientDataError as exc:
        logger.error("Data error building %r: %s", args.name, exc)
        return EXIT_DATA
    except ValueError as exc:
        logger.error("Config error building %r: %s", args.name, exc)
        return EXIT_CONFIG
    print(model_dir)
    if args.print_cv_scores:
        meta = load_metadata(model_dir)
        print(json.dumps(meta.get("model", {}).get("cross_validation", {}).get("scores", {})))
    return 0


def fleet_build(args: argparse.Namespace) -> int:
    """Build a whole fleet from its YAML: machines bucketed, each bucket
    trained as one stacked program on the card, each machine committed as
    its own generation; prints ``{name: model_dir}`` as JSON. With
    ``--coordinator-address`` (or ``--num-processes`` under torchrun's
    environment) the build runs as one rank of several, each building its
    own block of every slice; a failed collective or a tripped slice
    watchdog exits 75 (retryable)."""
    import torch

    from ..dataset.dataset import InsufficientDataError
    from ..parallel import FleetMachineConfig, build_fleet
    from ..parallel.distributed import RankFailure, initialize_multihost, world_size
    from ..precision import parse_precision_map
    from ..workflow import NormalizedConfig

    # a device runtime failure other than an out-of-memory (torch >= 2.8)
    device_errors = tuple(e for e in (getattr(torch, "AcceleratorError", None),) if e)
    # a collective that failed: a dead peer, a broken transport
    rank_errors = (RankFailure,) + tuple(
        e for e in (getattr(torch.distributed, "DistError", None),) if e)
    multi_rank = args.coordinator_address is not None or args.num_processes is not None
    if args.process_id is not None and not multi_rank:
        # a bare rank would run a whole one-rank build on every process:
        # duplicated training and racing writes
        logger.error("--process-id needs --coordinator-address and/or --num-processes")
        return EXIT_USAGE
    try:
        if multi_rank:
            initialize_multihost(args.coordinator_address, args.num_processes, args.process_id)
        multi_rank = world_size() > 1
        if multi_rank and args.n_devices is not None:
            logger.warning("--n-devices is ignored in a build of several ranks: each rank "
                           "drives one device")
        elif args.n_devices is not None and args.n_devices != 1:
            # the reference's fleet_mesh refuses more devices than exist: a
            # process of the port drives one, and more cards mean more ranks
            raise ValueError(f"Requested {args.n_devices} devices, but a process of the port "
                             "drives one; run one rank per card (--num-processes) instead")
        config = NormalizedConfig(_load_config(args.machine_config, "machine-config"))
        machines = [
            FleetMachineConfig(name=m.name, model_config=m.model, data_config=m.dataset,
                               metadata=m.metadata, evaluation=m.evaluation)
            for m in config.machines
        ]
        results = build_fleet(
            machines, args.output_dir,
            model_register_dir=args.model_register_dir,
            device=args.device,
            seed=args.seed,
            n_splits=args.n_splits,
            profile_dir=args.trace_dir,
            slice_size=args.slice_size or None,
            precision_default=args.precision,
            precision_map=parse_precision_map(args.precision_map),
            compile_cache_store=_build_store(args.output_dir, args.compile_cache_dir),
        )
    except InsufficientDataError as exc:
        logger.error("Data error in fleet build: %s", exc)
        return EXIT_DATA
    except ValueError as exc:
        logger.error("Config error in fleet build: %s", exc)
        return EXIT_CONFIG
    except torch.cuda.OutOfMemoryError as exc:
        logger.error("Out of device memory in fleet build: %s — exiting permanent code %d "
                     "(restarts cannot help)", exc, EXIT_PERMANENT)
        return EXIT_PERMANENT
    except rank_errors + device_errors as exc:
        logger.error("%s in fleet build: %s — exiting retryable code %d; a restarted run "
                     "resumes from the registry, the journals and the slice checkpoints",
                     "Rank failure" if isinstance(exc, rank_errors) else "Device failure", exc,
                     EXIT_RETRYABLE)
        return EXIT_RETRYABLE
    if args.serving_cache and results and not multi_rank:
        # the serving builds, paid here, once, into the store a server over
        # this tree defaults to; best effort: a failed export costs the
        # first boot its builds, never the build its artifacts. A build of
        # several ranks skips it (each rank holds only its own block)
        from ..compile_cache import default_root, export_serving_cache

        try:
            summary = export_serving_cache(results, default_root(args.output_dir))
            logger.info("Serving compile-cache export: %s", summary)
        except Exception:  # noqa: BLE001 - best effort by contract
            logger.warning("Serving compile-cache export failed (builds unaffected; the "
                           "first server boot will build instead)", exc_info=True)
    print(json.dumps(results, indent=2))
    return 0


def rollback(args: argparse.Namespace) -> int:
    """Roll a generation root back to its previous verified generation
    (an atomic ``CURRENT`` swap), or with ``--list`` print its status."""
    from ..store.errors import StoreError
    from ..store.generations import artifact_status, rollback_generation

    if args.list_only:
        print(json.dumps(artifact_status(args.model_dir), indent=2))
        return 0
    try:
        restored = rollback_generation(args.model_dir)
    except StoreError as exc:
        logger.error("Rollback failed: %s", exc)
        return EXIT_CONFIG
    print(restored)
    return 0


def run_server(args: argparse.Namespace) -> int:
    """Serve built model(s) over HTTP until SIGTERM or an interrupt. SIGTERM
    runs the graceful drain first (admission closes with the draining
    marker, in-flight requests finish, the engine quiesces; at most
    ``GORDO_DRAIN_TIMEOUT`` seconds, default 10) and stops the listener
    only after it, so ``/healthz`` keeps answering ``draining`` meanwhile:
    a silent socket would read as a dead worker to a router."""
    import signal
    import threading

    from ..resilience import faults, qos
    from ..serializer import load_metadata
    from ..server.server import make_server

    if args.tenants is not None:
        try:
            # a typo'd table fails the command instead of serving everyone
            # as 'default'
            qos.parse_tenants(args.tenants)
        except ValueError as exc:
            logger.error("Bad --tenants spec: %s", exc)
            return EXIT_USAGE
        os.environ["GORDO_TENANTS"] = args.tenants
    if args.faults is not None:
        try:
            faults.configure(args.faults)
        except ValueError as exc:
            logger.error("Bad --faults spec: %s", exc)
            return EXIT_USAGE
    if args.lazy_boot is not None:
        # exported, so that every reload's state and a tier's workers agree
        os.environ["GORDO_LAZY_BOOT"] = "1" if args.lazy_boot else "0"
    # exported, so that every reload re-derives the partition this boot used
    if args.mesh_shards is not None:
        os.environ["GORDO_MESH_SHARDS"] = str(args.mesh_shards)
    if args.mesh_shard is not None:
        os.environ["GORDO_MESH_SHARD"] = str(args.mesh_shard)
    # the engine reads it at construction: exported, so that the boot and
    # every reload's engine agree
    if args.megabatch is not None:
        os.environ["GORDO_MEGABATCH"] = "1" if args.megabatch else "0"
    if args.fill_window_us is not None:
        os.environ["GORDO_FILL_WINDOW_US"] = str(args.fill_window_us)
    lazy_boot = os.environ.get("GORDO_LAZY_BOOT", "0").strip().lower() in (
        "1", "true", "on", "yes")
    if lazy_boot and not args.models_dir:
        logger.error("--lazy-boot requires --models-dir (its FLEET_INDEX.json names the fleet)")
        return EXIT_USAGE
    model_dirs = args.model_dirs or (
        [os.environ["MODEL_LOCATION"]] if os.environ.get("MODEL_LOCATION") else [])
    resolved = {}
    for model_dir in model_dirs:
        name = load_metadata(model_dir).get("name") or os.path.basename(model_dir.rstrip("/"))
        resolved[name] = model_dir
    if not resolved and not args.models_dir:
        logger.error("Provide --model-dir (or MODEL_LOCATION) or --models-dir")
        return EXIT_USAGE
    options = {"project": args.project, "max_inflight": args.max_inflight,
               "worker_id": args.worker_id, "lazy_boot": lazy_boot,
               "compile_cache_store": args.compile_cache_store,
               "shard_fleet": args.shard_fleet}
    if not resolved:
        target = args.models_dir  # a fleet: reload rescans it
    elif len(resolved) == 1 and not args.models_dir:
        target = next(iter(resolved.values()))  # a server of one machine
    else:
        target, options["models_root"] = resolved, args.models_dir
    httpd = make_server(target, args.host, args.port, device=args.device, **options)
    host, port = httpd.server_address[:2]
    logger.info("Serving %s on http://%s:%d", sorted(httpd.model_server.machines), host, port)

    drain_timeout = float(os.environ.get("GORDO_DRAIN_TIMEOUT", "10"))

    def _drain_and_stop() -> None:
        # admission closed, in-flight drained, engine quiesced, and only
        # then the listener stopped
        httpd.model_server.quiesce(drain_timeout)
        httpd.shutdown()

    def _on_sigterm(signum, frame) -> None:
        logger.info("SIGTERM: beginning graceful drain")
        # a thread: this (main) thread runs serve_forever, which shutdown()
        # waits for, and which must keep answering while the drain runs
        threading.Thread(target=_drain_and_stop, name="gordo-drain", daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # not the main thread: stopping is the embedder's job
        logger.debug("SIGTERM handler not installed (not the main thread)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()  # closes admission, drains, stops the engine
    logger.info("Server stopped")
    return 0


def cache_list(args: argparse.Namespace) -> int:
    """Print the store's entries as JSON: key, size, whether each verifies
    and whether its backend fingerprint matches this process."""
    from ..compile_cache import CompileCacheStore, backend_fingerprint

    store = CompileCacheStore(args.store)
    print(json.dumps({"root": store.root, "backend": backend_fingerprint(),
                      "entries": store.entries()}, indent=2))
    return 0


def cache_warm(args: argparse.Namespace) -> int:
    """Fill the store for every model under ``--models-dir`` off the
    serving path and print the summary (``--shard-fleet`` changes nothing:
    a kernel library does not depend on the engine variant)."""
    from ..compile_cache import default_root, export_serving_cache
    from ..store.generations import scan_models_dir

    model_dirs = scan_models_dir(args.models_dir) if os.path.isdir(args.models_dir) else {}
    if not model_dirs:
        logger.error("No model dirs found under %r", args.models_dir)
        return EXIT_USAGE
    summary = export_serving_cache(model_dirs, args.store or default_root(args.models_dir))
    print(json.dumps(summary, indent=2))
    return 0


def cache_purge(args: argparse.Namespace) -> int:
    """Delete entries (all, or with ``--stale`` the ones of another backend
    or that fail verification) and sweep crash debris."""
    from ..compile_cache import CompileCacheStore

    store = CompileCacheStore(args.store)
    removed = store.purge(stale_only=args.stale_only)
    print(json.dumps({"root": store.root, "removed": removed}, indent=2))
    return 0


def run_fleet_server(args: argparse.Namespace) -> int:
    """The horizontal serving tier: spawn and supervise ``--workers``
    server processes over one models tree (each ``run-server --worker-id
    i``, on the card unless ``--device cpu``) and route ``/prediction``
    traffic by consistent-hash machine→worker placement. Worker health
    probes drive breaker/quarantine-based eject + respawn; ``POST /reload``
    canaries one worker then sweeps the rest, and ``POST /rollback`` swaps
    ``CURRENT`` fleet-wide before re-adopting. ``--mesh-shards N`` makes
    it a fleet-sharded mesh: worker i serves shard i mod N and the router
    prefers each machine's owning shard. This process never touches the
    card."""
    from ..resilience import qos
    from ..router import run_fleet_server as serve_fleet

    if args.workers < 1:
        logger.error("--workers must be >= 1")
        return EXIT_USAGE
    if args.mesh_shards and args.mesh_shards > args.workers:
        logger.error("--mesh-shards (%d) needs at least that many --workers to cover every "
                     "shard (got %d)", args.mesh_shards, args.workers)
        return EXIT_USAGE
    worker_args: List[str] = []
    if args.megabatch is not None:
        worker_args += ["--megabatch" if args.megabatch else "--no-megabatch"]
    if args.max_inflight is not None:
        worker_args += ["--max-inflight", str(args.max_inflight)]
    if args.tenants is not None:
        try:
            qos.parse_tenants(args.tenants)
        except ValueError as exc:
            logger.error("Bad --tenants spec: %s", exc)
            return EXIT_USAGE
        # env, not worker_args: the router process reads the table too
        os.environ["GORDO_TENANTS"] = args.tenants
    serve_fleet(
        args.models_dir,
        workers=args.workers,
        host=args.host,
        port=args.port,
        worker_base_port=args.worker_base_port,
        project=args.project,
        replicas=args.replicas,
        hot_rps=args.hot_rps,
        probe_interval=args.probe_interval,
        worker_args=worker_args,
        mesh_shards=args.mesh_shards,
        device=args.device,
    )
    return 0


def run_watchman(args: argparse.Namespace) -> int:
    """Serve the fleet-health aggregator (or, with ``--watch``, follow a
    fleet build's manifest and exit 0 once every machine is built)."""
    from ..watchman import run_watchman as serve_watchman
    from ..watchman import watch_build_progress

    if args.watch:
        if not args.manifest:
            logger.error("--watch requires --manifest")
            return EXIT_USAGE
        return 0 if watch_build_progress(args.manifest, interval_s=args.interval) else 1
    if not (args.project and args.machines and args.target_url):
        logger.error("--project, --machine and --target-url are required (or use --watch "
                     "--manifest)")
        return EXIT_USAGE
    serve_watchman(args.project, list(args.machines), args.target_url, host=args.host,
                   port=args.port, manifest_path=args.manifest)
    return 0


def _get_json(url: str) -> Any:
    """GET ``url`` and parse its JSON body; an HTTP error status raises
    ``urllib.error.HTTPError``."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as response:
        return json.loads(response.read().decode())


def _read_server(url: str, what: str) -> Optional[Any]:
    """``_get_json`` that logs a failure and returns None."""
    import urllib.error

    try:
        return _get_json(url)
    except (urllib.error.URLError, OSError, ValueError) as exc:
        logger.error("Could not read %s from %s: %s", what, url, exc)
        return None


def trace_list(args: argparse.Namespace) -> int:
    """List the flight recorder's timelines (recent, slowest, errored)."""
    body = _read_server(f"{args.base_url.rstrip('/')}/debug/requests?limit={args.limit}",
                        "the flight recorder")
    if body is None:
        return 1
    print(json.dumps(body, indent=2))
    return 0


def trace_dump(args: argparse.Namespace) -> int:
    """Dump ONE trace's stage timeline: Chrome trace-event JSON (open it at
    https://ui.perfetto.dev or chrome://tracing) or the raw timeline with
    its stage totals."""
    import urllib.error

    url = f"{args.base_url.rstrip('/')}/debug/requests/{args.trace_id}"
    if args.format == "chrome":
        url += "?format=chrome"
    try:
        body = _get_json(url)
    except urllib.error.HTTPError as exc:
        if exc.code == 404:
            logger.error("Trace %s is not in the flight recorder (rotated out, or never seen "
                         "by this server)", args.trace_id)
        else:
            logger.error("Trace fetch failed: %s", exc)
        return 1
    except (urllib.error.URLError, OSError, ValueError) as exc:
        logger.error("Could not fetch the trace from %s: %s", args.base_url, exc)
        return 1
    text = json.dumps(body, indent=2)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(text)
        print(args.output)
    else:
        print(text)
    return 0


def tenants(args: argparse.Namespace) -> int:
    """The QoS surface of a running server: the tenant table, bucket
    levels, the admission gate's class limits and the raw header values
    seen."""
    body = _read_server(f"{args.base_url.rstrip('/')}/tenants", "/tenants")
    if body is None:
        return 1
    print(json.dumps(body, indent=2))
    return 0


def _request_json(url: str, method: str = "GET", payload: Any = None) -> Optional[Any]:
    """The JSON body of ``method url`` (POSTing ``payload`` as JSON when
    given), or None (logged) when the server cannot be reached, answers no
    JSON or answers an error status."""
    import urllib.error
    import urllib.request

    data = None
    if method == "POST":
        data = b"" if payload is None else json.dumps(payload).encode()
    request = urllib.request.Request(url, method=method, data=data,
                                     headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=30) as response:
            status, raw = response.status, response.read()
    except urllib.error.HTTPError as exc:
        status, raw = exc.code, exc.read()
    except (urllib.error.URLError, OSError) as exc:
        logger.error("Could not reach %s: %s", url, exc)
        return None
    try:
        body = json.loads(raw.decode())
    except ValueError:
        logger.error("Non-JSON answer from %s (HTTP %d)", url, status)
        return None
    if status >= 400:
        logger.error("%s answered HTTP %d: %s", url, status,
                     body.get("error", body) if isinstance(body, dict) else body)
        return None
    return body


def _print_from(url: str, method: str = "GET") -> int:
    body = _request_json(url, method)
    if body is None:
        return 1
    print(json.dumps(body, indent=2))
    return 0


def slo(args: argparse.Namespace) -> int:
    """Objective attainment, fast and slow burn rates, breach counts and
    the stages eating the budget, from a running server's ``/slo``."""
    return _print_from(f"{args.base_url.rstrip('/')}/slo")


def autopilot(args: argparse.Namespace) -> int:
    """``status``: the ``/autopilot`` body (enablement, each actuator's
    value, bounds and cooldown, the decision journal, the last
    observation); ``enable``/``disable``: the runtime kill switch (``POST
    /autopilot/<action>``; 409, so exit 1, under ``GORDO_AUTOPILOT=0``)."""
    base = args.base_url.rstrip("/")
    if args.autopilot_command == "status":
        return _print_from(f"{base}/autopilot")
    return _print_from(f"{base}/autopilot/{args.autopilot_command}", method="POST")


def _telemetry(base_url: str, window: Optional[float], view: Optional[str] = None
               ) -> Optional[Any]:
    import urllib.parse

    query = {key: value for key, value in (("window", window), ("view", view))
             if value is not None}
    url = f"{base_url.rstrip('/')}/telemetry"
    if query:
        url += "?" + urllib.parse.urlencode(query)
    body = _request_json(url)
    if body is not None and not body.get("enabled", True) and "schema" not in body:
        logger.error("Telemetry is disabled on %s (GORDO_TELEMETRY=0)", base_url)
        return None
    return body


def telemetry(args: argparse.Namespace) -> int:
    """``traffic``: the top-k sketch with its 1m/10m/1h rates and the shape
    x precision groups; ``costs``: the cost ledger and the warehouse's
    state; ``export``: the ``gordo-layout-input/v1`` document
    (``?view=export``), validated before it is printed."""
    from ..observability import telemetry as telemetry_engine

    if args.telemetry_command == "export":
        seconds = telemetry_engine.parse_window(args.window)
        if seconds is None:
            logger.error("--window %r is not a duration (try 90, 10m, 1h)", args.window)
            return 1
        body = _telemetry(args.base_url, seconds, view="export")
        if body is None:
            return 1
        problems = telemetry_engine.validate_layout_input(body)
        for problem in problems:
            logger.error("layout-input validation: %s", problem)
        if problems:
            return 1
        text = json.dumps(body, indent=2)
        if args.output:
            with open(args.output, "w") as fh:
                fh.write(text + "\n")
            print(args.output)
        else:
            print(text)
        return 0
    body = _telemetry(args.base_url, args.window)
    if body is None:
        return 1
    head = {"now": body.get("now"), "workers": body.get("workers", [body.get("worker")])}
    if args.telemetry_command == "traffic":
        view = {**head, "traffic": body.get("traffic"), "window": body.get("window")}
    else:
        view = {**head, "costs": body.get("costs"), "warehouse": body.get("warehouse")}
    print(json.dumps(view, indent=2))
    return 0


def incidents(args: argparse.Namespace) -> int:
    """``list``: newest-first incident summaries; ``show ID``: one report
    (trigger, the lookback's ledger events, metric deltas, the ranked
    candidates); ``ledger``: the control ledger's tail."""
    import urllib.parse

    base = args.base_url.rstrip("/")
    if args.incidents_command == "list":
        return _print_from(f"{base}/incidents")
    if args.incidents_command == "show":
        return _print_from(f"{base}/incidents/{urllib.parse.quote(args.incident_id)}")
    query = {"view": "ledger", "limit": args.limit}
    if args.window is not None:
        query["window"] = args.window
    return _print_from(f"{base}/incidents?{urllib.parse.urlencode(query)}")


def _read_json_file(path: str) -> Optional[Any]:
    try:
        with open(path) as fh:
            return json.load(fh)
    except OSError as exc:
        logger.error("Cannot read %s: %s", path, exc)
    except ValueError as exc:
        logger.error("%s is not JSON: %s", path, exc)
    return None


def fleet(args: argparse.Namespace) -> int:
    """The declarative fleet reconciler of a running router: ``apply``
    commits a JSON spec file as a new revision (``POST /fleet/apply``;
    parsing is loud: an unknown machine, precision rung or key is a 422,
    so exit 1); ``diff`` shows the spec-vs-observed divergences without
    repairing (``/fleet/diff``); ``status`` dumps ``/fleet`` (revision,
    divergence counts, the repair ring, frozen and cooling classes);
    ``rollback`` re-applies the previous revision as a new one. Under
    ``GORDO_FLEET=0`` at router start every verb answers 409 (exit 1)."""
    base = args.base_url.rstrip("/")
    if args.fleet_command == "apply":
        payload = _read_json_file(args.spec_file)
        if payload is None:
            return 1
        body = _request_json(f"{base}/fleet/apply", "POST", payload)
    elif args.fleet_command == "rollback":
        body = _request_json(f"{base}/fleet/rollback", "POST")
    else:
        body = _request_json(f"{base}/fleet/diff" if args.fleet_command == "diff"
                             else f"{base}/fleet")
    if body is None:
        return 1
    print(json.dumps(body, indent=2))
    return 0


def _read_plan(path: str) -> Optional[Any]:
    from ..layout import plan as layout_plan

    plan = _read_json_file(path)
    if plan is None:
        return None
    problems = layout_plan.validate_layout_plan(plan)
    for problem in problems:
        logger.error("layout-plan validation: %s", problem)
    return None if problems else plan


def layout(args: argparse.Namespace) -> int:
    """The fleet layout compiler: ``plan`` compiles a ``gordo-layout-plan/v1``
    from a live router's ``/telemetry?view=export`` (``--base-url``) or a
    saved layout-input document (``--input``), the same document always to
    the same bytes; ``explain`` renders a plan's decisions and why each
    machine moved (a plan file, or with ``--base-url`` the committed spec's
    plan); ``apply`` commits a plan file into the fleet spec journal (the
    current spec with ``layout`` replaced, as a new revision), where the
    reconciler drives it onto the fleet and ``fleet rollback`` reverts it."""
    from ..layout import compiler as layout_compiler
    from ..layout import plan as layout_plan
    from ..observability import telemetry as telemetry_engine

    if args.layout_command == "plan":
        if (args.base_url is None) == (args.input is None):
            logger.error("pass exactly one of --base-url or --input")
            return 1
        if args.base_url is not None:
            seconds = telemetry_engine.parse_window(args.window)
            if seconds is None:
                logger.error("--window %r is not a duration (try 90, 10m, 1h)", args.window)
                return 1
            doc = _telemetry(args.base_url, seconds, view="export")
        else:
            doc = _read_json_file(args.input)
        if doc is None:
            return 1
        try:
            plan = layout_compiler.compile_plan(
                doc, residency_cap=args.cap, parity_budget=args.parity_budget)
        except ValueError as exc:
            logger.error("layout plan does not compile: %s", exc)
            return 1
        rendered = json.dumps(plan, indent=2, sort_keys=True)
        if args.output:
            with open(args.output, "w") as fh:
                fh.write(rendered + "\n")
            print(args.output)
        else:
            print(rendered)
        return 0
    if args.layout_command == "explain":
        if (args.plan_file is None) == (args.base_url is None):
            logger.error("pass exactly one of PLAN_FILE or --base-url")
            return 1
        if args.plan_file is not None:
            plan = _read_plan(args.plan_file)
        else:
            body = _request_json(f"{args.base_url.rstrip('/')}/fleet/diff")
            plan = None if body is None else (body.get("spec") or {}).get("layout")
            if body is not None and plan is None:
                logger.error("the committed fleet spec carries no layout plan")
        if plan is None:
            return 1
        print(layout_plan.explain_plan(plan))
        return 0
    plan = _read_plan(args.plan_file)
    if plan is None:
        return 1
    base = args.base_url.rstrip("/")
    body = _request_json(f"{base}/fleet/diff")
    if body is None:
        return 1
    spec = dict(body.get("spec") or {})
    spec["layout"] = plan
    reply = _request_json(f"{base}/fleet/apply", "POST", spec)
    if reply is None:
        return 1
    print(json.dumps(reply, indent=2))
    return 0


def client_predict(args: argparse.Namespace) -> int:
    """Score [START, END) for every machine (or ``--machine``) and print the
    row counts; ``--output-dir`` writes one score CSV per machine."""
    from ..client import Client, ClientError, CsvForwarder

    forwarders = [CsvForwarder(args.output_dir)] if args.output_dir else []
    client = Client(args.base_url, project=args.project, machines=args.machines or None,
                    max_interval=args.max_interval, parallelism=args.parallelism,
                    forwarders=forwarders)
    try:
        frames = client.predict(args.start, args.end)
    except ClientError as exc:
        logger.error("Prediction failed: %s", exc)
        return 1
    finally:
        client.close()
    print(json.dumps({machine: 0 if frame is None else len(frame)
                      for machine, frame in frames.items()}))
    return 0


def workflow_generate(args: argparse.Namespace) -> int:
    """Fleet config → an Argo Workflow, or with ``--tpu`` the one-Job fleet
    spec (its limits request ``nvidia.com/gpu``); prints the manifest, or
    writes it to ``--output-file`` and prints that path. A config the
    generator rejects exits ``EXIT_CONFIG``, as the reference's does."""
    from ..workflow import generate_argo_workflow, generate_tpu_job
    from ..workflow.workflow_generator import validate_generated

    try:
        config = _load_config(args.machine_config, "machine-config")
    except ValueError as exc:
        logger.error("%s", exc)
        return EXIT_USAGE
    try:
        if args.tpu_mode:
            manifest = generate_tpu_job(
                config, image=args.image, tpu_chips=args.tpu_chips, hosts=args.tpu_hosts,
                slice_timeout_s=args.slice_timeout_s,
                active_deadline_s=args.active_deadline_s,
            )
        else:
            manifest = generate_argo_workflow(config, image=args.image,
                                              parallelism=args.parallelism)
        validate_generated(manifest)
    except ValueError as exc:
        logger.error("Config error generating workflow: %s", exc)
        return EXIT_CONFIG
    if args.output_file:
        with open(args.output_file, "w") as fh:
            fh.write(manifest)
        print(args.output_file)
    else:
        print(manifest)
    return 0


def _int_at_least(low: int):
    """An argparse type: an integer no less than ``low`` (click's
    ``IntRange(min=low)``)."""

    def parse(text: str) -> int:
        value = int(text)
        if value < low:
            raise argparse.ArgumentTypeError(f"{value} is smaller than the minimum {low}")
        return value

    parse.__name__ = f"integer >= {low}"
    return parse


_COMPILE_CACHE_DIR_HELP = (
    "the kernel-library store the build's fit loads its CUDA libraries from and writes "
    "them to ('off': none, the package's build directory). Default: "
    "<output-dir>/.compile-cache/torch-cuda")


def parser() -> argparse.ArgumentParser:
    env = os.environ.get
    root = argparse.ArgumentParser(
        prog="python -m gordo_components_tpu_torch.cli",
        description="gordo-components-tpu on PyTorch: build fleets and machines, roll "
                    "them back, and serve them.")
    root.add_argument("--log-level", default=env("GORDO_LOG_LEVEL", "INFO"))
    root.add_argument("--log-format", default=env("GORDO_LOG_FORMAT", "text"),
                      choices=["text", "json"],
                      help="'json' emits one JSON object per record, trace and span ids as "
                           "fields; 'text' the plain line format")
    root.add_argument("--debug-nans", action=argparse.BooleanOptionalAction, default=None,
                      help="Enable the numeric sanitizer: every operator's output is checked "
                           "and the first op that makes a NaN raises FloatingPointError naming "
                           "it (the reference's jax_debug_nans; large slowdown, diagnostics "
                           "only). Default: GORDO_DEBUG_NANS, else off")
    commands = root.add_subparsers(dest="command", required=True)

    b = commands.add_parser("build", help="build one machine's model (idempotent via the "
                                          "config-hash cache)")
    b.add_argument("name")
    b.add_argument("--model-config", default=env("MODEL_CONFIG"),
                   help="JSON/YAML string or file path")
    b.add_argument("--data-config", default=env("DATA_CONFIG"),
                   help="JSON/YAML string or file path")
    b.add_argument("--output-dir", default=env("OUTPUT_DIR"), required=not env("OUTPUT_DIR"))
    b.add_argument("--model-register-dir", default=env("MODEL_REGISTER_DIR"))
    b.add_argument("--metadata", default=env("METADATA"),
                   help="extra user metadata (JSON/YAML string)")
    b.add_argument("--cv-mode", default="full_build",
                   choices=["full_build", "cross_val_only", "build_only"])
    b.add_argument("--n-splits", type=int, default=3)
    b.add_argument("--print-cv-scores", action="store_true")
    b.add_argument("--precision", default=None, choices=list(PRECISIONS),
                   help="the machine's serving rung, pinned in its build metadata; int8 also "
                        "commits the quantized weights. Default: GORDO_PRECISION_DEFAULT, "
                        "else f32")
    b.add_argument("--trace-dir", default=env("GORDO_TRACE_DIR"),
                   help="write a torch.profiler Chrome trace of the build to this directory")
    b.add_argument("--compile-cache-dir", default=env("GORDO_COMPILE_CACHE"),
                   help=_COMPILE_CACHE_DIR_HELP)
    b.add_argument("--device", default=None,
                   help="cuda (default) or cpu; there is no silent fallback")
    b.set_defaults(run=build)

    f = commands.add_parser(
        "fleet-build", help="build a whole fleet: machines bucketed and trained as stacked "
                            "programs on the card")
    f.add_argument("--machine-config", required=True,
                   help="fleet YAML/JSON (machines + globals): a file path or a string")
    f.add_argument("--output-dir", default=env("OUTPUT_DIR"), required=not env("OUTPUT_DIR"))
    f.add_argument("--model-register-dir", default=env("MODEL_REGISTER_DIR"))
    f.add_argument("--n-splits", type=int, default=3,
                   help="CV folds for machines that set no evaluation.n_splits of their own "
                        "(default 3)")
    f.add_argument("--n-devices", type=int, default=None,
                   help="devices of this process's share of the fleet axis: 1 (a process "
                        "drives one card; more cards mean more ranks). Ignored with several "
                        "ranks")
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--coordinator-address", default=env("GORDO_COORDINATOR"),
                   help="a build of several ranks: the gloo group's host:port, where rank 0 "
                        "listens; run the same command once per rank, each with its "
                        "--process-id. Each rank fetches, trains and commits its own block "
                        "of every slice (output and registry directories shared). Omitted "
                        "with --num-processes: torchrun's environment (MASTER_ADDR, ...)")
    f.add_argument("--num-processes", type=int,
                   default=env("GORDO_NUM_PROCESSES"), help="the group's size")
    f.add_argument("--process-id", type=int, default=env("GORDO_PROCESS_ID"),
                   help="this process's rank (needs --coordinator-address or "
                        "--num-processes)")
    f.add_argument("--slice-size", type=int, default=256,
                   help="machines per slice of a bucket; each slice's artifacts land as it "
                        "finishes; 0 disables slicing (default 256)")
    f.add_argument("--precision", default=None, choices=list(PRECISIONS),
                   help="the fleet's default serving rung (pinned in each machine's "
                        "metadata; training is unchanged). Default: GORDO_PRECISION_DEFAULT, "
                        "else f32")
    f.add_argument("--precision-map", default=None,
                   help="per-machine rungs: 'name=prec,name=prec' or a YAML file mapping "
                        "names to f32/bf16/int8")
    f.add_argument("--trace-dir", default=env("GORDO_TRACE_DIR"),
                   help="write a torch.profiler Chrome trace of the training to this directory")
    f.add_argument("--serving-cache", action=argparse.BooleanOptionalAction, default=True,
                   help="after the build, put the kernel libraries the fleet's serving "
                        "launches into <output-dir>/.compile-cache/torch-cuda (the store "
                        "run-server --models-dir defaults to), so the first boot, and every "
                        "reload and rollback, loads them instead of running nvcc (best "
                        "effort; default on)")
    f.add_argument("--compile-cache-dir", default=env("GORDO_COMPILE_CACHE"),
                   help=_COMPILE_CACHE_DIR_HELP)
    f.add_argument("--device", default=None,
                   help="cuda (default) or cpu; there is no silent fallback")
    f.set_defaults(run=fleet_build)

    r = commands.add_parser("rollback", help="swap a model dir's CURRENT back to its previous "
                                             "verified generation")
    r.add_argument("model_dir")
    r.add_argument("--list", dest="list_only", action="store_true",
                   help="print the generation status as JSON without changing anything")
    r.set_defaults(run=rollback)

    s = commands.add_parser("run-server", help="serve built model(s) over HTTP")
    s.add_argument("--model-dir", dest="model_dirs", action="append", default=None,
                   help="a model dir; repeat for several machines (default: MODEL_LOCATION)")
    s.add_argument("--models-dir", default=None,
                   help="a directory whose immediate subdirectories are model dirs; "
                        "POST /reload rescans it")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=5555)
    s.add_argument("--project", default="project")
    s.add_argument("--max-inflight", type=int, default=None,
                   help="admission-gate bound on concurrently scoring requests; past it "
                        "(and a small queue) requests shed with 503 + Retry-After (default: "
                        "GORDO_MAX_INFLIGHT, else 64)")
    s.add_argument("--tenants", default=env("GORDO_TENANTS"),
                   help="the tenant table: 'name:class[:rate[:burst[:key]]]' entries separated "
                        "by ';', class interactive/standard/bulk, rate in requests/s (0 = no "
                        "quota), key an optional API key. Requests name their tenant in "
                        "X-Gordo-Tenant; unknown names fold into 'default'")
    s.add_argument("--faults", default=env("GORDO_FAULTS"),
                   help="fault-injection spec 'point:target:kind[:param][;...]' (points "
                        "model-load, engine-dispatch, data-fetch; kinds error, latency, "
                        "corrupt); never in production")
    s.add_argument("--worker-id", type=int, default=env("GORDO_WORKER_ID"),
                   help="fleet slot id when this server runs as one worker of a "
                        "run-fleet-server tier: responses carry X-Gordo-Worker, /healthz "
                        "reports the id, and the ledger and warehouse directories are "
                        "worker-<id> (default: GORDO_WORKER_ID, else unset, 0 in the paths)")
    s.add_argument("--lazy-boot", action=argparse.BooleanOptionalAction, default=None,
                   help="boot from the models directory's FLEET_INDEX.json: the first "
                        "GORDO_BOOT_EAGER machines load now, the rest on their first request "
                        "through the host-RAM spill tier (GORDO_HOST_CACHE_MB), verified "
                        "then; needs --models-dir; overrides GORDO_LAZY_BOOT")
    s.add_argument("--compile-cache-store", default=env("GORDO_COMPILE_CACHE_STORE"),
                   help="the kernel-library store the server loads its CUDA libraries from "
                        "('off': none, the package's build directory). Default: "
                        "<models-dir>/.compile-cache/torch-cuda when --models-dir is given, "
                        "the store fleet-build fills, so a boot, a reload and a rollback run "
                        "no nvcc against a warm store")
    s.add_argument("--mesh-shards", type=int, default=env("GORDO_MESH_SHARDS"),
                   help="fleet-sharded serving mesh: the shard count the fleet's stacked "
                        "machines partition across by ring position; this process stacks "
                        "only its owned machines and serves the rest through the spill "
                        "fallback rung. 0 or unset: single-host serving (default: "
                        "GORDO_MESH_SHARDS)")
    s.add_argument("--mesh-shard", type=int, default=env("GORDO_MESH_SHARD"),
                   help="this process's shard (0-based) of the --mesh-shards mesh (default: "
                        "GORDO_MESH_SHARD, else the worker id mod the shards)")
    s.add_argument("--shard-fleet", action="store_true",
                   help="the host-sharded capacity mode: split every bucket's stacked "
                        "machines over all visible cards (for fleets whose stack exceeds one "
                        "card), at the cost of a gather per cold dispatch; machines asked "
                        "repeatedly keep a hot copy (GORDO_SERVE_HOT_CACHE); megabatching is "
                        "off")
    s.add_argument("--megabatch", action=argparse.BooleanOptionalAction, default=None,
                   help="cross-machine megabatching: concurrent requests for different "
                        "machines fuse into one dispatch through the resident stack (default "
                        "on; always off with --shard-fleet); overrides GORDO_MEGABATCH")
    s.add_argument("--fill-window-us", type=int, default=env("GORDO_FILL_WINDOW_US"),
                   help="bounded megabatch fill window in microseconds: how long a dispatch "
                        "leader that observes concurrency collects further requests before "
                        "dispatching the fused batch (core-aware default; 0 disables the "
                        "wait; idle requests never wait); exported as GORDO_FILL_WINDOW_US")
    s.add_argument("--device", default=None,
                   help="cuda (default) or cpu; there is no silent fallback")
    s.set_defaults(run=run_server)

    fs = commands.add_parser(
        "run-fleet-server", help="the horizontal serving tier: a router over supervised "
                                 "worker server processes")
    fs.add_argument("--models-dir", required=True,
                    help="directory whose immediate subdirectories are model dirs; every "
                         "worker serves this tree")
    fs.add_argument("--workers", type=int, default=2,
                    help="worker server processes to spawn and supervise (default 2)")
    fs.add_argument("--host", default="0.0.0.0", help="router listen address")
    fs.add_argument("--port", type=int, default=5555, help="router listen port")
    fs.add_argument("--worker-base-port", type=int, default=5600,
                    help="worker i listens on worker-base-port + i (loopback; default 5600)")
    fs.add_argument("--project", default="project")
    fs.add_argument("--replicas", type=int, default=2,
                    help="distinct workers serving each HOT machine (cold machines are "
                         "pinned to exactly one; default 2)")
    fs.add_argument("--hot-rps", type=float, default=50.0,
                    help="request rate at which a machine is replicated across --replicas "
                         "workers; 0 disables rate-based promotion (default 50)")
    fs.add_argument("--probe-interval", type=float, default=2.0,
                    help="control-plane health-probe interval in seconds, each tick "
                         "jittered by 10%% (default 2)")
    fs.add_argument("--megabatch", action=argparse.BooleanOptionalAction, default=None,
                    help="forwarded to every worker (see run-server)")
    fs.add_argument("--max-inflight", type=int, default=None,
                    help="per-WORKER admission bound (see run-server)")
    fs.add_argument("--tenants", default=env("GORDO_TENANTS"),
                    help="the tenant table (see run-server), exported as GORDO_TENANTS so "
                         "the router and every worker load the same table")
    fs.add_argument("--mesh-shards", type=int, default=int(env("GORDO_MESH_SHARDS") or 0),
                    help="fleet-sharded serving mesh: partition the fleet's stacked machines "
                         "across this many shards; worker i serves shard i mod shards and "
                         "the router prefers each machine's owning shard, falling back to "
                         "another worker's spill tier when the owner is down. 0 (default: "
                         "GORDO_MESH_SHARDS, else 0): the replicated tier. More shards than "
                         "--workers exits 2")
    fs.add_argument("--device", default=None,
                    help="passed on to every worker: cuda (default) or cpu; the router "
                         "itself never touches the card")
    fs.set_defaults(run=run_fleet_server)

    w = commands.add_parser("run-watchman", help="the fleet-health aggregator, or a fleet "
                                                 "build follower with --watch")
    w.add_argument("--project", default=None)
    w.add_argument("--machine", dest="machines", action="append", default=[],
                   help="a machine to probe; repeat for several")
    w.add_argument("--target-url", default=None,
                   help="the server (or fleet router) base URL the machines are served at")
    w.add_argument("--host", default="0.0.0.0")
    w.add_argument("--port", type=int, default=5556)
    w.add_argument("--manifest", default=None,
                   help="a fleet build's fleet_manifest.json; GET / then also reports build "
                        "progress (completed/pending) from it")
    w.add_argument("--watch", action="store_true",
                   help="no HTTP: follow the fleet manifest, print one JSON progress line "
                        "per interval, exit 0 when every machine is completed")
    w.add_argument("--interval", type=float, default=5.0,
                   help="--watch poll interval in seconds (default 5)")
    w.set_defaults(run=run_watchman)

    t = commands.add_parser("trace", help="flight-recorder timelines of a running server")
    trace_commands = t.add_subparsers(dest="trace_command", required=True)
    tl = trace_commands.add_parser("list", help="list recorded request timelines (recent, "
                                                "slowest, errored)")
    tl.add_argument("--base-url", required=True, help="the server's base URL")
    tl.add_argument("--limit", type=int, default=20)
    tl.set_defaults(run=trace_list)
    td = trace_commands.add_parser("dump", help="dump one trace's stage timeline")
    td.add_argument("trace_id", help="an X-Gordo-Trace-Id a response echoed")
    td.add_argument("--base-url", required=True, help="the server's base URL")
    td.add_argument("--output", "-o", default=None, help="write here instead of stdout")
    td.add_argument("--format", default="chrome", choices=["chrome", "json"],
                    help="chrome = trace-event JSON (Perfetto); json = the timeline with its "
                         "stage totals")
    td.set_defaults(run=trace_dump)

    so = commands.add_parser("slo", help="objective attainment and burn rates of a running "
                                         "server")
    so.add_argument("--base-url", required=True, help="the server's base URL")
    so.set_defaults(run=slo)

    tn = commands.add_parser("tenants", help="the tenant table, quota levels and class "
                                             "limits of a running server")
    tn.add_argument("--base-url", required=True, help="the server's base URL")
    tn.set_defaults(run=tenants)

    a = commands.add_parser("autopilot", help="the closed-loop controller of a running server")
    autopilot_commands = a.add_subparsers(dest="autopilot_command", required=True)
    for action, text in (("status", "the controller's status and decision journal"),
                         ("enable", "start (or resume) adapting"),
                         ("disable", "freeze all adaptation now (the runtime kill switch)")):
        ap = autopilot_commands.add_parser(action, help=text)
        ap.add_argument("--base-url", required=True, help="the server's base URL")
        ap.set_defaults(run=autopilot)

    te = commands.add_parser("telemetry", help="the telemetry warehouse of a running server")
    telemetry_commands = te.add_subparsers(dest="telemetry_command", required=True)
    for action, text in (("traffic", "the top-k traffic sketch with its EWMA rates"),
                         ("costs", "the measured-cost ledger per rung")):
        tp = telemetry_commands.add_parser(action, help=text)
        tp.add_argument("--base-url", required=True, help="the server's base URL")
        tp.add_argument("--window", type=float, default=300.0,
                        help="history window in seconds (default 300)")
        tp.set_defaults(run=telemetry)
    tx = telemetry_commands.add_parser("export", help="the gordo-layout-input/v1 document")
    tx.add_argument("--base-url", required=True, help="the server's base URL")
    tx.add_argument("--window", default="5m", help="rate horizon: seconds or 1m/10m/1h forms "
                                                   "(default 5m)")
    tx.add_argument("--output", "-o", default=None, help="write here instead of stdout")
    tx.set_defaults(run=telemetry)

    i = commands.add_parser("incidents", help="incident reports and the control ledger of a "
                                              "running server")
    incident_commands = i.add_subparsers(dest="incidents_command", required=True)
    il = incident_commands.add_parser("list", help="newest-first incident summaries")
    il.add_argument("--base-url", required=True, help="the server's base URL")
    il.set_defaults(run=incidents)
    ish = incident_commands.add_parser("show", help="one full incident report")
    ish.add_argument("incident_id")
    ish.add_argument("--base-url", required=True, help="the server's base URL")
    ish.set_defaults(run=incidents)
    ile = incident_commands.add_parser("ledger", help="the control ledger's tail")
    ile.add_argument("--base-url", required=True, help="the server's base URL")
    ile.add_argument("--window", default=None, help="only events in this trailing window: "
                                                    "seconds or 1m/10m/1h forms")
    ile.add_argument("--limit", type=int, default=200, help="newest events kept (default 200)")
    ile.set_defaults(run=incidents)

    fl = commands.add_parser("fleet", help="the declarative fleet reconciler of a running "
                                           "router")
    fleet_commands = fl.add_subparsers(dest="fleet_command", required=True)
    fa = fleet_commands.add_parser("apply", help="commit a JSON fleet spec as a new revision")
    fa.add_argument("spec_file")
    for action, text in (("diff", "spec-vs-observed divergences, read-only"),
                         ("status", "the reconciler's status and repair journal"),
                         ("rollback", "re-apply the previous spec revision as a new one")):
        fleet_commands.add_parser(action, help=text)
    for fp in fleet_commands.choices.values():
        fp.add_argument("--base-url", required=True, help="the router's base URL")
        fp.set_defaults(run=fleet)

    la = commands.add_parser("layout", help="the fleet layout compiler")
    layout_commands = la.add_subparsers(dest="layout_command", required=True)
    lp = layout_commands.add_parser("plan", help="compile a gordo-layout-plan/v1 from measured "
                                                 "costs")
    lp.add_argument("--base-url", default=None,
                    help="router base URL to pull /telemetry?view=export from")
    lp.add_argument("--input", default=None,
                    help="a saved layout-input document instead of a live fleet")
    lp.add_argument("--window", default="10m",
                    help="rate horizon: seconds or 1m/10m/1h forms (default 10m)")
    lp.add_argument("--cap", type=int, default=None, help="per-worker residency cap override")
    lp.add_argument("--parity-budget", type=float, default=None,
                    help="traffic-weighted parity budget for precision downgrades (0 disables "
                         "them)")
    lp.add_argument("--output", "-o", default=None, help="write the plan here instead of stdout")
    lp.set_defaults(run=layout)
    le = layout_commands.add_parser("explain", help="render a plan's decisions and why each "
                                                    "machine moved")
    le.add_argument("plan_file", nargs="?", default=None)
    le.add_argument("--base-url", default=None,
                    help="read the committed spec's plan from a live router")
    le.set_defaults(run=layout)
    lap = layout_commands.add_parser("apply", help="commit a plan into the fleet spec journal")
    lap.add_argument("plan_file")
    lap.add_argument("--base-url", required=True, help="the router's base URL")
    lap.set_defaults(run=layout)

    ca = commands.add_parser(
        "cache", help="the kernel-library store (built CUDA libraries beside the models)",
        epilog="Not offered on 'warm': --rows (a library does not depend on a request's "
               "rows; 'warm' needs no card).")
    cache_commands = ca.add_subparsers(dest="cache_command", required=True)
    cl = cache_commands.add_parser("list", help="entries as JSON: key, size, verified, and "
                                                "current (this process's backend)")
    cl.add_argument("--store", required=True,
                    help="store root (e.g. <models-dir>/.compile-cache/torch-cuda)")
    cl.set_defaults(run=cache_list)
    cw = cache_commands.add_parser("warm", help="put the libraries a models tree's serving "
                                                "launches into the store, off the serving path")
    cw.add_argument("--models-dir", required=True,
                    help="directory whose immediate subdirectories are model dirs (the tree "
                         "run-server --models-dir serves)")
    cw.add_argument("--store", default=None,
                    help="store root (default: <models-dir>/.compile-cache/torch-cuda, "
                         "run-server's default)")
    cw.add_argument("--shard-fleet", action="store_true",
                    help="accepted for the reference's command line; a no-op (a kernel "
                         "library does not depend on the engine variant, so a run-server "
                         "--shard-fleet boot finds the same libraries either way)")
    cw.set_defaults(run=cache_warm)
    cg = cache_commands.add_parser("purge", help="delete entries and sweep crash debris")
    cg.add_argument("--store", required=True, help="store root")
    cg.add_argument("--stale", dest="stale_only", action="store_true",
                    help="remove only entries of another backend (torch, CUDA, machine, "
                         "architecture or debug flag) or that fail verification; without it "
                         "the whole store is cleared")
    cg.set_defaults(run=cache_purge)

    wf = commands.add_parser("workflow", help="fleet-workflow manifest generation")
    workflow_commands = wf.add_subparsers(dest="workflow_command", required=True)
    wg = workflow_commands.add_parser(
        "generate", help="fleet config -> an Argo Workflow, or with --tpu the one-Job fleet "
                         "spec (its limits request nvidia.com/gpu)")
    wg.add_argument("--machine-config", required=True,
                    help="the fleet config: a JSON/YAML file, or the mapping inline")
    wg.add_argument("--output-file", default=None)
    wg.add_argument("--image", default="gordo-components-tpu:latest",
                    help="container image (default gordo-components-tpu:latest)")
    wg.add_argument("--parallelism", type=int, default=10,
                    help="Argo builder pods at once (default 10)")
    wg.add_argument("--tpu", dest="tpu_mode", action="store_true",
                    help="emit the single-Job fleet spec instead of pod-per-machine Argo")
    wg.add_argument("--tpu-chips", type=int, default=16,
                    help="cards the fleet-build pod requests (default 16)")
    wg.add_argument("--tpu-hosts", type=int, default=1,
                    help="(with --tpu) >1 emits the multi-host layout: an Indexed Job (one "
                         "pod per host) + a headless coordinator Service wiring "
                         "fleet-build's rank flags (default 1)")
    wg.add_argument("--slice-timeout-s", type=_int_at_least(0), default=1800,
                    help="(with --tpu --tpu-hosts>1) GORDO_SLICE_TIMEOUT_S on the build pods: "
                         "the slice watchdog's budget, after which a wedged collective exits "
                         "the retryable 75; 0 disables the watchdog (default 1800)")
    wg.add_argument("--active-deadline-s", type=_int_at_least(1), default=86400,
                    help="(with --tpu) the Job's activeDeadlineSeconds: the wall-clock bound "
                         "on the build and on retryable (exit 75) crash loops (default 86400)")
    wg.set_defaults(run=workflow_generate)

    c = commands.add_parser("client", help="bulk prediction against running servers")
    client_commands = c.add_subparsers(dest="client_command", required=True)
    cp = client_commands.add_parser("predict", help="score [START, END) for every machine and "
                                                    "print row counts")
    cp.add_argument("start")
    cp.add_argument("end")
    cp.add_argument("--base-url", required=True, help="the model server's base URL")
    cp.add_argument("--project", default="project")
    cp.add_argument("--machine", dest="machines", action="append", default=[],
                    help="a machine to score; repeat for several (default: the server's "
                         "/models)")
    cp.add_argument("--max-interval", default="1D",
                    help="the longest chunk of one request, e.g. 1D, 12h, 30min (default 1D)")
    cp.add_argument("--parallelism", type=int, default=10)
    cp.add_argument("--output-dir", default=None, help="write one score CSV per machine here")
    cp.set_defaults(run=client_predict)

    li = commands.add_parser(
        "lint", add_help=False,
        help="the port's invariant linter (lock discipline, guarded state, span seams, "
             "wire contracts, fault-seam coverage, exception hygiene, metric conventions, "
             "knob registry); every argument goes to python -m "
             "gordo_components_tpu_torch.analysis (--help lists them)")
    li.add_argument("lint_args", nargs=argparse.REMAINDER)
    li.set_defaults(run=lint)
    return root


def lint(args) -> int:
    """``lint``: run the port's analyzer (stdlib only) with the arguments
    as given; its exit status: 0 clean, 1 findings, 2 a bad command line."""
    from ..analysis.runner import main as lint_main

    return lint_main(list(args.lint_args))


def main(argv: Optional[List[str]] = None) -> int:
    from ..observability.logsetup import configure_logging

    root = parser()
    # ``lint`` hands its options to the analyzer's own parser, including
    # those argparse would otherwise claim (``--help``, ``--format``)
    args, extra = root.parse_known_args(argv)
    if args.command == "lint":
        args.lint_args = extra + list(args.lint_args)
    elif extra:
        root.error("unrecognized arguments: " + " ".join(extra))
    if args.debug_nans is None:
        try:
            args.debug_nans = bool(parse_flag(os.environ.get("GORDO_DEBUG_NANS")))
        except ValueError as exc:
            root.error(f"GORDO_DEBUG_NANS: {exc}")
    configure_logging(args.log_level, args.log_format)
    set_debug_nans(args.debug_nans)
    if args.debug_nans:
        logger.warning("debug nans enabled: training and scoring check every op's output "
                       "for NaN and will be much slower")
    return args.run(args)


if __name__ == "__main__":
    sys.exit(main())
