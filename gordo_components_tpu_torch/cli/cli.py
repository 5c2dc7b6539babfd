"""``python -m gordo_components_tpu_torch.cli``: the ``build``,
``fleet-build`` and ``rollback`` commands of the reference's CLI
(``gordo_components_tpu/cli/cli.py:164-401, 404-430``), on ``argparse``.

The arguments, environment variables (``MODEL_CONFIG``, ``DATA_CONFIG``,
``OUTPUT_DIR``, ``MODEL_REGISTER_DIR``, ``METADATA``, ``GORDO_TRACE_DIR``,
``GORDO_LOG_LEVEL``) and exit codes are the reference's: 0 ok, 64 a bad
config (permanent), 66 data unavailable or short (retryable), 70 a
deterministic device failure (an out-of-memory on the card), 75 another
device failure (retryable), 1 anything else. Configs are JSON, or YAML
read through ``yaml`` (imported only there). ``--device`` picks the card
(default) or the CPU; there is no silent fallback.

    python -m gordo_components_tpu_torch.cli build NAME --model-config M \\
        --data-config D --output-dir OUT [--model-register-dir REG] \\
        [--cv-mode build_only] [--precision int8] [--device cpu]
    python -m gordo_components_tpu_torch.cli fleet-build --machine-config FLEET \\
        --output-dir OUT [--model-register-dir REG] [--n-splits 3] [--seed 0] \\
        [--slice-size 256] [--precision int8] [--precision-map a=f32,b=int8] \\
        [--device cpu]
    python -m gordo_components_tpu_torch.cli rollback [--list] MODEL_DIR
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Any, List, Optional

from ..precision import PRECISIONS

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
    its own generation; prints ``{name: model_dir}`` as JSON."""
    import torch

    from ..dataset.dataset import InsufficientDataError
    from ..parallel import FleetMachineConfig, build_fleet
    from ..precision import parse_precision_map
    from ..workflow import NormalizedConfig

    # a device runtime failure other than an out-of-memory (torch >= 2.8)
    device_errors = tuple(e for e in (getattr(torch, "AcceleratorError", None),) if e)
    try:
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
    except device_errors as exc:
        logger.error("Device failure in fleet build: %s — exiting retryable code %d; a "
                     "restarted run resumes from the registry and the journal",
                     exc, EXIT_RETRYABLE)
        return EXIT_RETRYABLE
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


def parser() -> argparse.ArgumentParser:
    env = os.environ.get
    root = argparse.ArgumentParser(
        prog="python -m gordo_components_tpu_torch.cli",
        description="gordo-components-tpu on PyTorch: build fleets and machines, and roll "
                    "them back.")
    root.add_argument("--log-level", default=env("GORDO_LOG_LEVEL", "INFO"))
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
    b.add_argument("--device", default=None,
                   help="cuda (default) or cpu; there is no silent fallback")
    b.set_defaults(run=build)

    f = commands.add_parser(
        "fleet-build", help="build a whole fleet: machines bucketed and trained as stacked "
                            "programs on the card",
        epilog="Not offered yet: --coordinator-address, --num-processes, --process-id and "
               "--n-devices (multi-process ranks over torch.distributed, ROADMAP Queue 1 "
               "item 3) and --serving-cache (the serving compile cache, ROADMAP Queue 1 "
               "item 7).")
    f.add_argument("--machine-config", required=True,
                   help="fleet YAML/JSON (machines + globals): a file path or a string")
    f.add_argument("--output-dir", default=env("OUTPUT_DIR"), required=not env("OUTPUT_DIR"))
    f.add_argument("--model-register-dir", default=env("MODEL_REGISTER_DIR"))
    f.add_argument("--n-splits", type=int, default=3,
                   help="CV folds for machines that set no evaluation.n_splits of their own "
                        "(default 3)")
    f.add_argument("--seed", type=int, default=0)
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
    f.add_argument("--device", default=None,
                   help="cuda (default) or cpu; there is no silent fallback")
    f.set_defaults(run=fleet_build)

    r = commands.add_parser("rollback", help="swap a model dir's CURRENT back to its previous "
                                             "verified generation")
    r.add_argument("model_dir")
    r.add_argument("--list", dest="list_only", action="store_true",
                   help="print the generation status as JSON without changing anything")
    r.set_defaults(run=rollback)
    return root


def main(argv: Optional[List[str]] = None) -> int:
    args = parser().parse_args(argv)
    logging.basicConfig(level=args.log_level.upper(),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    return args.run(args)


if __name__ == "__main__":
    sys.exit(main())
