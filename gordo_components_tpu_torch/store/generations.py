"""Generation roots: every build lands beside its predecessors (the port's
copy of ``gordo_components_tpu/store/generations.py:1-348``).

A generation root is a machine's model directory once it holds::

    <machine>/
      gen-0001/            # a whole, manifested artifact (atomic_commit)
      gen-0002/
      CURRENT              # one line: the generation that serves

``CURRENT`` is swapped atomically (sidecar, fsync, ``os.replace``, fsync
of the directory), so a reader sees the old pointer or the new one. A
rollback points ``CURRENT`` at the newest PREVIOUS generation that
verifies; the bytes of a generation are never changed. A flat artifact
(``definition.json`` directly in the directory) resolves through
unchanged.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Any, Callable, Dict, List, Optional

from ..observability.registry import REGISTRY
from .atomic import atomic_commit, atomic_write_file
from .errors import ArtifactIncomplete, StoreError
from .manifest import verify_artifact

logger = logging.getLogger(__name__)

GEN_PREFIX = "gen-"
CURRENT_FILE = "CURRENT"
KEEP_GENERATIONS_ENV = "GORDO_STORE_KEEP_GENERATIONS"
# the fleet index at a MODELS ROOT: every machine dir and its current
# generation, advisory (each artifact is still verified when touched)
FLEET_INDEX_FILE = "FLEET_INDEX.json"
FLEET_INDEX_VERSION = 1
_GEN_RE = re.compile(r"^gen-(\d{4,})$")

_M_ROLLBACKS = REGISTRY.counter(
    "gordo_store_rollbacks_total",
    "Generation rollbacks performed, by outcome (ok / failed)",
    labels=("outcome",),
)


def is_generation_root(path: str) -> bool:
    return os.path.isfile(os.path.join(path, CURRENT_FILE))


def _gen_num(name: str) -> int:
    return int(_GEN_RE.match(name).group(1))


def list_generations(root: str) -> List[str]:
    """Generation dir names under ``root``, oldest first, in NUMERIC order
    (gen-10000 after gen-9999)."""
    try:
        entries = os.listdir(root)
    except OSError:
        return []
    return sorted(
        (name for name in entries
         if _GEN_RE.match(name) and os.path.isdir(os.path.join(root, name))),
        key=_gen_num,
    )


def current_generation(root: str) -> Optional[str]:
    """The generation ``CURRENT`` names, or ``None`` for a flat or absent
    root. A pointer that is not a generation name raises
    :class:`ArtifactIncomplete`: such a root is torn, not flat."""
    path = os.path.join(root, CURRENT_FILE)
    if not os.path.isfile(path):
        return None
    with open(path) as fh:
        name = fh.read().strip()
    if not _GEN_RE.match(name):
        raise ArtifactIncomplete(f"{root}: {CURRENT_FILE} contains {name!r}, not a generation name")
    return name


def resolve_artifact_dir(path: str) -> str:
    """The directory holding the artifact files: ``CURRENT``'s generation
    for a generation root, ``path`` itself for a flat one. Raises
    :class:`ArtifactIncomplete` when the pointer names a missing dir."""
    gen = current_generation(path)
    if gen is None:
        return path
    target = os.path.join(path, gen)
    if not os.path.isdir(target):
        raise ArtifactIncomplete(f"{path}: {CURRENT_FILE} points at {gen!r} which does not exist")
    return target


def _swap_current(root: str, gen_name: str) -> None:
    atomic_write_file(os.path.join(root, CURRENT_FILE), gen_name + "\n")


def pin_generation(root: str, gen_name: str) -> str:
    """Point ``CURRENT`` at a NAMED existing generation (forward or back).
    Raises :class:`ArtifactIncomplete` for a name that is not a generation
    or not on disk."""
    if not _GEN_RE.match(gen_name):
        raise ArtifactIncomplete(f"{root}: {gen_name!r} is not a generation name")
    if not os.path.isdir(os.path.join(root, gen_name)):
        raise ArtifactIncomplete(f"{root}: cannot pin {gen_name!r}: no such generation on disk")
    _swap_current(root, gen_name)
    return gen_name


def next_generation_name(root: str) -> str:
    gens = list_generations(root)
    if not gens:
        return f"{GEN_PREFIX}0001"
    return f"{GEN_PREFIX}{_gen_num(gens[-1]) + 1:04d}"


def commit_generation(
    root: str,
    write_fn: Callable[[str], Any],
    name: Optional[str] = None,
    keep: Optional[int] = None,
    manifest: Optional[Dict[str, Any]] = None,
) -> str:
    """Write a new generation under ``root`` and adopt it: ``write_fn``
    fills a staging dir, :func:`~.atomic.atomic_commit` manifests and
    publishes it as ``gen-NNNN``, then ``CURRENT`` swaps to it. Returns the
    new generation's path. ``keep`` bounds the generations kept (newest
    first; default ``GORDO_STORE_KEEP_GENERATIONS``, else 3; never fewer
    than 2, so one rollback target survives)."""
    if keep is None:
        keep = int(os.environ.get(KEEP_GENERATIONS_ENV, "3"))
    keep = max(2, keep)
    os.makedirs(root, exist_ok=True)
    gen_name = next_generation_name(root)
    gen_dir = os.path.join(root, gen_name)
    with atomic_commit(gen_dir, name=name, manifest=manifest) as staging:
        write_fn(staging)
    _swap_current(root, gen_name)
    _prune(root, keep)
    return gen_dir


def _prune(root: str, keep: int) -> None:
    gens = list_generations(root)
    current = current_generation(root)
    doomed = [g for g in gens[:-keep] if g != current] if len(gens) > keep else []
    for gen in doomed:
        shutil.rmtree(os.path.join(root, gen), ignore_errors=True)
        logger.info("Pruned old generation %s/%s", root, gen)


def rollback_generation(root: str) -> str:
    """Point ``CURRENT`` at the newest PREVIOUS generation that passes
    verification and return its path; unverifiable candidates are skipped.
    A malformed ``CURRENT`` makes every generation a candidate. Raises
    :class:`StoreError` when no predecessor verifies."""
    if not os.path.isfile(os.path.join(root, CURRENT_FILE)):
        _M_ROLLBACKS.labels("failed").inc()
        raise StoreError(f"{root} is not a generation root (no {CURRENT_FILE}); "
                         "flat artifacts have nothing to roll back to")
    try:
        current = current_generation(root)
    except ArtifactIncomplete:
        current = None
    previous = list_generations(root)
    if current is not None:
        previous = [g for g in previous if _gen_num(g) < _gen_num(current)]
    for gen in reversed(previous):
        candidate = os.path.join(root, gen)
        try:
            verify_artifact(candidate)
        except StoreError as exc:
            logger.warning("Rollback skipping unverifiable generation %s: %s", candidate, exc)
            continue
        _swap_current(root, gen)
        _M_ROLLBACKS.labels("ok").inc()
        logger.info("Rolled back %s: %s -> %s", root, current, gen)
        return candidate
    _M_ROLLBACKS.labels("failed").inc()
    raise StoreError(f"{root}: no previous generation verifies (current {current}, "
                     f"candidates {previous or 'none'})")


def write_fleet_index(models_root: str, machines: Dict[str, Dict[str, Any]]) -> str:
    """Atomically write ``FLEET_INDEX.json`` at ``models_root``:
    ``{name: {"path", "generation", "precision"}}``."""
    payload = {
        "format_version": FLEET_INDEX_VERSION,
        "count": len(machines),
        "machines": {
            name: {
                "path": entry.get("path", name),
                "generation": entry.get("generation"),
                "precision": entry.get("precision"),
            }
            for name, entry in sorted(machines.items())
        },
    }
    path = os.path.join(models_root, FLEET_INDEX_FILE)
    atomic_write_file(path, json.dumps(payload, indent=1, sort_keys=True))
    return path


def read_fleet_index(models_root: str) -> Optional[Dict[str, Dict[str, Any]]]:
    """The index's machine table, or ``None`` when it is absent,
    unreadable or of another version (the caller scans instead)."""
    path = os.path.join(models_root, FLEET_INDEX_FILE)
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as fh:
            payload = json.load(fh)
    except (OSError, ValueError) as exc:
        logger.warning("Unreadable %s (%s); falling back to scan", path, exc)
        return None
    if (not isinstance(payload, dict) or payload.get("format_version") != FLEET_INDEX_VERSION
            or not isinstance(payload.get("machines"), dict)):
        logger.warning("%s is not a version-%d fleet index; falling back to scan",
                       path, FLEET_INDEX_VERSION)
        return None
    return payload["machines"]


def is_artifact_dir(path: str) -> bool:
    """A generation root (``CURRENT``) or a flat artifact
    (``definition.json``): the one rule the server's scan and
    :func:`build_fleet_index` share."""
    return is_generation_root(path) or os.path.exists(os.path.join(path, "definition.json"))


def scan_models_dir(models_dir: str) -> Dict[str, str]:
    """``{name: path}`` for each immediate artifact subdirectory (flat or
    generation root) of ``models_dir``; hidden directories never count.
    The server's fleet and the router's fleet-wide rollback walk this."""
    return {
        entry: os.path.join(models_dir, entry)
        for entry in sorted(os.listdir(models_dir))
        if not entry.startswith(".")
        and os.path.isdir(os.path.join(models_dir, entry))
        and is_artifact_dir(os.path.join(models_dir, entry))
    }


def build_fleet_index(models_root: str) -> Dict[str, Dict[str, Any]]:
    """Every immediate, non-hidden artifact subdirectory of
    ``models_root`` with its current generation (``None`` for a flat one
    or a torn pointer)."""
    machines: Dict[str, Dict[str, Any]] = {}
    try:
        entries = sorted(os.listdir(models_root))
    except OSError:
        return machines
    for entry in entries:
        path = os.path.join(models_root, entry)
        if entry.startswith(".") or not os.path.isdir(path) or not is_artifact_dir(path):
            continue
        gen = None
        if is_generation_root(path):
            try:
                gen = current_generation(path)
            except ArtifactIncomplete:
                gen = None
        machines[entry] = {"path": entry, "generation": gen}
    return machines


def artifact_status(path: str) -> Dict[str, Any]:
    """``{"generation", "generations", "verified", "error"}`` of one model
    dir (flat or generational)."""
    status: Dict[str, Any] = {
        "generation": None,
        "generations": list_generations(path),
        "verified": False,
        "error": None,
    }
    try:
        status["generation"] = current_generation(path)
        verify_artifact(resolve_artifact_dir(path))
        status["verified"] = True
    except StoreError as exc:
        status["error"] = f"{type(exc).__name__}: {exc}"
    return status
