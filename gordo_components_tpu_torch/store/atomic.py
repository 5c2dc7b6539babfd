"""Atomic directory commits: an artifact exists whole or not at all (the
port's copy of ``gordo_components_tpu/store/atomic.py:1-235``).

The commit sequence:

1. the writer fills a hidden ``.staging-*`` sibling of the destination,
2. every staged file is fsync'd,
3. ``MANIFEST.json`` (per-file SHA-256 + size) is written and fsync'd,
4. the staging dir itself is fsync'd,
5. a rename swaps it into place and the PARENT dir is fsync'd (the rename
   itself must be durable, or a power cut undoes a finished build).

A crash before step 5 leaves the destination untouched; a leftover
``.staging-*`` dir is inert debris for :func:`sweep_leftovers`. The
``name=`` parameter of :func:`atomic_commit` names the commit for the
``store-commit`` fault seam (:mod:`..resilience.faults`): an ``error`` fault
fires before the manifest exists, ``truncate``/``bitflip`` damage a staged
file after its hash was recorded.
"""

from __future__ import annotations

import logging
import os
import shutil
import uuid
from contextlib import contextmanager
from typing import Iterator, Optional

from ..observability.registry import REGISTRY
from ..resilience import faults
from .manifest import fsync_enabled, write_manifest

logger = logging.getLogger(__name__)

STAGING_PREFIX = ".staging-"
_TRASH_PREFIX = ".trash-"

_M_COMMITS = REGISTRY.counter(
    "gordo_store_commits_total",
    "Atomic artifact commits, by outcome (committed / aborted)",
    labels=("outcome",),
)


def fsync_file(path: str) -> None:
    if not fsync_enabled():
        return
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """fsync a directory so renames and creates inside it survive a power
    cut; best effort where the filesystem refuses directory fds."""
    if not fsync_enabled():
        return
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_file(path: str, data: str) -> None:
    """Durable atomic single-file write: a per-writer sidecar, fsync,
    ``os.replace``, fsync of the directory. Concurrent writers to one path
    (a rollback racing a commit on ``CURRENT``) never clobber each other's
    sidecar; the last replace wins whole."""
    tmp = f"{path}.{uuid.uuid4().hex[:8]}.tmp"
    with open(tmp, "w") as fh:
        fh.write(data)
        fh.flush()
        if fsync_enabled():
            os.fsync(fh.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


@contextmanager
def atomic_commit(
    dest_dir: str, name: Optional[str] = None, manifest: Optional[dict] = None
) -> Iterator[str]:
    """Yield a hidden staging dir; on a clean exit, manifest + fsync +
    rename it into ``dest_dir`` (replacing any existing dir). On an
    exception the destination is untouched and the staging dir removed,
    except for an injected :class:`~..resilience.faults.FaultInjected`,
    which stands for a kill and leaves the staging dir as a crash would.

    ``name`` names the commit: the ``store-commit`` fault seam's target
    (defaults to the destination's basename). ``manifest``: a precomputed
    payload, checked structurally against the staged files before it is
    written (see :func:`~.manifest.write_manifest`)."""
    dest_dir = os.path.abspath(dest_dir)
    parent = os.path.dirname(dest_dir)
    os.makedirs(parent, exist_ok=True)
    target = name if name is not None else os.path.basename(dest_dir)
    staging = os.path.join(
        parent, f"{STAGING_PREFIX}{os.path.basename(dest_dir)}.{uuid.uuid4().hex[:8]}")
    os.makedirs(staging)
    try:
        yield staging
        # a kill between "files written" and "commit": no manifest yet
        faults.inject("store-commit", target)
        for entry in os.scandir(staging):
            if entry.is_file():
                fsync_file(entry.path)
        write_manifest(staging, fsync=True, payload=manifest)
        # damage a staged file after its hash was recorded: provably torn
        faults.damage_artifact("store-commit", target, staging)
        fsync_dir(staging)
        commit_dir(staging, dest_dir)
        _M_COMMITS.labels("committed").inc()
    except faults.FaultInjected:
        _M_COMMITS.labels("aborted").inc()
        raise  # a simulated kill: the staging dir stays, as after a crash
    except BaseException:
        _M_COMMITS.labels("aborted").inc()
        logger.debug("Commit %s aborted", target)
        shutil.rmtree(staging, ignore_errors=True)
        raise


def commit_dir(staged_dir: str, dest_dir: str) -> None:
    """Atomically publish ``staged_dir`` as ``dest_dir``. An existing
    destination is renamed aside first (a rename onto a non-empty dir fails
    on POSIX) and deleted only after the swap is durable."""
    parent = os.path.dirname(os.path.abspath(dest_dir))
    trash: Optional[str] = None
    if os.path.isdir(dest_dir):
        trash = os.path.join(
            parent, f"{_TRASH_PREFIX}{os.path.basename(dest_dir)}.{uuid.uuid4().hex[:8]}")
        os.rename(dest_dir, trash)
    try:
        os.rename(staged_dir, dest_dir)
    except BaseException:
        if trash is not None:  # roll the old artifact back into place
            os.rename(trash, dest_dir)
        raise
    fsync_dir(parent)
    if trash is not None:
        shutil.rmtree(trash, ignore_errors=True)


def sweep_leftovers(directory: str) -> list:
    """Remove orphaned ``.staging-*`` / ``.trash-*`` dirs from
    ``directory``; returns the swept names. A ``.trash-<name>.<id>`` dir
    whose ``<name>`` sibling is missing holds the only copy of an artifact
    (a crash between :func:`commit_dir`'s two renames): it is restored,
    not deleted."""
    swept = []
    try:
        entries = list(os.scandir(directory))
    except OSError:
        return swept
    for entry in entries:
        if not entry.is_dir():
            continue
        if entry.name.startswith(_TRASH_PREFIX):
            original = entry.name[len(_TRASH_PREFIX):].rsplit(".", 1)[0]
            dest = os.path.join(directory, original)
            if original and not os.path.exists(dest):
                try:
                    os.rename(entry.path, dest)
                    fsync_dir(directory)
                    swept.append(f"{entry.name} (restored as {original})")
                    logger.warning("Restored %s from crash-window trash %s", dest, entry.name)
                except OSError:
                    if os.path.exists(dest):  # the replacement landed meanwhile
                        shutil.rmtree(entry.path, ignore_errors=True)
                        swept.append(entry.name)
                    else:  # may be the only copy: keep it and say so
                        logger.error("Could not restore %s and %s is absent; keeping the "
                                     "trash dir", entry.path, dest)
                continue
        elif not entry.name.startswith(STAGING_PREFIX):
            continue
        shutil.rmtree(entry.path, ignore_errors=True)
        swept.append(entry.name)
        logger.info("Swept leftover store dir %s", entry.path)
    return swept
