"""Checksummed artifact manifests (the port's copy of
``gordo_components_tpu/store/manifest.py:35-197``).

``MANIFEST.json`` records, per artifact file, its SHA-256 and byte size
plus a format version. Loading verifies every listed file (present, same
size, same hash) before anything is deserialized; a torn or tampered
artifact raises, never half-loads. The rendering (sorted keys, 2-space
indent, trailing newline) is the reference's, so manifests written by
either package are byte-identical for the same files.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional

from ..observability.registry import REGISTRY
from .errors import ArtifactCorrupt, ArtifactIncomplete, ManifestMissing, StoreError

MANIFEST_FILE = "MANIFEST.json"
FORMAT_VERSION = 1
_HASH_CHUNK = 1 << 20

_M_VERIFY_FAILURES = REGISTRY.counter(
    "gordo_store_verify_failures_total",
    "Artifact manifest verifications that failed, by typed error",
    labels=("error",),
)


def fsync_enabled() -> bool:
    """``GORDO_STORE_FSYNC=0`` turns the commit path's fsyncs off (bulk
    synthetic fleets); atomicity is kept."""
    return os.environ.get("GORDO_STORE_FSYNC", "1").strip().lower() not in (
        "0", "false", "off", "no")


def file_sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(_HASH_CHUNK), b""):
            digest.update(chunk)
    return digest.hexdigest()


def manifest_for_dir(artifact_dir: str) -> Dict[str, Any]:
    """The manifest payload (not written) of every regular file in
    ``artifact_dir`` but the manifest itself; the format is flat."""
    files: Dict[str, Any] = {}
    for entry in sorted(os.scandir(artifact_dir), key=lambda e: e.name):
        if not entry.is_file() or entry.name == MANIFEST_FILE:
            continue
        files[entry.name] = {
            "sha256": file_sha256(entry.path),
            "size": entry.stat().st_size,
        }
    return {"format_version": FORMAT_VERSION, "files": files}


def render_manifest(payload: Dict[str, Any]) -> bytes:
    """The one rendering: sorted keys, 2-space indent, trailing newline."""
    return (json.dumps(payload, indent=2, sort_keys=True) + "\n").encode()


def write_manifest(
    artifact_dir: str,
    fsync: bool = True,
    payload: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Hash the directory's files and write ``MANIFEST.json`` beside them.
    A precomputed ``payload`` is checked structurally (same names, same
    sizes) against the directory first; a mismatch raises
    :class:`ArtifactIncomplete` rather than publish a manifest that lies."""
    if payload is None:
        payload = manifest_for_dir(artifact_dir)
    else:
        staged = {
            entry.name: entry.stat().st_size
            for entry in os.scandir(artifact_dir)
            if entry.is_file() and entry.name != MANIFEST_FILE
        }
        declared = {name: entry.get("size") for name, entry in payload.get("files", {}).items()}
        if staged != declared:
            raise ArtifactIncomplete(
                f"{artifact_dir}: precomputed manifest disagrees with the staged files "
                f"(staged {sorted(staged)} sizes vs declared {sorted(declared)})"
            )
    with open(os.path.join(artifact_dir, MANIFEST_FILE), "wb") as fh:
        fh.write(render_manifest(payload))
        if fsync and fsync_enabled():
            fh.flush()
            os.fsync(fh.fileno())
    return payload


def _fail(error: type, message: str) -> StoreError:
    _M_VERIFY_FAILURES.labels(error.__name__).inc()
    return error(message)


def read_manifest(artifact_dir: str) -> Dict[str, Any]:
    """Load and structurally validate the manifest; raises typed errors."""
    path = os.path.join(artifact_dir, MANIFEST_FILE)
    if not os.path.isfile(path):
        raise _fail(ManifestMissing, f"{artifact_dir}: no {MANIFEST_FILE}")
    try:
        with open(path) as fh:
            payload = json.load(fh)
    except (OSError, ValueError) as exc:
        raise _fail(ArtifactCorrupt, f"{artifact_dir}: unreadable {MANIFEST_FILE}: {exc}") from exc
    files = payload.get("files") if isinstance(payload, dict) else None
    if not isinstance(files, dict):
        raise _fail(ArtifactCorrupt, f"{artifact_dir}: {MANIFEST_FILE} has no 'files' mapping")
    version = payload.get("format_version")
    if version != FORMAT_VERSION:
        raise _fail(ArtifactCorrupt, f"{artifact_dir}: unsupported manifest format_version "
                                     f"{version!r} (this build reads {FORMAT_VERSION})")
    return payload


def verify_artifact(artifact_dir: str, deep: bool = True) -> Dict[str, Any]:
    """Manifest present and well-formed; every listed file present with
    matching size and, with ``deep``, SHA-256. Returns the manifest.
    ``deep=False`` is the structural check of a build's cache hit: O(stats)
    rather than O(bytes); anything that deserializes keeps the hash pass."""
    payload = read_manifest(artifact_dir)
    for name, entry in sorted(payload["files"].items()):
        file_path = os.path.join(artifact_dir, name)
        if not os.path.isfile(file_path):
            raise _fail(ArtifactIncomplete,
                        f"{artifact_dir}: manifest names {name!r} but the file is missing")
        size = os.path.getsize(file_path)
        if size != entry.get("size"):
            raise _fail(ArtifactCorrupt, f"{artifact_dir}: {name!r} is {size} bytes, manifest "
                                         f"says {entry.get('size')}")
        if not deep:
            continue
        digest = file_sha256(file_path)
        if digest != entry.get("sha256"):
            raise _fail(ArtifactCorrupt, f"{artifact_dir}: {name!r} SHA-256 mismatch "
                                         f"({digest[:12]}… != manifest "
                                         f"{str(entry.get('sha256'))[:12]}…)")
    return payload
