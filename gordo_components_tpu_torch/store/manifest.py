"""Checksummed artifact manifests (the port's own copy of the check in
``gordo_components_tpu/store/manifest.py:56-197``).

``MANIFEST.json`` records, per artifact file, its SHA-256 and byte size
plus a format version. Loading verifies every listed file — present, same
size, same hash — before anything is deserialized; a torn or tampered
artifact raises, never half-loads. The rendering (sorted keys, 2-space
indent, trailing newline) is the reference's, so manifests written by
either package are byte-identical for the same files.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict

MANIFEST_FILE = "MANIFEST.json"
FORMAT_VERSION = 1
CURRENT_FILE = "CURRENT"
_HASH_CHUNK = 1 << 20


class StoreError(Exception):
    """An artifact on disk is not whole."""


class ManifestMissing(StoreError):
    pass


class ArtifactIncomplete(StoreError):
    pass


class ArtifactCorrupt(StoreError):
    pass


def file_sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(_HASH_CHUNK), b""):
            digest.update(chunk)
    return digest.hexdigest()


def manifest_for_dir(artifact_dir: str) -> Dict[str, Any]:
    files: Dict[str, Any] = {}
    for entry in sorted(os.scandir(artifact_dir), key=lambda e: e.name):
        if not entry.is_file() or entry.name == MANIFEST_FILE:
            continue
        files[entry.name] = {
            "sha256": file_sha256(entry.path),
            "size": entry.stat().st_size,
        }
    return {"format_version": FORMAT_VERSION, "files": files}


def write_manifest(artifact_dir: str) -> Dict[str, Any]:
    payload = manifest_for_dir(artifact_dir)
    with open(os.path.join(artifact_dir, MANIFEST_FILE), "wb") as fh:
        fh.write((json.dumps(payload, indent=2, sort_keys=True) + "\n").encode())
        fh.flush()
        os.fsync(fh.fileno())
    return payload


def verify_artifact(artifact_dir: str) -> Dict[str, Any]:
    """Manifest present and well-formed; every listed file present with
    matching size and SHA-256. Returns the manifest."""
    path = os.path.join(artifact_dir, MANIFEST_FILE)
    if not os.path.isfile(path):
        raise ManifestMissing(f"{artifact_dir}: no {MANIFEST_FILE}")
    try:
        with open(path) as fh:
            payload = json.load(fh)
    except (OSError, ValueError) as exc:
        raise ArtifactCorrupt(f"{artifact_dir}: unreadable {MANIFEST_FILE}: {exc}") from exc
    files = payload.get("files") if isinstance(payload, dict) else None
    if not isinstance(files, dict):
        raise ArtifactCorrupt(f"{artifact_dir}: {MANIFEST_FILE} has no 'files' mapping")
    if payload.get("format_version") != FORMAT_VERSION:
        raise ArtifactCorrupt(
            f"{artifact_dir}: unsupported manifest format_version "
            f"{payload.get('format_version')!r} (this build reads {FORMAT_VERSION})"
        )
    for name, entry in sorted(files.items()):
        file_path = os.path.join(artifact_dir, name)
        if not os.path.isfile(file_path):
            raise ArtifactIncomplete(
                f"{artifact_dir}: manifest names {name!r} but the file is missing"
            )
        size = os.path.getsize(file_path)
        if size != entry.get("size"):
            raise ArtifactCorrupt(
                f"{artifact_dir}: {name!r} is {size} bytes, manifest says "
                f"{entry.get('size')}"
            )
        digest = file_sha256(file_path)
        if digest != entry.get("sha256"):
            raise ArtifactCorrupt(f"{artifact_dir}: {name!r} SHA-256 mismatch")
    return payload


def resolve_artifact_dir(path: str) -> str:
    """Follow a generation root's ``CURRENT`` pointer (``gen-NNNN``); a
    flat artifact dir passes through."""
    pointer = os.path.join(path, CURRENT_FILE)
    if not os.path.isfile(pointer):
        return path
    with open(pointer) as fh:
        gen = fh.read().strip()
    target = os.path.join(path, gen)
    if not gen or os.sep in gen or not os.path.isdir(target):
        raise ArtifactIncomplete(f"{path}: {CURRENT_FILE} points at {gen!r}, which does not exist")
    return target
