"""Typed artifact-integrity errors (the port's copy of
``gordo_components_tpu/store/errors.py:1-35``).

Every integrity violation an artifact can show maps to exactly one of
these, so callers (the server's load path, ``/reload``, a build's cache
hit, ``rollback``) route on the type instead of parsing prose. All inherit
:class:`StoreError`, which inherits ``RuntimeError``, deliberately NOT
``ValueError``: the server maps ``ValueError`` to a client 400 and the CLI
to a config error (64), and a corrupt artifact is neither.
"""

from __future__ import annotations


class StoreError(RuntimeError):
    """Base for every artifact-store integrity failure."""


class ManifestMissing(StoreError):
    """The artifact directory has no ``MANIFEST.json`` — either it predates
    the store (never atomically committed) or the commit never finished."""


class ArtifactIncomplete(StoreError):
    """A file the manifest promises is absent, or a generation root's
    ``CURRENT`` pointer names a generation that does not exist — the
    artifact is structurally torn."""


class ArtifactCorrupt(StoreError):
    """Bytes on disk disagree with the manifest (size or SHA-256 mismatch,
    unparseable manifest, unsupported format version) — the artifact must
    not be deserialized."""
