"""Generation roots, the read side (the port's copy of
``current_generation`` in ``gordo_components_tpu/store/generations.py``).

A generation root holds ``gen-NNNN/`` artifact directories and a
``CURRENT`` file naming the one that serves; ``store/manifest.py``'s
``resolve_artifact_dir`` follows it. Committing generations waits for the
port's fleet build.
"""

from __future__ import annotations

import os
import re
from typing import Optional

from .manifest import CURRENT_FILE, ArtifactIncomplete

_GEN_RE = re.compile(r"^gen-(\d{4,})$")


def current_generation(root: str) -> Optional[str]:
    """The generation ``CURRENT`` names, or ``None`` for a flat artifact.
    A pointer that is not a generation name raises
    :class:`ArtifactIncomplete`: such a root is torn, not flat."""
    path = os.path.join(root, CURRENT_FILE)
    if not os.path.isfile(path):
        return None
    with open(path) as fh:
        name = fh.read().strip()
    if not _GEN_RE.match(name):
        raise ArtifactIncomplete(f"{root}: {CURRENT_FILE} contains {name!r}, not a generation name")
    return name
