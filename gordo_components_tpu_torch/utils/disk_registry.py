"""File-per-key registry mapping config hashes to built-model dirs (the
port's copy of ``gordo_components_tpu/utils/disk_registry.py:1-65``).

``write_key`` / ``get_value`` / ``delete_key``, one ``<key>.md5`` file per
key under a registry dir: what makes a build idempotent, as a retry finds
the key and skips the rebuild.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Optional

from ..store.atomic import atomic_write_file

logger = logging.getLogger(__name__)

_KEY_RE = re.compile(r"^[A-Za-z0-9._-]+$")


def _key_path(registry_dir: str, key: str) -> str:
    if not _KEY_RE.match(key):
        raise ValueError(f"Registry key {key!r} must match {_KEY_RE.pattern} "
                         "(it is used as a filename)")
    return os.path.join(registry_dir, f"{key}.md5")


def write_key(registry_dir: str, key: str, value: str) -> None:
    """Atomic and durable: an entry lost in a power cut would make a
    finished build pending again."""
    os.makedirs(registry_dir, exist_ok=True)
    atomic_write_file(_key_path(registry_dir, key), value)
    logger.debug("Registry write %s -> %s", key, value)


def get_value(registry_dir: str, key: str) -> Optional[str]:
    """The registered model dir for ``key``, or ``None``, also when the
    entry points at a directory that no longer exists (a retry must
    rebuild rather than trust a dangling pointer)."""
    path = _key_path(registry_dir, key)
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        value = fh.read()
    if not os.path.isdir(value):
        logger.warning("Registry key %s points at missing model dir %r; treating as "
                       "unregistered", key, value)
        return None
    return value


def delete_key(registry_dir: str, key: str) -> bool:
    path = _key_path(registry_dir, key)
    if os.path.exists(path):
        os.remove(path)
        return True
    return False
