"""The numeric sanitizer's process-wide switch, stdlib only.

The counterpart of the reference's ``jax.config.update("jax_debug_nans",
...)`` (``gordo --debug-nans``). It lives apart from the sanitizer itself
(``utils/backend.py``, which needs torch) so that a process that never
imports torch, a fleet tier's router, can read and set it. A process
starts with ``GORDO_DEBUG_NANS``: a child started with it in its
environment (a router's workers, a build's ranks) has the sanitizer on
from its start, while ``--debug-nans`` covers its own process only, as
the reference's flag does.
"""

from __future__ import annotations

import os
from typing import Optional

_TRUE = ("1", "true", "t", "yes", "y", "on")
_FALSE = ("0", "false", "f", "no", "n", "off")


def parse_flag(raw: Optional[str]) -> Optional[bool]:
    """A boolean option's environment value as click reads one: ``1``,
    ``true``, ``yes``, ``on`` (and ``t``, ``y``) are true, their opposites
    false, unset or blank is None; anything else raises ``ValueError``."""
    if raw is None or not raw.strip():
        return None
    value = raw.strip().lower()
    if value in _TRUE:
        return True
    if value in _FALSE:
        return False
    raise ValueError(f"{raw!r} is not a valid boolean")


def _from_env() -> bool:
    try:
        return bool(parse_flag(os.environ.get("GORDO_DEBUG_NANS")))
    except ValueError:
        return False  # the CLI names a bad value; a library's start stays off


_debug_nans = _from_env()


def set_debug_nans(on: bool) -> None:
    """Turn the numeric sanitizer on or off for the whole process."""
    global _debug_nans
    _debug_nans = bool(on)


def debug_nans_enabled() -> bool:
    return _debug_nans
