"""The scoring response's JSON body (the port's copy of
``encode_scored_json`` and ``format_float_array`` in
``gordo_components_tpu/wire.py:131-187``).

Byte-compatible with the reference: array blocks are rendered row at a
time with ``%.17g`` (which round-trips float64, and so every float32
score) and spliced into the ``{"data": {...}, <extras>}`` template;
non-finite values fall back to the generic encoder.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

SCORE_FIELDS = (
    "model-input",
    "model-output",
    "tag-anomaly-scores",
    "total-anomaly-score",
)


def format_float_array(arr: np.ndarray) -> str:
    arr = np.asarray(arr)
    if not np.isfinite(arr).all():
        return json.dumps(arr.tolist())
    if arr.ndim == 1:
        if arr.size == 0:
            return "[]"
        fmt = ",".join(["%.17g"] * arr.shape[0])
        return "[" + fmt % tuple(arr.tolist()) + "]"
    if arr.ndim != 2:
        return json.dumps(arr.tolist())
    if arr.shape[0] == 0:
        return "[]"
    fmt = ",".join(["%.17g"] * arr.shape[1])
    rows = (fmt % tuple(row) for row in arr.tolist())
    return "[[" + "],[".join(rows) + "]]"


def encode_scored_json(
    arrays: Dict[str, np.ndarray],
    timestamps: Optional[List[str]] = None,
    extras: Optional[Dict[str, Any]] = None,
) -> str:
    parts = ['{"data":{']
    for i, (name, arr) in enumerate(arrays.items()):
        if i:
            parts.append(",")
        parts.append(json.dumps(name))
        parts.append(":")
        parts.append(format_float_array(arr))
    if timestamps is not None:
        parts.append(',"timestamps":')
        parts.append(json.dumps(timestamps, default=str))
    parts.append("}")
    for key, value in (extras or {}).items():
        parts.append(",")
        parts.append(json.dumps(key))
        parts.append(":")
        parts.append(json.dumps(value, default=str))
    parts.append("}")
    return "".join(parts)
