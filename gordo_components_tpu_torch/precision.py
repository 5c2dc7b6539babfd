"""The per-machine precision ladder: f32 / bf16 / int8 (the port's copy of
``gordo_components_tpu/precision.py:43-247``).

A machine's precision is chosen at build time and recorded in its build
metadata (``"precision"``); the server validates it on load and the
engine serves the machine at that rung:

- **f32**, the default;
- **bf16**: weights stored in bfloat16, the forward computed in the
  architecture's compute dtype, everything around it in float32;
- **int8**: weights quantized per tensor (symmetric, ``scale =
  max|w|/127``), kept as int8 on the device and dequantized into float32
  inside the scoring program on every dispatch. The quantized weights and
  their scales ride in the artifact as ``quant_int8.npz`` beside the
  untouched float32 ``state.npz``, hashed by the manifest like every other
  file, so serving an int8 machine loads its weights rather than
  recomputing them.

The parity budgets bound how far a downgraded rung's total anomaly scores
may drift from f32, normalized by the mean f32 total score (raw relative
error explodes where residuals cancel to ~0). ``GORDO_PARITY_RTOL_BF16``
and ``GORDO_PARITY_RTOL_INT8`` override them.

Trees here are nested dicts of numpy arrays: the flax parameter layout
that ``state.npz`` stores under ``…/params``.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

PRECISIONS = ("f32", "bf16", "int8")
DEFAULT_PRECISION = "f32"

#: the artifact file holding the int8 weights and per-tensor scales
QUANT_INT8_FILE = "quant_int8.npz"

# max |downgraded - f32| of total_anomaly_score over mean |f32| (see
# parity_error)
_DEFAULT_BUDGETS = {"f32": 0.0, "bf16": 0.02, "int8": 0.08}
_BUDGET_ENV = {
    "bf16": "GORDO_PARITY_RTOL_BF16",
    "int8": "GORDO_PARITY_RTOL_INT8",
}


def validate(value: Optional[str]) -> str:
    """Normalize a precision (None or "" → f32). Raises ``ValueError`` on
    anything outside the ladder: the server then refuses the machine
    rather than serving it at f32 silently."""
    if value in (None, ""):
        return DEFAULT_PRECISION
    normalized = str(value).strip().lower()
    if normalized not in PRECISIONS:
        raise ValueError(f"unknown precision {value!r} (expected one of {PRECISIONS})")
    return normalized


def resolve_default(explicit: Optional[str] = None) -> str:
    """The build-time precision: an explicit flag, else
    ``GORDO_PRECISION_DEFAULT``, else f32. A bad environment value fails
    here, at build time, rather than label a fleet of artifacts wrongly."""
    if explicit:
        return validate(explicit)
    return validate(os.environ.get("GORDO_PRECISION_DEFAULT"))


def of_metadata(metadata: Dict[str, Any]) -> str:
    """The validated precision an artifact's build metadata pins (absent →
    f32)."""
    return validate((metadata or {}).get("precision"))


def error_budget(precision: str) -> float:
    """The parity budget of a rung, overridable per rung by its env var."""
    precision = validate(precision)
    env = _BUDGET_ENV.get(precision)
    if env:
        raw = os.environ.get(env)
        if raw:
            try:
                return max(0.0, float(raw))
            except ValueError:
                logger.warning("%s=%r is not a float; using the default %s budget",
                               env, raw, precision)
    return _DEFAULT_BUDGETS[precision]


def parity_error(reference: np.ndarray, candidate: np.ndarray) -> float:
    """``max|candidate - reference| / mean|reference|`` over two
    total-anomaly-score arrays (a zero mean normalizes by 1)."""
    reference = np.asarray(reference, np.float64)
    candidate = np.asarray(candidate, np.float64)
    scale = float(np.mean(np.abs(reference)))
    if scale == 0.0:
        scale = 1.0
    return float(np.max(np.abs(candidate - reference))) / scale


# -- int8 quantization ---------------------------------------------------------
def quantize_array_int8(array: np.ndarray) -> Tuple[np.ndarray, np.float32]:
    """Symmetric per-tensor quantization: ``q = round(w / scale)`` with
    ``scale = max|w| / 127`` (1.0 for an all-zero or empty tensor).
    Deterministic numpy, so a build-time sidecar and an on-the-fly
    quantization of the same weights are the same bytes."""
    array = np.asarray(array, np.float32)
    peak = float(np.max(np.abs(array))) if array.size else 0.0
    scale = peak / 127.0 if peak > 0.0 else 1.0
    q = np.clip(np.round(array / scale), -127, 127).astype(np.int8)
    return q, np.float32(scale)


def quantize_tree_int8(params: Any) -> Tuple[Any, Any]:
    """Quantize every leaf of a nested-dict tree: ``(q_tree, scale_tree)``
    of the same structure, one scale per leaf."""
    if not isinstance(params, dict):
        return quantize_array_int8(params)
    q_tree, scale_tree = {}, {}
    for key, value in params.items():
        q_tree[key], scale_tree[key] = quantize_tree_int8(value)
    return q_tree, scale_tree


def dequantize_tree_int8(q_tree: Any, scale_tree: Any) -> Any:
    """Host-side inverse, the same float32 multiply the scoring program
    does."""
    if not isinstance(q_tree, dict):
        return np.asarray(q_tree, np.float32) * np.float32(scale_tree)
    return {key: dequantize_tree_int8(q_tree[key], scale_tree[key]) for key in q_tree}


def quantized_arrays_for(model: Any) -> Optional[Dict[str, np.ndarray]]:
    """``{"q/<path>": int8, "s/<path>": float32 scale}`` for a pipeline's
    estimator parameters: the ``quant_int8.npz`` payload. ``None`` when the
    model has no estimator the engine could lift."""
    from .models.analysis import analyze_model
    from .serializer.persistence import _flatten_state

    try:
        params = analyze_model(model).estimator.params_
    except (ValueError, AttributeError, TypeError):
        return None
    if params is None:
        return None
    q_tree, scale_tree = quantize_tree_int8(params)
    arrays, _ = _flatten_state({"q": q_tree, "s": scale_tree})
    return arrays


def load_quantized(artifact_dir: str) -> Optional[Tuple[Any, Any]]:
    """The ``(q_tree, scale_tree)`` stored in a resolved artifact
    directory's ``quant_int8.npz``, or ``None`` when it has none (the
    engine then quantizes on the fly: same formula, same bytes). Integrity
    is the manifest's job: ``load`` has hashed this file already."""
    from .serializer.persistence import _unflatten_state

    path = os.path.join(artifact_dir, QUANT_INT8_FILE)
    if not os.path.isfile(path):
        return None
    with np.load(path, allow_pickle=False) as npz:
        arrays = {key: npz[key] for key in npz.files}
    tree = _unflatten_state(arrays, {})
    q_tree, scale_tree = tree.get("q"), tree.get("s")
    if q_tree is None or scale_tree is None:
        raise ValueError(f"{path}: malformed quantized sidecar (missing q/ or s/ trees)")
    return q_tree, scale_tree


def parse_precision_map(spec: Optional[str]) -> Dict[str, str]:
    """``--precision-map``: ``name=precision`` pairs (comma- or
    semicolon-separated), or the path of a YAML file mapping names to
    precisions (read through ``yaml``, imported here only). Every value is
    validated, so a typo fails the command, not a fleet of artifacts."""
    if not spec:
        return {}
    mapping: Dict[str, str] = {}
    if os.path.exists(spec):
        try:
            import yaml
        except ImportError as exc:
            raise ImportError(f"reading the --precision-map file {spec!r} needs the 'yaml' "
                              "package (PyYAML), which is not installed") from exc
        with open(spec) as fh:
            loaded = yaml.safe_load(fh)
        if not isinstance(loaded, dict):
            raise ValueError(f"--precision-map file {spec!r} must parse to a mapping")
        items = list(loaded.items())
    else:
        items = []
        for pair in spec.replace(";", ",").split(","):
            pair = pair.strip()
            if not pair:
                continue
            if "=" not in pair:
                raise ValueError(f"--precision-map entry {pair!r} is not name=precision")
            name, _, value = pair.partition("=")
            items.append((name.strip(), value.strip()))
    for name, value in items:
        if not name:
            raise ValueError("--precision-map entry has an empty name")
        mapping[str(name)] = validate(str(value))
    return mapping
