"""Artifact load and dump (port of
``gordo_components_tpu/serializer/persistence.py:53-57, 71-207``).

The reference's pickle-free format, unchanged::

    model_dir/
      definition.json   # class graph + kwargs (JSON)
      state.npz         # every fitted array under flattened "step/sub/key" paths
      state_meta.json   # non-array fitted state (history, widths, thresholds…)
      metadata.json     # build metadata (optional)
      quant_int8.npz    # int8 weights + per-tensor scales (int8 rung only)
      MANIFEST.json     # per-file SHA-256 + size

``load`` verifies the manifest before it reads anything else, follows a
generation root's ``CURRENT`` pointer, builds the port's classes from the
definition and loads the state; every estimator lands on ``device``
(``cuda`` unless the caller says ``"cpu"``). ``dump`` stages the files in a
hidden sibling directory, writes the manifest and renames into place, so a
crash never leaves a half-written artifact under the final name.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import uuid
import zipfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from .. import precision as precision_mod
from ..models.anomaly.diff import DiffBasedAnomalyDetector
from ..models.models import BaseTorchEstimator
from ..models.pipeline import Pipeline, TransformedTargetRegressor
from ..store.manifest import resolve_artifact_dir, verify_artifact, write_manifest
from ..utils.backend import DeviceLike, resolve_device
from .from_definition import pipeline_from_definition
from .into_definition import pipeline_into_definition

METADATA_FILE = "metadata.json"
DEFINITION_FILE = "definition.json"
STATE_FILE = "state.npz"
STATE_META_FILE = "state_meta.json"
_SEP = "/"
_ZIP_EPOCH = (1980, 1, 1, 0, 0, 0)


def _flatten_state(
    state: Dict[str, Any], prefix: str = ""
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    arrays: Dict[str, np.ndarray] = {}
    scalars: Dict[str, Any] = {}
    for key, value in state.items():
        if _SEP in str(key):
            raise ValueError(f"State key {key!r} must not contain {_SEP!r}")
        path = f"{prefix}{_SEP}{key}" if prefix else str(key)
        if isinstance(value, dict):
            sub_arrays, sub_scalars = _flatten_state(value, path)
            arrays.update(sub_arrays)
            scalars.update(sub_scalars)
        elif hasattr(value, "__array__") and not isinstance(value, (int, float, bool)):
            arrays[path] = np.asarray(value)
        else:
            scalars[path] = value
    return arrays, scalars


def _unflatten_state(
    arrays: Dict[str, np.ndarray], scalars: Dict[str, Any]
) -> Dict[str, Any]:
    state: Dict[str, Any] = {}
    for path, value in list(arrays.items()) + list(scalars.items()):
        parts = path.split(_SEP)
        node = state
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return state


def _write_state_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez`` with fixed timestamps and sorted members: the same
    arrays always give the same bytes (and the same manifest hash)."""
    from numpy.lib import format as npformat

    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name in sorted(arrays):
            buffer = io.BytesIO()
            npformat.write_array(buffer, np.asarray(arrays[name]), allow_pickle=False)
            info = zipfile.ZipInfo(name + ".npy", date_time=_ZIP_EPOCH)
            info.external_attr = 0o644 << 16
            zf.writestr(info, buffer.getvalue())


def estimators(obj: Any) -> Iterator[BaseTorchEstimator]:
    """Every torch estimator inside a loaded graph."""
    if isinstance(obj, BaseTorchEstimator):
        yield obj
    elif isinstance(obj, DiffBasedAnomalyDetector):
        yield from estimators(obj.base_estimator)
    elif isinstance(obj, TransformedTargetRegressor):
        yield from estimators(obj.regressor)
    elif isinstance(obj, Pipeline):
        for _, step in obj.steps:
            yield from estimators(step)


def load(source_dir: str, device: DeviceLike = None) -> Any:
    """Rebuild the fitted pipeline persisted at ``source_dir`` (flat
    artifact or generation root) with its estimators on ``device``."""
    device = resolve_device(device)
    source_dir = resolve_artifact_dir(source_dir)
    verify_artifact(source_dir)
    with open(os.path.join(source_dir, DEFINITION_FILE)) as fh:
        definition = json.load(fh)
    obj = pipeline_from_definition(definition)
    with np.load(os.path.join(source_dir, STATE_FILE), allow_pickle=False) as npz:
        arrays = {key: npz[key] for key in npz.files}
    scalars: Dict[str, Any] = {}
    meta_path = os.path.join(source_dir, STATE_META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            scalars = json.load(fh)
    for est in estimators(obj):
        est.to(device)
    obj.set_state(_unflatten_state(arrays, scalars))
    return obj


def load_metadata(source_dir: str) -> Dict[str, Any]:
    path = os.path.join(resolve_artifact_dir(source_dir), METADATA_FILE)
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return json.load(fh)


def write_artifact_files(
    obj: Any,
    dest_dir: str,
    metadata: Optional[Dict[str, Any]] = None,
    precision: Optional[str] = None,
) -> None:
    """Write the artifact files into the existing directory ``dest_dir``
    (no manifest, no atomic rename: :func:`dump` wraps this). At the int8
    rung ``quant_int8.npz`` (the per-tensor quantized weights and scales)
    is written beside the untouched float32 ``state.npz``."""
    with open(os.path.join(dest_dir, DEFINITION_FILE), "w") as fh:
        json.dump(pipeline_into_definition(obj), fh, indent=2)
    arrays, scalars = _flatten_state(obj.get_state())
    _write_state_npz(os.path.join(dest_dir, STATE_FILE), arrays)
    with open(os.path.join(dest_dir, STATE_META_FILE), "w") as fh:
        json.dump(scalars, fh, indent=2, sort_keys=True)
    if precision_mod.validate(precision) == "int8":
        quant = precision_mod.quantized_arrays_for(obj)
        if quant is not None:
            _write_state_npz(os.path.join(dest_dir, precision_mod.QUANT_INT8_FILE), quant)
    if metadata is not None:
        with open(os.path.join(dest_dir, METADATA_FILE), "w") as fh:
            json.dump(metadata, fh, indent=2, default=str)


def dump(
    obj: Any,
    dest_dir: str,
    metadata: Optional[Dict[str, Any]] = None,
    precision: Optional[str] = None,
) -> str:
    """Persist a fitted pipeline to ``dest_dir`` (replacing it whole)
    through :func:`write_artifact_files`, so the manifest hashes an int8
    sidecar like every other file."""
    dest_dir = os.path.abspath(dest_dir)
    parent = os.path.dirname(dest_dir)
    os.makedirs(parent, exist_ok=True)
    staging = os.path.join(
        parent, f".staging-{os.path.basename(dest_dir)}.{uuid.uuid4().hex[:8]}"
    )
    os.makedirs(staging)
    try:
        write_artifact_files(obj, staging, metadata, precision)
        write_manifest(staging)
        if os.path.isdir(dest_dir):
            shutil.rmtree(dest_dir)
        os.replace(staging, dest_dir)
    finally:
        if os.path.isdir(staging):
            shutil.rmtree(staging)
    return dest_dir
