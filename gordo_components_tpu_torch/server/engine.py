"""Anomaly scoring on the card (port of ``gordo_components_tpu/server/engine.py``:
``ScoreResult``, ``_identity``, ``_affine``, ``_MachineEntry``,
``_lift_machine`` and ``_make_machine_score`` at 210-253 and 352-523, and
the request validation of ``anomaly`` at 2917-2946).

One machine per dispatch: scale → window (none for a dense model: one
score per input row) → model forward → inverse-scale → residual against
the target columns → error-scale → per-row L2, all on the engine's device,
then one stream-synchronised copy of the four arrays to the host. A joint
multi-step forecaster is refused with the reference's reason. The
reference's stacked, hot, megabatch and chunked programs are a later slice
(ROADMAP.md).

Precision rungs: ``f32``, and ``bf16`` — weights stored in bfloat16 and
windows rounded to bfloat16, with the forward computed in the
architecture's ``compute_dtype`` (flax promotes bf16 weights the same way)
and everything around it in float32. ``int8`` raises
``NotImplementedError``.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..models.analysis import analyze_model
from ..models.transformers import MinMaxScaler, StandardScaler
from ..ops import windowing
from ..ops.scaling import ScalerParams
from ..utils.backend import DeviceLike, resolve_device

PRECISIONS = ("f32", "bf16", "int8")


class ScoreResult(NamedTuple):
    """Tail-aligned scoring arrays — the anomaly payload's field names."""

    model_input: np.ndarray  # (m, F) raw input rows the outputs align to
    model_output: np.ndarray  # (m, T) predictions in raw units
    tag_anomaly_scores: np.ndarray  # (m, T) error-scaled |residuals|
    total_anomaly_score: np.ndarray  # (m,) L2 norm across tags


def _identity(width: int) -> ScalerParams:
    return ScalerParams(
        scale=np.ones((width,), np.float32), offset=np.zeros((width,), np.float32)
    )


def _affine(scaler: Optional[Any], width: int) -> ScalerParams:
    """A fitted affine scaler's (scale, offset); identity when absent."""
    if scaler is None:
        return _identity(width)
    if not isinstance(scaler, (MinMaxScaler, StandardScaler)):
        raise ValueError(f"engine lifts affine scalers only; got {type(scaler).__name__}")
    if scaler.params_ is None:
        raise ValueError(f"{type(scaler).__name__} is not fitted")
    return ScalerParams(
        scale=np.asarray(scaler.params_.scale, np.float32),
        offset=np.asarray(scaler.params_.offset, np.float32),
    )


@dataclass
class _MachineEntry:
    name: str
    module: torch.nn.Module  # the forward at this machine's rung, on the device
    sx: ScalerParams  # device tensors from here on
    sy: ScalerParams
    es: ScalerParams
    tcols: torch.Tensor  # input-column index of each target tag
    n_features: int
    lookback: int
    lookahead: Optional[int]
    precision: str


def _on(params: ScalerParams, device: torch.device) -> ScalerParams:
    return ScalerParams(
        scale=torch.as_tensor(params.scale, device=device),
        offset=torch.as_tensor(params.offset, device=device),
    )


def _lift_machine(
    name: str, model: Any, target_cols: Optional[List[int]], precision: str,
    device: torch.device,
) -> _MachineEntry:
    """One loaded model → its engine entry on ``device``; raises
    ``ValueError`` for a model the engine cannot score."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; use one of {PRECISIONS}")
    if precision == "int8":
        raise NotImplementedError(
            "the int8 rung is not ported yet (ROADMAP.md, Queue 1: int8)"
        )
    analyzed = analyze_model(model)
    est = analyzed.estimator
    est._check_fitted()
    if getattr(est, "joint_horizon", False):
        raise ValueError(
            "joint multi-step forecast emits horizon x F values "
            "per window; the anomaly engine scores one row per "
            "timestamp — use the direct-horizon LSTMForecast "
            "for anomaly serving"
        )
    n_features = int(est.n_features_)
    n_targets = int(est.n_features_out_)
    if target_cols is None:
        if n_targets != n_features:
            raise ValueError(
                f"targets are a {n_targets}-of-{n_features} subset but no "
                "target-column mapping was provided"
            )
        tcols = np.arange(n_features)
    else:
        tcols = np.asarray(target_cols, np.int64)
        if tcols.shape != (n_targets,):
            raise ValueError(
                f"target-column mapping has {tcols.shape[0]} entries for "
                f"{n_targets} targets"
            )
        if tcols.size and (tcols.min() < 0 or tcols.max() >= n_features):
            raise ValueError(
                f"target-column mapping indexes outside the {n_features}-wide input"
            )
    detector = analyzed.detector
    if detector is None:
        es = _identity(n_targets)
    elif getattr(detector.scaler, "params_", "unset") is None:
        if detector.require_thresholds:
            raise ValueError("error scaler unfitted and require_thresholds set")
        es = _identity(n_targets)  # the reference's fallback: raw |residuals|
    else:
        es = _affine(detector.scaler, n_targets)
    est.to(device)
    module = est.module_
    if precision == "bf16":
        module = copy.deepcopy(module).to(torch.bfloat16)
    return _MachineEntry(
        name=name,
        module=module,
        sx=_on(_affine(analyzed.input_scaler, n_features), device),
        sy=_on(_affine(analyzed.target_scaler, n_targets), device),
        es=_on(es, device),
        tcols=torch.as_tensor(tcols, dtype=torch.long, device=device),
        n_features=n_features,
        lookback=est.lookback_window,
        lookahead=est.lookahead,
        precision=precision,
    )


def _make_machine_score(entry: _MachineEntry):
    """The per-machine scoring math, as the reference's closure."""
    L, la = entry.lookback, entry.lookahead

    def machine_score(x: torch.Tensor):
        xs = x * entry.sx.scale + entry.sx.offset
        inputs = xs if la is None else windowing.sliding_windows(xs, L, la)
        if entry.precision == "bf16":
            inputs = inputs.to(torch.bfloat16)
        pred = entry.module(inputs).float()
        pred_raw = (pred - entry.sy.offset) / entry.sy.scale
        x_tail = x[x.shape[0] - pred_raw.shape[0] :]
        y_tail = x_tail.index_select(-1, entry.tcols)
        err = (y_tail - pred_raw).abs()
        scaled = err * entry.es.scale + entry.es.offset
        total = torch.linalg.vector_norm(scaled, dim=-1)
        return x_tail, pred_raw, scaled, total

    return machine_score


class ServingEngine:
    """Score loaded models by machine name on one device.

    ``models``: ``{machine_name: loaded model}``. A machine the engine
    cannot lift is recorded in :attr:`skipped` with its reason and answers
    ``KeyError`` (the port has no host path to fall back to).
    ``target_cols``: optional ``{name: [input-column index of each target
    tag]}`` for target-subset machines; ``precisions``: ``{name: rung}``.
    """

    def __init__(
        self,
        models: Dict[str, Any],
        target_cols: Optional[Dict[str, Optional[List[int]]]] = None,
        precisions: Optional[Dict[str, str]] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        target_cols = target_cols or {}
        precisions = precisions or {}
        self._entries: Dict[str, _MachineEntry] = {}
        self._scores: Dict[str, Any] = {}
        self.skipped: Dict[str, str] = {}
        for name, model in models.items():
            try:
                entry = _lift_machine(
                    name, model, target_cols.get(name),
                    precisions.get(name, "f32"), self.device,
                )
            except ValueError as exc:
                self.skipped[name] = str(exc)
                continue
            self._entries[name] = entry
            self._scores[name] = _make_machine_score(entry)

    def can_score(self, name: str) -> bool:
        return name in self._entries

    def anomaly(self, name: str, X) -> ScoreResult:
        """Full anomaly scoring for one request on the engine's device."""
        entry = self._entries.get(name)
        if entry is None:
            raise KeyError(name)
        X = np.asarray(getattr(X, "values", X), np.float32)
        if X.ndim == 1:
            X = X[None, :]
        if X.shape[1] != entry.n_features:
            raise ValueError(
                f"Model expects {entry.n_features} features, got {X.shape[1]}"
            )
        L, la = entry.lookback, entry.lookahead
        if la is not None and windowing.n_windows(X.shape[0], L, la) <= 0:
            raise ValueError(
                f"Need at least lookback_window+lookahead={L + la} rows, "
                f"got {X.shape[0]}"
            )
        with torch.inference_mode():
            x = torch.from_numpy(X).to(self.device)
            outputs = self._scores[name](x)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            host = [t.cpu().numpy() for t in outputs]
        return ScoreResult(*host)
