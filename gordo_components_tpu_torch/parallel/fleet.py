"""The stacked fleet program (port of
``gordo_components_tpu/parallel/fleet.py:65-553, 854-891``).

One bucket's ENTIRE build — input and target scalers, windowing,
time-ordered cross-validation folds, the K fold fits and the final fit,
the error scaler on out-of-fold residuals and the thresholds — runs as one
program over a leading machine axis: ``(X (M, N, F), y (M, N, T), w (M,
N), keys (M,)) → MachineResult`` with every field stacked over M. The
reference ``vmap``s a per-machine function; the port writes the program
over the stack:

- the statistics (scalers, fold masks, metrics, error scaler) are plain
  tensor functions with a leading machine axis, reduced over the row axis
  with plain weighted sums, as the reference's are;
- the fits are stacks of parameter sets: M·(K+1) fits at once when
  ``cv_parallel`` is true, else K+1 sequential stacks of M. Each step maps
  ``functional_call`` of one shared template module over the stacked
  parameters with ``torch.func.vmap``, takes ONE ``torch.autograd.grad``
  of the summed per-fit losses (machines share no parameter, so the
  gradient of the sum with respect to fit g's leaves is fit g's gradient)
  and updates every stacked leaf with one call of the optimizer, whose
  transforms are elementwise with one shared step count. A flash
  attention layer therefore launches its forward and backward kernels
  once per layer per step for the whole stack, at BH = fits·B·tags·heads
  (``gordo::flash_fwd``'s vmap rule folds the stack into BH);
- a fit's loss is :func:`..models.train.make_loss_fn`'s weighted mean over
  its real rows, so a zero-weight padding machine gets a zero gradient and
  a zero update, and ends with identity scalers and zero thresholds.

Randomness: the port cannot draw ``jax.random``. Each machine has one
integer key; :func:`fit_generator` seeds a ``torch.Generator`` from (key,
index), with the reference's order of ``split(key, n_splits + 2)``: index
0 draws the initial parameters, 1 the final fit, 2 + k fold k. A fit's
generator draws one permutation per epoch and, with dropout, one mask key
per step (masks are hashed from it by :class:`..models.modules.KeyStream`,
so every fit of the stack draws its own). :func:`train_fleet_arrays` also
takes injected initial parameters and permutations, which is how the tests
hold it to the reference's draws.

Windowed models train on window START indices: each batch gathers its
``(fits, B, L, F)`` windows from the ``(M, N, F)`` rows, and the ``(n_windows,
L, F)`` tensor is never built. ``remat`` is a memory knob of the single
fit; the stacked program runs its template without recomputation
(``torch.utils.checkpoint`` under ``vmap`` is untested here), so a remat
bucket pays the plain activation memory of its stack.
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.factories.spec import apply_updates
from ..models.models import init_flax_distributions
from ..models.modules import KeyStream
from ..models.train import make_batch_step, make_loss_fn
from ..ops import windowing
from ..ops.scaling import ScalerParams
from ..utils.backend import DeviceLike, nan_guard, resolve_device
from .mesh import pad_to_multiple

logger = logging.getLogger(__name__)
_EPS = 1e-12
Params = Dict[str, torch.Tensor]


class FleetSpec(NamedTuple):
    """Static description of one bucket's machines (the reference's fields
    and defaults)."""

    module: Any  # the factory's nn.Module: the shared architecture
    optimizer: Any  # GradientTransformation (models/factories/spec.py)
    loss: str
    lookahead: Optional[int]  # None=flat, 0=reconstruction, k>=1=k-step forecast
    lookback_window: int
    scaler: str  # "minmax" | "standard" | "none"
    feature_range: Tuple[float, float]
    batch_size: int
    epochs: int
    n_splits: int  # 0 disables CV (error scaler fits on train residuals)
    use_dropout: bool = False
    # True ⇔ the config wraps the model in a TransformedTargetRegressor:
    # targets train scaled and predictions are inverse-transformed
    scale_targets: bool = True
    scaler_options: Tuple[bool, bool] = (True, True)  # ("standard") with_mean, with_std
    target_scaler: str = "minmax"
    target_feature_range: Tuple[float, float] = (0.0, 1.0)
    target_scaler_options: Tuple[bool, bool] = (True, True)
    # True: the K fold fits and the final fit train as ONE stack of
    # M·(K+1) fits, at (K+1)× the step memory; False: K+1 stacks of M
    cv_parallel: bool = True
    # the reference's lax.scan unroll; eager PyTorch has no such knob, so
    # the field is kept for equal specs and unused
    fit_unroll: int = 1
    # widen the predict chunks (windowed models) up to 4 training batches
    widen_predict: bool = False


class MachineBatch(NamedTuple):
    """Stacked per-machine data: X (M, N, F) raw, y (M, N, T) raw, w (M, N)
    row weights (0 on padding), keys (M,) one integer seed per machine."""

    X: Any
    y: Any
    w: Any
    keys: Any


class MachineResult(NamedTuple):
    params: Params  # (M, ...) leaves of the template's named parameters
    input_scaler: ScalerParams  # (M, F)
    target_scaler: ScalerParams  # (M, T)
    error_scaler: ScalerParams  # (M, T) minmax over |raw residuals|
    loss_history: torch.Tensor  # (M, epochs)
    cv_scores: torch.Tensor  # (M, n_splits, len(FLEET_CV_METRICS))
    tag_thresholds: torch.Tensor  # (M, T) 99th pct of scaled residuals
    total_threshold: torch.Tensor  # (M,) 99th pct of residual L2 norms


FleetResult = MachineResult

# column order of the per-fold metric vector: the single-machine builder's
# four metrics, in sklearn ``uniform_average`` semantics
FLEET_CV_METRICS = (
    "explained_variance_score",
    "r2_score",
    "mean_squared_error",
    "mean_absolute_error",
)


def _masked_minmax(x: torch.Tensor, w: torch.Tensor, feature_range) -> ScalerParams:
    """``x (..., N, C)``, ``w (..., N)`` → min-max over the rows of weight
    > 0; a machine with no real row gets the identity scaler."""
    lo, hi = feature_range
    mask = (w > 0)[..., None]
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    xmin = torch.where(mask, x, inf).amin(dim=-2)
    xmax = torch.where(mask, x, -inf).amax(dim=-2)
    xmin = torch.where(torch.isfinite(xmin), xmin, 0.0)
    xmax = torch.where(torch.isfinite(xmax), xmax, 1.0)
    span = xmax - xmin
    scale = (hi - lo) / torch.where(span < _EPS, 1.0, span)
    return ScalerParams(scale=scale, offset=lo - xmin * scale)


def _masked_standard(x: torch.Tensor, w: torch.Tensor, with_mean: bool = True,
                     with_std: bool = True) -> ScalerParams:
    wsum = torch.clamp(w.sum(dim=-1), min=1.0)[..., None]
    wcol = w[..., None]
    mean = (x * wcol).sum(dim=-2) / wsum
    var = ((x - mean[..., None, :]) ** 2 * wcol).sum(dim=-2) / wsum
    std = torch.sqrt(var)
    scale = 1.0 / torch.where(std < _EPS, 1.0, std) if with_std else torch.ones_like(std)
    offset = -mean * scale if with_mean else torch.zeros_like(mean)
    return ScalerParams(scale=scale, offset=offset)


def _fit_scaler(kind: str, options, feature_range, x: torch.Tensor,
                w: torch.Tensor) -> ScalerParams:
    if kind == "minmax":
        return _masked_minmax(x, w, feature_range)
    if kind == "standard":
        with_mean, with_std = options
        return _masked_standard(x, w, with_mean, with_std)
    if kind == "none":
        shape = x.shape[:-2] + x.shape[-1:]
        return ScalerParams(scale=x.new_ones(shape), offset=x.new_zeros(shape))
    raise ValueError(f"Unknown scaler kind {kind!r}")


def _masked_metrics(y: torch.Tensor, pred: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted fold metrics in :data:`FLEET_CV_METRICS` order over the row
    axis: ``y``/``pred (..., P, T)``, ``w (..., P)`` → ``(..., 4)``; NaN
    where the fold has no real row. Per-output scores average uniformly
    (sklearn ``multioutput="uniform_average"``)."""
    w_total = w.sum(dim=-1)
    wsum = torch.clamp(w_total, min=1.0)[..., None]
    wcol = w[..., None]
    diff = y - pred
    # explained variance: 1 - Var(residual)/Var(y)
    dmean = (diff * wcol).sum(dim=-2) / wsum
    dvar = ((diff - dmean[..., None, :]) ** 2 * wcol).sum(dim=-2) / wsum
    ymean = (y * wcol).sum(dim=-2) / wsum
    yvar = ((y - ymean[..., None, :]) ** 2 * wcol).sum(dim=-2) / wsum
    flat = yvar < _EPS
    ev = 1.0 - dvar / torch.where(flat, 1.0, yvar)
    ev = torch.where(flat, (dvar < _EPS).to(ev.dtype), ev).mean(dim=-1)
    # r2: 1 - SS_res/SS_tot (not mean-adjusted residuals)
    ss_res = (diff ** 2 * wcol).sum(dim=-2) / wsum
    r2 = 1.0 - ss_res / torch.where(flat, 1.0, yvar)
    r2 = torch.where(flat, (ss_res < _EPS).to(r2.dtype), r2).mean(dim=-1)
    mse = ss_res.mean(dim=-1)
    mae = ((diff.abs() * wcol).sum(dim=-2) / wsum).mean(dim=-1)
    scores = torch.stack([ev, r2, mse, mae], dim=-1)
    return torch.where((w_total > 0)[..., None], scores, float("nan"))


def timeseries_fold_masks(wt: torch.Tensor, n_splits: int) -> List[Tuple[torch.Tensor,
                                                                         torch.Tensor]]:
    """sklearn ``TimeSeriesSplit`` fold masks over each machine's REAL
    samples (``wt > 0``), ``wt (..., P)`` → ``n_splits`` pairs of (train,
    test) masks of ``wt``'s shape. For ``n`` real samples and ``k`` splits,
    ``test_size = n // (k+1)``; split ``i`` tests ranks ``[n-(k-i)*ts,
    n-(k-i-1)*ts)`` and trains on every earlier rank. The masks are in rank
    space over real samples, so padding anywhere never shifts a boundary."""
    real = (wt > 0).to(torch.float32)
    n_real = real.sum(dim=-1).to(torch.int64)
    rank = torch.cumsum(real, dim=-1) - real  # 0-based rank among real samples
    test_size = n_real // (n_splits + 1)
    masks = []
    for i in range(n_splits):
        test_start = (n_real - (n_splits - i) * test_size)[..., None]
        test_end = (n_real - (n_splits - i - 1) * test_size)[..., None]
        train_mask = real * (rank < test_start)
        test_mask = real * (rank >= test_start) * (rank < test_end)
        masks.append((train_mask, test_mask))
    return masks


def fit_generator(key: int, index: int) -> torch.Generator:
    """The CPU generator of machine ``key``'s draw ``index``: 0 the initial
    parameters, 1 the final fit, 2 + k fold k."""
    state = np.random.SeedSequence([int(key), int(index)]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed((int(state[0]) << 32) | int(state[1]))


def initial_params(module: torch.nn.Module, keys: Sequence[int]) -> Params:
    """Each machine's initial parameters, drawn from flax's distributions
    by its index-0 generator, stacked ``(M, ...)`` on the CPU."""
    trees = []
    for key in keys:
        fresh = init_flax_distributions(copy.deepcopy(module).cpu(), fit_generator(key, 0))
        trees.append({n: p.detach() for n, p in fresh.named_parameters()})
    return {name: torch.stack([t[name] for t in trees]) for name in trees[0]}


def _template(module: torch.nn.Module) -> torch.nn.Module:
    """A meta-device copy of ``module`` for ``functional_call``: it holds
    the architecture, the stacked parameters are swapped in per call."""
    template = copy.deepcopy(module).to("meta").train(False)
    for sub in template.modules():
        if getattr(sub, "remat", False):
            sub.remat = False  # see the module docstring
    return template


def _gather_windows(rows: torch.Tensor, machines: torch.Tensor, starts: torch.Tensor,
                    L: int) -> torch.Tensor:
    """``rows (M, N, F)``, each fit's machine ``machines (G,)`` and window
    starts ``starts (G, B)`` → ``(G, B, L, F)``: window ``i`` is rows
    ``[start, start + L)``, the index arithmetic of
    :func:`..ops.windowing.gather_windows`."""
    offsets = torch.arange(L, device=rows.device)
    return rows[machines[:, None, None], starts[..., None] + offsets]


class _Program:
    """One bucket's tensors and closures on the device (what the reference
    closes over in ``make_machine_program``)."""

    def __init__(self, spec: FleetSpec, X: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
        self.spec = spec
        self.device = X.device
        M, N, _ = X.shape
        L, la = spec.lookback_window, spec.lookahead
        if la is None:
            n_samples = N
        else:
            n_samples = windowing.n_windows(N, L, la)
            if n_samples < spec.batch_size:
                raise ValueError(f"Bucket rows {N} give {n_samples} windows "
                                 f"(< batch_size {spec.batch_size})")
        self.padded = pad_to_multiple(n_samples, spec.batch_size)
        self.sx = _fit_scaler(spec.scaler, spec.scaler_options, spec.feature_range, X, w)
        if spec.scale_targets:
            self.sy = _fit_scaler(spec.target_scaler, spec.target_scaler_options,
                                  spec.target_feature_range, y, w)
        else:  # no TransformedTargetRegressor: the model trains on raw targets
            self.sy = _fit_scaler("none", None, None, y, w)
        self.rows = X * self.sx.scale[:, None] + self.sx.offset[:, None]
        ys = y * self.sy.scale[:, None] + self.sy.offset[:, None]
        if la is None:
            inputs, targets, wt = self.rows, ys, w
        else:
            by_row = ys.movedim(1, 0)  # windowing's contract runs over dim 0
            targets = (windowing.reconstruction_targets(by_row, L) if la == 0
                       else windowing.forecast_targets(by_row, L, la)).movedim(0, 1)
            inputs = torch.arange(n_samples, device=self.device)
            target_idx = torch.as_tensor(windowing.window_output_index(N, L, la),
                                         device=self.device)
            # a window's weight: the min of its rows' weights times its target row's
            window_w = windowing.sliding_windows(w.t(), L, la).amin(dim=1).t()
            wt = window_w * w[:, target_idx]
        pad = self.padded - n_samples
        if pad:
            pad_rows = torch.nn.functional.pad
            inputs = (pad_rows(inputs, (0, 0, 0, pad)) if la is None
                      else pad_rows(inputs, (0, pad)))
            targets = pad_rows(targets, (0, 0, 0, pad))
            wt = pad_rows(wt, (0, pad))
        self.inputs, self.targets, self.wt = inputs, targets, wt
        self.raw_targets = (targets - self.sy.offset[:, None]) / self.sy.scale[:, None]
        self.template = _template(spec.module)
        steps = self.padded // spec.batch_size
        self.predict_width = spec.batch_size
        if la is not None and spec.widen_predict:
            # prediction has no backward: fold up to 4 training batches into
            # one forward chunk (the largest factor of the step count)
            self.predict_width *= next(k for k in range(min(4, steps), 0, -1) if steps % k == 0)

        def apply(params, x, key):
            generator = None if key is None else KeyStream(key)
            return torch.func.functional_call(self.template, params, (x,),
                                              {"generator": generator})

        loss_fn = make_loss_fn(apply, spec.loss)
        self._losses = torch.func.vmap(loss_fn, in_dims=(0, 0, 0, 0, 0 if spec.use_dropout
                                                         else None))
        self._forward = torch.func.vmap(
            lambda params, x: torch.func.functional_call(self.template, params, (x,)))

    def batch_inputs(self, machines: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        if self.spec.lookahead is None:
            return self.inputs[machines[:, None], idx]
        return _gather_windows(self.rows, machines, self.inputs[idx],
                               self.spec.lookback_window)

    def fit(self, params0: Params, machines: torch.Tensor, fit_w: torch.Tensor,
            generators: List[torch.Generator],
            perms: Optional[Sequence[Any]] = None) -> Tuple[Params, torch.Tensor]:
        """Train one stack of fits: fit g starts from machine
        ``machines[g]``'s parameters and trains on its rows weighted by
        ``fit_w[g]``. Returns the stacked parameters and the ``(G,
        epochs)`` loss histories (each epoch's batch losses weighted by
        their real rows)."""
        spec = self.spec
        B = spec.batch_size
        P = self.padded
        names = list(params0)
        values = [params0[n].index_select(0, machines).clone().requires_grad_() for n in names]
        params = dict(zip(names, values))
        opt_state = spec.optimizer.init(values)
        history = []
        for epoch in range(spec.epochs):
            if perms is not None:
                perm = torch.as_tensor(np.stack([np.asarray(p[epoch]) for p in perms]),
                                       dtype=torch.long)
            else:
                perm = torch.stack([torch.randperm(P, generator=g) for g in generators])
            perm = perm.to(self.device)
            losses, wsums = [], []
            for start in range(0, P, B):
                idx = perm[:, start:start + B]
                x = self.batch_inputs(machines, idx)
                y = self.targets[machines[:, None], idx]
                w = fit_w.gather(1, idx)
                keys = None
                if spec.use_dropout:
                    keys = torch.tensor([int(torch.randint(0, 2**31, (), generator=g))
                                         for g in generators], device=self.device)
                with torch.enable_grad():
                    fit_losses = self._losses(params, x, y, w, keys)
                    grads = torch.autograd.grad(fit_losses.sum(), values)
                with torch.no_grad():
                    updates, opt_state = spec.optimizer.update(list(grads), opt_state, values)
                    apply_updates(values, updates)
                losses.append(fit_losses.detach())
                wsums.append(w.sum(dim=1))
            losses, wsums = torch.stack(losses, dim=1), torch.stack(wsums, dim=1)
            history.append((losses * wsums).sum(dim=1) / torch.clamp(wsums.sum(dim=1), min=1.0))
        return {n: v.detach() for n, v in params.items()}, torch.stack(history, dim=1)

    @torch.no_grad()
    def predict_raw(self, params: Params, machines: torch.Tensor) -> torch.Tensor:
        """Every fit's predictions over all (padded) samples, ``(G, P, T)``,
        inverse-transformed to raw target units. Windowed models run in
        chunks of ``predict_width`` windows per fit."""
        if self.spec.lookahead is None:
            pred = self._forward(params, self.inputs[machines])
        else:
            chunks = []
            for start in range(0, self.padded, self.predict_width):
                idx = torch.arange(start, start + self.predict_width, device=self.device)
                x = self.batch_inputs(machines, idx.expand(len(machines), -1))
                chunks.append(self._forward(params, x))
            pred = torch.cat(chunks, dim=1)
        return (pred - self.sy.offset[machines, None]) / self.sy.scale[machines, None]


def _as_tensor(a: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32) if not torch.is_tensor(a) else a,
                           dtype=torch.float32).to(device)


def train_fleet_arrays(
    spec: FleetSpec,
    batch: MachineBatch,
    device: DeviceLike = None,
    params0: Optional[Params] = None,
    perms: Optional[Sequence[Any]] = None,
) -> MachineResult:
    """Train a stacked bucket of machines on ``device`` (``cuda`` unless the
    caller says ``"cpu"``); returns the stacked results on it.

    ``params0``: the initial parameters ``{name: (M, ...)}`` in the
    template's layout, instead of drawing them. ``perms``: the permutations
    instead of drawing them, ``perms[m][j][epoch]`` for machine m's fit j
    (folds 0..K-1, then the final fit), each a permutation of the padded
    sample count. Runs under the numeric sanitizer while it is on
    (``utils.backend.nan_guard``)."""
    with nan_guard():
        return _train_fleet_arrays(spec, batch, resolve_device(device), params0, perms)


def _train_fleet_arrays(spec: FleetSpec, batch: MachineBatch, device: torch.device,
                        params0: Optional[Params],
                        perms: Optional[Sequence[Any]]) -> MachineResult:
    X, y, w = (_as_tensor(a, device) for a in (batch.X, batch.y, batch.w))
    keys = [int(k) for k in np.asarray(batch.keys).reshape(-1)]
    M = X.shape[0]
    T = y.shape[-1]
    K = spec.n_splits
    program = _Program(spec, X, y, w)
    wt = program.wt
    if params0 is None:
        params0 = initial_params(spec.module, keys)
    params0 = {name: _as_tensor(value, device) for name, value in params0.items()}
    fold_masks = timeseries_fold_masks(wt, K)
    machines = torch.arange(M, device=device)

    def generators(index: int) -> List[torch.Generator]:
        return [fit_generator(key, index) for key in keys]

    def fit_perms(j: int) -> Optional[List[Any]]:
        return None if perms is None else [perms[m][j] for m in range(M)]

    if K > 0 and spec.cv_parallel:
        # one stack of M·(K+1) fits, machine-major: machine m's folds, then its final fit
        stack_machines = machines.repeat_interleave(K + 1)
        fit_w = torch.stack([m[0] * wt for m in fold_masks] + [wt], dim=1).reshape(M * (K + 1), -1)
        stack_gens = [fit_generator(key, 2 + j if j < K else 1)
                      for key in keys for j in range(K + 1)]
        stack_perms = None if perms is None else [perms[m][j] for m in range(M)
                                                  for j in range(K + 1)]
        fitted, history = program.fit(params0, stack_machines, fit_w, stack_gens, stack_perms)
        preds = program.predict_raw(fitted, stack_machines).reshape(M, K + 1, *wt.shape[1:], T)
        final_params = {n: v.unflatten(0, (M, K + 1))[:, K] for n, v in fitted.items()}
        loss_history = history.reshape(M, K + 1, -1)[:, K]
        del fitted
    else:
        # K+1 sequential stacks of M: step memory at 1× the stack
        pred_list = []
        for k in range(K):
            fitted, _ = program.fit(params0, machines, fold_masks[k][0] * wt, generators(2 + k),
                                    fit_perms(k))
            pred_list.append(program.predict_raw(fitted, machines))
            del fitted
        final_params, loss_history = program.fit(params0, machines, wt, generators(1),
                                                 fit_perms(K))
        pred_list.append(program.predict_raw(final_params, machines))
        preds = torch.stack(pred_list, dim=1)  # (M, K+1, P, T)
    raw_targets = program.raw_targets
    errs = (raw_targets[:, None] - preds).abs()  # (M, K+1, P, T)
    if K > 0:
        fold_test_masks = torch.stack([m[1] * wt for m in fold_masks], dim=1)  # (M, K, P)
        cv_scores = _masked_metrics(raw_targets[:, None], preds[:, :K], fold_test_masks)
    else:
        fold_test_masks = wt.new_zeros((M, 0, wt.shape[1]))
        cv_scores = wt.new_zeros((M, 0, len(FLEET_CV_METRICS)))
    inf = torch.tensor(float("inf"), device=device)
    fmask = (fold_test_masks > 0)[..., None]
    fold_errors, err_final = errs[:, :K], errs[:, K]
    emin = torch.where(fmask, fold_errors, inf).amin(dim=(1, 2)) if K else inf.expand(M, T)
    emax = torch.where(fmask, fold_errors, -inf).amax(dim=(1, 2)) if K else (-inf).expand(M, T)
    mask_final = (wt > 0)[..., None]
    fmin = torch.where(mask_final, err_final, inf).amin(dim=1)
    fmax = torch.where(mask_final, err_final, -inf).amax(dim=1)
    # CV residuals when a fold covered the machine, else the final model's
    use_cv = (fold_test_masks.sum(dim=(1, 2)) > 0)[:, None]
    emin = torch.where(use_cv, emin, fmin)
    emax = torch.where(use_cv, emax, fmax)
    emin = torch.where(torch.isfinite(emin), emin, 0.0)
    emax = torch.where(torch.isfinite(emax), emax, 1.0)
    span = emax - emin
    e_scale = 1.0 / torch.where(span < _EPS, 1.0, span)
    error_scaler = ScalerParams(scale=e_scale, offset=-emin * e_scale)

    # thresholds: 99th percentiles of the scaled residuals, out-of-fold
    # when CV covered the machine, final-model residuals otherwise
    fallback = wt * (~use_cv).to(wt.dtype)
    masks = torch.cat([fold_test_masks, fallback[:, None]], dim=1) > 0  # (M, K+1, P)
    scaled = errs * e_scale[:, None, None] + error_scaler.offset[:, None, None]
    norms = torch.linalg.vector_norm(
        torch.nan_to_num(torch.where(masks[..., None], scaled, 0.0)), dim=-1)
    # per machine over its masked rows, picked out rather than set to NaN
    # (the numeric sanitizer takes any NaN for a fault), outside any vmap:
    # torch.quantile caps its input at 2**24; a machine with no such row
    # gets 0
    real = masks.reshape(M, -1).sum(dim=1).tolist()
    tag_thresholds = torch.stack([
        torch.nan_to_num(torch.nanquantile(scaled[m][masks[m]], 0.99, dim=0)) if real[m]
        else scaled.new_zeros(T) for m in range(M)])
    total_threshold = torch.stack([
        torch.nan_to_num(torch.nanquantile(norms[m][masks[m]], 0.99)) if real[m]
        else norms.new_zeros(()) for m in range(M)])
    return MachineResult(
        params=final_params,
        input_scaler=program.sx,
        target_scaler=program.sy,
        error_scaler=error_scaler,
        loss_history=loss_history,
        cv_scores=cv_scores,
        tag_thresholds=tag_thresholds,
        total_threshold=total_threshold,
    )


def fleet_flops_accounting(
    spec: FleetSpec,
    n_machines: int,
    n_rows: int,
    n_features: int,
    n_targets: int,
) -> Optional[dict]:
    """Operation count of one bucket's stacked build (the reference's
    ``fleet_flops_accounting``): the operations of one stacked mini-batch
    step (:func:`..models.train.make_batch_step` over the template mapped
    with ``torch.func.vmap`` across ``n_machines``) and of one batch-wide
    predict chunk, each counted by ``torch.utils.flop_counter.
    FlopCounterMode`` on the meta device (no memory, no kernel), times the
    program's trip counts, which are the reference's arithmetic:
    ``train_steps = (n_splits + 1) · epochs · steps_per_epoch`` and
    ``predict_chunks = (n_splits + 1) · steps_per_epoch`` batch-wide chunks
    (the program may run wider ones; the count is linear in width).

    The counter counts matrix products, convolutions and attention
    (``gordo::flash_fwd``/``flash_bwd`` through their registered formulas,
    whichever of kernel or plain version would run); elementwise work,
    the optimizer's update, scalers, folds and thresholds count nothing,
    so the total slightly undercounts. Dropout is not drawn (it adds no
    product). Returns None, with a warning, when the probe fails, else
    ``{"train_step_flops", "train_steps", "predict_chunk_flops",
    "predict_chunks", "total_flops"}``."""
    from torch.utils.flop_counter import FlopCounterMode

    L, la = spec.lookback_window, spec.lookahead
    if la is None:
        n_samples, x_elem = n_rows, (n_features,)
    else:
        n_samples, x_elem = windowing.n_windows(n_rows, L, la), (L, n_features)
    steps_per_epoch = pad_to_multiple(n_samples, spec.batch_size) // spec.batch_size
    n_fits = spec.n_splits + 1
    train_steps = n_fits * spec.epochs * steps_per_epoch
    predict_chunks = n_fits * steps_per_epoch
    try:
        template = _template(spec.module)
        meta = torch.device("meta")
        params = {name: torch.empty((n_machines, *p.shape), device=meta,
                                    dtype=p.dtype).requires_grad_()
                  for name, p in template.named_parameters()}
        forward = torch.func.vmap(
            lambda p, x: torch.func.functional_call(template, p, (x,)))

        def apply_stacked(p, x, generator):
            return forward(p, x)

        step = make_batch_step(apply_stacked, spec.optimizer, loss=spec.loss)
        x = torch.empty((n_machines, spec.batch_size, *x_elem), device=meta)
        y = torch.empty((n_machines, spec.batch_size, n_targets), device=meta)
        w = torch.empty((n_machines, spec.batch_size), device=meta)
        opt_state = spec.optimizer.init(list(params.values()))
        with FlopCounterMode(display=False) as counter:
            step(params, opt_state, (x, y, w, None))
        train_step_flops = counter.get_total_flops()
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            forward({n: v.detach() for n, v in params.items()}, x)
        predict_chunk_flops = counter.get_total_flops()
    except Exception:  # noqa: BLE001 - a measurement aid never fails its caller
        logger.warning("fleet_flops_accounting probe failed; the build's operation count "
                       "is unreported", exc_info=True)
        return None
    return {
        "train_step_flops": train_step_flops,
        "train_steps": train_steps,
        "predict_chunk_flops": predict_chunk_flops,
        "predict_chunks": predict_chunks,
        "total_flops": train_step_flops * train_steps + predict_chunk_flops * predict_chunks,
    }
