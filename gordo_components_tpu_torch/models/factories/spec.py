"""What a model factory produces, and the optimizers it names (port of
``gordo_components_tpu/models/factories/spec.py:18-109``).

The reference bundles an optax gradient transformation into its
``ModelSpec``. The port writes each of the seven optimizers a config may
name as optax writes it — a pure ``init``/``update`` pair over the list of
parameter tensors, built from the same chain of transforms — and not as
``torch.optim``, whose defaults and formulas differ: optax's ``rmsprop``
adds eps inside the square root, its ``adagrad`` starts the accumulator at
0.1 with eps 1e-7 inside the root, its ``nadam`` has no momentum-decay
schedule, its ``adamax`` adds eps to |g| before the max, and its ``adamw``
decays by 1e-4 unless told otherwise. Every state and update is float32,
and so is every bias correction ``1 - decay**count``, as in optax.
"""

from __future__ import annotations

import inspect
import logging
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

_log = logging.getLogger(__name__)

Tensors = List[torch.Tensor]


class GradientTransformation(NamedTuple):
    """optax's pair: ``init(params) -> state`` and ``update(grads, state,
    params) -> (updates, state)``, over lists of tensors in one order."""

    init: Callable[[Sequence[torch.Tensor]], Any]
    update: Callable[[Tensors, Any, Tensors], Tuple[Tensors, Any]]


def apply_updates(params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor]) -> None:
    """``optax.apply_updates`` in place: ``p += u`` for every pair (the
    port updates the parameters in place, where optax returns new ones)."""
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
    return float(np.float32(1) - np.power(np.float32(decay), np.float32(count)))


def _chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return [t.init(params) for t in transforms]

    def update(updates, state, params):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, new_state

    return GradientTransformation(init, update)


def _zeros(params):
    return [torch.zeros_like(p) for p in params]


def _scale_by_learning_rate(learning_rate: float) -> GradientTransformation:
    step = -float(learning_rate)
    return GradientTransformation(
        lambda params: (), lambda g, state, params: ([u * step for u in g], state)
    )


def _scale_by_adam(b1: float, b2: float, eps: float, eps_root: float,
                   nesterov: bool) -> GradientTransformation:
    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(grads, state, params):
        count = state["count"] + 1
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state["mu"])]
        nu = [(1 - b2) * (g * g) + b2 * n for g, n in zip(grads, state["nu"])]
        if nesterov:
            c_mu, c_g = _bias_correction(b1, count + 1), _bias_correction(b1, count)
            mu_hat = [b1 * (m / c_mu) + (1 - b1) * (g / c_g) for m, g in zip(mu, grads)]
        else:
            c_mu = _bias_correction(b1, count)
            mu_hat = [m / c_mu for m in mu]
        c_nu = _bias_correction(b2, count)
        updates = [
            m / (torch.sqrt(n / c_nu + eps_root) + eps) for m, n in zip(mu_hat, nu)
        ]
        return updates, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def _scale_by_rms(decay: float, eps: float, initial_scale: float, eps_in_sqrt: bool,
                  bias_correction: bool, centered: bool) -> GradientTransformation:
    """optax's ``scale_by_rms`` and, with ``centered``, ``scale_by_stddev``."""

    def init(params):
        state = {"count": 0, "nu": [torch.full_like(p, initial_scale) for p in params]}
        if centered:
            state["mu"] = _zeros(params)
        return state

    def update(grads, state, params):
        count = state["count"] + 1
        nu = [(1 - decay) * (g * g) + decay * n for g, n in zip(grads, state["nu"])]
        correction = _bias_correction(decay, count) if bias_correction else 1.0
        nu_hat = [n / correction for n in nu] if bias_correction else nu
        new_state = {"count": count, "nu": nu}
        if centered:
            mu = [(1 - decay) * g + decay * m for g, m in zip(grads, state["mu"])]
            mu_hat = [m / correction for m in mu] if bias_correction else mu
            nu_hat = [n - m * m for n, m in zip(nu_hat, mu_hat)]
            new_state["mu"] = mu
        if eps_in_sqrt:
            scaling = [torch.rsqrt(n + eps) for n in nu_hat]
        else:
            scaling = [1 / (torch.sqrt(n) + eps) for n in nu_hat]
        return [s * g for s, g in zip(scaling, grads)], new_state

    return GradientTransformation(init, update)


def _scale_by_rss(initial_accumulator_value: float, eps: float) -> GradientTransformation:
    def init(params):
        return [torch.full_like(p, initial_accumulator_value) for p in params]

    def update(grads, state, params):
        sums = [g * g + t for g, t in zip(grads, state)]
        inv = [torch.where(t > 0, torch.rsqrt(t + eps), torch.zeros_like(t)) for t in sums]
        return [i * g for i, g in zip(inv, grads)], sums

    return GradientTransformation(init, update)


def _scale_by_adamax(b1: float, b2: float, eps: float) -> GradientTransformation:
    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(grads, state, params):
        count = state["count"] + 1
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state["mu"])]
        nu = [torch.maximum(g.abs() + eps, b2 * n) for g, n in zip(grads, state["nu"])]
        correction = _bias_correction(b1, count)
        updates = [(m / correction) / n for m, n in zip(mu, nu)]
        return updates, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def _trace(decay: float, nesterov: bool) -> GradientTransformation:
    def update(grads, state, params):
        trace = [g + decay * t for g, t in zip(grads, state)]
        updates = [g + decay * t for g, t in zip(grads, trace)] if nesterov else trace
        return updates, trace

    return GradientTransformation(_zeros, update)


def _add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(grads, state, params):
        return [g + weight_decay * p for g, p in zip(grads, params)], state

    return GradientTransformation(lambda params: (), update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0, *, nesterov: bool = False) -> GradientTransformation:
    return _chain(_scale_by_adam(b1, b2, eps, eps_root, nesterov),
                  _scale_by_learning_rate(learning_rate))


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, weight_decay: float = 1e-4, *,
          nesterov: bool = False) -> GradientTransformation:
    return _chain(_scale_by_adam(b1, b2, eps, eps_root, nesterov),
                  _add_decayed_weights(weight_decay), _scale_by_learning_rate(learning_rate))


def nadam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, *, nesterov: bool = True) -> GradientTransformation:
    return adam(learning_rate, b1, b2, eps, eps_root, nesterov=nesterov)


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> GradientTransformation:
    transforms = [] if momentum is None else [_trace(momentum, nesterov)]
    return _chain(*transforms, _scale_by_learning_rate(learning_rate))


def rmsprop(learning_rate: float, decay: float = 0.9, eps: float = 1e-8,
            initial_scale: float = 0.0, eps_in_sqrt: bool = True, centered: bool = False,
            momentum: Optional[float] = None, nesterov: bool = False,
            bias_correction: bool = False) -> GradientTransformation:
    transforms = [
        _scale_by_rms(decay, eps, initial_scale, eps_in_sqrt, bias_correction, centered),
        _scale_by_learning_rate(learning_rate),
    ]
    if momentum is not None:
        transforms.append(_trace(momentum, nesterov))
    return _chain(*transforms)


def adagrad(learning_rate: float, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> GradientTransformation:
    return _chain(_scale_by_rss(initial_accumulator_value, eps),
                  _scale_by_learning_rate(learning_rate))


def adamax(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
           eps: float = 1e-8) -> GradientTransformation:
    return _chain(_scale_by_adamax(b1, b2, eps), _scale_by_learning_rate(learning_rate))


_OPTIMIZERS: Dict[str, Callable[..., GradientTransformation]] = {
    "adam": adam,
    "adamw": adamw,
    "sgd": sgd,
    "rmsprop": rmsprop,
    "adagrad": adagrad,
    "adamax": adamax,
    "nadam": nadam,
}

# Keras kwarg spellings → optax spellings
_KERAS_KWARG_MAP = {
    "lr": "learning_rate",
    "beta_1": "b1",
    "beta_2": "b2",
    "epsilon": "eps",
    "rho": "decay",  # RMSprop's smoothing constant
}


def make_optimizer(
    optimizer: str = "Adam", optimizer_kwargs: Optional[Dict[str, Any]] = None
) -> GradientTransformation:
    """Keras optimizer name + kwargs → the optimizer, as the reference maps
    them: Keras spellings (``lr``, ``beta_1``, ``beta_2``, ``epsilon``,
    ``rho``) are translated, Keras' ``decay`` (a learning-rate schedule) is
    dropped with a warning, as is any kwarg the optimizer does not take,
    and the learning rate defaults to 1e-3."""
    raw = dict(optimizer_kwargs or {})
    if "decay" in raw:  # dropped BEFORE mapping: rmsprop's own `decay` is Keras' `rho`
        _log.warning(
            "Optimizer %s: Keras 'decay' (lr schedule) is not supported; ignored", optimizer
        )
        raw.pop("decay")
    kwargs = {_KERAS_KWARG_MAP.get(k, k): v for k, v in raw.items()}
    kwargs.setdefault("learning_rate", 1e-3)
    name = optimizer.lower()
    if name not in _OPTIMIZERS:
        raise ValueError(f"Unknown optimizer {optimizer!r}; supported: {sorted(_OPTIMIZERS)}")
    fn = _OPTIMIZERS[name]
    accepted = set(inspect.signature(fn).parameters)
    dropped = {k: kwargs.pop(k) for k in list(kwargs) if k not in accepted}
    if dropped:
        _log.warning("Optimizer %s ignores unsupported kwargs: %s", optimizer, sorted(dropped))
    return fn(**kwargs)


class ModelSpec(NamedTuple):
    """A ready-to-train model: module + optimizer + loss. ``input_kind`` is
    ``"flat"`` for ``(batch, F)`` models and ``"window"`` for ``(batch, L,
    F)`` ones; the estimator checks it against its own windowing."""

    module: nn.Module
    optimizer: GradientTransformation
    loss: str
    input_kind: str
    config: Dict[str, Any]  # JSON-able record of the resolved architecture
