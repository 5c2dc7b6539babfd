"""The training loop (port of ``gordo_components_tpu/models/train.py``).

The reference compiles the whole fit into one XLA program (``lax.scan``
over epochs and mini-batches); the port runs the same loop eagerly, one
optimizer step per mini-batch, with the reference's contract:

- inputs are padded to a whole number of batches, with a per-row weight
  ``w`` (1 on real rows, 0 on padding), and each batch's loss is the
  weighted mean over its real rows;
- every epoch draws one permutation of the rows and walks it in batches;
  the epoch's loss is the batch losses weighted by their real rows;
- ``fit(params, X, y, w, generator, perms=None)`` takes the parameters as
  a dict of leaf tensors and updates them in place (optax returns new
  ones). ``generator`` is a CPU ``torch.Generator``: it draws each epoch's
  permutation and, with dropout, each step's mask key (a
  :class:`.modules.KeyStream`). The port cannot draw ``jax.random``,
  so ``perms`` (one permutation per epoch) lets a caller give the
  reference's order instead.

Gradients are taken under ``torch.enable_grad()`` inside the step, so a
fit called from a thread under ``no_grad`` or ``inference_mode`` still
trains, and grad mode never leaks out: it is thread-local, and serving
threads keep their own. The loss history is read back once, after the
last epoch. The loop runs under the numeric sanitizer while it is on
(``utils.backend.nan_guard``): a NaN made in a forward or a backward op
raises ``FloatingPointError`` at that op.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.backend import nan_guard
from .factories.spec import GradientTransformation, apply_updates
from .modules import KeyStream

Params = Dict[str, torch.Tensor]
# apply_fn(params, x, dropout KeyStream or None) -> predictions
ApplyFn = Callable[[Params, torch.Tensor, Optional[KeyStream]], torch.Tensor]


def _huber(diff: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """``optax.huber_loss`` against a zero target, delta 1."""
    abs_err = diff.abs()
    quadratic = torch.clamp(abs_err, max=delta)
    return 0.5 * quadratic * quadratic + delta * (abs_err - quadratic)


_LOSSES = {
    "mse": lambda diff: diff * diff,
    "mean_squared_error": lambda diff: diff * diff,
    "mae": torch.abs,
    "mean_absolute_error": torch.abs,
    "huber": _huber,
}


def make_loss_fn(apply_fn: ApplyFn, loss: str = "mse") -> Callable:
    """Weighted per-sample loss: ``(params, x, y, w, generator) → scalar``;
    ``w`` masks padding rows and the mean is over real rows only."""
    if loss not in _LOSSES:
        raise ValueError(f"Unknown loss {loss!r}; supported: {sorted(_LOSSES)}")
    elementwise = _LOSSES[loss]

    def loss_fn(params, x, y, w, generator):
        per_sample = torch.mean(elementwise(apply_fn(params, x, generator) - y), dim=-1)
        return torch.sum(per_sample * w) / torch.clamp(torch.sum(w), min=1.0)

    return loss_fn


class FitResult(NamedTuple):
    params: Params
    loss_history: List[float]  # (epochs,) weighted mean loss per epoch


def make_batch_step(
    apply_fn: ApplyFn,
    optimizer: GradientTransformation,
    loss: str = "mse",
    use_dropout: bool = False,
) -> Callable:
    """One mini-batch step: ``(params, opt_state, (x, y, w, generator)) →
    (opt_state, batch loss, real rows)``; the parameters move in place."""
    loss_fn = make_loss_fn(apply_fn, loss)

    def batch_step(params: Params, opt_state: Any, batch: Tuple) -> Tuple[Any, torch.Tensor,
                                                                          torch.Tensor]:
        x, y, w, generator = batch
        values = list(params.values())
        with torch.enable_grad():
            batch_loss = loss_fn(params, x, y, w, generator if use_dropout else None)
            grads = torch.autograd.grad(batch_loss, values)
        with torch.no_grad():
            updates, opt_state = optimizer.update(list(grads), opt_state, values)
            apply_updates(values, updates)
        return opt_state, batch_loss.detach(), torch.sum(w)

    return batch_step


def make_fit_fn(
    apply_fn: ApplyFn,
    optimizer: GradientTransformation,
    loss: str = "mse",
    batch_size: int = 32,
    epochs: int = 1,
    shuffle: bool = True,
    use_dropout: bool = False,
) -> Callable:
    """The training loop: ``fit(params, X, y, w, generator, perms=None) ->
    FitResult``, where ``X.shape[0]`` is a multiple of ``batch_size`` (see
    :func:`pad_to_batches`). ``perms``, when given, is one permutation of
    ``range(X.shape[0])`` per epoch, used instead of drawing one."""
    batch_step = make_batch_step(apply_fn, optimizer, loss=loss, use_dropout=use_dropout)

    def fit(
        params: Params,
        X: torch.Tensor,
        y: torch.Tensor,
        w: torch.Tensor,
        generator: torch.Generator,
        perms: Optional[Sequence[Any]] = None,
    ) -> FitResult:
        n = X.shape[0]
        if n % batch_size:
            raise ValueError(f"{n} rows are not a whole number of batches of {batch_size}")
        if perms is not None and len(perms) != epochs:
            raise ValueError(f"got {len(perms)} permutations for {epochs} epochs")
        with nan_guard():
            opt_state = optimizer.init(list(params.values()))
            history = []
            for epoch in range(epochs):
                if perms is not None:
                    perm = torch.as_tensor(np.array(perms[epoch]), dtype=torch.long)
                elif shuffle:
                    perm = torch.randperm(n, generator=generator)
                else:
                    perm = torch.arange(n)
                perm = perm.to(X.device)
                losses, wsums = [], []
                for start in range(0, n, batch_size):
                    idx = perm[start:start + batch_size]
                    masks = None
                    if use_dropout:
                        key = torch.randint(0, 2**31, (), generator=generator)
                        masks = KeyStream(key.to(X.device))
                    opt_state, batch_loss, wsum = batch_step(
                        params, opt_state, (X[idx], y[idx], w[idx], masks)
                    )
                    losses.append(batch_loss)
                    wsums.append(wsum)
                losses, wsums = torch.stack(losses), torch.stack(wsums)
                history.append(torch.sum(losses * wsums) / torch.clamp(torch.sum(wsums), min=1.0))
            return FitResult(params=params, loss_history=torch.stack(history).tolist())

    return fit


def pad_to_batches(
    X: np.ndarray, y: np.ndarray, batch_size: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad ``(X, y)`` with zero rows to a multiple of ``batch_size``; returns
    ``(Xp, yp, w)`` where ``w`` is 1.0 on real rows, 0.0 on padding."""
    n = X.shape[0]
    if n == 0:
        raise ValueError("Cannot fit on an empty dataset")
    steps = max(1, -(-n // batch_size))
    pad = steps * batch_size - n
    w = np.ones(steps * batch_size, dtype=np.float32)
    if pad:
        X = np.concatenate([X, np.zeros((pad, *X.shape[1:]), X.dtype)])
        y = np.concatenate([y, np.zeros((pad, *y.shape[1:]), y.dtype)])
        w[n:] = 0.0
    return X, y, w


def make_predict_fn(apply_fn: ApplyFn) -> Callable:
    """Deterministic forward pass: ``(params, X) → predictions``."""

    def predict(params, X):
        with torch.no_grad(), nan_guard():
            return apply_fn(params, X, None)

    return predict
