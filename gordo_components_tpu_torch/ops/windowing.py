"""Sliding-window primitives (port of ``gordo_components_tpu/ops/windowing.py``).

THE OFF-BY-ONE CONTRACT, unchanged from the reference (pinned by
``tests/test_ops.py`` there and ``tests/test_torch_ops.py`` here):

Given ``x`` with ``n`` rows and ``lookback_window = L``:

- ``sliding_windows(x, L)`` → shape ``(n - L + 1, L, F)``; window ``i`` is
  rows ``[i, i+L)``.
- **Reconstruction**: window ``i`` targets its own last row ``x[i+L-1]``.
- **Forecast** (``lookahead = k >= 1``): window ``i`` targets
  ``x[i+L-1+k]``; ``n - L + 1 - k`` usable windows.

``sliding_windows`` returns a strided view (``Tensor.unfold``), not a
copy: the windows of one request overlap in all but one row, and the
model's first step reads them once.
"""

from __future__ import annotations

import numpy as np
import torch


def n_windows(n_rows: int, lookback_window: int, lookahead: int = 0) -> int:
    """Number of usable windows for ``n_rows`` of input."""
    if lookback_window < 1:
        raise ValueError(f"lookback_window must be >= 1, got {lookback_window}")
    if not isinstance(lookahead, (int, np.integer)) or lookahead < 0:
        raise ValueError(f"lookahead must be an int >= 0, got {lookahead}")
    return max(0, n_rows - lookback_window + 1 - lookahead)


def sliding_windows(
    x: torch.Tensor, lookback_window: int, lookahead: int = 0
) -> torch.Tensor:
    """``(n, F) → (n - L + 1 - lookahead, L, F)`` windows (a view of ``x``)."""
    count = n_windows(x.shape[0], lookback_window, lookahead)
    if count <= 0:
        raise ValueError(
            f"Need at least lookback_window+lookahead={lookback_window + lookahead} "
            f"rows, got {x.shape[0]}"
        )
    # unfold → (n - L + 1, F, L); trailing windows beyond ``count`` belong
    # to no target under a forecast contract
    return x.unfold(0, lookback_window, 1)[:count].transpose(1, 2)


def gather_windows(rows: torch.Tensor, starts: torch.Tensor, lookback_window: int) -> torch.Tensor:
    """``(n, F)`` rows + ``(k,)`` window-start indices → ``(k, L, F)``.

    The lazy twin of :func:`sliding_windows`: a training loop batches over
    start indices and gathers each batch's windows when it runs, so the
    device holds the ``(n, F)`` rows and never the L×-larger window tensor.
    Window ``i`` is rows ``[starts[i], starts[i] + L)`` — the same index
    arithmetic as :func:`sliding_windows`, whose strided view this indexes.
    Every start must be in ``[0, n - L]``."""
    return sliding_windows(rows, lookback_window)[starts]


def reconstruction_targets(x: torch.Tensor, lookback_window: int) -> torch.Tensor:
    """Row ``i+L-1`` per window."""
    return x[lookback_window - 1 :]


def forecast_targets(
    x: torch.Tensor, lookback_window: int, lookahead: int = 1
) -> torch.Tensor:
    """Row ``i + L - 1 + lookahead`` per window."""
    if lookahead < 1:
        raise ValueError(
            f"forecast lookahead must be >= 1, got {lookahead} "
            "(use reconstruction_targets for lookahead=0)"
        )
    return x[lookback_window - 1 + lookahead :]


def multi_step_targets(x, lookback_window: int, horizon: int):
    """Joint-horizon targets: ``(n, F) → (count, horizon, F)``, window ``i``
    targeting rows ``[i + L, i + L + horizon)``; zips with
    ``sliding_windows(x, L, lookahead=horizon)``."""
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    count = n_windows(x.shape[0], lookback_window, horizon)
    if count <= 0:
        raise ValueError(
            f"Need at least lookback_window+horizon={lookback_window + horizon} "
            f"rows, got {x.shape[0]}"
        )
    idx = np.arange(count)[:, None] + lookback_window + np.arange(horizon)[None, :]
    return x[idx]


def window_output_index(
    n_rows: int, lookback_window: int, lookahead: int = 0
) -> np.ndarray:
    """Input-row index each prediction row corresponds to."""
    count = n_windows(n_rows, lookback_window, lookahead)
    return np.arange(count) + lookback_window - 1 + lookahead
