"""Dense scaled-dot-product attention (port of ``dense_attention`` in
``gordo_components_tpu/ops/attention.py``).

Plain PyTorch: the reference computes it outside any Pallas kernel, and
the port keeps it for sequences that fit one tile (see
:func:`gordo_components_tpu_torch.ops.flash_attention.flash_attention`).
Ring attention over ``torch.distributed`` is a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q/k/v ``(..., seq, heads, head_dim)`` → ``(..., seq, heads, head_dim)``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("...hqk,...khd->...qhd", weights, v)
