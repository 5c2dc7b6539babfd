"""The yardstick's arithmetic: operations a scored window needs, counted
from the configuration's widths by the published equations, the attention
kernel's least operations and bytes from its shapes, and the card's
peaks. Nothing here is taken from the program, so a change to the
program's own accounting cannot move a metric."""

from __future__ import annotations

from typing import Dict

from .data import n_patches

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
# 700 W power limit
PEAKS = {
    "tf32": 495e12,       # TF32 tensor cores
    "bf16": 989e12,       # bf16 tensor cores
    "fp32_simt": 67e12,   # float32 outside the tensor cores
    "hbm_bytes_per_s": 3.35e12,
}


def flops_per_window(model: Dict, tags: int) -> float:
    """Matrix-product operations (2 per multiply-add) of one window: the
    patch embedding, per layer the q/k/v and output projections, the
    scores and the weighted sum over every patch, the feed-forward pair,
    and the flatten head; LayerNorm, GELU and softmax are not counted."""
    d, ff, pl = model["d_model"], model["ff_dim"], model["patch_length"]
    p = n_patches(model)
    embed = 2 * pl * d
    layer = 2 * d * 3 * d + 2 * d * d + 2 * 2 * p * d + 2 * 2 * d * ff
    head = 2 * d  # Linear(p * d, 1) per channel, spread over its p tokens
    return float(tags * p * (embed + model["n_layers"] * layer + head))


def attention_work(model: Dict, tags: int, windows: float, elem_bytes: int) -> Dict[str, float]:
    """One layer's attention over ``windows`` windows, as the kernel's
    least work: 4*BH*S^2*D operations; q, k and v read once, the output
    and the float32 log-sum-exp written once."""
    heads, d = model["n_heads"], model["d_model"]
    bh, s, hd = windows * tags * heads, n_patches(model), d // heads
    return {"flops": 4.0 * bh * s * s * hd,
            "bytes": bh * s * (4 * hd * elem_bytes + 4)}


def least_seconds(work: Dict[str, float], peak_flops: float) -> float:
    """The roofline: the larger of operations over the peak rate and bytes
    over the memory bandwidth."""
    return max(work["flops"] / peak_flops, work["bytes"] / PEAKS["hbm_bytes_per_s"])
