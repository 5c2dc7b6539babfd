"""Plain PyTorch reference of a served PatchTST anomaly machine.

Nie et al., "A Time Series is Worth 64 Words: Long-term Forecasting with
Transformers", ICLR 2023 (arXiv:2211.14730): each channel's window is cut
into patches of ``patch_len`` rows every ``stride`` rows, embedded by one
linear map plus a learned position table, and run through a transformer
encoder shared by all channels; a flatten head maps the encoder's output
to the prediction. Departures from the paper, as the served model has
them:

- pre-norm encoder layers with LayerNorm (epsilon 1e-6) and one more
  LayerNorm after the last layer, where the paper uses BatchNorm after each
  sub-layer; no RevIN (the machine's own min-max scaler normalises);
- GELU in its tanh approximation;
- the head is ``Linear(n_patches * d_model, 1)`` per channel: one
  reconstructed value, of the window's last row, per channel and window
  (the paper forecasts ``pred_len`` rows);
- no dropout (inference).

Around the model, the anomaly scoring of a machine: inputs min-max scaled
per tag, sliding windows of ``lookback`` rows, the prediction mapped back
through the target scaler, its absolute error against the window's last
row scaled per tag by the error scaler, and the row's L2 norm.

Weights come as the flax-layout tree the benchmark made (Dense kernels
``(in, out)``; the q/k/v kernel ``(d, 3, heads, head_dim)``; the output
kernel ``(heads, head_dim, d)``). This file imports nothing but torch.

``mode`` selects the arithmetic of every matrix product: ``fp32`` (the
reference: float32, no TF32), or the controls a step below a stated
precision, with float32 accumulation: ``tf32`` (operands rounded to 10
mantissa bits, as the tensor cores' TF32 does) and ``fp8`` (operands
scaled per tensor to e4m3's range and rounded to it).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

LN_EPS = 1e-6
FP8_MAX = 448.0  # largest finite float8_e4m3fn


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Scale per tensor to e4m3's range, round to e4m3, scale back."""
    amax = x.abs().amax().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


_ROUND = {"fp32": None, "tf32": _round_tf32, "fp8": _round_fp8}


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    rnd = _ROUND[mode]
    if rnd is not None:
        a, b = rnd(a), rnd(b)
    return torch.matmul(a, b)


def _layer_norm(x: torch.Tensor, norm: Dict[str, torch.Tensor]) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * norm["scale"] + norm["bias"]


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _dense(x: torch.Tensor, dense: Dict[str, torch.Tensor], mode: str) -> torch.Tensor:
    kernel = dense["kernel"]
    return matmul(x, kernel.reshape(-1, kernel.shape[-1]), mode) + dense["bias"]


def forward(tree: Dict, windows: torch.Tensor, model: Dict, mode: str = "fp32") -> torch.Tensor:
    """``(B, L, F)`` scaled windows -> ``(B, F)`` predictions."""
    batch, _, tags = windows.shape
    pl, stride = model["patch_length"], model["stride"]
    heads, d = model["n_heads"], model["d_model"]
    hd = d // heads
    patches = windows.transpose(1, 2).unfold(2, pl, stride)  # (B, F, P, pl)
    n_patches = patches.shape[2]
    h = _dense(patches, tree["Dense_0"], mode) + tree["pos_embedding"]  # (B, F, P, d)
    for i in range(model["n_layers"]):
        layer = tree[f"TransformerEncoderLayer_{i}"]
        attn = layer["MultiHeadSelfAttention_0"]
        a = _layer_norm(h, layer["LayerNorm_0"])
        qkv = matmul(a, attn["qkv"]["kernel"].reshape(d, 3 * d), mode) + attn["qkv"]["bias"].reshape(3 * d)
        q, k, v = qkv.reshape(batch, tags, n_patches, 3, heads, hd).permute(3, 0, 1, 4, 2, 5)
        logits = matmul(q, k.transpose(-1, -2), mode) * hd ** -0.5  # (B, F, H, P, P)
        o = matmul(torch.softmax(logits, dim=-1), v, mode)  # (B, F, H, P, hd)
        o = o.permute(0, 1, 3, 2, 4).reshape(batch, tags, n_patches, d)
        h = h + matmul(o, attn["out"]["kernel"].reshape(d, d), mode) + attn["out"]["bias"]
        a = _layer_norm(h, layer["LayerNorm_1"])
        f = _gelu_tanh(_dense(a, layer["Dense_0"], mode))
        h = h + _dense(f, layer["Dense_1"], mode)
    h = _layer_norm(h, tree["LayerNorm_0"])
    flat = h.reshape(batch, tags, n_patches * d)
    return _dense(flat, tree["Dense_1"], mode)[..., 0]


def minmax(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tag ``(scale, offset)`` mapping ``rows``' range onto [0, 1]
    (a tag of zero range maps to 0)."""
    lo, hi = rows.amin(0), rows.amax(0)
    span = hi - lo
    scale = 1.0 / torch.where(span < 1e-12, torch.ones_like(span), span)
    return scale, -lo * scale


def score(tree: Dict, scalers: Dict[str, Tuple[torch.Tensor, torch.Tensor]], rows: torch.Tensor,
          model: Dict, mode: str = "fp32", block: int = 32) -> Dict[str, torch.Tensor]:
    """One request's anomaly answer: ``rows`` ``(n, F)`` -> the four score
    arrays, one row per window (the window's last row), the windows run
    ``block`` at a time. ``scalers`` holds ``x`` (inputs), ``y`` (targets)
    and ``e`` (errors), each ``(scale, offset)``."""
    lookback = model["lookback_window"]
    (sx, ox), (sy, oy), (se, oe) = scalers["x"], scalers["y"], scalers["e"]
    scaled = rows * sx + ox
    n_win = rows.shape[0] - lookback + 1
    preds = []
    for start in range(0, n_win, block):
        stop = min(n_win, start + block)
        windows = scaled.unfold(0, lookback, 1)[start:stop].transpose(1, 2)  # (b, L, F)
        preds.append(forward(tree, windows, model, mode))
    pred = (torch.cat(preds) - oy) / sy
    y = rows[lookback - 1:]
    err = (y - pred).abs() * se + oe
    return {"model-input": y, "model-output": pred, "tag-anomaly-scores": err,
            "total-anomaly-score": torch.linalg.vector_norm(err, dim=-1)}
