"""PatchTST transformer factory (port of
``gordo_components_tpu/models/factories/transformer.py:37-322``).

Channel-independent patching: each tag's lookback window is cut into
patches, embedded, run through a shared pre-norm transformer encoder, and
a linear head per channel emits the reconstruction. The attention core is
``dense`` (plain PyTorch), ``flash`` (the hand-written CUDA kernel on the
card; see :mod:`gordo_components_tpu_torch.ops.flash_attention`), or
``ring`` / ``ring_flash``: the patch axis split over the ranks of the ring
group (:func:`~gordo_components_tpu_torch.ops.attention.set_ring_group`;
unset, one rank), each hop dense or the flash kernel (see
:mod:`gordo_components_tpu_torch.ops.attention`).

Parity with the flax modules, point by point:

- flax ``nn.gelu`` is the tanh approximation; flax ``LayerNorm`` uses
  ``epsilon=1e-6``;
- patches are the slices ``[s, s + patch_length)`` for ``s`` in
  ``range(0, window - patch_length + 1, stride)`` — ``Tensor.unfold``;
- the q/k/v projection is one ``(d_model → 3·H·hd)`` matrix whose output
  is read as ``(3, H, hd)`` row-major, like flax's ``DenseGeneral``;
- the head is one ``Dense(1)`` over the row-major ``(B, F, P·d_model)``
  flatten, followed by a second Dense only when ``n_features_out !=
  n_features``; the output is float32.

Every layer computes in ``compute_dtype``: weights are cast to it at use
(so weights stored in bfloat16 for the bf16 serving rung compute in
float32 when the architecture says float32, as flax promotes them), every
Dense rounds its product before it adds its bias (:func:`~..modules.linear`,
flax's two roundings in bf16), and LayerNorm statistics are taken in
float32.

Training, as the reference trains: with a dropout ``generator`` the forward
applies dropout after the patch embedding and on both residual branches,
and on the attention weights of the dense path (the flash path never
materialises them, so it and the ring paths train with residual dropout
only); ``remat``
recomputes each encoder layer in the backward pass
(``torch.utils.checkpoint``) and leaves the parameters as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ...ops.attention import dense_attention, ring_attention, ring_group, ring_size
from ...ops.flash_attention import flash_attention, launches_kernel
from ..modules import (KeyStream, activation, dropout, dropout_generator, linear,
                       replay_generator, resolve_dtype)
from ..register import register_model_factory
from .spec import ModelSpec, make_optimizer

_LN_EPS = 1e-6
_ATTENTION_IMPLS = ("dense", "flash", "ring", "ring_flash")


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    out = F.layer_norm(
        x.float(), norm.normalized_shape, norm.weight.float(),
        norm.bias.float(), _LN_EPS,
    )
    return out.to(x.dtype)


class MultiHeadSelfAttention(nn.Module):
    """Fused q/k/v projection, attention core, output projection."""

    def __init__(self, d_model: int, n_heads: int, attention_impl: str = "dense",
                 dropout_rate: float = 0.0):
        super().__init__()
        if d_model % n_heads != 0:
            raise ValueError(
                f"d_model ({d_model}) must be divisible by n_heads ({n_heads})"
            )
        if attention_impl not in _ATTENTION_IMPLS:
            raise ValueError(
                f"Unknown attention_impl {attention_impl!r}; "
                "use 'dense', 'flash', 'ring', or 'ring_flash'"
            )
        self.n_heads = n_heads
        self.head_dim = d_model // n_heads
        self.attention_impl = attention_impl
        self.dropout_rate = dropout_rate
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(
        self, x: torch.Tensor, generator: Optional[KeyStream] = None
    ) -> torch.Tensor:
        qkv = linear(x, self.qkv).unflatten(-1, (3, self.n_heads, self.head_dim))
        q, k, v = qkv.unbind(dim=-3)  # each (..., seq, heads, head_dim)
        if self.attention_impl in ("ring", "ring_flash"):
            out = ring_attention(
                q, k, v, group=ring_group(),
                block_impl="flash" if self.attention_impl == "ring_flash" else "dense",
            )
        elif self.attention_impl == "flash":
            out = flash_attention(q, k, v)
        elif self.dropout_rate > 0.0 and generator is not None:
            # the weights are materialised here, so dropout can reach them
            logits = torch.einsum("...qhd,...khd->...hqk", q, k) * self.head_dim**-0.5
            weights = dropout(torch.softmax(logits, dim=-1), self.dropout_rate, generator)
            out = torch.einsum("...hqk,...khd->...qhd", weights, v)
        else:
            out = dense_attention(q, k, v)
        return linear(out.flatten(-2), self.out)


class TransformerEncoderLayer(nn.Module):
    """Pre-norm encoder block; dropout only under a ``generator``."""

    def __init__(self, d_model: int, n_heads: int, ff_dim: int, attention_impl: str,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.norm1 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.attn = MultiHeadSelfAttention(d_model, n_heads, attention_impl, dropout_rate)
        self.norm2 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.ff1 = nn.Linear(d_model, ff_dim)
        self.ff2 = nn.Linear(ff_dim, d_model)

    def forward(
        self, x: torch.Tensor, generator: Optional[KeyStream] = None
    ) -> torch.Tensor:
        h = self.attn(_layer_norm(x, self.norm1), generator)
        x = x + dropout(h, self.dropout_rate, generator)
        h = linear(_layer_norm(x, self.norm2), self.ff1)
        h = linear(F.gelu(h, approximate="tanh"), self.ff2)
        return x + dropout(h, self.dropout_rate, generator)


class PatchTSTModule(nn.Module):
    """``(batch, L, F) → (batch, F_out)`` channel-independent PatchTST."""

    def __init__(
        self,
        n_features: int,
        n_features_out: int,
        lookback_window: int,
        patch_length: int,
        stride: int,
        d_model: int,
        n_heads: int,
        n_layers: int,
        ff_dim: int,
        out_func: str = "linear",
        compute_dtype: Any = "float32",
        attention_impl: str = "dense",
        dropout_rate: float = 0.0,
        remat: bool = False,
    ):
        super().__init__()
        self.n_features = n_features
        self.dropout_rate = dropout_rate
        self.remat = remat
        self.lookback_window = lookback_window
        self.patch_length = patch_length
        self.stride = stride
        self.d_model = d_model
        self.n_patches = (lookback_window - patch_length) // stride + 1
        self.out_func = out_func
        self.dtype = resolve_dtype(compute_dtype)
        self.patch_embed = nn.Linear(patch_length, d_model)
        self.pos_embedding = nn.Parameter(torch.zeros(self.n_patches, d_model))
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, n_heads, ff_dim, attention_impl, dropout_rate)
            for _ in range(n_layers)
        )
        self.norm = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.head = nn.Linear(self.n_patches * d_model, 1)
        self.head_out = (
            nn.Linear(n_features, n_features_out)
            if n_features_out != n_features
            else None
        )

    def flash_dtype(self) -> Optional[torch.dtype]:
        """The dtype of the flash kernel this module's forward launches (its
        compute dtype), or None where its attention is dense (or ring) or a
        flash patch sequence fits one tile: what a caller must load before
        it runs. A ``ring_flash`` hop always launches the kernel."""
        impls = {layer.attn.attention_impl for layer in self.layers}
        if "ring_flash" in impls or ("flash" in impls and launches_kernel(self.n_patches)):
            return self.dtype
        return None

    def forward(
        self, x: torch.Tensor, generator: Optional[KeyStream] = None
    ) -> torch.Tensor:
        batch, window, n_features = x.shape
        if window != self.lookback_window or n_features != self.n_features:
            raise ValueError(
                f"PatchTST expects (batch, {self.lookback_window}, "
                f"{self.n_features}) windows, got {tuple(x.shape)}"
            )
        channels = x.to(self.dtype).transpose(1, 2)  # (B, F, L)
        patches = channels.unfold(2, self.patch_length, self.stride)  # (B, F, P, pl)
        h = patches.reshape(batch * n_features, self.n_patches, self.patch_length)
        h = linear(h, self.patch_embed) + self.pos_embedding.to(self.dtype)
        h = dropout(h, self.dropout_rate, generator)
        for layer in self.layers:
            # each layer draws from a generator of its own, so that a layer
            # recomputed under remat draws the masks it drew the first time
            layer_gen = dropout_generator(generator)
            if self.remat and torch.is_grad_enabled():
                h = torch.utils.checkpoint.checkpoint(
                    self._run_layer, layer, h, layer_gen, use_reentrant=False
                )
            else:
                h = layer(h, layer_gen)
        h = _layer_norm(h, self.norm)
        flat = h.reshape(batch, n_features, self.n_patches * self.d_model)
        out = linear(flat, self.head)[..., 0]  # per-channel head (B, F)
        if self.head_out is not None:
            out = linear(out, self.head_out)
        return activation(self.out_func)(out).float()

    @staticmethod
    def _run_layer(layer, h, generator):
        generator = replay_generator(generator)  # a recompute starts from the layer's own seed
        return layer(h, generator)


@register_model_factory("patchtst")
def patchtst(
    n_features: int,
    n_features_out: Optional[int] = None,
    lookback_window: int = 32,
    patch_length: int = 8,
    stride: Optional[int] = None,
    d_model: int = 64,
    n_heads: int = 4,
    n_layers: int = 2,
    ff_dim: Optional[int] = None,
    dropout: float = 0.0,
    out_func: str = "linear",
    optimizer: str = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    loss: str = "mse",
    compute_dtype: str = "float32",
    attention_impl: str = "dense",
    remat: bool = False,
    **unknown: Any,
) -> ModelSpec:
    """Validation and config as the reference's factory. ``dropout``,
    ``remat`` and ``optimizer*`` shape training only; the config keeps them,
    so artifacts round-trip."""
    if unknown:
        raise ValueError(
            f"Unknown hyperparameters for kind 'patchtst': {sorted(unknown)}"
        )
    if lookback_window < patch_length:
        raise ValueError(
            f"lookback_window ({lookback_window}) must be >= patch_length "
            f"({patch_length})"
        )
    stride = stride or max(1, patch_length // 2)
    ff_dim = ff_dim or 2 * d_model
    n_features_out = n_features_out or n_features
    if attention_impl not in _ATTENTION_IMPLS:
        raise ValueError(
            f"Unknown attention_impl {attention_impl!r}; "
            "use 'dense', 'flash', 'ring', or 'ring_flash'"
        )
    if d_model % n_heads != 0:
        raise ValueError(
            f"d_model ({d_model}) must be divisible by n_heads ({n_heads})"
        )
    if attention_impl in ("ring", "ring_flash"):
        n_patches = (lookback_window - patch_length) // stride + 1
        n_devices = ring_size(ring_group())
        if n_patches % n_devices != 0:
            raise ValueError(
                f"attention_impl={attention_impl!r} shards the patch axis "
                f"over {n_devices} device(s), but {n_patches} patches do "
                "not divide evenly; pick lookback_window/patch_length/"
                "stride so (lookback_window - patch_length)//stride + 1 is "
                "a multiple of the device count"
            )
    module = PatchTSTModule(
        n_features=n_features,
        n_features_out=n_features_out,
        lookback_window=lookback_window,
        patch_length=patch_length,
        stride=stride,
        d_model=d_model,
        n_heads=n_heads,
        n_layers=n_layers,
        ff_dim=ff_dim,
        out_func=out_func,
        compute_dtype=compute_dtype,
        attention_impl=attention_impl,
        dropout_rate=dropout,
        remat=remat,
    )
    config = {
        "n_features": n_features,
        "n_features_out": n_features_out,
        "lookback_window": lookback_window,
        "patch_length": patch_length,
        "stride": stride,
        "d_model": d_model,
        "n_heads": n_heads,
        "n_layers": n_layers,
        "ff_dim": ff_dim,
        "dropout": dropout,
        "out_func": out_func,
        "optimizer": optimizer,
        "optimizer_kwargs": dict(optimizer_kwargs or {}),
        "loss": loss,
        "compute_dtype": compute_dtype,
        "attention_impl": attention_impl,
        "remat": remat,
    }
    return ModelSpec(
        module=module,
        optimizer=make_optimizer(optimizer, optimizer_kwargs),
        loss=loss,
        input_kind="window",
        config=config,
    )
