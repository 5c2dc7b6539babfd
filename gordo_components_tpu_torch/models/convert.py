"""Carry flax parameters across into the port's modules.

``state.npz`` holds a fitted estimator's flax parameter tree as nested
``…/params/<scope>/<leaf>`` arrays. :func:`params_from_flax` copies such a
tree (a nested dict of numpy arrays) into a
:class:`~gordo_components_tpu_torch.models.factories.transformer.PatchTSTModule`.

Flax's tree for PatchTST (auto-named scopes, in creation order):

- ``Dense_0`` patch embedding, kernel ``(patch_len, d)``; ``pos_embedding (P, d)``;
- ``TransformerEncoderLayer_i/{LayerNorm_0, MultiHeadSelfAttention_0/{qkv
  kernel (d, 3, H, hd), bias (3, H, hd); out kernel (H, hd, d), bias (d,)},
  LayerNorm_1, Dense_0, Dense_1}``;
- ``LayerNorm_0`` final norm; ``Dense_1`` head ``(P·d, 1)``; ``Dense_2``
  target projection, present only when ``n_features_out != n_features``.

Flax Dense kernels are ``(in, out)``; ``nn.Linear`` wants ``(out, in)``,
so every kernel is flattened to ``(in, out)`` and transposed once here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from .factories.transformer import PatchTSTModule


def _copy(target: torch.Tensor, value: Any, where: str) -> None:
    value = torch.from_numpy(np.array(value, dtype=np.float32))
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(
            f"params_from_flax: {where} has shape {tuple(value.shape)}, the "
            f"module expects {tuple(target.shape)}"
        )
    with torch.no_grad():
        target.copy_(value)


def _dense(layer: nn.Linear, scope: Mapping[str, Any], where: str) -> None:
    kernel = np.asarray(scope["kernel"])
    kernel = kernel.reshape(layer.in_features, -1)  # DenseGeneral → (in, out)
    _copy(layer.weight, kernel.T, f"{where}/kernel")
    _copy(layer.bias, np.asarray(scope["bias"]).reshape(-1), f"{where}/bias")


def _dense_general_out(layer: nn.Linear, scope: Mapping[str, Any], where: str) -> None:
    kernel = np.asarray(scope["kernel"])  # (H, hd, d): contracts the last two input axes
    _copy(layer.weight, kernel.reshape(-1, kernel.shape[-1]).T, f"{where}/kernel")
    _copy(layer.bias, scope["bias"], f"{where}/bias")


def _norm(norm: nn.LayerNorm, scope: Mapping[str, Any], where: str) -> None:
    _copy(norm.weight, scope["scale"], f"{where}/scale")
    _copy(norm.bias, scope["bias"], f"{where}/bias")


def params_from_flax(module: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Load the flax parameter ``tree`` into ``module`` in place (and
    return it). Raises on a missing scope or a shape that disagrees."""
    if not isinstance(module, PatchTSTModule):
        raise TypeError(
            f"params_from_flax supports PatchTSTModule; got {type(module).__name__}"
        )
    try:
        _dense(module.patch_embed, tree["Dense_0"], "Dense_0")
        _copy(module.pos_embedding, tree["pos_embedding"], "pos_embedding")
        for i, layer in enumerate(module.layers):
            name = f"TransformerEncoderLayer_{i}"
            scope = tree[name]
            attn = scope["MultiHeadSelfAttention_0"]
            _norm(layer.norm1, scope["LayerNorm_0"], f"{name}/LayerNorm_0")
            _dense(layer.attn.qkv, attn["qkv"], f"{name}/qkv")
            _dense_general_out(layer.attn.out, attn["out"], f"{name}/out")
            _norm(layer.norm2, scope["LayerNorm_1"], f"{name}/LayerNorm_1")
            _dense(layer.ff1, scope["Dense_0"], f"{name}/Dense_0")
            _dense(layer.ff2, scope["Dense_1"], f"{name}/Dense_1")
        _norm(module.norm, tree["LayerNorm_0"], "LayerNorm_0")
        _dense(module.head, tree["Dense_1"], "Dense_1")
        if module.head_out is not None:
            _dense(module.head_out, tree["Dense_2"], "Dense_2")
    except KeyError as exc:
        raise ValueError(
            f"params_from_flax: flax tree has no scope {exc.args[0]!r}"
        ) from None
    expected = {"Dense_0", "Dense_1", "LayerNorm_0", "pos_embedding"}
    expected |= {f"TransformerEncoderLayer_{i}" for i in range(len(module.layers))}
    if module.head_out is not None:
        expected.add("Dense_2")
    extra = set(tree) - expected
    if extra:
        raise ValueError(f"params_from_flax: unexpected flax scopes {sorted(extra)}")
    return module
