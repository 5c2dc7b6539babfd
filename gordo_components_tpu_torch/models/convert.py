"""Carry flax parameters across into the port's modules, and back.

``state.npz`` holds a fitted estimator's flax parameter tree as nested
``…/params/<scope>/<leaf>`` arrays. :func:`params_from_flax` copies such a
tree (a nested dict of numpy arrays) into the port's module of the same
architecture; the module's type picks the loader. Flax names its scopes
automatically, in creation order:

- PatchTST (:class:`~.factories.transformer.PatchTSTModule`): ``Dense_0``
  patch embedding, kernel ``(patch_len, d)``; ``pos_embedding (P, d)``;
  ``TransformerEncoderLayer_i/{LayerNorm_0, MultiHeadSelfAttention_0/{qkv
  kernel (d, 3, H, hd), bias (3, H, hd); out kernel (H, hd, d), bias (d,)},
  LayerNorm_1, Dense_0, Dense_1}``; ``LayerNorm_0`` final norm;
  ``Dense_1`` head ``(P·d, 1)``; ``Dense_2`` target projection, present
  only when ``n_features_out != n_features``.
- Dense autoencoder (:class:`~.modules.DenseAutoencoderModule`):
  ``Dense_0 … Dense_n`` — the encoder, the decoder, then the output layer.
- LSTM (:class:`~.modules.LSTMModule`): ``OptimizedLSTMCell_i`` per layer,
  holding the input kernels ``ii, if, ig, io`` ``(F_in, units)`` without
  bias and the recurrent kernels ``hi, hf, hg, ho`` ``(units, units)`` with
  bias; then ``Dense_0``, the head on the last step's hidden state. There
  is no ``RNN_*`` scope: flax binds the cell to the module that made it.

Flax Dense kernels are ``(in, out)``; ``nn.Linear`` wants ``(out, in)``,
so every Dense kernel is flattened to ``(in, out)`` and transposed once
here. :func:`flax_from_params` writes a port-trained module back as such a
tree, so a port-trained artifact loads in the reference. The LSTM cell keeps flax's ``(in, out)`` layout, each gate's kernel
copied into its quarter of the last axis, in flax's order.

An int8 tree (:func:`quantized_params_from_flax`) carries one scale per
flax leaf. Reshapes and transposes commute with a per-tensor scale, but
the LSTM cell concatenates four gate leaves into one parameter, which then
needs a scale per gate: each parameter's scale is whatever the loader made
of its leaves' scales, cut down to the smallest shape that broadcasts to
the parameter (a scalar for a Dense kernel, a ``(4·units,)`` vector for an
LSTM kernel).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Set, Tuple

import numpy as np
import torch
from torch import nn

from .factories.transformer import PatchTSTModule
from .modules import DenseAutoencoderModule, LSTMModule

_GATES = ("i", "f", "g", "o")


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


def _load_patchtst(module: PatchTSTModule, tree: Mapping[str, Any]) -> Set[str]:
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
    expected = {"Dense_0", "Dense_1", "LayerNorm_0", "pos_embedding"}
    expected |= {f"TransformerEncoderLayer_{i}" for i in range(len(module.layers))}
    if module.head_out is not None:
        _dense(module.head_out, tree["Dense_2"], "Dense_2")
        expected.add("Dense_2")
    return expected


def _load_dense(module: DenseAutoencoderModule, tree: Mapping[str, Any]) -> Set[str]:
    names = [f"Dense_{i}" for i in range(len(module.layers))]
    for name, layer in zip(names, module.layers):
        _dense(layer, tree[name], name)
    return set(names)


def _load_lstm(module: LSTMModule, tree: Mapping[str, Any]) -> Set[str]:
    names = [f"OptimizedLSTMCell_{i}" for i in range(len(module.cells))]
    for name, cell in zip(names, module.cells):
        scope = tree[name]
        for k, gate in enumerate(_GATES):
            cols = slice(k * cell.units, (k + 1) * cell.units)
            _copy(cell.input_kernel[:, cols], scope[f"i{gate}"]["kernel"],
                  f"{name}/i{gate}/kernel")
            _copy(cell.recurrent_kernel[:, cols], scope[f"h{gate}"]["kernel"],
                  f"{name}/h{gate}/kernel")
            _copy(cell.recurrent_bias[cols], scope[f"h{gate}"]["bias"],
                  f"{name}/h{gate}/bias")
    _dense(module.head, tree["Dense_0"], "Dense_0")
    return {*names, "Dense_0"}


_LOADERS = (
    (PatchTSTModule, _load_patchtst),
    (DenseAutoencoderModule, _load_dense),
    (LSTMModule, _load_lstm),
)


def params_from_flax(module: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Load the flax parameter ``tree`` into ``module`` in place (and
    return it). Raises on a missing scope, an unexpected scope, or a shape
    that disagrees."""
    for cls, loader in _LOADERS:
        if isinstance(module, cls):
            break
    else:
        raise TypeError(
            "params_from_flax supports "
            f"{', '.join(cls.__name__ for cls, _ in _LOADERS)}; "
            f"got {type(module).__name__}"
        )
    try:
        expected = loader(module, tree)
    except KeyError as exc:
        raise ValueError(
            f"params_from_flax: flax tree has no scope {exc.args[0]!r}"
        ) from None
    extra = set(tree) - expected
    if extra:
        raise ValueError(f"params_from_flax: unexpected flax scopes {sorted(extra)}")
    return module


def _array(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _dense_tree(layer: nn.Linear, kernel_shape: Tuple[int, ...] = None,
                bias_shape: Tuple[int, ...] = None) -> Dict[str, np.ndarray]:
    """An ``nn.Linear`` as flax's Dense scope: the kernel back to ``(in,
    out)``, reshaped to a DenseGeneral's axes when given."""
    kernel = _array(layer.weight).T
    bias = _array(layer.bias)
    return {
        "kernel": kernel.reshape(kernel_shape) if kernel_shape else kernel,
        "bias": bias.reshape(bias_shape) if bias_shape else bias,
    }


def _norm_tree(norm: nn.LayerNorm) -> Dict[str, np.ndarray]:
    return {"scale": _array(norm.weight), "bias": _array(norm.bias)}


def _patchtst_tree(module: PatchTSTModule) -> Dict[str, Any]:
    tree: Dict[str, Any] = {
        "Dense_0": _dense_tree(module.patch_embed),
        "pos_embedding": _array(module.pos_embedding),
    }
    for i, layer in enumerate(module.layers):
        attn = layer.attn
        h, hd = attn.n_heads, attn.head_dim
        d = h * hd
        tree[f"TransformerEncoderLayer_{i}"] = {
            "LayerNorm_0": _norm_tree(layer.norm1),
            "MultiHeadSelfAttention_0": {
                "qkv": _dense_tree(attn.qkv, (d, 3, h, hd), (3, h, hd)),
                "out": _dense_tree(attn.out, (h, hd, d)),
            },
            "LayerNorm_1": _norm_tree(layer.norm2),
            "Dense_0": _dense_tree(layer.ff1),
            "Dense_1": _dense_tree(layer.ff2),
        }
    tree["LayerNorm_0"] = _norm_tree(module.norm)
    tree["Dense_1"] = _dense_tree(module.head)
    if module.head_out is not None:
        tree["Dense_2"] = _dense_tree(module.head_out)
    return tree


def _dense_ae_tree(module: DenseAutoencoderModule) -> Dict[str, Any]:
    return {f"Dense_{i}": _dense_tree(layer) for i, layer in enumerate(module.layers)}


def _lstm_tree(module: LSTMModule) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for i, cell in enumerate(module.cells):
        scope: Dict[str, Any] = {}
        for k, gate in enumerate(_GATES):
            cols = slice(k * cell.units, (k + 1) * cell.units)
            scope[f"i{gate}"] = {"kernel": _array(cell.input_kernel[:, cols])}
            scope[f"h{gate}"] = {"kernel": _array(cell.recurrent_kernel[:, cols]),
                                 "bias": _array(cell.recurrent_bias[cols])}
        tree[f"OptimizedLSTMCell_{i}"] = scope
    tree["Dense_0"] = _dense_tree(module.head)
    return tree


_TREES = (
    (PatchTSTModule, _patchtst_tree),
    (DenseAutoencoderModule, _dense_ae_tree),
    (LSTMModule, _lstm_tree),
)


def flax_from_params(module: nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`params_from_flax`: ``module``'s parameters as
    the reference's flax tree of float32 numpy arrays (what ``state.npz``
    holds under ``…/params``). Dense kernels go back to ``(in, out)`` (and
    to a DenseGeneral's axes), an LSTM cell's concatenated kernels back to
    flax's per-gate leaves."""
    for cls, tree_of in _TREES:
        if isinstance(module, cls):
            return tree_of(module)
    raise TypeError(
        f"flax_from_params supports {', '.join(cls.__name__ for cls, _ in _TREES)}; "
        f"got {type(module).__name__}"
    )


def _broadcast_form(ids: torch.Tensor) -> torch.Tensor:
    """``ids`` cut to size 1 along every axis it is constant on, then
    stripped of leading unit axes: the smallest tensor that broadcasts back
    to it."""
    for axis in range(ids.dim()):
        first = ids.narrow(axis, 0, 1)
        if torch.equal(ids, first.expand_as(ids)):
            ids = first
    while ids.dim() and ids.shape[0] == 1:
        ids = ids.squeeze(0)
    return ids


def quantized_params_from_flax(
    make_module: Callable[[], nn.Module], q_tree: Dict[str, Any], scale_tree: Dict[str, Any]
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """An int8 flax tree and its per-leaf scales in the port's layout:
    ``({name: int8 tensor}, {name: float32 scale})`` keyed like the
    module's ``state_dict``, each scale broadcastable to its tensor, so
    ``q.float() * scale`` is the float32 parameter that the dequantized
    flax tree would load (the same multiply of the same values).
    ``make_module`` builds a fresh module of the architecture.

    The loader runs twice: on the int8 values (exact in float32) and on a
    tree that fills each leaf with its own id, from which each parameter's
    scale layout is read off, so it depends on the structure and never on
    the values (machines of one architecture stack)."""
    scales = []

    def leaf_ids(q, s):
        if isinstance(q, dict):
            return {key: leaf_ids(q[key], s[key]) for key in q}
        scales.append(np.float32(s))
        return np.full(np.shape(q), len(scales), np.float32)  # ids from 1

    def fresh() -> nn.Module:
        with torch.device("meta"):
            module = make_module()
        module = module.to_empty(device="cpu")
        for p in module.parameters():
            p.data.zero_()
        return module

    ids = params_from_flax(fresh(), leaf_ids(q_tree, scale_tree)).state_dict()
    values = params_from_flax(fresh(), q_tree).state_dict()
    table = torch.from_numpy(np.asarray(scales, np.float32))
    q_state, s_state = {}, {}
    for name, value in values.items():
        if bool((ids[name] < 1).any()):
            raise ValueError(f"quantized_params_from_flax: {name} is not loaded from a flax leaf")
        q_state[name] = value.to(torch.int8)
        s_state[name] = table[_broadcast_form(ids[name]).long() - 1]
    return q_state, s_state
