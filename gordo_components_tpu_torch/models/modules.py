"""Activation table, dtype resolution and the dense and LSTM modules of the
model zoo (port of ``gordo_components_tpu/models/modules.py:26-118``).

Activations keep flax's definitions, which differ from PyTorch's defaults
in one place: flax's ``gelu`` is the tanh approximation.

Both modules compute the way flax's ``nn.Dense`` and
``nn.OptimizedLSTMCell`` do under ``dtype=compute_dtype``: weights are
cast to the compute dtype at use (weights stored in bfloat16 for the bf16
serving rung compute in float32 when the architecture says float32, as
flax's ``promote_dtype`` does), a Dense layer rounds its product before it
adds the bias, and the output is cast to float32. The LSTM carry stays
float32 under a bfloat16 compute dtype, as flax's does.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS: dict = {
    "linear": lambda x: x,
    "tanh": torch.tanh,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    "selu": F.selu,
    "softplus": F.softplus,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
}


def activation(name: str) -> Callable:
    """Resolve a Keras-style activation name."""
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"Unknown activation {name!r}; supported: {sorted(_ACTIVATIONS)}"
        ) from None


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(
            f"Unsupported compute_dtype {dtype!r}; supported: {sorted(_DTYPES)}"
        ) from None


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """flax ``nn.Dense`` in ``x``'s dtype: the product, then the bias — two
    roundings in bf16, as flax, where a fused bias would round once."""
    return F.linear(x, layer.weight.to(x.dtype)) + layer.bias.to(x.dtype)


_MASK32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (``lowbias32``) of int64 tensors holding
    32-bit values; products are cut back to 32 bits, so int64 wrap-around
    never changes the result."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _MASK32
    return x ^ (x >> 16)


class KeyStream:
    """Dropout masks as a pure function of an integer ``key`` tensor: the
    ``generator`` every model takes. A fit draws one key per step from its
    ``torch.Generator`` (``models/train.py``); under ``torch.func.vmap``
    over a stack of fits (``parallel/fleet.py``) the key is a per-fit
    tensor, where a ``torch.Generator`` could not be drawn from. Each mask
    hashes (key, draw counter, element index), so every fit of a stack,
    whose key differs, draws its own mask; the same key draws the same
    masks again, on the card and on the CPU alike. Neither gives flax's
    bits: only the distribution is the reference's."""

    def __init__(self, key: torch.Tensor, counter: int = 0):
        self.key = key
        self.start = counter
        self.counter = counter

    def _next(self) -> torch.Tensor:
        stream = _mix32((self.key + self.counter * 0x9E3779B9) & _MASK32)
        self.counter += 1
        return stream

    def keep(self, shape: Sequence[int], rate: float, device: torch.device) -> torch.Tensor:
        """A boolean mask of ``shape``, each element True with probability
        ``1 - rate``."""
        stream = self._next()
        index = torch.arange(math.prod(shape), device=device, dtype=torch.int64).reshape(shape)
        bits = _mix32((index * 0x85EBCA6B + stream) & _MASK32)
        return bits < int(round((1.0 - rate) * 2**32))

    def fork(self) -> "KeyStream":
        """A child stream, keyed by this stream's next draw."""
        return KeyStream(self._next())

    def replay(self) -> "KeyStream":
        """The stream again from its start: the same masks in the same order."""
        return KeyStream(self.key, self.start)


def dropout_generator(generator: Optional[KeyStream]) -> Optional[KeyStream]:
    """A child stream of ``generator`` (None stays None): a block that must
    draw the same masks again (an encoder layer recomputed under ``remat``)
    takes one of these and never ``generator`` itself."""
    return None if generator is None else generator.fork()


def replay_generator(generator: Optional[KeyStream]) -> Optional[KeyStream]:
    """``generator`` restarted from its start (see :func:`dropout_generator`)."""
    return None if generator is None else generator.replay()


def dropout(x: torch.Tensor, rate: float, generator: Optional[KeyStream]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)``; the identity when
    ``generator`` is None (flax's ``deterministic=True``) or ``rate`` is 0.
    The mask is hashed from ``generator`` on ``x``'s device."""
    if generator is None or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = generator.keep(x.shape, rate, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class DenseAutoencoderModule(nn.Module):
    """Encoder/decoder MLP: ``(batch, F) → (batch, F_out)``.

    ``layers`` holds flax's ``Dense_0 … Dense_n`` in order: the encoder,
    the decoder, then the output layer with ``out_func``.
    """

    def __init__(
        self,
        n_features: int,
        encoding_dims: Sequence[int],
        decoding_dims: Sequence[int],
        n_features_out: int,
        encoding_funcs: Sequence[str],
        decoding_funcs: Sequence[str],
        out_func: str = "linear",
        compute_dtype: Any = "float32",
    ):
        super().__init__()
        dims = [n_features, *encoding_dims, *decoding_dims, n_features_out]
        self.layers = nn.ModuleList(
            nn.Linear(n_in, n_out) for n_in, n_out in zip(dims[:-1], dims[1:])
        )
        self.activations = [
            activation(func) for func in (*encoding_funcs, *decoding_funcs, out_func)
        ]
        self.dtype = resolve_dtype(compute_dtype)

    def forward(
        self, x: torch.Tensor, generator: Optional[KeyStream] = None
    ) -> torch.Tensor:
        h = x.to(self.dtype)  # no dropout here (the reference has none)
        for layer, act in zip(self.layers, self.activations):
            h = act(linear(h, layer))
        return h.float()


class OptimizedLSTMCell(nn.Module):
    """flax 0.12 ``nn.OptimizedLSTMCell`` run over a whole sequence.

    Parameters, with the gates in flax's order ``i, f, g, o`` along the last
    axis: ``input_kernel`` ``(F_in, 4·units)`` (flax's ``ii/if/ig/io``
    kernels, no bias), ``recurrent_kernel`` ``(units, 4·units)`` and
    ``recurrent_bias`` (``hi/hf/hg/ho``). Per step::

        gates = (h @ W_h + b_h) + x_t @ W_i
        i, f, o = sigmoid(gates_i, gates_f, gates_o)
        c' = f * c + i * act(gates_g);   h' = o * act(c')

    ``act`` is the configured activation, applied twice as in flax (not
    only to the candidate), so ``torch.nn.LSTM``, which knows only tanh,
    cannot stand in for it. The carry starts at zero and stays float32;
    the products and gate pre-activations are in the compute dtype. The
    input projection of every step is one product over ``(B·L, F_in)``.
    In bf16 the sigmoid rounds once; XLA on the CPU rounds the exp, the sum
    and the quotient of ``1 / (1 + exp(-x))`` separately, so a gate may
    differ from the reference's by one ulp.
    """

    def __init__(self, n_in: int, units: int, func: str = "tanh"):
        super().__init__()
        self.units = units
        self.act = activation(func)
        self.input_kernel = nn.Parameter(torch.zeros(n_in, 4 * units))
        self.recurrent_kernel = nn.Parameter(torch.zeros(units, 4 * units))
        self.recurrent_bias = nn.Parameter(torch.zeros(4 * units))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``(B, L, F_in)`` → every step's hidden state, ``(B, L, units)``
        in float32."""
        act = self.act
        u = self.units
        x_proj = torch.matmul(x.to(dtype), self.input_kernel.to(dtype))
        w_h = self.recurrent_kernel.to(dtype)
        b_h = self.recurrent_bias.to(dtype)
        c = x.new_zeros((x.shape[0], u), dtype=torch.float32)
        h = c
        steps = []
        for t in range(x.shape[1]):
            gates = (h.to(dtype) @ w_h + b_h) + x_proj[:, t]
            i, f, _, o = torch.sigmoid(gates).chunk(4, dim=-1)
            c = f * c + i * act(gates[:, 2 * u : 3 * u])
            h = o * act(c)
            steps.append(h)
        return torch.stack(steps, dim=1)


class LSTMModule(nn.Module):
    """Stacked LSTM over a lookback window: ``(batch, L, F) → (batch, F_out)``.

    flax's tree: ``OptimizedLSTMCell_{i}`` per layer, then ``Dense_0``, the
    head, on the last step's hidden state with ``out_func``. ``dropout``
    follows every layer's output sequence under a dropout ``generator``
    (training), as in the reference; without one it is the identity.
    """

    def __init__(
        self,
        n_features: int,
        units: Sequence[int],
        n_features_out: int,
        funcs: Sequence[str],
        out_func: str = "linear",
        compute_dtype: Any = "float32",
        dropout: float = 0.0,
    ):
        super().__init__()
        self.dropout_rate = dropout
        widths = [n_features, *units]
        self.cells = nn.ModuleList(
            OptimizedLSTMCell(n_in, n_units, func)
            for n_in, n_units, func in zip(widths[:-1], widths[1:], funcs)
        )
        self.head = nn.Linear(widths[-1], n_features_out)
        self.out_act = activation(out_func)
        self.dtype = resolve_dtype(compute_dtype)

    def forward(
        self, x: torch.Tensor, generator: Optional[KeyStream] = None
    ) -> torch.Tensor:
        h = x.to(self.dtype)
        for cell in self.cells:
            h = dropout(cell(h, self.dtype), self.dropout_rate, generator)
        last = h[:, -1, :].to(self.dtype)
        return self.out_act(linear(last, self.head)).float()
