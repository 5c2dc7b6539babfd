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


def _seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, 2**62, (), generator=generator))


def dropout_generator(generator: Optional[torch.Generator]) -> Optional[torch.Generator]:
    """A fresh CPU generator seeded from ``generator`` (None stays None): a
    block that must draw the same masks again (an encoder layer recomputed
    under ``remat``) takes one of these and never ``generator`` itself."""
    return None if generator is None else torch.Generator().manual_seed(_seed(generator))


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)``; the identity when
    ``generator`` is None (flax's ``deterministic=True``) or ``rate`` is 0.
    The mask is drawn on ``x``'s device by a generator seeded from the CPU
    ``generator``: a fit draws the same seeds on the card and the CPU, but
    the two devices' generators turn them into other masks, and neither
    gives flax's bits: only the distribution is the reference's."""
    if generator is None or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    device_gen = torch.Generator(device=x.device).manual_seed(_seed(generator))
    keep = torch.rand(x.shape, generator=device_gen, device=x.device) < 1.0 - rate
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
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
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
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        h = x.to(self.dtype)
        for cell in self.cells:
            h = dropout(cell(h, self.dtype), self.dropout_rate, generator)
        last = h[:, -1, :].to(self.dtype)
        return self.out_act(linear(last, self.head)).float()
