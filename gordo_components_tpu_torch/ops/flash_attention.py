"""Blockwise (flash) attention forward (port of
``gordo_components_tpu/ops/flash_attention.py``).

The reference runs a Pallas TPU kernel (``_fwd_kernel`` via
``_flash_fwd_3d``); the port runs a CUDA kernel written for Hopper on CUDA
tensors, one per dtype (``csrc/flash_fwd_f32.cu``, ``csrc/flash_fwd_bf16.cu``),
and :func:`flash_fwd_reference`, their plain PyTorch version, on CPU
tensors. The choice follows the tensor's device and dtype and nothing
else: a CUDA tensor launches its dtype's kernel or raises.

Public contract kept from the reference:

- :func:`flash_attention` takes and returns the flax layout
  ``(..., seq, heads, head_dim)`` and sends a sequence that fits one tile
  (``seq <= min(block_q, block_k)``) to :func:`dense_attention`;
  ``block_q``/``block_k`` decide only that rule — the CUDA kernel's tiles
  are its own;
- :func:`flash_block_with_lse` is the ``(BH, S, D)`` forward with the
  per-row logsumexp exposed (the ring composition's per-hop update, whose
  caller is a later slice).

The ``(BH, S, D)`` forward is one PyTorch operator, ``gordo::flash_fwd``
(``torch.library.custom_op``): its CUDA implementation launches the kernel
of q's dtype, its CPU implementation is the plain version. Its vmap rule
folds the mapped dimension into BH and makes one call, so a program that
maps a model with ``torch.func.vmap`` over k machines (the serving engine's fused
dispatch) launches the kernel once per layer for all k, at BH = k·BH, as
the reference's ``vmap`` over its Pallas call does.

The backward (the reference's ``_bwd_3d``, the ``custom_vjp`` rule of
``_flash_3d`` and ``flash_block_with_lse``) is a second operator,
``gordo::flash_bwd``, registered as ``gordo::flash_fwd``'s autograd rule:
its CUDA implementation launches ``csrc/flash_bwd.cu``, its CPU
implementation is :func:`flash_bwd_reference`. The forward saves ``(q, k,
v, out, lse)``, as the reference does, and both outputs are differentiable:
an lse cotangent enters the score gradient and never ``dv``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels
from .attention import dense_attention

_DEF_BLOCK_Q = 128
_DEF_BLOCK_K = 128


def flash_fwd_reference(
    q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``(BH, S, D)`` → ``(out in q's dtype, lse (BH, S)
    float32)``, computed in float32 with the whole score matrix."""
    s = torch.einsum("bqd,bkd->bqk", q3.float(), k3.float()) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bqk,bkd->bqd", p, v3.float())
    return out.to(q3.dtype), lse


def flash_bwd_reference(
    q3: torch.Tensor,
    k3: torch.Tensor,
    v3: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: float,
    dlse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the backward: from the forward's ``(BH, S, D)``
    q, k, v, out and ``(BH, S)`` lse, the output cotangent ``do`` and the
    optional lse cotangent ``dlse`` → ``(dq, dk, dv)`` in the inputs'
    dtypes, computed in float32 with the whole score matrix."""
    qf, kf, vf, dof = (t.float() for t in (q3, k3, v3, do))
    p = torch.exp(torch.einsum("bqd,bkd->bqk", qf, kf) * scale - lse[..., None])
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dresid = torch.einsum("bqd,bkd->bqk", dof, vf)
    dresid = dresid - torch.sum(dof * out.float(), dim=-1)[..., None]
    if dlse is not None:
        dresid = dresid + dlse.float()[..., None]
    ds = p * dresid * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, kf)
    dk = torch.einsum("bqk,bqd->bkd", ds, qf)
    return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype)


@torch.library.custom_op(
    "gordo::flash_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, float scale) -> (Tensor, Tensor)",
)
def _flash_fwd_op(
    q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(BH, S, D)`` → ``(out, lse)``; this body is the CPU implementation."""
    return flash_fwd_reference(q3, k3, v3, scale)


@_flash_fwd_op.register_kernel("cuda")
def _flash_fwd_cuda(q3, k3, v3, scale):
    return _kernels.flash_fwd_cuda(q3, k3, v3, scale)


@_flash_fwd_op.register_fake
def _flash_fwd_fake(q3, k3, v3, scale):
    return torch.empty_like(q3), q3.new_empty(q3.shape[:2], dtype=torch.float32)


def _flash_fwd_vmap(info, in_dims, q3, k3, v3, scale):
    """k mapped ``(BH, S, D)`` inputs → one call at ``(k·BH, S, D)``: the
    mapped dimension goes to the front (an unmapped operand is expanded),
    folds into BH, and the outputs unfold again."""

    def fold(t, dim):
        t = t.movedim(dim, 0) if dim is not None else t.expand(info.batch_size, *t.shape)
        return t.reshape(-1, *t.shape[2:]).contiguous()

    n = info.batch_size
    q, k, v = (fold(t, dim) for t, dim in zip((q3, k3, v3), in_dims[:3]))
    out, lse = _flash_fwd_op(q, k, v, scale)
    return (out.unflatten(0, (n, -1)), lse.unflatten(0, (n, -1))), (0, 0)


_flash_fwd_op.register_vmap(_flash_fwd_vmap)


@torch.library.custom_op(
    "gordo::flash_bwd", mutates_args=(), device_types="cpu",
    schema=(
        "(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, Tensor dout, "
        "Tensor? dlse, float scale) -> (Tensor, Tensor, Tensor)"
    ),
)
def _flash_bwd_op(q3, k3, v3, out, lse, dout, dlse, scale):
    """``(BH, S, D)`` backward → ``(dq, dk, dv)``; this body is the CPU
    implementation."""
    return flash_bwd_reference(q3, k3, v3, out, lse, dout, scale, dlse)


@_flash_bwd_op.register_kernel("cuda")
def _flash_bwd_cuda(q3, k3, v3, out, lse, dout, dlse, scale):
    return _kernels.flash_bwd_cuda(q3, k3, v3, out, lse, dout, scale, dlse)


@_flash_bwd_op.register_fake
def _flash_bwd_fake(q3, k3, v3, out, lse, dout, dlse, scale):
    return torch.empty_like(q3), torch.empty_like(k3), torch.empty_like(v3)


def _flash_fwd_setup_context(ctx, inputs, output):
    q3, k3, v3, scale = inputs
    out, lse = output
    ctx.save_for_backward(q3, k3, v3, out, lse)
    ctx.scale = scale


def _flash_fwd_backward(ctx, dout, dlse):
    q3, k3, v3, out, lse = ctx.saved_tensors
    if dout is None:
        dout = torch.zeros_like(out)
    if dlse is not None:
        dlse = dlse.contiguous()
    dq, dk, dv = _flash_bwd_op(q3, k3, v3, out, lse, dout.contiguous(), dlse, ctx.scale)
    return dq, dk, dv, None


_flash_fwd_op.register_autograd(_flash_fwd_backward, setup_context=_flash_fwd_setup_context)


def flash_fwd(
    q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(BH, S, D)`` attention forward on the tensors' own device: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    differentiable in both outputs."""
    return _flash_fwd_op(q3.contiguous(), k3.contiguous(), v3.contiguous(), float(scale))


def flash_block_with_lse(
    q3: torch.Tensor,
    k3: torch.Tensor,
    v3: torch.Tensor,
    scale: float,
    block_q: int = _DEF_BLOCK_Q,
    block_k: int = _DEF_BLOCK_K,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(BH, S, D)`` q/k/v → ``(out (BH, S, D), lse (BH, S))``,
    differentiable in both outputs; the block sizes are accepted for the
    reference's signature and do not change the result."""
    return flash_fwd(q3, k3, v3, scale)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    block_q: int = _DEF_BLOCK_Q,
    block_k: int = _DEF_BLOCK_K,
) -> torch.Tensor:
    """Exact attention; drop-in for :func:`dense_attention`. q/k/v
    ``(..., seq, heads, head_dim)`` → ``(..., seq, heads, head_dim)``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    *batch, seq, heads, head_dim = q.shape
    if seq <= min(block_q, block_k):
        return dense_attention(q, k, v, scale)
    bh = heads
    for dim in batch:
        bh *= int(dim)

    def to3d(a: torch.Tensor) -> torch.Tensor:
        return a.movedim(-2, -3).reshape(bh, seq, head_dim)  # (..., H, S, D)

    out3, _ = flash_fwd(to3d(q), to3d(k), to3d(v), float(scale))
    return out3.reshape(*batch, heads, seq, head_dim).movedim(-3, -2)
