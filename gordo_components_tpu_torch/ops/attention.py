"""Attention primitives: dense scaled-dot-product and ring attention (port
of ``gordo_components_tpu/ops/attention.py``).

``dense_attention`` is plain PyTorch: the reference computes it outside
any Pallas kernel, and the port keeps it for sequences that fit one tile
(see :func:`gordo_components_tpu_torch.ops.flash_attention.flash_attention`).

``ring_attention`` is the reference's long-context path over
``torch.distributed`` in place of a mesh axis: each rank of the ring's
process group keeps its block of the sequence's queries while the K/V
blocks move one rank on by point-to-point sends (``batch_isend_irecv``),
``n − 1`` hops of one block each, so a rank holds O(seq/n) of K/V. Each
hop folds one block into the reference's online softmax (running max
``m``, normaliser ``l``, accumulator ``acc``): ``block_impl="dense"``
computes the hop's scores with einsums, ``"flash"`` runs the hand-written
flash kernel (:func:`~.flash_attention.flash_block_with_lse`) and folds
its ``(out, lse)``. Only the output blocks are gathered, so that every
rank returns the whole result. Exact, not approximate: held against the
reference's ring on the CPU in ``tests/test_torch_ring_attention.py``.

The group. The reference's ring spans every device of ``jax.devices()``;
the port's spans the ranks of one process group, which a caller names once
with :func:`set_ring_group` (the models read :func:`ring_group` at each
forward). Unset, the ring has one rank: one hop, no collective, which is
what a server or a fit on one card runs. The ring never takes a process
group by default: ``fleet-build``'s ranks train different machines, and a
ring across them would pair unrelated blocks.

Across ranks the global tensors are replicated, as in the reference's one
program: every rank passes the same ``q``, ``k``, ``v`` and receives the
same output, and the cotangent of that output must be the same on every
rank (each rank computes the same loss). The ring is then a
``torch.autograd.Function`` whose backward walks the ring again: ``dq``
stays on its rank, ``dk`` and ``dv`` travel with their K/V blocks and end
on the block's owner, and each hop's gradients come from the flash
backward operator (``gordo::flash_bwd``: the hand-written kernel on the
card) for ``"flash"``, or its plain version for ``"dense"``, with the
softmax's global logsumexp, which makes each hop's share exact. gloo
sends host tensors only: over a gloo group a CUDA block is staged through
host memory. At one rank the plain autograd path serves, and it passes
through ``torch.func.vmap`` (the stacked engine and the fleet trainer map
a model over machines); the ring across ranks does not.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

_RING = {"group": None}


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


def set_ring_group(group: Any) -> Any:
    """Name the process group that the models' ring attention spans (a
    ``torch.distributed`` group, e.g. ``dist.group.WORLD``; None: one
    rank). Returns the group it replaces."""
    previous, _RING["group"] = _RING["group"], group
    return previous


def ring_group() -> Any:
    """The group :func:`set_ring_group` named, or None (one rank)."""
    return _RING["group"]


def ring_size(group: Any = None) -> int:
    """Ranks of ``group`` (1 for None)."""
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


# -- one hop of the online softmax --------------------------------------------

def _hop_dense(q, k_blk, v_blk, m, l, acc, scale, want_lse):
    logits = torch.einsum("...qhd,...khd->...hqk", q, k_blk) * scale
    blk_max = torch.amax(logits, dim=-1)  # (..., h, q)
    new_m = torch.maximum(m, blk_max)
    correction = torch.exp(m - new_m)
    p = torch.exp(logits - new_m[..., None])  # (..., h, q, k)
    l = l * correction + torch.sum(p, dim=-1)
    # correction/l carry (..., heads, q); acc carries (..., q, heads, d)
    acc = (acc * correction.swapaxes(-1, -2)[..., None]
           + torch.einsum("...hqk,...khd->...qhd", p, v_blk))
    return new_m, l, acc, torch.logsumexp(logits.float(), dim=-1) if want_lse else None


def _to3d(a: torch.Tensor) -> torch.Tensor:
    """``(..., S, H, D)`` → ``(BH, S, D)``."""
    return a.movedim(-2, -3).reshape(-1, a.shape[-3], a.shape[-1])


def _from3d(a3: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``(BH, S, D)`` or ``(BH, S)`` → ``(..., S, H, D)`` or ``(..., H, S)``
    in the layout of ``like`` ``(..., S, H, D)``."""
    *batch, seq, heads, head_dim = like.shape
    if a3.dim() == 2:
        return a3.reshape(*batch, heads, seq)
    return a3.reshape(*batch, heads, seq, head_dim).movedim(-3, -2)


def _hop_flash(q, k_blk, v_blk, m, l, acc, scale, want_lse):
    from .flash_attention import flash_block_with_lse

    out3, lse3 = flash_block_with_lse(_to3d(q), _to3d(k_blk), _to3d(v_blk), scale, 128, 128)
    # the hop folds into the carry as one pre-reduced block whose "max" is
    # its lse and whose normaliser mass is exp(lse - new_m): out3 is
    # normalised, so its unnormalised sum is out3 * exp(lse)
    hop_out = _from3d(out3, q)  # (..., q, h, d)
    hop_lse = _from3d(lse3, q)  # (..., h, q), float32
    new_m = torch.maximum(m, hop_lse)
    correction = torch.exp(m - new_m)
    hop_w = torch.exp(hop_lse - new_m)  # (..., h, q)
    l = l * correction + hop_w
    acc = (acc * correction.swapaxes(-1, -2)[..., None]
           + hop_out * hop_w.swapaxes(-1, -2)[..., None])
    return new_m, l, acc, hop_lse


_HOPS = {"dense": _hop_dense, "flash": _hop_flash}


# -- moving blocks around the ring --------------------------------------------

def _neighbours(group) -> Tuple[int, int]:
    """The global ranks this rank sends to and receives from."""
    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    return dist.get_global_rank(group, (r + 1) % n), dist.get_global_rank(group, (r - 1) % n)


def _host_staged(group) -> bool:
    import torch.distributed as dist

    return dist.get_backend(group) == "gloo"


class _Rotation:
    """Tensors on their way one rank on: the sends and receives are posted
    at once (``batch_isend_irecv``) and :meth:`wait` returns what the
    previous rank sent, on the tensors' device. Over gloo a CUDA tensor is
    staged through host memory. Rotations in flight at once take tags of
    their own (``tag`` onwards, one per tensor)."""

    def __init__(self, group, tensors: List[torch.Tensor], tag: int = 0):
        import torch.distributed as dist

        self.device = tensors[0].device
        stage = self.device.type != "cpu" and _host_staged(group)
        staged = [t.contiguous().to("cpu") if stage else t.contiguous() for t in tensors]
        self.received = [torch.empty_like(t) for t in staged]
        to_next, from_prev = _neighbours(group)
        ops = [dist.P2POp(dist.isend, t, to_next, group, tag + i) for i, t in enumerate(staged)]
        ops += [dist.P2POp(dist.irecv, t, from_prev, group, tag + i)
                for i, t in enumerate(self.received)]
        self._staged = staged  # kept alive until the sends complete
        self._requests = dist.batch_isend_irecv(ops)

    def wait(self) -> List[torch.Tensor]:
        for request in self._requests:
            request.wait()
        return [t.to(self.device) for t in self.received]


def _gather_blocks(block: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``(batch, blk, ...)`` block, concatenated along axis 1
    in rank order."""
    import torch.distributed as dist

    staged = block.to("cpu") if block.device.type != "cpu" and _host_staged(group) else block
    parts = [torch.empty_like(staged) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, staged.contiguous(), group=group)
    return torch.cat(parts, dim=1).to(block.device)


# -- the per-rank body ----------------------------------------------------------

def _ring_attention_sharded(q, k, v, *, scale: float, block_impl: str = "dense",
                            group=None):
    """Per-rank body: q/k/v are this rank's sequence block ``(batch, block,
    heads, head_dim)`` → ``(out block, lse block (batch, heads, block)
    float32)``. ``group`` None: one hop, no collective (differentiable by
    autograd and vmap-able); else ``n`` hops with K/V sent one rank on
    between them, each next block's transfer beside the hop's work."""
    n = ring_size(group)
    hop = _HOPS[block_impl]
    *batch_shape, q_len, heads, _ = q.shape
    m = torch.full((*batch_shape, heads, q_len), float("-inf"), dtype=q.dtype,
                   device=q.device)
    l = torch.zeros((*batch_shape, heads, q_len), dtype=q.dtype, device=q.device)
    acc = torch.zeros_like(q)
    lse = None
    k_blk, v_blk = k, v
    for i in range(n):
        rotation = _Rotation(group, [k_blk, v_blk]) if i < n - 1 else None
        m, l, acc, hop_lse = hop(q, k_blk, v_blk, m, l, acc, scale, n > 1)
        if n > 1:
            lse = hop_lse if lse is None else torch.logaddexp(lse, hop_lse)
        if rotation is not None:
            k_blk, v_blk = rotation.wait()
    out = (acc / l.swapaxes(-1, -2)[..., None]).to(q.dtype)
    return out, lse


def _hop_backward(q, k_blk, v_blk, out, lse, dout, scale, block_impl):
    """One hop's ``(dq, dk, dv)`` share from the softmax's global
    logsumexp: the flash backward operator (the kernel on the card), or its
    plain version for dense hops."""
    from .flash_attention import _flash_bwd_op, flash_bwd_reference

    args = [_to3d(t).contiguous() for t in (q, k_blk, v_blk, out)]
    lse3 = lse.reshape(-1, lse.shape[-1]).contiguous()
    dout3 = _to3d(dout).contiguous()
    if block_impl == "flash":
        grads = _flash_bwd_op(*args, lse3, dout3, None, scale)
    else:
        grads = flash_bwd_reference(*args, lse3, dout3, scale)
    return [_from3d(g, q) for g in grads]


class _RingAttention(torch.autograd.Function):
    """The ring across ranks: global ``(batch, seq, heads, head_dim)``
    q/k/v in, the global output (and this rank's float32 lse block, not
    differentiable) out."""

    @staticmethod
    def forward(q, k, v, scale, block_impl, group):
        import torch.distributed as dist

        n, r = dist.get_world_size(group), dist.get_rank(group)
        blk = q.shape[1] // n
        local = [t.narrow(1, r * blk, blk).contiguous() for t in (q, k, v)]
        out_l, lse_l = _ring_attention_sharded(*local, scale=scale, block_impl=block_impl,
                                               group=group)
        return _gather_blocks(out_l, group), lse_l

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, scale, block_impl, group = inputs
        out, lse_l = output
        ctx.save_for_backward(q, k, v, out, lse_l)
        ctx.scale, ctx.block_impl, ctx.group = scale, block_impl, group
        ctx.mark_non_differentiable(lse_l)

    @staticmethod
    def backward(ctx, dout, _dlse):
        import torch.distributed as dist

        q, k, v, out, lse_l = ctx.saved_tensors
        group = ctx.group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        blk = q.shape[1] // n
        q_l, k_blk, v_blk, out_l, dout_l = (
            t.narrow(1, r * blk, blk).contiguous() for t in (q, k, v, out, dout))
        dq = torch.zeros(q_l.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k_blk.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        for i in range(n):
            rotation = _Rotation(group, [k_blk, v_blk]) if i < n - 1 else None
            dq_i, dk_i, dv_i = _hop_backward(q_l, k_blk, v_blk, out_l, lse_l, dout_l,
                                             ctx.scale, ctx.block_impl)
            dq += dq_i
            dk += dk_i
            dv += dv_i
            # the block's gradients travel with it; after the last hop they
            # go one rank on more, to the block's owner
            dk, dv = _Rotation(group, [dk, dv], tag=2).wait()
            if rotation is not None:
                k_blk, v_blk = rotation.wait()
        grads = [_gather_blocks(g.to(t.dtype), group) for g, t in ((dq, q), (dk, k), (dv, v))]
        return (*grads, None, None, None)

    @staticmethod
    def vmap(info, in_dims, *args):
        raise RuntimeError(
            "ring attention across ranks does not run under torch.func.vmap: map the "
            "model at one rank (set_ring_group(None)), or run the ranks unmapped")


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group: Any = None,
    scale: Optional[float] = None,
    block_impl: str = "dense",
) -> torch.Tensor:
    """Exact attention with the sequence axis split over the ranks of
    ``group`` (None: one rank).

    q/k/v: the global ``(batch, seq, heads, head_dim)`` tensors, the same
    on every rank, with ``seq`` divisible by the group's size; returns the
    global output on every rank. Communication is ``n − 1`` neighbour hops
    of one K/V block each (and the backward's walk back).
    ``block_impl="flash"`` runs each hop's local attention as the flash
    kernel, so per-hop scores never materialise either."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if block_impl not in ("dense", "flash"):
        raise ValueError(
            f"Unknown block_impl {block_impl!r}; use 'dense' or 'flash'"
        )
    n = ring_size(group)
    if q.shape[1] % n != 0:
        raise ValueError(
            f"Sequence length {q.shape[1]} must divide over the ring group "
            f"of size {n}"
        )
    if n == 1:
        return _ring_attention_sharded(q, k, v, scale=float(scale), block_impl=block_impl)[0]
    return _RingAttention.apply(q, k, v, float(scale), block_impl, group)[0]
