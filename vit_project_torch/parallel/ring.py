"""Ring attention: attention over a sequence sharded across a model group
(counterpart of the JAX package's parallel/ring.py).

The gather form of sequence parallelism (models/vit.py) all-gathers the
packed qkv of every block, so each rank holds the whole sequence's k and v.
Ring attention is the alternative: each rank keeps its own query block,
and the k/v blocks rotate around the ring of the model group's ranks, one
hop a step (``parallel/dist.ring_shift``: send to the next rank, receive
from the one before), while each rank folds every visiting block into its
queries' online softmax (the flash-attention recurrence, in f32). A rank
holds one k/v block at a time instead of the whole sequence.

The backward (``memory_efficient=True``, the default) is ring-shaped too:
an autograd Function whose forward saves only the rank's own q/k/v shards,
the output and the per-row log-sum-exp, and whose backward rotates the k/v
blocks a second time, recomputing each visiting block's probabilities from
the saved lse. dq accumulates on the rank (its query block never moves);
the dk/dv accumulators travel with their blocks and take one last hop home.
``memory_efficient=False`` is autograd through the forward's loop (each hop
a differentiable ``RingHop``), kept as the debugging oracle.

Like JAX's, the arithmetic is einsums outside any kernel (JAX runs it with
jnp inside ``shard_map``): no hand-written kernel runs here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .dist import RingHop, ring_shift

_NEG = -1e30  # finite mask value (exp underflows to exactly 0 after shift)


def _block_mask(qidx, kidx, s_valid, causal):
    """[s_q, s_k] validity mask for one (query block, key block) pair,
    addressed by GLOBAL token positions; None when nothing is masked."""
    mask = None
    if s_valid is not None:
        mask = (kidx[None, :] < s_valid).expand(len(qidx), -1)
    if causal:
        c = kidx[None, :] <= qidx[:, None]
        mask = c if mask is None else mask & c
    return mask


def _fold(m, l, acc, qf, k_cur, v_cur, mask):
    """Fold one k/v block into the online softmax (m, l [b, h, q, 1], acc
    [b, q, h, dh], all f32). Masked entries contribute exactly zero, even
    when a whole block is masked and m stays at _NEG."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k_cur.float())
    if mask is not None:
        s = torch.where(mask, s, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v_cur.float())
    return m_new, l, acc * corr.permute(0, 2, 1, 3) + pv


def _positions(seq, s_loc, device):
    return seq.index * s_loc + torch.arange(s_loc, device=device)


def _key_positions(seq, s_loc, j, device):
    """Global positions of the block that visits at step j: shard
    (index - j) mod n."""
    return ((seq.index - j) % seq.n) * s_loc + torch.arange(s_loc,
                                                            device=device)


def _ring_forward(q, k, v, seq, s_valid, causal, hop):
    """(out [b, q, h, dh] in q's dtype, lse [b, q, h] f32). The resident
    block is folded first, so the ring makes exactly n - 1 hops."""
    b, s_loc, h, dh = q.shape
    qidx = _positions(seq, s_loc, q.device)
    qf = q.float() * (1.0 / dh ** 0.5)
    m = torch.full((b, h, s_loc, 1), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for j in range(seq.n):
        if j:
            k_cur, v_cur = hop(k_cur, v_cur)
        kidx = _key_positions(seq, s_loc, j, q.device)
        m, l, acc = _fold(m, l, acc, qf, k_cur, v_cur,
                          _block_mask(qidx, kidx, s_valid, causal))
    lq = l.permute(0, 2, 1, 3)
    out = torch.where(lq > 0, acc / torch.where(lq > 0, lq, 1.0), 0.0)
    # lse of a row with any valid key; +inf for a fully masked row, so the
    # backward's exp(s - lse) is exactly 0 there
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)),
                      torch.inf)
    return out.to(q.dtype), lse[..., 0].permute(0, 2, 1)


class _RingAttention(torch.autograd.Function):
    """The memory-efficient ring: saves the rank's q/k/v, out and lse; the
    backward is the flash-attention backward, ring form."""

    @staticmethod
    def forward(ctx, q, k, v, seq, s_valid, causal):
        out, lse = _ring_forward(
            q, k, v, seq, s_valid, causal,
            lambda k_, v_: tuple(ring_shift([k_, v_], seq)))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.seq, ctx.s_valid, ctx.causal = seq, s_valid, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        seq, s_valid, causal = ctx.seq, ctx.s_valid, ctx.causal
        s_loc, dh = q.shape[1], q.shape[-1]
        scale = 1.0 / dh ** 0.5
        qidx = _positions(seq, s_loc, q.device)
        qf = q.float() * scale
        do = dout.float()
        # delta[b, h, q, 1] = rowwise <dout, out> (the softmax-jacobian term)
        delta = (do * out.float()).sum(dim=-1).permute(0, 2, 1)[..., None]
        lse_ = lse.permute(0, 2, 1)[..., None]                 # [b, h, q, 1]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        k_cur, v_cur = k, v
        for j in range(seq.n):
            if j:
                # the accumulators travel with their blocks (f32 first: the
                # hop's byte buffer keeps every part aligned)
                dk, dv, k_cur, v_cur = ring_shift([dk, dv, k_cur, v_cur],
                                                  seq)
            kidx = _key_positions(seq, s_loc, j, q.device)
            mask = _block_mask(qidx, kidx, s_valid, causal)
            kf, vf = k_cur.float(), v_cur.float()
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
            # exact softmax probabilities recomputed from the saved lse
            p = torch.exp(s - lse_)
            if mask is not None:
                p = torch.where(mask, p, 0.0)
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, do)
            dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
            ds = p * (dp - delta)
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf)
        if seq.n > 1:
            # block b's accumulator sits on rank b - 1 after n - 1 hops; one
            # more delivers it home
            dk, dv = ring_shift([dk, dv], seq)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        seq, *, s_valid: int | None = None,
                        causal: bool = False,
                        memory_efficient: bool = True) -> torch.Tensor:
    """Attention over this rank's block [B, S_pad / n, H, Dh] of q, k, v,
    whose sequence axis is split in n equal blocks over the model group
    `seq` (``parallel/mesh.SeqShard``; rank t holds block t). Returns this
    rank's rows of the output.

    Every block has one length, so a ragged sequence is padded first
    (``pad_seq``; vit_encode pads before it shards). `s_valid` masks the
    padded tail: keys at global positions >= s_valid get no weight, so the
    valid rows are exactly the dense attention of the unpadded sequence
    (padded rows are garbage the caller drops). `causal` masks key > query
    by global position. The math is ``ops.attention.attention_core_bshd``'s
    to f32-accumulation tolerance. Every rank of the group must call it
    alike."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one rank's blocks of one shape: "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not memory_efficient:
        def hop(k_, v_):
            return RingHop.apply(k_, seq), RingHop.apply(v_, seq)
        return _ring_forward(q, k, v, seq, s_valid, causal, hop)[0]
    return _RingAttention.apply(q, k, v, seq, s_valid, causal)


def pad_seq(x: torch.Tensor, n: int) -> tuple[torch.Tensor, int]:
    """Zero-pad axis 1 of [B, S, ...] up to a multiple of n; returns
    (padded, original S). Padded key rows are masked inside ring attention
    (s_valid) and padded query rows never mix into valid tokens (attention
    is the only token-mixing op), so the caller slices [:, :S] at the
    end."""
    S = x.shape[1]
    pad = (-S) % n
    if pad == 0:
        return x, S
    return F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad)), S
