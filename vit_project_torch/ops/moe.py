"""Mixture-of-Experts MLP: Switch top-1 or GShard top-2 routing
(counterpart of the JAX package's ops/moe.py, with its semantics).

JAX writes dispatch and combine as einsums over [tokens, experts, capacity]
one-hots, the TPU-native shape. At ViT-B/16, batch 256 and 8 experts each
one-hot is 50,432 x 8 x 7,888 = 3.18e9 elements (6.4 GB in bf16) and each
einsum ~5 TFLOP, for a function in which every slot holds at most one
token. The port computes the same function by index:

- routing in f32: logits = x @ router_w, softmax, the first choice by
  argmax (ties to the first index, as jnp.argmax), its probability the gate.
  Top-2 masks the first choice's LOGIT by 2e30 (a saturated router's other
  probabilities underflow to 0, and an argmax over them could return the
  first choice again) and takes the second by argmax; the pair's gates are
  renormalised over their sum;
- capacity C = ``expert_capacity(T, E, capacity_factor * topk)``; each
  expert's queue runs in token order, second choices behind every first
  choice; a token past C is dropped (its term is 0: it rides the residual);
- dispatch gathers each kept token into its [E, C, D] slot, the expert FFNs
  are two batched products (``torch.baddbmm``; JAX runs them outside any
  Pallas kernel), and combine gathers each kept slot's output back to its
  token, times the gate cast to the compute dtype (a top-2 pair summed in
  f32 and rounded once, as the einsum's accumulator does);
- aux is the Switch loss E * sum_e f_e * p_e over the first choices before
  capacity (f_e the share of tokens, p_e the mean router probability).

Both gathers are ``_GatherRows``, whose backward is the adjoint gather: a
slot holds one token and a token one slot a choice, so every gradient row is
a sum of at most topk rows in a fixed order, and repeat runs give equal bits
(a backward through ``index_add`` would sum rows with float atomics in no
fixed order).

Across ranks (``MoEGroups``): JAX's moe_mlp sees the whole batch, so the
capacity, the queues and aux are the global batch's. Each rank of the data
axis routes its own images, which sit in the global batch interleaved with
the other data ranks' (``route``); one all-gather over the data group of
each image's per-expert counts of first (and second) choices and of the
router-probability sums gives it the global capacity, its place in each
queue, f and p. aux's value is the global one on every rank; its gradient
is the rank's share (f times its own rows' probabilities over its own
token count), so the data axis's mean of the gradients is JAX's. Under
expert parallelism the ranks of an expert group hold the same tokens and
E / ep experts each: a rank dispatches only to its own experts, and the
gathered outputs are summed over the group (Megatron's copy / reduce pair:
the copy on the tokens the experts read, the reduce on what they give
back). Routing, gates and aux stay whole on every rank of the group, so
the router's gradient is the same there and counts the aux term once. With
no group (or a data axis of one) no collective runs.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import dist


class MoEMlp(nn.Module):
    """The parameters of a MoE FFN in JAX's orientation: ``router_w`` [D, E],
    ``fc1_w`` [E, D, H], ``fc1_b`` [E, H], ``fc2_w`` [E, H, D], ``fc2_b``
    [E, D]. Under expert parallelism the expert leaves hold the rank's E / ep
    experts and ``router_w`` all E columns."""

    def __init__(self, width: int, hidden: int, n_experts: int):
        super().__init__()
        self.router_w = nn.Parameter(torch.empty(width, n_experts))
        self.fc1_w = nn.Parameter(torch.empty(n_experts, width, hidden))
        self.fc1_b = nn.Parameter(torch.empty(n_experts, hidden))
        self.fc2_w = nn.Parameter(torch.empty(n_experts, hidden, width))
        self.fc2_b = nn.Parameter(torch.empty(n_experts, width))


@dataclass(frozen=True)
class MoEGroups:
    """Where a MoE layer's rows and experts live across ranks: the data
    axis (`data`, None for the default group; this rank is `data_rank` of
    `n_data`) and the expert group (`expert`; this rank holds experts
    [expert_rank * E / n_expert, (expert_rank + 1) * E / n_expert))."""
    data: object = None
    n_data: int = 1
    data_rank: int = 0
    expert: object = None
    n_expert: int = 1
    expert_rank: int = 0


@dataclass
class Routing:
    """One MoE layer's routing of T local tokens: `slots` [T, topk] is each
    choice's global slot e * C + position, -1 where the token was dropped;
    `gates` [T, topk] f32 (renormalised over the pair under top-2); `aux`
    the Switch loss; `capacity` C."""
    slots: torch.Tensor
    gates: torch.Tensor
    aux: torch.Tensor
    capacity: int


def expert_capacity(n_tokens: int, n_experts: int,
                    capacity_factor: float) -> int:
    """Per-expert token capacity, padded to a multiple of 8 (JAX's formula:
    its [E, C, D] batch keeps the MXU's sublane alignment)."""
    c = int(n_tokens * capacity_factor / n_experts) + 1
    return max(8, ((c + 7) // 8) * 8)


def route(xt: torch.Tensor, router_w: torch.Tensor, *, n_images: int,
          capacity_factor: float, topk: int,
          groups: MoEGroups | None = None) -> Routing:
    """The routing of `xt` [T, D], `n_images` images of T / n_images tokens
    each (module docstring), global over the data axis of `groups`: local
    image i of data rank r is image i * n_data + r of the global batch (the
    loaders' strided shards: one process's batch is the ranks' batches
    interleaved), so every queue runs in one process's token order."""
    T = xt.shape[0]
    E = router_w.shape[-1]
    logits = xt.float() @ router_w.float()                          # [T, E]
    probs = torch.softmax(logits, dim=-1)
    e1 = probs.argmax(dim=-1)
    g1 = probs.gather(1, e1[:, None])[:, 0]
    choices, gates = [e1], [g1]
    if topk == 2:
        masked = logits - F.one_hot(e1, E).to(logits.dtype) * 2e30
        e2 = masked.argmax(dim=-1)
        choices.append(e2)
        gates.append(probs.gather(1, e2[:, None])[:, 0])
    # each choice's tokens of an expert before it in its own image, and
    # each image's count per expert
    onehots = [F.one_hot(e, E).view(n_images, -1, E) for e in choices]
    within = [oh.cumsum(1) - oh for oh in onehots]
    counts = torch.cat([oh.sum(1) for oh in onehots], 1)     # [b, k * E]
    psum = probs.sum(0)
    n_data = groups.n_data if groups is not None else 1
    if n_data > 1:
        # counts are exact in f32 below 2^24 tokens
        mine = torch.cat([counts.float().reshape(-1), psum.detach()])
        rows = dist.all_gather_rows(mine.to(dist.collective_device()),
                                    groups.data).to(xt.device)
        images = rows[:, :counts.numel()].long().view(n_data, n_images, -1)
        images = images.transpose(0, 1).reshape(n_images * n_data, -1)
        mine_at = torch.arange(n_images, device=xt.device) * n_data \
            + groups.data_rank
        psum_all = rows[:, counts.numel():].sum(0)
    else:
        images, mine_at, psum_all = counts, None, None
    before = images.cumsum(0) - images                 # earlier images' counts
    if mine_at is not None:
        before = before[mine_at]
    total = images.sum(0)                                        # [k * E]
    n_tokens = T * n_data
    C = expert_capacity(n_tokens, E, capacity_factor * topk)
    slots = []
    for k, e in enumerate(choices):
        queue = before[:, k * E:(k + 1) * E, None].transpose(1, 2) + within[k]
        if k == 1:      # second choices queue behind every first choice
            queue = queue + total[:E]
        pos = queue.reshape(T, E).gather(1, e[:, None])[:, 0]
        slots.append(torch.where(pos < C, e * C + pos, -1))
    if topk == 2:
        denom = torch.clamp(gates[0] + gates[1], min=1e-9)
        gates = [g / denom for g in gates]
    f = total[:E].float() / n_tokens
    aux = E * (f * (psum / T)).sum()
    if psum_all is not None:
        aux = aux + (E * (f * (psum_all / n_tokens)).sum() - aux).detach()
    return Routing(torch.stack(slots, 1), torch.stack(gates, 1), aux, C)


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src[idx] by rows, a zero row where idx < 0."""
    pad = torch.cat([src, src.new_zeros(1, src.shape[1])])
    return pad[torch.where(idx < 0, src.shape[0], idx)]


class _GatherRows(torch.autograd.Function):
    """out[i] = src[idx[i]] (a zero row where idx[i] < 0). The backward is
    the adjoint gather, grad_src[j] = sum over k, in order, of
    grad_out[inv[j, k]] (nothing where inv[j, k] < 0): `inv` lists every
    out row that reads source row j."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return _take(src, idx)

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        out = _take(g, inv[:, 0])
        for k in range(1, inv.shape[1]):
            out = out + _take(g, inv[:, k])
        return out, None, None


def moe_mlp(x: torch.Tensor, p: MoEMlp, *, act,
            capacity_factor: float = 1.25, topk: int = 1,
            groups: MoEGroups | None = None):
    """Top-1 (Switch) or top-2 (GShard) MoE FFN over the token axis.

    x [B, S, D] -> (y [B, S, D] in x.dtype, aux f32 scalar). Routing runs
    in f32, the expert FFNs in x.dtype with the weights cast to it, as the
    dense MLP. `groups` places the rows and the experts across ranks
    (module docstring)."""
    E = p.router_w.shape[-1]
    if topk not in (1, 2):
        raise ValueError(f"topk must be 1 or 2, got {topk}")
    if topk == 2 and E < 2:
        raise ValueError("topk=2 needs at least 2 experts")
    B, S, D = x.shape
    dt = x.dtype
    xt = x.reshape(B * S, D)
    r = route(xt, p.router_w, n_images=B, capacity_factor=capacity_factor,
              topk=topk, groups=groups)
    T, C = xt.shape[0], r.capacity
    n_expert = groups.n_expert if groups is not None else 1
    n_local = p.fc1_w.shape[0]
    if n_local * n_expert != E:
        raise ValueError(f"{n_local} experts on each of {n_expert} ranks; "
                         f"the router has {E}")
    # this rank's slots: local index, -1 for a dropped token or another
    # rank's expert
    n_slots = n_local * C
    first = (groups.expert_rank if groups is not None else 0) * n_slots
    local = r.slots - first
    slots = torch.where((r.slots >= 0) & (local >= 0) & (local < n_slots),
                        local, -1)                                # [T, K]
    flat = slots.reshape(-1)
    # the (token, choice) of each slot, one at most; the dropped ones all
    # go to a last entry, which is cut off (no host sync, no atomics on a
    # slot that is read)
    slot_tk = torch.full((n_slots + 1,), -1, dtype=torch.long,
                         device=x.device)
    slot_tk.scatter_(0, torch.where(flat >= 0, flat, n_slots),
                     torch.arange(flat.numel(), device=x.device))
    slot_tk = slot_tk[:n_slots]
    slot_tok = torch.where(slot_tk >= 0, slot_tk // topk, -1)
    xin = xt
    if n_expert > 1:
        xin = dist.CopyToGroup.apply(xt, groups.expert)
    xe = _GatherRows.apply(xin, slot_tok, slots).view(n_local, C, D)
    h = act(torch.baddbmm(p.fc1_b[:, None, :].to(dt), xe, p.fc1_w.to(dt)))
    ye = torch.baddbmm(p.fc2_b[:, None, :].to(dt), h, p.fc2_w.to(dt))
    yk = _GatherRows.apply(ye.reshape(n_slots, D), flat, slot_tk[:, None])
    yk = yk.view(T, topk, D)
    if n_expert > 1:
        yk = dist.ReduceFromGroup.apply(yk, groups.expert)
    g = r.gates.to(dt)
    if topk == 1:
        y = g[:, :1] * yk[:, 0]
    else:
        y = (g[:, :1].float() * yk[:, 0].float()
             + g[:, 1:].float() * yk[:, 1].float()).to(dt)
    return y.reshape(B, S, D), r.aux


@torch.no_grad()
def init_moe_mlp(moe: MoEMlp, trunc_normal) -> None:
    """JAX's draws: the router and the expert weights truncated normals of
    std 0.02 (`trunc_normal(tensor)` fills one), the biases zero."""
    for w in (moe.router_w, moe.fc1_w, moe.fc2_w):
        trunc_normal(w)
    moe.fc1_b.zero_()
    moe.fc2_b.zero_()
