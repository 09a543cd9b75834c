"""GPipe pipeline parallelism for the ViT classifier over a "stage" mesh
axis (counterpart of the JAX package's parallel/pipeline.py).

JAX runs the schedule as one SPMD program over a ('data', 'stage') mesh.
The port runs one process per rank: on the ("data", "stage") DeviceMesh of
shape (W/S, S) (``parallel/mesh.make_mesh(n_stage=S)``) stage rank s holds
blocks [s*L/S, (s+1)*L/S) of the classifier and the replicated rest (the
stem: patch embedding, CLS, positions; the final LayerNorm; the head).
``shard_params_pp`` is that placement on a flat state {name: tensor}
(timm's names, ``blocks.{i}.…``); ``stage_model`` applies it to a model in
place, so the other stages' block tensors are freed on the rank.
``stage_blocks`` / ``unstage_blocks`` are JAX's stacked layout ([S, L/S,
...] leaves) and its inverse, the flat layout checkpoints keep.

The schedule, explicit on every rank. The rank's local batch (its data
shard, which every stage of a group reads) splits into M microbatches.

- Forward: stage 0 embeds the whole local batch (``models/vit.vit_embed``,
  the stem the plain forward runs) and, microbatch by microbatch, runs its
  blocks (``models/vit.classifier_blocks``) and sends the activations to
  stage 1 (``parallel/dist.stage_send``); stage s > 0 receives microbatch
  m, runs its blocks and sends it on; the last stage pools it
  (``models/vit.vit_pool``: the final LayerNorm, then CLS or the patch
  mean). So stage s runs microbatch t - s at tick t of T = M + S - 1.
  JAX's lock-step program runs every stage's blocks on every tick, the
  bubble's too, under `where` gates; here a stage with nothing to do at a
  tick (the bubble, (S - 1)/(M + S - 1) of the ticks) skips it. A rank
  runs its L/S blocks M times a pass: L/S * M attention forwards, and in a
  training step as many backwards (with ``remat`` another L/S * M
  forwards).
- Backward (``pipeline_backward``), not left to the autograd engine, which
  would see the M microbatch graphs of a stage as independent branches and
  could order their hops otherwise than the neighbour posts its receives:
  the last stage backpropagates its microbatches' losses in reverse order,
  M - 1 down to 0, and sends each input gradient back; stage s receives
  microbatch m's, backpropagates it through its blocks and sends its own
  input gradient on; stage 0 then backpropagates the stem once over the
  whole batch. Every hop carries a tag (direction, microbatch) that the
  receiver checks, so a schedule out of step raises.

Gradients land in each parameter's ``.grad``: a block leaf's on its
stage; a replicated leaf's where it is used, the stem's on stage 0, the
final LayerNorm's and the head's on the last stage (only it runs the
loss). The trainer sums the replicated ones over the stage group (one term
is not zero, so every stage holds the same bits) and averages everything
over the data group (train/vit_loop.py, mode "pp").

The forward-only entries, ``pipeline_features`` and ``pipeline_classify``
(validation, the RSA), broadcast the last stage's pooled features [B,
width] over the stage group, as JAX's closing psum does, so every rank
returns the whole result.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import torch
from torch import nn

from ..models import vit as vvit
from . import dist

_BLOCK = re.compile(r"blocks\.(\d+)\.(.+)")


def is_block_leaf(name: str) -> bool:
    """True for a leaf of one of the classifier's blocks."""
    return _BLOCK.fullmatch(name) is not None


def _split_blocks(state: dict) -> tuple[dict, list]:
    """(rest, [{leaf: tensor} of each block held, in block order])."""
    rest, blocks = {}, {}
    for name, x in state.items():
        m = _BLOCK.fullmatch(name)
        if m:
            blocks.setdefault(int(m.group(1)), {})[m.group(2)] = x
        else:
            rest[name] = x
    return rest, [blocks[i] for i in sorted(blocks)]


def _bounds(layers: int, n_stages: int, index: int) -> tuple[int, int]:
    if layers % n_stages != 0:
        raise ValueError(f"layers ({layers}) must divide by n_stages "
                         f"({n_stages})")
    lp = layers // n_stages
    return index * lp, (index + 1) * lp


def stage_blocks(state: dict, n_stages: int) -> tuple[dict, dict]:
    """Split the classifier's flat state into (rest, blocks_st): blocks_st
    stacks each block leaf over the layers into [n_stages, L / n_stages,
    ...] (JAX's layout); rest is every other leaf."""
    rest, blocks = _split_blocks(state)
    L = len(blocks)
    _bounds(L, n_stages, 0)
    return rest, {leaf: torch.stack([b[leaf] for b in blocks]).reshape(
        (n_stages, L // n_stages) + tuple(x.shape))
        for leaf, x in blocks[0].items()}


def unstage_blocks(rest: dict, blocks_st: dict) -> dict:
    """Inverse of ``stage_blocks``: the flat state (block leaves as views
    of blocks_st's)."""
    n_stages, lp = next(iter(blocks_st.values())).shape[:2]
    flat = dict(rest)
    for s in range(n_stages):
        for j in range(lp):
            for leaf, x in blocks_st.items():
                flat[f"blocks.{s * lp + j}.{leaf}"] = x[s, j]
    return flat


@dataclass(frozen=True)
class Stages:
    """A stage group: the process group `group` of the `n` stages of one
    data shard, this rank's stage `index`, and the data axis's size."""
    group: object
    n: int
    index: int
    n_data: int

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.n - 1


def stages_of(mesh) -> Stages:
    """This rank's place on `mesh`'s "stage" axis."""
    names = tuple(mesh.mesh_dim_names or ())
    if "stage" not in names:
        raise ValueError(f"mesh {names} has no 'stage' axis")
    n_data = mesh.size(names.index("data")) if "data" in names else 1
    return Stages(mesh.get_group("stage"), mesh.size(names.index("stage")),
                  mesh.get_local_rank("stage"), n_data)


def shard_params_pp(mesh, state: dict, n_stages: int | None = None) -> dict:
    """This rank's share of the classifier's flat state (parameters or
    momentum) on `mesh`'s "stage" axis: its stage's L / S blocks and every
    other leaf, the same tensors (the rest replicated, as JAX places
    it)."""
    st = stages_of(mesh)
    n_stages = st.n if n_stages is None else n_stages
    if n_stages != st.n:
        raise ValueError(f"n_stages ({n_stages}) != mesh 'stage' size "
                         f"({st.n})")
    lo, hi = _bounds(len(_split_blocks(state)[1]), n_stages, st.index)
    return {name: x for name, x in state.items()
            if not is_block_leaf(name)
            or lo <= int(_BLOCK.fullmatch(name).group(1)) < hi}


class OtherStage(nn.Module):
    """The place of a block that another stage's ranks hold: no tensors;
    calling it raises."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"block {self.index} lives on another pipeline "
                           f"stage's ranks")


def stage_model(model: vvit.VisionTransformerClassifier, mesh):
    """``shard_params_pp`` on `model` in place: every block this rank's
    stage does not hold becomes an ``OtherStage`` (its tensors freed).
    Returns `model`."""
    kept = shard_params_pp(mesh, dict(model.named_parameters()))
    for i in range(len(model.blocks)):
        if f"blocks.{i}.norm1.weight" not in kept:
            model.blocks[i] = OtherStage(i)
    return model


def _stage_range(model, st: Stages) -> tuple[int, int]:
    """The blocks [lo, hi) this rank's stage runs; raises unless `model`
    holds exactly those (a model staged for another stage count would
    skip or repeat blocks)."""
    L = len(model.blocks)
    held = [i for i, b in enumerate(model.blocks)
            if not isinstance(b, OtherStage)]
    k = L // len(held) if held and L % len(held) == 0 \
        else f"{L}/{len(held)}"
    if k != st.n:
        raise ValueError(f"blocks_st has {k} stages but the mesh 'stage' "
                         f"axis is {st.n} (use shard_params_pp)")
    lo, hi = _bounds(L, st.n, st.index)
    if held != list(range(lo, hi)):
        raise ValueError(f"stage {st.index} runs blocks [{lo}, {hi}) but "
                         f"this rank holds {held} (use shard_params_pp)")
    return lo, hi


def _check_batch(B: int, st: Stages, n_micro: int) -> None:
    """JAX's check on the global batch: the local one is B / n_data."""
    if B % n_micro != 0:
        raise ValueError(f"batch {B * st.n_data} must divide by "
                         f"n_data*n_micro = {st.n_data}*{n_micro}")


def _tag(backward: bool, m: int, n_micro: int) -> int:
    return n_micro * int(backward) + m


def _forward(model, images, st: Stages, lo: int, hi: int, n_micro: int, *,
             input_norm, compute_dtype, remat: bool, grad: bool):
    """The forward schedule: (the stem's output on stage 0, else None; each
    microbatch's input to this stage's blocks; their output, or None where
    nothing needs it). With `grad` the inputs are leaves that will hold
    their gradients."""
    cfg = model.cfg
    mb = images.shape[0] // n_micro
    stem = None
    if st.first:
        stem = vvit.vit_embed(model, images, input_norm=input_norm,
                              compute_dtype=compute_dtype)
    ins, outs, pending = [], [], []
    for m in range(n_micro):
        if st.first:
            x = stem[m * mb:(m + 1) * mb]
        else:
            x = dist.stage_recv((mb, cfg.seq_len, cfg.width), compute_dtype,
                                images.device, st.group, st.index - 1,
                                _tag(False, m, n_micro))
        if grad:
            x = x.detach().requires_grad_()
        y = vvit.classifier_blocks(model, x, lo, hi, remat=remat)
        if not st.last:
            pending.append(dist.stage_send(y, st.group, st.index + 1,
                                           _tag(False, m, n_micro)))
        ins.append(x if grad else None)
        outs.append(y if grad or st.last else None)
    dist.wait_sends(pending)
    return stem, ins, outs


@torch.no_grad()
def pipeline_features(model: vvit.VisionTransformerClassifier,
                      images: torch.Tensor, mesh, *, n_micro: int,
                      pool: str = "token", input_norm: tuple | None = None,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """Pipelined trunk: this rank's images [B, H, W, 3] (its data shard)
    -> pooled features [B, width] in the compute dtype on every rank of
    the stage group (the final LayerNorm applied; pool='token' the CLS
    token, 'avg' the patch mean: ``models/vit.forward_features``'s
    contract). `model` must be staged for `mesh` (``stage_model``), and
    `n_micro` must divide B."""
    st = stages_of(mesh)
    _check_batch(images.shape[0], st, n_micro)
    lo, hi = _stage_range(model, st)
    _, _, outs = _forward(model, images, st, lo, hi, n_micro,
                          input_norm=input_norm, compute_dtype=compute_dtype,
                          remat=False, grad=False)
    if st.last:
        feats = torch.cat([vvit.vit_pool(model, y, pool) for y in outs])
    else:
        feats = torch.empty((images.shape[0], model.cfg.width),
                            dtype=compute_dtype, device=images.device)
    return dist.broadcast_from(feats, st.n - 1, st.group)


@torch.no_grad()
def pipeline_classify(model: vvit.VisionTransformerClassifier,
                      images: torch.Tensor, mesh, *, n_micro: int,
                      input_norm: tuple | None = None,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """Pipelined classifier logits [B, num_classes] in f32 on every rank of
    the stage group (``models/vit.vit_classify``'s contract): the pipelined
    trunk, the CLS token, the head."""
    feats = pipeline_features(model, images, mesh, n_micro=n_micro,
                              pool="token", input_norm=input_norm,
                              compute_dtype=compute_dtype)
    return vvit.classifier_head(model, feats)


def _mean_ce(model, y: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean cross-entropy of the head's logits on the last block's
    tokens y."""
    logp = torch.log_softmax(
        vvit.classifier_head(model, vvit.vit_pool(model, y)), -1)
    return -logp.gather(1, labels[:, None].long())[:, 0].mean()


def pipeline_backward(model: vvit.VisionTransformerClassifier,
                      images: torch.Tensor, labels: torch.Tensor, mesh, *,
                      n_micro: int, input_norm: tuple | None = None,
                      compute_dtype=torch.float32,
                      remat: bool = False) -> torch.Tensor:
    """One GPipe forward and backward of the mean cross-entropy of this
    rank's batch (module docstring). Adds this stage's gradients to the
    ``.grad`` of the parameters it used; returns the loss (an f32 device
    scalar) on the last stage and 0 on the others. `remat` recomputes each
    block's forward in the backward."""
    st = stages_of(mesh)
    _check_batch(images.shape[0], st, n_micro)
    lo, hi = _stage_range(model, st)
    stem, ins, outs = _forward(model, images, st, lo, hi, n_micro,
                               input_norm=input_norm,
                               compute_dtype=compute_dtype, remat=remat,
                               grad=True)
    loss = torch.zeros((), dtype=torch.float32, device=images.device)
    if st.last:
        # the last stage's graphs end in each microbatch's mean CE over M,
        # whose sum is the batch's mean
        outs = [_mean_ce(model, y, lbl) / n_micro
                for y, lbl in zip(outs, labels.chunk(n_micro))]
        loss = torch.stack([lm.detach() for lm in outs]).sum()
    pending = []
    for m in reversed(range(n_micro)):
        if st.last:
            torch.autograd.backward(outs[m])
        else:
            dy = dist.stage_recv(outs[m].shape, outs[m].dtype, images.device,
                                 st.group, st.index + 1,
                                 _tag(True, m, n_micro))
            torch.autograd.backward(outs[m], dy)
        outs[m] = None
        if not st.first:
            pending.append(dist.stage_send(ins[m].grad, st.group,
                                           st.index - 1,
                                           _tag(True, m, n_micro)))
            ins[m] = None
    dist.wait_sends(pending)
    if st.first:
        torch.autograd.backward(stem, torch.cat([x.grad for x in ins]))
    return loss
