"""ViT-B/16 ImageNet supervised training, one process per card
(counterpart of the JAX package's train/vit_loop.py).

The reference DDP pipeline (train_vit_sgd.py), as the JAX package trains it:
SGD with momentum and torch-style weight decay added to the gradient, the
warmup-cosine schedule stepped per epoch, per-epoch full-state checkpoints
plus training_metrics.csv, auto-resume from checkpoint_latest.pth, and
mid-epoch preemption with a bit-exact resume.

- bf16 compute (no GradScaler state) over f32 master weights;
- the update is the JAX step's arithmetic on explicit tensors,
  buf = m * buf + (g + wd * p), p = p - lr * buf, applied in place to the
  model's parameters and the momentum buffers (the JAX step returns new
  trees; in place saves a copy of both). The momentum is defined from step
  0, so checkpoints hold the same tree in both packages;
- validation sums the loss, the correct count and the image count on the
  card and divides once (fixing the reference's unnormalized all_reduce of
  per-rank averages, train_vit_sgd.py:193-196);
- a feeder thread copies batch k+1 to the card through pinned memory while
  batch k trains (``device_prefetch``);
- ``fused_dw`` routes every dense layer with a bias (the qkv, output, fc1
  and fc2 projections of each block and the head) through the fused dW+db
  kernel, ``ops/fused_dw.py``: 49 launches per ViT-B/16 step;
- ``host_prefetch`` copies the epoch's checkpoint trees to the host beside
  validation (``core/hostcopy.py``);
- a perturbed epoch (the measurement grid, cli/vit_measure.py): "gaussian"
  and "uniform_gray" replace the normalized images of every batch, each
  batch drawing from its own key (seed, epoch, batch index), so a mid-epoch
  resume draws the same noise; "label_shuffle" and "target_noise" go
  through the loader's ``label_table``, which the caller sets;
- ``compute_rsa_score``: the CLS embeddings of the THINGS-48 images in
  dataset order against the human RDM (Spearman rho).

``profile_dir`` wraps the first epoch this call trains in a
``torch.profiler`` trace (core/profiling.py).

Data parallelism over a ``torch.distributed`` group (parallel/dist.py;
one process per card under torchrun, NCCL on cards, gloo on the CPU), as
JAX's multi-process path runs it: each rank loads a strided shard of the
data (``num_shards`` = the world size, ``shard_id`` = the rank) and feeds
its local batch, global batch / world size; the global batch is the union
of the ranks' batches. Every number a CSV holds is global: the train
loss is the mean of the ranks' sums, read on the host only where it is
printed; validation all-reduces its three sums; the RSA embeds each
rank's strided THINGS shard and gathers it in dataset order. Three modes,
each with the update arithmetic above on the same numbers:

- dp: one all-reduce of the flattened gradients, divided by the world
  size (DDP's arithmetic; the gradients come from ``torch.autograd.grad``,
  which DDP's reducer would not see, so the trainer issues the collective;
  a data axis of one skips it);
- ``zero1``: as dp, but each rank keeps the momentum rows of its share of
  every leaf whose leading axis the world size divides (JAX's
  ``zero1_sharding``; others whole), updates those rows of the parameters
  and all-gathers them. The numbers are dp's bit for bit;
- ``fsdp``: FSDP2 ``fully_shard`` on every block and on the root; the
  gradients come from ``.backward()`` (FSDP2's reduce-scatter hooks into
  it; with ``grad_accum`` the microbatches before the last skip the
  sync), and the update runs on each rank's shards of the parameters and
  the momentum (DTensors, updated through their local tensors).

Tensor parallelism, ``tp`` (``tp_devices`` = T > 1, under torchrun with W
ranks): JAX's ("data", "model") mesh of shape (W/T, T), row-major, so each
model group is T consecutive ranks (``parallel/mesh.make_mesh``). Each
rank holds its model rank's shards of the block weights and of their
momentum (``parallel/mesh.shard_vit_params_tp``) and the rest whole, and
runs the Megatron block (``models/vit.classifier_block_tp``). The data
shards by the DATA rank: both ranks of a model group read the same
images, local batch = global batch / (W/T). Gradients, shards and whole
leaves alike, are averaged over the data group only (within a model group
the whole leaves' gradients are already equal: the block's copy / reduce
pair makes them so). Validation and the RSA count each image once over the
data axis. Checkpoints gather the shards over the model group into the
flat layout, so dp, tp, one process and the JAX package resume each
other's files.

MoE (``moe_experts`` > 0, ``ops/moe.py``): the loss adds
``moe_aux_weight`` times the blocks' summed load-balance loss (JAX's
Switch term). Over the data axis every MoE layer routes as JAX's does on
the global batch: capacity, queue order and aux are global (one all-gather
of per-image expert counts a layer), and the data axis's mean of the
gradients is JAX's. The global batch is the data ranks' images
interleaved, as the strided shards deal them, so with ``grad_accum`` G > 1
the union of the ranks' g-th chunks is the global batch's g-th contiguous
microbatch, JAX's.

Expert parallelism, ``ep`` (``ep_devices`` = ep > 1, under torchrun with W
ranks): JAX's ("data", "expert") mesh of shape (W/ep, ep), row-major.
Each rank holds its expert rank's E / ep experts of every MoE block and of
their momentum (``parallel/mesh.shard_vit_params_ep``) and the rest whole;
the data shards by the data rank (an expert group reads one shard), and
each rank routes the group's tokens, runs its own experts and sums the
group's outputs (``ops/moe.py``). Gradients are averaged over the data
group only; checkpoints gather the experts into the flat layout.

Sequence parallelism, ``sp`` (``sp_devices`` = n > 1, under torchrun with
W ranks; ``sp_ring`` for ring attention): JAX's ("data", "model") mesh of
shape (W/n, n), as tp's. Every rank holds the whole model; a model group
reads one data shard (by the data rank, as tp), and each of its ranks runs
the trunk on its tokens (``models/vit.py``: the gather form on the flash
kernels, or the ring). The head and the loss see the gathered tokens on
every rank; only model rank 0 differentiates its loss (the others seed
theirs with 0 and still run every backward collective), so each leaf's
gradient is counted once: the trunk's are the ranks' token shares, the
head's model rank 0's. One all-reduce over every rank, divided by the data
axis, then sums them over the model group and averages them over the data
group. ``zero1`` splits the momentum over the data axis (JAX's
``zero1_sharding`` on "data"; the model group holds equal shares);
``grad_accum`` and ``remat`` compose as they do alone. Checkpoints are
the flat layout.

``fused_dw`` is refused with more than one process, as JAX refuses it on a
multi-device mesh. The pipeline is not ported yet and is refused by name.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from ..core import hostcopy
from ..core.configs import IMAGENET_MEAN, IMAGENET_STD, ViTTrainConfig
from ..core.device import resolve_device
from ..data.imagenet import normalize_imagenet
from ..models import convert as vconvert
from ..models import vit as vvit
from ..ops import moe as vmoe
from ..ops import rsa as vrsa
from ..parallel import dist
from ..parallel import mesh as vmesh
from ..perturb import injectors

IMAGENET_NORM = (IMAGENET_MEAN, IMAGENET_STD)
# image perturbations, applied in the step; the label kinds go through the
# loader's label_table
IMAGE_PERTURBATIONS = ("gaussian", "uniform_gray")

# ViTTrainConfig fields whose features are not ported yet, with the value
# that leaves them off
_UNPORTED = (("pp_stages", 1),)


def train_mode(cfg: ViTTrainConfig, grouped: bool,
               heads: int | None = None, moe: bool | None = None) -> str:
    """"single" (no process group), "dp", "zero1", "fsdp" (fsdp wins over
    zero1: its shards hold the momentum too, as JAX's), "tp", "ep" or
    "sp" (zero1 under sp is the trainer's ``zero1`` flag).
    Raises on the combinations JAX refuses (in its words; `heads`, when
    given, must divide over tp_devices; `moe`, whether the model has MoE
    blocks, defaults to cfg.moe_experts > 0), before the refusal of what is
    not ported."""
    moe = cfg.moe_experts > 0 if moe is None else moe
    sharded = cfg.zero1 or cfg.fsdp
    tp, ep, sp = cfg.tp_devices > 1, cfg.ep_devices > 1, cfg.sp_devices > 1
    if sum((cfg.pp_stages > 1, sp, ep, tp)) > 1:
        raise ValueError("pp_stages / sp_devices / ep_devices / tp_devices "
                         "each need the whole second mesh axis; enable at "
                         "most one")
    if tp and moe:
        raise ValueError("tp_devices does not compose with MoE blocks: the "
                         "expert FFNs shard over 'expert', not 'model' (use "
                         "ep_devices)")
    if tp and heads is not None and heads % cfg.tp_devices != 0:
        raise ValueError(f"tp_devices ({cfg.tp_devices}) must divide the "
                         f"model heads ({heads}) for head-aligned qkv "
                         f"sharding")
    if ep and not moe:
        raise ValueError("ep_devices > 1 needs a MoE model "
                         "(vit_cfg.moe_experts > 0)")
    if cfg.pp_stages > 1 and moe:
        raise ValueError("MoE blocks are not supported on the pipeline "
                         "path (the GPipe schedule drops the aux loss)")
    if cfg.sp_ring and not sp:
        raise ValueError("sp_ring needs sp_devices > 1 (ring attention "
                         "rotates k/v around the sequence shards)")
    if cfg.sp_ring and moe:
        raise ValueError(
            "sp_ring does not compose with MoE blocks: the ring pads the "
            "token stream, and padded tokens would compete for expert "
            "capacity and pollute the aux loss (a second token-mixing "
            "channel) — use the gather sp path (sp_ring=False), which "
            "never pads")
    if sharded and cfg.pp_stages > 1:
        raise ValueError("zero1/fsdp shard over the 'data' axis of the dp "
                         "mesh; they do not compose with pp_stages")
    if sharded and ep:
        raise ValueError(
            "zero1/fsdp do not compose with ep_devices: their step "
            "constraints would pin the expert-sharded FFN weights "
            "to the 'data' layout (defeating expert parallelism) and "
            "reshard the momentum between 'expert' and 'data' every "
            "step")
    if sharded and tp:
        raise ValueError(
            "zero1/fsdp do not compose with tp_devices: their "
            "zero1_sharding constraints would re-layout the model-sharded "
            "block weights to the 'data' axis every step")
    if cfg.fsdp and sp:
        raise ValueError(
            "fsdp does not compose with sp_devices: fsdp's attention "
            "pin is sequence-replicated and defeats the "
            "sequence-sharded attention path")
    refuse_unported(cfg)
    if not grouped:
        if sharded:
            raise ValueError(
                "zero1/fsdp shard over the ranks of a process group: launch "
                "with torchrun (--nproc_per_node 1 for one card)")
        if tp:
            raise ValueError(
                "tp_devices shards the blocks over the ranks of a process "
                "group: launch with torchrun (--nproc_per_node tp_devices "
                "or a multiple of it)")
        if ep:
            raise ValueError(
                "ep_devices shards the experts over the ranks of a process "
                "group: launch with torchrun (--nproc_per_node ep_devices "
                "or a multiple of it)")
        if sp:
            raise ValueError(
                "sp_devices shards the tokens over the ranks of a process "
                "group: launch with torchrun (--nproc_per_node sp_devices "
                "or a multiple of it)")
        return "single"
    if cfg.fused_dw and dist.world_size() > 1:
        # JAX: the kernel has no GSPMD rule, so a sharded mesh would
        # all-gather its operands to one device
        raise ValueError("fused_dw is a single-chip path; disable it with "
                         f"{dist.world_size()} processes")
    if tp or ep or sp:
        return "tp" if tp else "ep" if ep else "sp"
    return "fsdp" if cfg.fsdp else "zero1" if cfg.zero1 else "dp"


def refuse_unported(cfg: ViTTrainConfig) -> None:
    for name, off in _UNPORTED:
        value = getattr(cfg, name)
        if value != off:
            raise NotImplementedError(
                f"ViTTrainConfig.{name}={value!r} is not ported to "
                f"vit_project_torch yet (leave it at {off!r}, or run the "
                f"JAX package)")


def sgd_init(params: dict) -> dict:
    """Momentum buffers, zero. Every mode's first update is m * 0 + g_0,
    which is torch SGD's buf_0 = g_0 bit for bit (0 * m and 0 + x are
    exact)."""
    return {k: torch.zeros_like(v) for k, v in params.items()}


def _device_prefetch(batches, place, depth: int):
    """Overlap the copy of batch k+1 to the card with the step on batch k:
    `place` (pinned host copy + non-blocking transfer) runs on the feeder
    thread (core/feeder.py holds the thread discipline)."""
    from ..core.feeder import feed
    return feed((place(images_u8, labels) for images_u8, labels in batches),
                depth)


class ViTTrainer:
    """The train step and validation of one classifier on this process's
    device, data-parallel over the default process group when there is
    one (module docstring). The step updates the model's parameters and
    the momentum buffers in place. Under ``fsdp`` the constructor shards
    `model` in place (FSDP2), so the parameters must already be the ones
    to train; ``init_momentum`` gives the momentum in the mode's layout.

    ``distributed=False`` keeps a trainer alone in a process that has a
    group (it then trains its own data, with no collective)."""

    def __init__(self, vit_cfg: vvit.ViTConfig, train_cfg: ViTTrainConfig,
                 model: vvit.VisionTransformerClassifier, device,
                 distributed: bool | None = None):
        grouped = dist.is_initialized() if distributed is None \
            else distributed
        if model.cfg != vit_cfg:
            # JAX's trainer has one config; the port's forward reads the
            # model's, so the two must be the same
            raise ValueError(f"vit_cfg {vit_cfg} is not the model's config "
                             f"{model.cfg}")
        self.moe = vit_cfg.moe_experts > 0
        self.mode = train_mode(train_cfg, grouped, vit_cfg.heads, self.moe)
        self.world = dist.world_size() if grouped else 1
        self.rank = dist.rank() if grouped else 0
        self.vit_cfg = vit_cfg
        self.cfg = train_cfg
        self.model = model
        self.device = torch.device(device)
        # the data axis: every rank, except under tp, ep and sp, where it
        # is the mesh's "data" dimension (a model or expert group reads one
        # shard)
        self.n_data, self.data_rank, self.data_group = \
            self.world, self.rank, None
        self.tp_group = self.ep_group = self.seq_shard = None
        self.ring = self.mode == "sp" and bool(train_cfg.sp_ring)
        self.zero1 = self.mode == "zero1" or (self.mode == "sp"
                                              and train_cfg.zero1)
        self.model_rank = 0
        if self.mode in ("tp", "ep", "sp"):
            n = {"tp": train_cfg.tp_devices, "ep": train_cfg.ep_devices,
                 "sp": train_cfg.sp_devices}[self.mode]
            axis = "expert" if self.mode == "ep" else "model"
            mesh = vmesh.make_mesh(**{f"n_{axis}": n})
            self.data_group = mesh.get_group("data")
            self.n_data = self.world // n
            self.data_rank = mesh.get_local_rank("data")
            index = mesh.get_local_rank(axis)
            named = dict(model.named_parameters())
            local = None
            if self.mode == "tp":
                self.tp_group, self.model_rank = mesh.get_group(axis), index
                local = vmesh.shard_vit_params_tp(named, n, index,
                                                  heads=vit_cfg.heads)
            elif self.mode == "ep":
                self.ep_group, self.expert_rank = mesh.get_group(axis), index
                local = vmesh.shard_vit_params_ep(named, n, index)
            else:
                self.seq_shard = vmesh.seq_sharding(mesh)
                self.model_rank = index
            with torch.no_grad():
                for name in self.shard_names():
                    owner, leaf = name.rsplit(".", 1)
                    setattr(model.get_submodule(owner), leaf,
                            torch.nn.Parameter(local[name]))
        # where the MoE layers' rows and experts live (none: one process, or
        # a data axis of one without ep, where no collective runs)
        self.moe_groups = None
        if self.moe and (self.n_data > 1 or self.ep_group is not None):
            self.moe_groups = vmoe.MoEGroups(
                data=self.data_group, n_data=self.n_data,
                data_rank=self.data_rank, expert=self.ep_group,
                n_expert=train_cfg.ep_devices if self.ep_group else 1,
                expert_rank=self.expert_rank if self.ep_group else 0)
        if self.mode == "fsdp":
            from torch.distributed.fsdp import fully_shard
            data_mesh = vmesh.make_mesh(device_type=self.device.type)
            for blk in model.blocks:
                fully_shard(blk, mesh=data_mesh)
            fully_shard(model, mesh=data_mesh)
        self.compute_dtype = (torch.bfloat16
                              if train_cfg.compute_dtype == "bfloat16"
                              else torch.float32)
        # per trainer, never process-wide: another trainer in the same
        # process keeps its own choice
        self.fused_dw = bool(train_cfg.fused_dw)

    # -- steps ----------------------------------------------------------------

    def logits(self, images: torch.Tensor, remat: bool = False,
               input_norm: tuple | None = IMAGENET_NORM,
               with_aux: bool = False):
        """f32 logits of raw 0..255 images (the normalization folded into
        the patch matrix), or of normalized images with input_norm=None;
        with `with_aux`, (logits, the MoE load-balance loss)."""
        return self.model(images, input_norm=input_norm,
                          compute_dtype=self.compute_dtype, remat=remat,
                          fused_dw=self.fused_dw, tp=self.tp_group,
                          moe_groups=self.moe_groups, with_aux=with_aux,
                          seq_shard=self.seq_shard, ring_attn=self.ring)

    def loss(self, images: torch.Tensor, labels: torch.Tensor,
             input_norm: tuple | None = IMAGENET_NORM):
        """Mean cross-entropy on f32 logits, plus moe_aux_weight times the
        load-balance loss of a MoE model (JAX's Switch term)."""
        out = self.logits(images, self.cfg.remat, input_norm,
                          with_aux=self.moe)
        logits, aux = out if self.moe else (out, None)
        logp = torch.log_softmax(logits, -1)
        loss = -logp.gather(1, labels[:, None].long())[:, 0].mean()
        if self.moe:
            loss = loss + self.cfg.moe_aux_weight * aux
        return loss

    def _grad(self, loss: torch.Tensor, params: list):
        """d loss / d params. Under sp only model rank 0 counts its loss
        (the others seed it with 0, so their gradients are their tokens'
        share of what rank 0's loss asks of them, and every backward
        collective still runs on every rank)."""
        counted = self.mode != "sp" or self.model_rank == 0
        seed = torch.ones_like(loss) if counted else torch.zeros_like(loss)
        return torch.autograd.grad(loss, params, grad_outputs=seed)

    def batch_grads(self, params: list, images, labels,
                    input_norm: tuple | None = IMAGENET_NORM):
        """(loss, grads) of the batch; with grad_accum = G > 1 the batch is
        split into G microbatches whose gradients are summed in order and
        divided by G (peak activation memory of one microbatch; CE is a mean
        over equal microbatches, so the numbers are the unsplit step's)."""
        G = self.cfg.grad_accum
        if G == 1:
            loss = self.loss(images, labels, input_norm)
            return loss.detach(), self._grad(loss, params)
        B = images.shape[0]
        if B % G != 0:
            raise ValueError(f"grad_accum ({G}) must divide the global batch "
                             f"({B})")
        total = torch.zeros((), dtype=torch.float32, device=images.device)
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        for img_g, lbl_g in zip(images.chunk(G), labels.chunk(G)):
            loss = self.loss(img_g, lbl_g, input_norm)
            grads = self._grad(loss, params)
            total = total + loss.detach()
            acc = [a + g for a, g in zip(acc, grads)]
        return total / G, [a / G for a in acc]

    def _fsdp_grads(self, images, labels, input_norm):
        """FSDP2: the batch loss, with each parameter's averaged gradient
        shard left in its ``.grad``. With grad_accum = G > 1 the
        microbatches before the last skip the reduce-scatter, so the full
        gradients sum in ``.grad`` in order (as ``batch_grads`` sums them)
        and the last one's backward reduces the sum; the shards are then
        divided by G."""
        G = self.cfg.grad_accum
        if images.shape[0] % G != 0:
            raise ValueError(f"grad_accum ({G}) must divide the global batch "
                             f"({images.shape[0]})")
        total = torch.zeros((), dtype=torch.float32, device=images.device)
        for g, (img_g, lbl_g) in enumerate(zip(images.chunk(G),
                                               labels.chunk(G))):
            self.model.set_requires_gradient_sync(g == G - 1)
            loss = self.loss(img_g, lbl_g, input_norm)
            loss.backward()
            total = total + loss.detach()
        grads = [p.grad.to_local() for p in self.model.parameters()]
        if G > 1:
            torch._foreach_div_(grads, G)
        return total / G, grads

    def _all_reduce_mean(self, grads: list) -> list:
        """The data axis's mean of every gradient: one all-reduce of them
        all, flattened, over the data group, then a division by its size.
        Under sp the all-reduce runs over every rank, so it also sums each
        model group's shares."""
        group = None if self.mode == "sp" else self.data_group
        flat = dist.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]),
                                   group)
        flat.div_(self.n_data)
        return [f.view_as(g) for f, g in
                zip(flat.split([g.numel() for g in grads]), grads)]

    def _reshard(self) -> None:
        """FSDP2 keeps the root's parameters gathered after a forward with
        no backward (validation, the RSA): put them back in shards before
        the code that reads them as such."""
        if self.mode == "fsdp":
            self.model.reshard()

    def shard_names(self) -> list:
        """The names of the leaves split over the second mesh axis: the
        tensor-parallel leaves (``mesh.TP_LEAVES``) under tp, the expert
        leaves (``mesh.ep_layout``) under ep; none otherwise."""
        layout = {"tp": vmesh.tp_layout, "ep": vmesh.ep_layout}.get(
            self.mode)
        return [n for n, _ in self.model.named_parameters()
                if layout and layout(n)]

    def check_replicas(self, momentum: dict) -> None:
        """Under tp and ep, raise unless the data group's ranks hold equal
        shards and the model (expert) group's equal whole leaves, of the
        parameters and of `momentum` (the trainer's layout) alike. Under sp
        every rank holds the parameters and the model group's ranks their
        data rank's momentum."""
        if self.mode == "sp":
            dist.check_replicas_equal(list(self.model.parameters()),
                                      "parameters")
            dist.check_replicas_equal(list(momentum.values()), "momentum",
                                      self.seq_shard.group)
            return
        if self.mode not in ("tp", "ep"):
            return
        split = set(self.shard_names())
        what = ("tensor-parallel shards" if self.mode == "tp"
                else "expert shards")
        for st in (dict(self.model.named_parameters()), momentum):
            dist.check_replicas_equal(
                [t for n, t in st.items() if n in split], what,
                self.data_group)
            dist.check_replicas_equal(
                [t for n, t in st.items() if n not in split], "whole leaves",
                self.tp_group or self.ep_group)

    def init_momentum(self, full: dict | None = None) -> dict:
        """The momentum in this mode's layout, from `full` (every leaf
        whole, on the device; zeros when None): whole in single, dp and sp;
        the data rank's rows of the leaves ``zero1_sharding`` splits under
        zero1 (sp's too); DTensors sharded as FSDP2 shards the parameters under
        fsdp; the model rank's shards of the tensor-parallel leaves under
        tp; the expert rank's experts under ep."""
        named = dict(self.model.named_parameters())
        if self.mode == "tp" and full is not None:
            return vmesh.shard_vit_params_tp(full, self.cfg.tp_devices,
                                             self.model_rank)
        if self.mode == "ep" and full is not None:
            return vmesh.shard_vit_params_ep(full, self.cfg.ep_devices,
                                             self.expert_rank)
        if self.mode == "fsdp":
            out = {}
            for n, p in named.items():
                m = torch.zeros_like(p)
                if full is not None:
                    local = m.to_local()
                    part = full[n].chunk(self.world)
                    part = part[self.rank] if self.rank < len(part) else \
                        full[n][:0]
                    if part.shape != local.shape:
                        raise RuntimeError(f"{n}: FSDP2 shard {local.shape} "
                                           f"is not the chunk {part.shape}")
                    with torch.no_grad():
                        local.copy_(part)
                out[n] = m
            return out
        if full is None:
            full = sgd_init(named)
        if not self.zero1:
            return full
        return {n: (vmesh.shard_rows(full[n], self.n_data,
                                     self.data_rank).clone()
                    if vmesh.zero1_sharding(self.n_data, p) else full[n])
                for n, p in named.items()}

    @torch.no_grad()
    def full_state(self, momentum: dict) -> tuple[dict, dict]:
        """(parameters, momentum) by name with every leaf whole, on the
        device; a collective under zero1, fsdp, tp and ep, which every rank
        makes (the checkpoint trees)."""
        self._reshard()
        named = dict(self.model.named_parameters())
        if self.mode == "fsdp":
            return ({n: p.full_tensor() for n, p in named.items()},
                    {n: m.full_tensor() for n, m in momentum.items()})
        if self.mode in ("tp", "ep"):
            return self._unshard(named), self._unshard(momentum)
        if not self.zero1:
            return named, momentum
        split = [n for n, p in named.items()
                 if vmesh.zero1_sharding(self.n_data, p)]
        rows = self._gather_rows([momentum[n] for n in split],
                                 self.data_group)
        full = dict(momentum)
        for n, r in zip(split, rows):
            full[n] = r.reshape(named[n].shape)
        return named, full

    def _unshard(self, state: dict) -> dict:
        """`state` (parameters or momentum, this rank's shards) with every
        split leaf gathered over the model (expert) group into the flat
        layout (``mesh.unshard_vit_params_tp`` / ``_ep``)."""
        names = self.shard_names()
        tp = self.mode == "tp"
        gathered = self._gather_rows([state[n] for n in names],
                                     self.tp_group if tp else self.ep_group)
        unshard = (vmesh.unshard_vit_params_tp if tp
                   else vmesh.unshard_vit_params_ep)
        return unshard([
            {**state, **{n: g[t] for n, g in zip(names, gathered)}}
            for t in range(len(gathered[0]))])

    def _gather_rows(self, shards: list, group=None) -> list:
        """Every rank's `shards` (equal shapes on the ranks of `group`, the
        default group when None) gathered with one all-gather where the
        collectives run: per leaf a [ranks, ...] tensor in rank order, on
        the shards' device."""
        flat = torch.cat([s.reshape(-1) for s in shards])
        stacked = dist.all_gather_rows(flat.to(dist.collective_device()),
                                       group).to(flat.device)
        sizes = [s.numel() for s in shards]
        return [part.reshape((len(stacked),) + tuple(s.shape))
                for part, s in zip(stacked.split(sizes, dim=1), shards)]

    def step(self, momentum: dict, images_u8, labels, lr: float,
             perturb: tuple | None = None):
        """One SGD step in place: buf = m * buf + (g + wd * p);
        p = p - lr * buf. Returns this rank's batch loss (a device scalar).

        `perturb` = (perturbation_type, key, epsilon) of an image
        perturbation: the whole batch is normalized explicitly and the
        injector replaces it in normalized space (the reference's
        GaussianNoiseTransform / UniformGrayTransform,
        measure...effect.py:36-60) before any grad_accum split. Over
        several ranks the gaussian draw is the global batch's, and each
        rank takes the rows of its local batch (data-rank-major, as JAX
        assembles the global batch)."""
        self._reshard()
        named = list(self.model.named_parameters())
        input_norm = IMAGENET_NORM
        if perturb is not None:
            ptype, key, epsilon = perturb
            images = normalize_imagenet(images_u8)
            drawn = None
            if ptype == "gaussian" and self.n_data > 1:
                b = images.shape[0]
                drawn = torch.randn(
                    (self.n_data * b,) + tuple(images.shape[1:]),
                    dtype=images.dtype, device=images.device,
                    generator=key.generator(images.device))[
                        self.data_rank * b:(self.data_rank + 1) * b]
            images_u8, labels = injectors.apply_vit_perturbation(
                ptype, key, images, labels, epsilon=epsilon, drawn=drawn)
            input_norm = None
        if self.mode == "fsdp":
            loss, grads = self._fsdp_grads(images_u8, labels, input_norm)
            with torch.no_grad():
                params = [p.to_local() for _, p in named]
                bufs = [momentum[n].to_local() for n, _ in named]
        else:
            params = [p for _, p in named]
            loss, grads = self.batch_grads(params, images_u8, labels,
                                           input_norm)
            # a data axis of one has nothing to sum, except sp's model group
            if self.n_data > 1 or self.mode == "sp":
                grads = self._all_reduce_mean(list(grads))
            bufs = [momentum[n] for n, _ in named]
            if self.zero1:
                split = [vmesh.zero1_sharding(self.n_data, p)
                         for _, p in named]
                params = [vmesh.shard_rows(p.detach(), self.n_data,
                                           self.data_rank)
                          if s else p for p, s in zip(params, split)]
                grads = [vmesh.shard_rows(g, self.n_data, self.data_rank)
                         if s else g for g, s in zip(grads, split)]
        with torch.no_grad():
            upd = torch._foreach_mul(params, self.cfg.weight_decay)
            torch._foreach_add_(upd, grads)                 # g + wd * p
            torch._foreach_mul_(bufs, self.cfg.momentum)
            torch._foreach_add_(bufs, upd)                  # m * buf + ...
            torch._foreach_sub_(params, torch._foreach_mul(bufs, lr))
            if self.zero1:
                # every rank updated its rows: gather them over the data
                # axis
                mine = [p for p, s in zip(params, split) if s]
                full = [p for (_, p), s in zip(named, split) if s]
                for p, rows in zip(full, self._gather_rows(mine,
                                                           self.data_group)):
                    p.view_as(rows).copy_(rows)
        if self.mode == "fsdp":
            for _, p in named:
                p.grad = None
        return loss

    def global_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The data axis's mean of a device scalar (a new tensor; `t`
        itself on a data axis of one)."""
        if self.n_data == 1:
            return t
        return dist.all_reduce_sum(t.detach().clone(),
                                   self.data_group) / self.n_data

    @torch.no_grad()
    def eval_counts(self, images_u8, labels, valid=None):
        """(sum of CE, correct count, count) of one batch, on the device;
        rows where the float mask `valid` is 0 (a shard's wrap padding)
        count for nothing."""
        logits = self.logits(images_u8)
        logp = torch.log_softmax(logits, -1)
        ce = -logp.gather(1, labels[:, None].long())[:, 0]
        correct = (logits.argmax(-1) == labels.long()).float()
        if valid is None:
            return ce.sum(), correct.sum(), float(len(labels))
        return (ce * valid).sum(), (correct * valid).sum(), valid.sum()

    @torch.no_grad()
    def _feature_step(self, images_u8: torch.Tensor) -> torch.Tensor:
        """CLS embeddings (forward_features, pool='token') of raw 0..255
        images, in the compute dtype."""
        return self.model(images_u8, pool="token", input_norm=IMAGENET_NORM,
                          compute_dtype=self.compute_dtype, tp=self.tp_group,
                          moe_groups=self.moe_groups,
                          seq_shard=self.seq_shard, ring_attn=self.ring)

    # -- epochs ---------------------------------------------------------------

    def place(self, images_u8: np.ndarray, labels: np.ndarray):
        """Host batch -> (uint8 images, int64 labels) on the device; through
        pinned memory and a non-blocking copy on a card."""
        imgs = torch.from_numpy(np.ascontiguousarray(images_u8))
        lbls = torch.from_numpy(np.asarray(labels).astype(np.int64))
        if self.device.type == "cuda":
            imgs, lbls = imgs.pin_memory(), lbls.pin_memory()
        return (imgs.to(self.device, non_blocking=True),
                lbls.to(self.device, non_blocking=True))

    def train_one_epoch(self, momentum: dict, loader, epoch: int, lr: float,
                        *, perturbation_type: str | None = None,
                        epsilon: float = 0.1, perturb_seed: int = 42,
                        log_every: int = 100, logger=None, guard=None,
                        start_batch: int = 0,
                        loss_carry: tuple | None = None) -> float:
        """One epoch; returns the average train loss over the ranks. `guard`
        (core/preempt.py) is polled at batch boundaries; on a stop request
        the loop finishes its step and returns early with
        `guard.mid_state` set to the batch to resume at and the running
        loss. A later call with `start_batch` / `loss_carry` from that state
        skips the trained prefix of the deterministic loader and continues
        the epoch bit-exactly (an image perturbation's key depends only on
        (perturb_seed, epoch, batch index))."""
        log = logger.info if logger else print
        image_perturb = perturbation_type in IMAGE_PERTURBATIONS
        carry_l, carry_n = loss_carry if loss_carry else (0.0, 0)
        # the loss sums on the device; the host reads it (the ranks' mean)
        # every log_every steps and at the end of the epoch
        total_loss = torch.tensor(carry_l, dtype=torch.float32,
                                  device=self.device)
        num_batches = carry_n
        t0 = time.time()
        n_batches = len(loader)
        raw = loader.epoch(epoch)
        if start_batch:
            # mid-epoch resume: decode and drop the trained prefix before
            # the copy stage (the skip costs host decode only)
            raw = (b for i, b in enumerate(raw) if i >= start_batch)
        depth = self.cfg.device_prefetch
        batches = (_device_prefetch(raw, self.place, depth) if depth > 0
                   else (self.place(i, l) for i, l in raw))
        preempted = False
        for off, (images_u8, labels) in enumerate(batches):
            batch_idx = start_batch + off
            perturb = None
            if image_perturb:
                perturb = (perturbation_type, injectors.batch_perturb_key(
                    perturb_seed, epoch, batch_idx), epsilon)
            loss = self.step(momentum, images_u8, labels, lr, perturb)
            total_loss = total_loss + loss
            num_batches += 1
            if batch_idx % log_every == 0:
                log(f"  Epoch {epoch} [{batch_idx:4d}/{n_batches}] "
                    f"Loss: {float(self.global_mean(loss)):.4f} "
                    f"LR: {lr:.6f}")
            if guard is not None and guard.should_stop():
                guard.mid_state = {"epoch": epoch, "batch_idx": batch_idx + 1,
                                   "total_loss": float(total_loss),
                                   "num_batches": num_batches}
                log(f"  Preemption requested - stopping epoch {epoch} after "
                    f"batch {batch_idx} ({num_batches}/{n_batches} done)")
                preempted = True
                break
        avg_loss = float(self.global_mean(total_loss)) / max(num_batches, 1)
        # loader.batch_size is this rank's share: report global images
        self.last_epoch = {"steps": num_batches - carry_n,
                           "images": (num_batches - carry_n)
                           * loader.batch_size * self.n_data,
                           "train_s": time.time() - t0}
        if not preempted:
            dt = self.last_epoch["train_s"]
            log(f"Epoch {epoch} training completed in {dt / 60:.2f} minutes. "
                f"Avg Train Loss: {avg_loss:.4f} [images_per_sec="
                f"{self.last_epoch['images'] / max(dt, 1e-9):.1f}]")
        return avg_loss

    def validate(self, loader, logger=None) -> tuple[float, float]:
        """(val loss, val accuracy %) over the whole validation set: one sum
        and one count for both, summed over the data axis (each data rank
        validates its strided shard; the wrap padding that evens the shards
        counts for nothing) and read once at the end."""
        log = logger.info if logger else print
        sums = torch.zeros(3, dtype=torch.float32, device=self.device)
        n_set = loader.num_samples()
        shards = getattr(loader, "num_shards", 1)
        seen = 0
        for images_u8, labels in loader.epoch(0):
            valid = None
            if shards > 1:
                pos = loader.shard_id + shards * (
                    seen + np.arange(len(labels)))
                seen += len(labels)
                if pos[-1] >= n_set:
                    valid = torch.from_numpy(
                        (pos < n_set).astype(np.float32)).to(self.device)
            ls, c, n = self.eval_counts(*self.place(images_u8, labels),
                                        valid=valid)
            sums += torch.stack([ls, c, torch.as_tensor(
                n, dtype=torch.float32, device=self.device)])
        if self.n_data > 1:
            dist.all_reduce_sum(sums, self.data_group)
        tot_loss, tot_correct, tot_n = sums.tolist()
        val_loss = tot_loss / max(tot_n, 1.0)
        val_acc = 100.0 * tot_correct / max(tot_n, 1.0)
        log(f"Validation - Loss: {val_loss:.4f}, Accuracy: {val_acc:.2f}%")
        return val_loss, val_acc

    def compute_rsa_score(self, things_images_u8: np.ndarray,
                          reference_rdm: np.ndarray,
                          batch_size: int = 8) -> tuple[float, float]:
        """(rho, p): forward_features CLS embeddings of the THINGS images
        in dataset order, chunks of `batch_size`, -> RDM -> Spearman
        against `reference_rdm` (reference compute_rsa_score,
        measure...effect.py:298-355).

        Over several data ranks each embeds its strided shard (indices
        r::P, wrap-padded to equal counts) and the shards are gathered back
        into dataset order over the data group
        (``parallel/dist.ordered_allgather_strided``), which fixes the
        reference's rank-order concatenation (measure...effect.py:327-334,
        SURVEY.md section 0)."""
        n = len(things_images_u8)
        mine = things_images_u8
        if self.n_data > 1:
            per = -(-n // self.n_data)
            mine = things_images_u8[
                np.arange(self.data_rank, self.n_data * per, self.n_data) % n]
        embs = []
        for s in range(0, len(mine), batch_size):
            chunk = np.ascontiguousarray(mine[s:s + batch_size])
            embs.append(self._feature_step(
                torch.from_numpy(chunk).to(self.device)))
        emb = torch.cat(embs)
        if self.n_data > 1:
            emb = dist.ordered_allgather_strided(emb, n, self.data_group)
        rho, p, _ = vrsa.behavioral_rsa(emb, reference_rdm)
        return float(rho), float(p)


def _jax_trees(model, momentum: dict):
    """The parameters and the momentum as JAX-layout numpy trees."""
    return (vconvert.vit_jax_from_state_dict(dict(model.named_parameters())),
            vconvert.vit_jax_from_state_dict(momentum))


@torch.no_grad()
def load_trees(model, params_tree, momentum: dict | None = None,
               opt_tree=None) -> None:
    """Copy JAX-layout checkpoint trees into the model's parameters and, when
    given, the SGD momentum."""
    patch = model.cfg.patch
    model.load_state_dict(vconvert.vit_state_dict_from_jax(params_tree, patch),
                          strict=True)
    if momentum is not None:
        for name, t in vconvert.vit_state_dict_from_jax(opt_tree,
                                                        patch).items():
            momentum[name].copy_(t)


def run_vit_training(cfg: ViTTrainConfig, logger=None,
                     vit_cfg: vvit.ViTConfig | None = None,
                     preempt_guard=None, device=None, on_epoch=None) -> dict:
    """Full ViT-B/16 ImageNet training with auto-resume (reference main,
    train_vit_sgd.py:246-371) on `device` (default: the card; under
    torchrun, the rank's card), data-parallel over the ranks torchrun
    launched (``parallel/dist.setup_distributed``; module docstring), or
    tensor-parallel with ``tp_devices``, or expert-parallel with
    ``ep_devices``.

    Preemption (cfg.preempt_save): a SIGTERM mid-epoch checkpoints {params,
    momentum, scheduler, epoch, batch_idx, running loss} to
    checkpoint_preempt.pth and returns {"preempted": True}; the next call
    resumes inside that epoch and reproduces the uninterrupted run
    bit-exactly. Over several ranks the stop waits for the end of the
    epoch, where every rank polls the collective flag after the epoch's
    checkpoint: one rank's notice stops them all. `preempt_guard` injects a
    prebuilt guard (tests use a stub that trips after N batches).
    `on_epoch`, if given, is called after each completed epoch with its
    times ({"epoch", "steps", "images", "train_s", "val_s", "epoch_s"})."""
    from ..ckpt import serialization as ser
    from ..ckpt import vit_ckpt
    from ..core.preempt import PreemptionGuard
    from ..core.profiling import trace
    from ..data.packed import make_loader
    from .schedules import CosineAnnealingLRWithWarmup

    log = logger.info if logger else print
    if vit_cfg is not None and cfg.moe_experts and \
            vit_cfg.moe_experts != cfg.moe_experts:
        # the two config surfaces could otherwise silently disagree (the
        # model config wins inside ViTTrainer): the caller picks one
        raise ValueError(
            f"moe_experts disagrees between ViTTrainConfig "
            f"({cfg.moe_experts}) and the explicit vit_cfg "
            f"({vit_cfg.moe_experts}); set it on the vit_cfg (or pass "
            f"vit_cfg=None to build one from the train config)")
    dev = resolve_device(dist.local_device(
        "cuda" if device is None else device))
    _, proc_count = dist.setup_distributed(dev)
    vit_cfg = vit_cfg or vvit.ViTConfig(
        patch=16, width=768, layers=12, heads=12, image_size=cfg.image_size,
        num_classes=cfg.num_classes, moe_experts=cfg.moe_experts,
        moe_topk=cfg.moe_topk, moe_capacity=cfg.moe_capacity)
    mode = train_mode(cfg, dist.is_initialized(), vit_cfg.heads,
                      vit_cfg.moe_experts > 0)
    # the data axis: the ranks, or under tp and ep the mesh's "data"
    # dimension
    n_data = proc_count // {"tp": cfg.tp_devices, "ep": cfg.ep_devices,
                            "sp": cfg.sp_devices}.get(mode, 1)

    log("=" * 60)
    log("ViT-Base ImageNet Training (SGD)")
    log("=" * 60)
    log(f"Device: {dev}  processes: {proc_count}  mode: {mode}")
    if mode in ("tp", "ep", "sp"):
        log(f"Mesh: {n_data} data x "
            + {"tp": f"{cfg.tp_devices} model",
               "ep": f"{cfg.ep_devices} expert",
               "sp": f"{cfg.sp_devices} sequence"
               + (" (ring attention)" if cfg.sp_ring else "")}[mode])
    if vit_cfg.moe_experts:
        log(f"MoE: {vit_cfg.moe_experts} experts every {vit_cfg.moe_every} "
            f"blocks, top-{vit_cfg.moe_topk}, capacity factor "
            f"{vit_cfg.moe_capacity}, aux weight {cfg.moe_aux_weight}")
    log(f"Global batch size: {cfg.batch_size}")
    log(f"Total epochs: {cfg.epochs}")
    log(f"Optimizer: SGD lr={cfg.lr} momentum={cfg.momentum} "
        f"wd={cfg.weight_decay} warmup={cfg.warmup_epochs}")
    log(f"Output directory: {cfg.output_dir}")
    if cfg.batch_size % n_data != 0:   # not an assert: must survive -O
        raise ValueError(f"global batch {cfg.batch_size} must divide by "
                         f"{n_data} data shards")

    gen = torch.Generator(device=dev).manual_seed(cfg.random_seed)
    model = vvit.init_vit_params(vvit.empty_vit(vit_cfg, dev), gen)
    total = sum(p.numel() for p in model.parameters())
    log(f"Model created. Parameters: {total / 1e6:.1f}M")
    momentum = sgd_init(dict(model.named_parameters()))
    scheduler = CosineAnnealingLRWithWarmup(cfg.lr, cfg.warmup_epochs,
                                            cfg.epochs)

    start_epoch = 0
    latest = vit_ckpt.latest_checkpoint(cfg.output_dir)
    if latest:
        ckpt = vit_ckpt.load_checkpoint(latest)
        load_trees(model, ckpt["params"], momentum, ckpt["opt_state"])
        scheduler.load_state_dict(ckpt["scheduler_state"])
        start_epoch = ckpt["epoch"] + 1
        log(f"Resumed from epoch {ckpt['epoch']}")

    # mid-epoch preemption checkpoint (one process only): valid only if it
    # continues exactly the next epoch; an older one is superseded by the
    # epoch checkpoint and deleted, a newer one means a torn tree and is
    # ignored loudly
    mid_resume = None
    preempt_path = os.path.join(cfg.output_dir, "checkpoint_preempt.pth")
    if proc_count == 1 and os.path.exists(preempt_path):
        pc = ser.load(preempt_path)
        if pc["epoch"] == start_epoch:
            load_trees(model, pc["params"], momentum, pc["opt_state"])
            scheduler.load_state_dict(pc["scheduler_state"])
            mid_resume = {k: pc[k] for k in (
                "epoch", "batch_idx", "total_loss", "num_batches")}
            log(f"Resuming mid-epoch {pc['epoch']} at batch "
                f"{pc['batch_idx']} (preemption checkpoint)")
            del pc
        elif pc["epoch"] < start_epoch:
            os.unlink(preempt_path)
        else:
            log(f"WARNING: ignoring checkpoint_preempt.pth for epoch "
                f"{pc['epoch']} > next epoch {start_epoch} (torn tree?)")

    # the ranks build the parameters from one seed or one checkpoint (DDP
    # would broadcast rank 0's, FSDP2 shards whatever each rank holds)
    dist.check_replicas_equal(list(model.parameters()), "parameters")
    trainer = ViTTrainer(vit_cfg, cfg, model, dev)   # fsdp, tp, ep shard it
    momentum = trainer.init_momentum(momentum)
    trainer.check_replicas(momentum)

    # each data rank loads its strided shard and feeds its local batch
    # (reference DistributedSampler + per-rank loaders, train_vit_sgd.py:
    # 58-66); the ranks of a model or expert group read the same one.
    # make_loader routes each split to PackedLoader when it is a packed
    # directory (identical batches either way)
    local_bs = cfg.batch_size // n_data
    train_loader = make_loader(
        f"{cfg.data_path}/train", local_bs, train=True,
        seed=cfg.random_seed, size=cfg.image_size, workers=cfg.num_workers,
        drop_last=True, use_native=cfg.use_native_loader, echo=cfg.data_echo,
        num_shards=n_data, shard_id=trainer.data_rank)
    val_loader = make_loader(
        f"{cfg.data_path}/val", local_bs, train=False,
        size=cfg.image_size, workers=cfg.num_workers,
        use_native=cfg.use_native_loader, num_shards=n_data,
        shard_id=trainer.data_rank)
    log(f"Data loaded. Train batches: {len(train_loader)}, "
        f"Val batches: {len(val_loader)}")

    def save_trees():
        """The JAX-layout checkpoint trees: host copies (started beside
        validation with host_prefetch) that the primary converts; every
        rank takes part in the gathers of zero1, fsdp and tp."""
        trees = trainer.full_state(momentum)
        if not dist.is_primary():
            return None
        return (hostcopy.prefetch_to_host(*trees) if cfg.host_prefetch
                else [hostcopy.HostCopy(tree) for tree in trees])

    def jax_trees(copies):
        if copies is None:
            return None, None
        return tuple(vconvert.vit_jax_from_state_dict(c.get())
                     for c in copies)

    guard = preempt_guard
    if guard is None and cfg.preempt_save:
        guard = PreemptionGuard()
    guard_cm = guard if (guard is not None and preempt_guard is None) \
        else contextlib.nullcontext()
    result = {"model": model, "momentum_buf": momentum,
              "scheduler": scheduler}
    with guard_cm:
        for epoch in range(start_epoch, cfg.epochs):
            log(f"Epoch {epoch}/{cfg.epochs - 1}")
            t_epoch = time.time()
            lr = scheduler.peek()
            mid_kw = {}
            if mid_resume is not None and epoch == start_epoch:
                mid_kw = dict(start_batch=mid_resume["batch_idx"],
                              loss_carry=(mid_resume["total_loss"],
                                          mid_resume["num_batches"]))
            with trace(cfg.profile_dir if epoch == start_epoch else None):
                train_loss = trainer.train_one_epoch(
                    momentum, train_loader, epoch, lr, logger=logger,
                    guard=guard, **mid_kw)
            if guard is not None and getattr(guard, "mid_state", None):
                # one process only (should_stop answers False over
                # several). The scheduler state saved here is the
                # epoch-start state (step() has not run), so the resume's
                # peek() re-derives the lr this partial epoch trained with
                ms = guard.mid_state
                save_p, save_m = (vconvert.vit_jax_from_state_dict(t)
                                  for t in trainer.full_state(momentum))
                ser.save(preempt_path, {
                    "epoch": ms["epoch"], "batch_idx": ms["batch_idx"],
                    "total_loss": ms["total_loss"],
                    "num_batches": ms["num_batches"],
                    "params": save_p, "opt_state": save_m,
                    "scheduler_state": scheduler.state_dict()})
                log(f"Preempted: saved {preempt_path} (epoch {ms['epoch']}, "
                    f"next batch {ms['batch_idx']}); exiting resumable")
                return {"preempted": True, **result}
            scheduler.step()
            # with host_prefetch the copy of the checkpoint trees runs
            # beside validation (core/hostcopy.py)
            copies = save_trees()
            t_val = time.time()
            val_loss, val_acc = trainer.validate(val_loader, logger=logger)
            val_s = time.time() - t_val
            save_p, save_m = jax_trees(copies)
            del copies
            vit_ckpt.save_checkpoint(
                epoch, save_p, save_m, scheduler.state_dict(), train_loss,
                val_loss, val_acc, cfg.output_dir,
                logger=logger if dist.is_primary() else None)
            if cfg.keep_last > 0:
                vit_ckpt.prune_checkpoints(cfg.output_dir, cfg.keep_last,
                                           epoch, logger=logger)
            if mid_resume is not None and epoch == start_epoch:
                # completed past its preemption point: the mid-epoch
                # checkpoint is superseded by the epoch checkpoint
                try:
                    os.unlink(preempt_path)
                except OSError:
                    pass
            if on_epoch is not None:
                on_epoch({"epoch": epoch, **trainer.last_epoch,
                          "val_s": val_s, "epoch_s": time.time() - t_epoch})
            # the epoch-boundary poll in its collective form, after the
            # epoch's checkpoint, every rank at the same point: over
            # several ranks this is where a stop happens. Skipped after the
            # last epoch, and for test guards without the collective form
            coll = getattr(guard, "should_stop_collective", None)
            if coll is not None and epoch + 1 < cfg.epochs and coll():
                log(f"Preemption requested - stopped cleanly after epoch "
                    f"{epoch} (checkpoint saved; auto-resume continues at "
                    f"epoch {epoch + 1})")
                return {"preempted": True, **result}
    log("Training Complete!")
    return result
