"""CLIP-HBA behavioral training loop (counterpart of the JAX package's
train/clip_loop.py; reference train_model + run_behavioral_training,
new_cvpr_train_behavior_things_pipeline.py:782-1227).

- per epoch: train over shuffled batches -> eval on the test split ->
  behavioral RSA on the 48 inference images -> embedding dumps -> DoRA
  checkpoint -> random-state checkpoint -> CSV row -> early stopping
  (patience paused inside the perturbation window, ref :1043-1056);
- perturbation window [training_run-1, training_run-1+perturb_length-1]
  0-indexed, per-batch injector keys from perturb_seed + training_run*1000
  + batch_idx (core/prng.py, perturb/injectors.py);
- NaN guard: a batch whose loss, targets or predictions are non-finite is
  skipped without an optimizer update, and AdamW's step count stays where
  it was (reference :929-998 `continue`);
- resume: CSV pre-population, DoRA + optimizer-state restore, replayable
  data order (PCG64) and dropout streams (core/prng.py Key).

The datasets are uploaded to the device once and each batch is gathered
there by index and normalized on the device. The frozen CLIP weights need
no gradient, so autograd differentiates only from the first adapted block
on: at the reference configuration one step runs the attention backward
kernel once (image block 23).

``train_step_forks``, ``evaluate_forks`` and ``behavioral_rsa_forks``
run R forks of one configuration in each call, for batched forks
(train/multi_fork.py); ``train_step`` is the solo step.

``frozen_cache`` computes each image set's activations below the first
adapted block once (``build_prefix_cache``) and the prompts' text prefix
once per trainer (``text_prefix_cache``); every train, eval and RSA step
then runs only the adapted suffix blocks. Epochs in which an image kind
(uniform_images, image_noise) is active run the full tower: those kinds
change the tower's input. ``remat`` recomputes every block in the backward
(torch.utils.checkpoint).

The port's AdamW updates the adapter tensors in place (the JAX loop returns
new trees).

Data parallelism (``mesh``, a ``("data",)`` mesh over the ranks of a
``torch.distributed`` group; one process per card under torchrun) is the
JAX loop's data mesh, the reference's ``cuda == -1`` DataParallel path.
Every rank holds the whole THINGS set, the frozen model, the prompts and
the adapters. Each step's index batch is padded to ceil(batch_size / W) * W
rows and rank k runs its block [k*w, (k+1)*w) (``_prep_idx``,
``_local_rows``); the injector perturbs the whole batch and each rank keeps
its block. The loss is the sum of the global batch's row MSEs over its row
count, each rank contributing its share, and one all-reduce sums the
adapters' gradients with the loss and the ranks' non-finite flags, so the
NaN guard skips a step on every rank together. AdamW runs replicated: the
ranks start equal (``dist.check_replicas_equal``) and stay equal. Eval splits
each batch the same way and all-reduces its sum; the RSA, the dumps and
the frozen-prefix caches run whole on every rank. The primary writes every
file, and the ranks meet at a barrier after each epoch's writes.

Sequence parallelism (``sp``, ``sp_ring``; ``run_behavioral_training``'s
``sp_devices``) runs the visual tower of every forward sequence-parallel
on a ``("data", "model")`` mesh (``models/vit.py``: the gather form on the
flash kernels, or ring attention); the text tower runs whole on every
rank. The data axis splits each batch as above (a model group's ranks
hold the same rows); only model rank 0 differentiates its loss (the
others seed theirs with 0 and run every backward collective), so the
step's all-reduce over every rank sums the visual adapters' token shares
and counts the text adapters once. Eval sums over the data group. Every
rank draws the same DoRA dropout mask (it is drawn on the weight, from the
step's key). The frozen-prefix cache is refused, as JAX refuses it.
"""
from __future__ import annotations

import contextlib
import csv
import functools
import os
import time
from datetime import datetime
from types import SimpleNamespace

import numpy as np
import torch

from ..adapters import dora as adora
from ..ckpt import clip_ckpt
from ..core import csvio, hostcopy
from ..core.configs import ClipRunConfig
from ..core.device import resolve_device
from ..core.logs import setup_logger
from ..core.prng import Key, batch_perturb_key, perturb_base_key
from ..core.profiling import EpochTimer
from ..data import things as dthings
from ..data.spose66 import classnames66
from ..models import clip as vclip
from ..models import convert as vconvert
from ..models import tokenizer as vtok
from ..models import vit as vvit
from ..ops import rsa as vrsa
from ..parallel import dist
from ..parallel import mesh as vmesh
from ..perturb import injectors, windows

# eval runs the whole test set as one batch while it stays under this many
# tokens (512 ViT-L/14 images; the JAX loop's cap)
EVAL_TOKEN_CAP = 132_000

# the frozen-prefix cache is built, and large sets are embedded, in chunks
# of this many images (the JAX loop's chunk)
PREFIX_CHUNK = 256


def make_optimizer(params, lr: float) -> torch.optim.AdamW:
    """torch AdamW with the reference's defaults (AdamW(params, lr=lr),
    ref :1181): betas (0.9, 0.999), eps 1e-8, decoupled weight decay 0.01;
    the same update as the JAX package's optax.adamw."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


class ClipHBATrainer:
    """The frozen CLIP, the adapters' static half, the prompts, and the
    train / eval / RSA steps, on the full tower or from the frozen-prefix
    cache."""

    def __init__(self, clip_cfg: vclip.CLIPConfig, model: vclip.CLIP,
                 adapter_cfg: dict, static: dict, prompt_tokens, lr: float,
                 compute_dtype=torch.bfloat16,
                 perturb_distribution: str = "target",
                 dist_mean: float = 0.0, dist_std: float = 1.0, mesh=None,
                 remat: bool = False, sp: bool = False,
                 sp_ring: bool = False):
        # sequence parallelism of the visual tower (gather form; sp_ring
        # upgrades it to ring attention) needs a ("data", "model") mesh
        if sp_ring and not sp:
            raise ValueError("sp_ring needs sp=True")
        if sp and mesh is None:
            raise ValueError("sp=True needs a ('data','model') mesh "
                             "(make_mesh(n_model=...)); got mesh=None")
        self.seq_shard = vmesh.seq_sharding(mesh) if sp else None
        self.sp_ring = sp_ring
        # the data axis (a ("data",) mesh's ranks, or a ("data", "model")
        # mesh's "data" dimension), which splits each batch: its size
        # `world`, this rank's place `rank` and its group (None: all ranks)
        self.mesh = mesh
        self.world, self.rank, self.data_group = 1, 0, None
        if mesh is not None:
            self.world = mesh.size(0)
            self.rank = mesh.get_local_rank("data")
            if sp:
                self.data_group = mesh.get_group("data")
        # under sp only model rank 0 counts its loss (module docstring)
        self.counts_loss = not sp or self.seq_shard.index == 0
        self.cfg = clip_cfg
        self.model = model.requires_grad_(False)
        self.device = next(model.parameters()).device
        self.acfg = adapter_cfg
        self.static = {t: {i: {k: v.to(self.device) for k, v in d.items()}
                           for i, d in blocks.items()}
                       for t, blocks in static.items()}
        self.prompts = torch.as_tensor(np.asarray(prompt_tokens),
                                       dtype=torch.long, device=self.device)
        self.lr = lr
        self.compute_dtype = compute_dtype
        self.perturb_distribution = perturb_distribution
        self.dist_mean = dist_mean
        self.dist_std = dist_std
        self.remat = remat

    def init_optimizer(self, trainable: dict) -> torch.optim.AdamW:
        return make_optimizer(
            [leaf for *_, leaf in adora.trainable_leaves(trainable)], self.lr)

    def upload_dataset(self, images_u8: np.ndarray,
                       targets: np.ndarray | None = None):
        """A dataset on the device: (uint8 images, f32 targets or None)."""
        img = torch.from_numpy(np.ascontiguousarray(images_u8)).to(
            self.device)
        tgt = None
        if targets is not None:
            tgt = torch.from_numpy(np.asarray(targets, np.float32)).to(
                self.device)
        return img, tgt

    # -- frozen-prefix activation cache -----------------------------------

    def suffix_sizes(self) -> tuple[int, int]:
        """(n_visual_suffix, n_text_suffix): how many trailing blocks of each
        tower carry adapters, from the static tree, so any vision_layers /
        transformer_layers configuration splits correctly."""
        vis = [int(i) for i in self.static.get("visual", {})]
        txt = [int(i) for i in self.static.get("text", {})]
        return (self.cfg.visual.layers - min(vis) if vis else 0,
                self.cfg.text.layers - min(txt) if txt else 0)

    @torch.no_grad()
    def build_prefix_cache(self, imgs_dev: torch.Tensor,
                           chunk: int = PREFIX_CHUNK) -> torch.Tensor:
        """Frozen-prefix activations [N, S, width] in the compute dtype for a
        resident uint8 image set, built in chunks (bounds the build's
        activation memory)."""
        if self.seq_shard is not None:
            raise ValueError(
                "frozen_cache is incompatible with sequence parallelism: "
                "the cache holds full-S activations, which defeats sp's "
                "token sharding (and the sp forward has no prefix split)")
        n_vis, _ = self.suffix_sizes()
        cache = None
        for s in range(0, imgs_dev.shape[0], chunk):
            h = vvit.clip_visual_prefix(
                self.model.visual,
                dthings.normalize_uint8(imgs_dev[s:s + chunk]),
                n_suffix=n_vis, compute_dtype=self.compute_dtype)
            if cache is None:
                cache = h.new_empty((imgs_dev.shape[0], *h.shape[1:]))
            cache[s:s + chunk] = h
        return cache

    @functools.cached_property
    def text_prefix_cache(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(hidden [n_prompts, context, width], eot [n_prompts]): the
        prompts' frozen text prefix, computed once per trainer."""
        _, n_txt = self.suffix_sizes()
        with torch.no_grad():
            return vclip.encode_text_prefix(self.model, self.prompts,
                                            n_suffix=n_txt,
                                            compute_dtype=self.compute_dtype)

    # -- steps ------------------------------------------------------------

    def forward(self, trainable: dict, images: torch.Tensor,
                dropout_key: Key | None = None, deterministic: bool = True,
                cached: bool = False) -> torch.Tensor:
        """[B, n_prompts] predictions from normalized images, or, with
        `cached`, from their frozen-prefix activations."""
        adapters = adora.assemble(trainable, self.static)
        if cached:
            n_vis, n_txt = self.suffix_sizes()
            hidden, eot = self.text_prefix_cache
            return vclip.clip_hba_suffix_forward(
                self.model, images, hidden, eot, n_vis_suffix=n_vis,
                n_txt_suffix=n_txt, adapters=adapters, adapter_cfg=self.acfg,
                dropout_key=dropout_key, deterministic=deterministic,
                remat=self.remat)
        return vclip.clip_hba_forward(
            self.model, images, self.prompts,
            compute_dtype=self.compute_dtype, adapters=adapters,
            adapter_cfg=self.acfg, dropout_key=dropout_key,
            deterministic=deterministic, remat=self.remat,
            seq_shard=self.seq_shard, ring_attn=self.sp_ring)

    def perturb(self, perturb_type: str, key: Key | None,
                images: torch.Tensor, targets: torch.Tensor,
                rows: int | None = None):
        """One batch's (images, targets) after the injector, drawn at
        [rows, ...] (the configured batch size; JAX's padded width)."""
        return injectors.apply_clip_perturbation(
            perturb_type, key, images, targets,
            distribution=self.perturb_distribution, mean=self.dist_mean,
            std=self.dist_std, rows=rows)

    # -- data parallelism: this rank's block of each batch ------------------

    def _local_rows(self, x):
        """This rank's contiguous block of a batch every rank holds whole
        (JAX's ``_local_rows``: data rank k owns rows [k*w, (k+1)*w))."""
        if self.world == 1:
            return x
        if len(x) % self.world != 0:
            # a floor division would drop the remainder rows
            raise ValueError(f"global batch width {len(x)} must divide by "
                             f"{self.world} processes")
        per = len(x) // self.world
        return x[self.rank * per:(self.rank + 1) * per]

    def _prep_idx(self, idx, batch_size: int):
        """An index batch padded to the data-parallel width, batch_size
        rounded up to a multiple of the data axis, with its valid mask
        (JAX's ``_prep_idx``), as this rank's block: (idx [w] int64, valid
        [w] float32). The padding indexes row 0."""
        n = len(idx)
        width = -(-max(batch_size, n) // self.world) * self.world
        idx_p = np.pad(np.asarray(idx, np.int64), (0, width - n))
        valid = (np.arange(width) < n).astype(np.float32)
        return self._local_rows(idx_p), self._local_rows(valid)

    def batch_inputs(self, all_images: torch.Tensor,
                     all_targets: torch.Tensor, idx, *,
                     perturb_type: str = "none",
                     perturb_key: Key | None = None,
                     batch_size: int | None = None, cached: bool = False):
        """One step's inputs on this rank: (images, targets, n), the rows
        `idx` of the resident dataset (normalized uint8 images, or with
        `cached` their prefix activations) after `perturb_type`'s injector
        drawn at [batch_size, ...], and the batch's row count n that the
        loss divides by.

        The rows are this rank's block of the padded batch (``_prep_idx``;
        one process: the whole batch), perturbed as the whole batch is
        (``injectors.apply_clip_perturbation(block=)``). The block's trailing
        padding is not run, so at world size 1 the step is the one-process
        step, shape for shape. A block of padding only runs its padded rows
        (dataset row 0, zero targets) and gives n = 0: the rank computes a
        zero gradient and joins the step's all-reduce."""
        if cached and perturb_type in injectors.IMAGE_KINDS:
            raise ValueError(
                f"perturb_type={perturb_type!r} replaces the input images; "
                "the frozen-prefix cache is stale under it - use the "
                "full-tower step for in-window epochs of image kinds")
        idx_l, valid = self._prep_idx(idx, batch_size or len(idx))
        m = int(valid.sum())
        if m == 0:
            rows = torch.as_tensor(idx_l, device=self.device)
            zeros = all_targets.new_zeros((len(idx_l),
                                           *all_targets.shape[1:]))
            return self._inputs(all_images[rows], cached), zeros, 0
        lo = self.rank * len(idx_l)
        images = self._inputs(all_images[torch.as_tensor(
            idx_l[:m], device=self.device)], cached)
        targets = all_targets[torch.as_tensor(np.asarray(idx, np.int64),
                                              device=self.device)]
        if perturb_type == "none":
            return images, targets[lo:lo + m], len(idx)
        images, targets = injectors.apply_clip_perturbation(
            perturb_type, perturb_key, images, targets,
            distribution=self.perturb_distribution, mean=self.dist_mean,
            std=self.dist_std, rows=batch_size, block=(lo, lo + m))
        return images, targets, len(idx)

    def _all_reduce_step(self, trainable: dict, loss: torch.Tensor,
                         ok: torch.Tensor):
        """The global step from this rank's share: one all-reduce (sum) of
        the adapters' gradients, flattened, with the loss and this rank's
        non-finite flag. Returns (the global loss, ok on every rank). Under
        sp the sum runs over every rank too (the model group's shares of
        the visual gradients), and the loss counts on model rank 0 only."""
        leaves = [leaf for *_, leaf in adora.trainable_leaves(trainable)]
        flat = torch.cat(
            [(leaf.grad if leaf.grad is not None
              else torch.zeros_like(leaf)).reshape(-1).float()
             for leaf in leaves]
            + [loss.detach().reshape(1).float() * float(self.counts_loss),
               (~ok).float().reshape(1)])
        dist.all_reduce_sum(flat)
        for leaf, g in zip(leaves, flat[:-2].split([leaf.numel()
                                                    for leaf in leaves])):
            leaf.grad = g.view_as(leaf).to(leaf.dtype)
        return flat[-2], flat[-1] == 0

    def train_step(self, trainable: dict, optimizer: torch.optim.Optimizer,
                   all_images: torch.Tensor, all_targets: torch.Tensor,
                   idx, dropout_key: Key, *, perturb_type: str = "none",
                   perturb_key: Key | None = None,
                   batch_size: int | None = None, cached: bool = False):
        """One masked-MSE step on the rows `idx` of the resident dataset
        (uint8 images, or with `cached` their prefix activations), after
        `perturb_type`'s injector. Returns (loss, ok); when not ok
        (non-finite loss, targets or predictions; data-parallel: on any
        rank) the parameters and the optimizer are left as they were."""
        images, targets, n = self.batch_inputs(
            all_images, all_targets, idx, perturb_type=perturb_type,
            perturb_key=perturb_key, batch_size=batch_size, cached=cached)
        optimizer.zero_grad(set_to_none=True)
        preds = self.forward(trainable, images, dropout_key,
                             deterministic=False, cached=cached)
        row_mse = torch.mean((preds - targets) ** 2, dim=-1)
        # this rank's share of the global batch's mean (one process: all)
        loss = torch.sum(row_mse) / n if n else torch.sum(row_mse) * 0.0
        loss.backward(torch.ones_like(loss) if self.counts_loss
                      else torch.zeros_like(loss))
        ok = (torch.isfinite(loss) & torch.all(torch.isfinite(targets))
              & torch.all(torch.isfinite(preds)))
        if self.mesh is not None:
            loss, ok = self._all_reduce_step(trainable, loss, ok)
        loss_f, ok_f = torch.stack([loss.detach(), ok.float()]).tolist()
        if ok_f:
            optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss_f, bool(ok_f)

    def _inputs(self, src: torch.Tensor, cached: bool) -> torch.Tensor:
        return src if cached else dthings.normalize_uint8(src)

    def eval_batch_size(self, n: int, batch_size: int, whole_set: bool = True,
                        vmap_factor: int = 1) -> int:
        """The eval batch: the whole set of n while its tokens, times the
        `vmap_factor` forward passes one call runs (the forks of a batched
        group), stay under EVAL_TOKEN_CAP, else `batch_size`. whole_set=False
        keeps `batch_size` as a hard memory bound."""
        if whole_set and n * self.cfg.visual.seq_len * vmap_factor \
                <= EVAL_TOKEN_CAP:
            return n
        return batch_size

    def eval_idx_mats(self, n: int, batch_size: int, whole_set: bool = True,
                      vmap_factor: int = 1):
        """The deterministic eval batches as JAX's (idx [n_batches, width]
        int32, valid [n_batches, width] float32) matrices, width the
        eval_batch_size."""
        bs = self.eval_batch_size(n, batch_size, whole_set, vmap_factor)
        starts = range(0, n, bs)
        idx = np.zeros((len(starts), bs), np.int32)
        valid = np.zeros((len(starts), bs), np.float32)
        for i, s in enumerate(starts):
            rows = np.arange(s, min(s + bs, n))
            idx[i, :len(rows)] = rows
            valid[i, :len(rows)] = 1.0
        return idx, valid

    @torch.no_grad()
    def evaluate_resident(self, trainable: dict, imgs_dev: torch.Tensor,
                          tgts_dev: torch.Tensor, n: int, batch_size: int,
                          whole_set: bool = True,
                          cache: torch.Tensor | None = None) -> float:
        """Dataset-weighted MSE (reference evaluate_model :584-602 sums
        loss * batch and divides by len(dataset)), in the batches of
        `eval_batch_size` (eval has no cross-batch dependence). With
        `cache` (the set's frozen-prefix activations) only the adapted
        suffix runs. Each rank runs its block of every batch
        (``eval_idx_mats`` widened to a multiple of the data axis, as
        JAX's, and ``_local_rows``) and the sum of the row MSEs is
        all-reduced over the data group before the division."""
        cached = cache is not None
        src = cache if cached else imgs_dev
        idx_mat, valid_mat = (
            np.pad(m, ((0, 0), (0, (-m.shape[1]) % self.world)))
            for m in self.eval_idx_mats(n, batch_size, whole_set))
        total = torch.zeros(1, dtype=torch.float32, device=self.device)
        for idx, valid in zip(idx_mat, valid_mat):
            m = int(self._local_rows(valid).sum())
            if m == 0:     # no kernel launch on an empty block
                continue
            rows = torch.as_tensor(self._local_rows(idx)[:m],
                                   dtype=torch.long, device=self.device)
            preds = self.forward(trainable, self._inputs(src[rows], cached),
                                 cached=cached)
            total += torch.sum(torch.mean((preds - tgts_dev[rows]) ** 2,
                                          dim=-1))
        if self.mesh is not None:
            dist.all_reduce_sum(total, self.data_group)
        return float(total) / n

    @torch.no_grad()
    def infer_in_chunks(self, trainable: dict, imgs_dev: torch.Tensor,
                        n_real: int, chunk: int = PREFIX_CHUNK,
                        cache: torch.Tensor | None = None) -> np.ndarray:
        """[n_real, n_prompts] predictions for a possibly large resident
        image set, in chunks (bounds activation memory, as the eval cap
        does); with `cache` only the adapted suffix runs per chunk."""
        cached = cache is not None
        src = cache if cached else imgs_dev
        outs = [self.forward(trainable, self._inputs(src[s:s + chunk], cached),
                             cached=cached).cpu()
                for s in range(0, n_real, chunk)]
        return torch.cat(outs).numpy()

    @torch.no_grad()
    def behavioral_rsa(self, trainable: dict, inference_images_u8,
                       reference_rdm, cache: torch.Tensor | None = None):
        """48-image inference + RDM + Spearman (reference behavioral_RSA
        :605-654). Returns (rho, p, model_rdm, embeddings) on the host.
        With `cache` (the set's frozen-prefix activations) only the adapted
        suffix runs."""
        if cache is not None:
            emb = self.forward(trainable, cache, cached=True)
        else:
            imgs = inference_images_u8
            if not isinstance(imgs, torch.Tensor):
                imgs, _ = self.upload_dataset(imgs)
            emb = self.forward(trainable, dthings.normalize_uint8(imgs))
        rho, p, model_rdm = vrsa.behavioral_rsa(emb, reference_rdm)
        return rho, p, model_rdm.cpu().numpy(), emb.cpu().numpy()

    # -- a fork axis: R forks of one configuration in each step ------------

    def forward_forks(self, trainables: list, images: torch.Tensor, *,
                      forked: bool = True, dropout_keys=None,
                      deterministic: bool = True,
                      cached: bool = False) -> torch.Tensor:
        """[R, B, n_prompts] predictions of R forks (`trainables`, one
        adapter tree each) from normalized images or, with `cached`, their
        frozen-prefix activations: [R*B, ...] (each fork's rows) when
        `forked`, else [B, ...] seen by every fork. `dropout_keys` holds
        each fork's batch key."""
        adapters = adora.assemble_forks(trainables, self.static)
        R = len(trainables)
        if cached:
            n_vis, n_txt = self.suffix_sizes()
            hidden, eot = self.text_prefix_cache
            return vclip.clip_hba_suffix_forward_forks(
                self.model, images, hidden, eot, R, n_vis_suffix=n_vis,
                n_txt_suffix=n_txt, forked=forked, adapters=adapters,
                adapter_cfg=self.acfg, dropout_keys=dropout_keys,
                deterministic=deterministic, remat=self.remat)
        return vclip.clip_hba_forward_forks(
            self.model, images, self.prompts, R, forked=forked,
            compute_dtype=self.compute_dtype, adapters=adapters,
            adapter_cfg=self.acfg, dropout_keys=dropout_keys,
            deterministic=deterministic, remat=self.remat)

    def train_step_forks(self, trainables: list, optimizers: list,
                         all_images: torch.Tensor, all_targets: torch.Tensor,
                         idxs: list, dropout_keys: list, *,
                         perturb_type: str = "none",
                         perturb_keys: list | None = None,
                         in_win: list | None = None,
                         batch_size: int | None = None,
                         cached: bool = False):
        """One lock-step batch of R forks: fork f takes the rows idxs[f]
        (every fork the same count), its own adapters, optimizer and
        dropout key, and, when in_win[f], `perturb_type`'s injector drawn
        from perturb_keys[f] (a fork outside its window trains on the clean
        batch). The backpropagated loss is the sum of the forks' own masked
        means, so each fork's gradients are its solo step's. Returns (losses,
        oks); a fork whose loss, targets or predictions are non-finite skips
        its own update, the others step."""
        if cached and perturb_type in injectors.IMAGE_KINDS:
            raise ValueError(
                f"perturb_type={perturb_type!r} replaces the input images; "
                "the frozen-prefix cache is stale under it - batched image "
                "kinds run the full tower")
        R, n = len(trainables), len(idxs[0])
        rows = torch.as_tensor(np.concatenate(
            [np.asarray(i, np.int64) for i in idxs]), device=self.device)
        images = self._inputs(all_images[rows], cached)
        targets = all_targets[rows].unflatten(0, (R, n))
        if perturb_type != "none":
            images, targets = injectors.apply_clip_perturbation_forks(
                perturb_type, perturb_keys, in_win, images, targets,
                distribution=self.perturb_distribution, mean=self.dist_mean,
                std=self.dist_std, rows=batch_size)
        for opt in optimizers:
            opt.zero_grad(set_to_none=True)
        preds = self.forward_forks(trainables, images, forked=True,
                                   dropout_keys=dropout_keys,
                                   deterministic=False, cached=cached)
        row_mse = torch.mean((preds - targets) ** 2, dim=-1)      # [R, n]
        losses = torch.sum(row_mse, dim=1) / n
        losses.sum().backward()
        ok = (torch.isfinite(losses)
              & torch.isfinite(targets).flatten(1).all(dim=1)
              & torch.isfinite(preds).flatten(1).all(dim=1))
        loss_f, ok_f = torch.stack([losses.detach(), ok.float()]).tolist()
        for opt, good in zip(optimizers, ok_f):
            if good:
                opt.step()
            opt.zero_grad(set_to_none=True)
        return loss_f, [bool(v) for v in ok_f]

    @torch.no_grad()
    def evaluate_forks(self, trainables: list, imgs_dev: torch.Tensor,
                       tgts_dev: torch.Tensor, n: int, batch_size: int, *,
                       vmap_factor: int = 1, whole_set: bool = True,
                       cache: torch.Tensor | None = None) -> list:
        """`evaluate_resident` for R forks on one shared eval set: each
        fork's dataset-weighted MSE. The whole-set batch's token cap counts
        the `vmap_factor` forward passes a call runs."""
        cached = cache is not None
        src = cache if cached else imgs_dev
        bs = self.eval_batch_size(n, batch_size, whole_set, vmap_factor)
        total = torch.zeros(len(trainables), dtype=torch.float32,
                            device=self.device)
        for s in range(0, n, bs):
            preds = self.forward_forks(
                trainables, self._inputs(src[s:s + bs], cached),
                forked=False, cached=cached)
            total += torch.sum(torch.mean((preds - tgts_dev[s:s + bs]) ** 2,
                                          dim=-1), dim=1)
        return [t / n for t in total.tolist()]

    @torch.no_grad()
    def behavioral_rsa_forks(self, trainables: list, inf_imgs_dev,
                             reference_rdm,
                             cache: torch.Tensor | None = None) -> list:
        """`behavioral_rsa` for R forks on the shared inference set:
        [(rho, p)] a fork."""
        cached = cache is not None
        src = cache if cached else dthings.normalize_uint8(inf_imgs_dev)
        emb = self.forward_forks(trainables, src, forked=False, cached=cached)
        return [vrsa.behavioral_rsa(e, reference_rdm)[:2] for e in emb]


def train_model(trainer: ClipHBATrainer, trainable: dict,
                optimizer: torch.optim.Optimizer, *, train_images,
                train_targets, test_images, test_targets, inference_images,
                reference_rdm, shuffler: dthings.EpochShuffler, epochs: int,
                batch_size: int, training_res_path: str, training_run: int,
                perturb_length: int, perturb_seed: int, perturb_type: str,
                logger=None, early_stopping_patience: int = 5,
                dora_parameters_path: str = "./dora_params",
                random_state_path: str = "./random_states",
                dropout_seed: int = 0, data_seed: int = 0,
                resume_from_epoch: int = 0,
                previous_training_res_path: str | None = None,
                dump_dir: str | None = None, inference_names=None,
                nod_images=None, nod_names=None, nod_dump_dir=None,
                host_prefetch: bool = False, preempt_guard=None,
                frozen_cache: bool = False, on_epoch=None):
    """The per-epoch loop (reference train_model :782-1063). Returns the final
    (trainable, optimizer, last_epoch0); the adapters and the optimizer are
    updated in place.

    `host_prefetch` starts the copy of the checkpoint trees (adapters and
    AdamW moments) to the host right after the epoch's training steps, so
    it runs beside the eval and RSA work (core/hostcopy.py); it changes no
    value. `preempt_guard` is polled at epoch
    boundaries, after the epoch's checkpoints are written, and gets
    `stopped_at_epoch` when it stops the run. `on_epoch`, if given, is
    called after each epoch with {epoch, steps, train_s, epoch_s, cached}:
    the seconds of its training steps and of the whole epoch, and whether
    its steps ran from the frozen-prefix cache.

    Over several ranks (the trainer's mesh) the primary alone writes the
    CSV, the checkpoints and the dumps, and copies the checkpoint trees
    out; every rank meets it at a barrier after each epoch's writes. Early
    stopping reads the all-reduced losses and the poll is the collective
    one, so every rank leaves the loop at the same epoch."""
    log = logger.info if logger else print
    best_test_loss = 500000.0  # reference initializes to 500000 (ref :790)
    epochs_no_improve = 0
    primary = dist.is_primary()

    if primary:    # one writer of the run's files
        os.makedirs(dora_parameters_path, exist_ok=True)
        csvio.init_clip_csv(training_res_path, resume_from_epoch,
                            previous_training_res_path, logger)

    dropout_root = Key.root(dropout_seed)
    n_train = len(train_images)
    n_test = len(test_images)
    last_epoch0 = resume_from_epoch - 1

    train_imgs_dev, train_tgts_dev = trainer.upload_dataset(train_images,
                                                            train_targets)
    test_imgs_dev, test_tgts_dev = trainer.upload_dataset(test_images,
                                                          test_targets)
    inf_imgs_dev, _ = trainer.upload_dataset(inference_images)
    nod_imgs_dev = None
    if nod_images is not None:
        nod_imgs_dev, _ = trainer.upload_dataset(nod_images)

    # the towers below the adapter split are frozen and THINGS has no random
    # augmentation, so each set's prefix activations are computed once here
    train_cache = test_cache = inf_cache = nod_cache = None
    if frozen_cache:
        t0 = time.perf_counter()
        train_cache = trainer.build_prefix_cache(train_imgs_dev)
        test_cache = trainer.build_prefix_cache(test_imgs_dev)
        inf_cache = trainer.build_prefix_cache(inf_imgs_dev)
        if nod_imgs_dev is not None:
            nod_cache = trainer.build_prefix_cache(nod_imgs_dev)
        trainer.text_prefix_cache  # noqa: B018  (built once, timed here)
        if train_cache.is_cuda:
            torch.cuda.synchronize(train_cache.device)
        caches = [c for c in (train_cache, test_cache, inf_cache, nod_cache)
                  if c is not None]
        nbytes = sum(c.numel() * c.element_size() for c in caches)
        log(f"Frozen-prefix cache built in {time.perf_counter() - t0:.2f}s "
            f"({nbytes / 2**20:.0f} MB on the device); train/eval/RSA steps "
            f"run only the adapted suffix blocks")

    if resume_from_epoch == 0:
        # initial (pre-training) eval + RSA, logged but not written to the CSV
        # (reference baseline pipeline cvpr...baseline.py:623-624)
        init_loss = trainer.evaluate_resident(trainable, test_imgs_dev,
                                              test_tgts_dev, n_test,
                                              batch_size, cache=test_cache)
        init_rho, init_p, _, _ = trainer.behavioral_rsa(
            trainable, inf_imgs_dev, reference_rdm, cache=inf_cache)
        log(f"Initial (epoch 0) Validation Loss: {init_loss:.4f}, "
            f"Behavioral RSA: {init_rho:.4f} (p={init_p:.4f})")

    base_pkey = perturb_base_key(perturb_seed, training_run)
    for epoch in range(resume_from_epoch, epochs):
        flags = windows.epoch_flags(epoch, training_run, perturb_length,
                                    perturb_type)
        active = any(flags.values())
        kind = perturb_type if active else "none"
        if active:
            ws, we = windows.window_bounds(training_run, perturb_length)
            log("=" * 80)
            log(f"*** PERTURBATION '{perturb_type}' ACTIVE FOR EPOCH "
                f"{epoch + 1} (window: epochs {ws + 1}-{we + 1}) ***")
            log(f"Perturbation seed: {perturb_seed}")
            log("=" * 80)
            _log_first_batch(trainer, log, kind, shuffler, epoch,
                             train_imgs_dev, train_tgts_dev, batch_size,
                             batch_perturb_key(perturb_seed, training_run, 0))

        timer = EpochTimer()
        batch_list = list(shuffler.batches(epoch))
        dropout_epoch_key = dropout_root.fold_in(epoch)
        # image kinds replace the tower's input while active, so those
        # epochs run the full tower; target-only kinds (and clean epochs)
        # train from the prefix cache
        use_cache = frozen_cache and kind not in injectors.IMAGE_KINDS
        imgs = train_cache if use_cache else train_imgs_dev
        losses, oks = [], []
        for bi, idx in enumerate(batch_list):
            loss, ok = trainer.train_step(
                trainable, optimizer, imgs, train_tgts_dev, idx,
                dropout_epoch_key.fold_in(bi), perturb_type=kind,
                perturb_key=base_pkey.fold_in(bi), batch_size=batch_size,
                cached=use_cache)
            losses.append(loss)
            oks.append(ok)
        train_s = timer.seconds()
        copies = None
        if primary:
            trees = (trainable, clip_ckpt.adamw_moments(optimizer, trainable))
            copies = (hostcopy.prefetch_to_host(*trees) if host_prefetch
                      else [hostcopy.HostCopy(tree) for tree in trees])
        for bi in np.nonzero(~np.asarray(oks))[0]:
            log(f"WARNING: non-finite batch {bi} skipped "
                f"(epoch {epoch + 1})")
        sizes = np.array([len(b) for b in batch_list])
        # a skipped batch's loss is NaN: mask before multiplying
        total_loss = float(np.sum(np.where(oks, losses, 0.0) * sizes))
        # reference divides by the full dataset size regardless of skips
        avg_train_loss = total_loss / n_train

        train_timing = timer.finish(images=n_train)
        avg_test_loss = trainer.evaluate_resident(
            trainable, test_imgs_dev, test_tgts_dev, n_test, batch_size,
            cache=test_cache)
        log(f"Epoch {epoch + 1}: Training Loss: {avg_train_loss:.4f}, "
            f"Validation Loss: {avg_test_loss:.4f} [{train_timing}]")

        rho, p_value, _, emb = trainer.behavioral_rsa(
            trainable, inf_imgs_dev, reference_rdm, cache=inf_cache)
        log(f"Behavioral RSA Correlation & p-value: {rho:.4f}, {p_value:.4f}")

        # the second per-epoch inference set (the reference runs produced
        # nod_embeddings_epochN.csv dumps; SURVEY.md section 0): the
        # primary's to write, every rank's to compute under sp (its forward
        # is collective)
        nod_emb = None
        if nod_imgs_dev is not None and nod_dump_dir is not None and (
                primary or trainer.seq_shard is not None):
            nod_emb = trainer.infer_in_chunks(trainable, nod_imgs_dev,
                                              len(nod_images), cache=nod_cache)
        # the host-side files come from the primary alone: every rank holds
        # the same replicated state, and two writers of one file would race
        if primary:
            if dump_dir is not None:
                dump_embeddings(dump_dir, epoch + 1, emb, inference_names,
                                prefix="things_48")
            if nod_emb is not None:
                dump_embeddings(nod_dump_dir, epoch + 1, nod_emb, nod_names,
                                prefix="nod")

            # checkpoints BEFORE the CSV row: a crash between the two
            # leaves "checkpoint without row" (the epoch is retrained on
            # resume), never "row without checkpoint"
            host_tr = copies[0].get()
            opt_state = clip_ckpt.optax_state_from_moments(*copies[1].get())
            clip_ckpt.save_dora_parameters(host_tr, dora_parameters_path,
                                           epoch, logger=logger)
            log(f"DoRA parameters saved for epoch {epoch + 1}")
            clip_ckpt.save_random_states(
                opt_state, epoch, random_state_path, data_seed,
                {"dropout_seed": dropout_seed}, logger=logger)
            csvio.append_clip_row(training_res_path, epoch + 1,
                                  avg_train_loss, avg_test_loss, rho,
                                  p_value, **flags)
        # a resume or the lengths ladder never reads a half-written tree
        dist.barrier()
        if on_epoch is not None:
            on_epoch({"epoch": epoch + 1, "steps": len(batch_list),
                      "train_s": train_s, "epoch_s": timer.seconds(),
                      "cached": use_cache})

        # patience freezes on pure window arithmetic (reference :1044-1056)
        in_win = windows.in_window(epoch, training_run, perturb_length)
        if avg_test_loss < best_test_loss:
            best_test_loss = avg_test_loss
            epochs_no_improve = 0
        elif not in_win:
            epochs_no_improve += 1
        last_epoch0 = epoch
        if epochs_no_improve == early_stopping_patience:
            log(f"Early stopping triggered at epoch {epoch + 1}")
            break
        # epoch-boundary preemption poll, skipped on the final epoch (a
        # completed run must not be flagged as preempted); the collective
        # form, so one rank's notice stops every rank here
        if preempt_guard is not None and epoch + 1 < epochs:
            poll = getattr(preempt_guard, "should_stop_collective",
                           preempt_guard.should_stop)
            if poll():
                log(f"Preemption requested - stopped cleanly after epoch "
                    f"{epoch + 1} (its checkpoints are saved; resume with "
                    f"resume_from_epoch={epoch + 1})")
                preempt_guard.stopped_at_epoch = epoch + 1
                break

    return trainable, optimizer, last_epoch0


@torch.no_grad()
def _log_first_batch(trainer: ClipHBATrainer, log, kind: str, shuffler,
                     epoch: int, imgs_dev, tgts_dev, batch_size: int,
                     key: Key) -> None:
    """The first batch after injection: stats that show the injector acted
    (the reference's debug-print verification, ref :886-982)."""
    rows = torch.as_tensor(np.asarray(next(iter(shuffler.batches(epoch))),
                                      np.int64), device=trainer.device)
    img0 = dthings.normalize_uint8(imgs_dev[rows])
    tgt0 = tgts_dev[rows]
    pi, pt = trainer.perturb(kind, key, img0, tgt0, batch_size)
    log(f"Batch 0 after injection - images: min={float(pi.min()):.3f} "
        f"max={float(pi.max()):.3f} mean={float(pi.mean()):.3f}; "
        f"targets: min={float(pt.min()):.3f} "
        f"max={float(pt.max()):.3f} mean={float(pt.mean()):.3f}; "
        f"targets changed: {not torch.equal(pt, tgt0)}, "
        f"images changed: {not torch.equal(pi, img0)}")


def dump_embeddings(dump_dir: str, epoch1: int, emb: np.ndarray, names,
                    prefix: str = "things_48") -> str:
    """One epoch's inference embeddings as
    {dump_dir}/{prefix}_embeddings_epoch{epoch1}.csv: an image_name column
    (when names are given) and one column per dimension named 0..D-1,
    values as float32 text (the JAX package's pandas layout; SURVEY.md
    section 0). Returns the path."""
    os.makedirs(dump_dir, exist_ok=True)
    path = os.path.join(dump_dir, f"{prefix}_embeddings_epoch{epoch1}.csv")
    emb = np.asarray(emb, np.float32)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        lead = ["image_name"] if names is not None else []
        w.writerow(lead + [str(j) for j in range(emb.shape[1])])
        for i, row in enumerate(emb):
            w.writerow(([names[i]] if names is not None else [])
                       + [str(v) for v in row])
    return path


def read_image_names(csv_file: str) -> list[str]:
    """The image names of an annotation CSV: its `image_name` column, else
    its first column (the JAX loop's reading of the NOD CSV)."""
    with open(csv_file, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    col = rows[0].index("image_name") if "image_name" in rows[0] else 0
    return [r[col] for r in rows[1:]]


def build_run_assets(cfg: ClipRunConfig, logger, device):
    """Everything a CLIP-HBA run needs before any training state exists:
    the frozen model on `device` and its config, decoded datasets, split
    indices, inference set + reference RDM, tokenized prompts, perturbation
    stats, and the DoRA (trainable, static) trees."""
    if cfg.clip_weights and not os.path.exists(cfg.clip_weights):
        # a mistyped weights path must not silently become random towers
        raise FileNotFoundError(
            f"clip_weights path does not exist: {cfg.clip_weights}")
    loaded_pretrained = bool(cfg.clip_weights)
    if loaded_pretrained:
        sd = vconvert.load_torch_state_dict(cfg.clip_weights)
        clip_cfg = vconvert.clip_config_from_state_dict(sd)
        model = vconvert.clip_from_state_dict(sd, device, clip_cfg)
        del sd
        logger.info(f"Loaded CLIP weights from {cfg.clip_weights}")
    else:
        if cfg.backbone not in vclip.CLIP_CONFIGS:
            raise ValueError(
                f"unsupported backbone {cfg.backbone!r}; supported: "
                f"{sorted(vclip.CLIP_CONFIGS)}")
        clip_cfg = vclip.CLIP_CONFIGS[cfg.backbone]
        model = vclip.init_clip_weights_(
            vclip.empty_clip(clip_cfg, device),
            torch.Generator(device=device).manual_seed(cfg.random_seed))
        logger.info("WARNING: no clip_weights provided - using random "
                    "initialization (testing only)")
    model.requires_grad_(False)

    dataset = dthings.ThingsDataset(cfg.csv_file, cfg.img_dir,
                                    size=clip_cfg.visual.image_size)
    mean, std = injectors.perturb_distribution_stats(
        dataset.targets, cfg.perturb_distribution)

    # split: replay the baseline split if provided, else fresh + persist
    if cfg.baseline_split_indices_path and \
            os.path.exists(cfg.baseline_split_indices_path):
        info = dthings.load_split_indices(cfg.baseline_split_indices_path,
                                          logger)
        train_idx = info["train_indices"]
        test_idx = info["test_indices"]
        logger.info("Using baseline dataset split")
    else:
        train_idx, test_idx = dthings.random_split_indices(
            len(dataset), cfg.train_portion, cfg.random_seed)
        split_path = os.path.join(cfg.random_state_path,
                                  "dataset_split_indices.pth")
        # every rank derives the same split from the seed; one writer
        if dist.is_primary():
            dthings.save_split_indices(split_path, train_idx, test_idx,
                                       cfg.random_seed)
            logger.info(f"Saved fresh dataset split to {split_path}")

    inference = dthings.ThingsInferenceDataset(
        cfg.inference_csv_file, cfg.img_dir, cfg.RDM48_triplet_dir,
        size=clip_cfg.visual.image_size)
    reference_rdm = inference.load_reference_rdm()

    tok = vtok.default_tokenizer(cfg.bpe_vocab)
    if loaded_pretrained and isinstance(tok, vtok.HashTokenizer):
        # hash-tokenized prompts are meaningless to a pretrained text tower
        # and would silently destroy behavioral RSA: a hard error with an
        # explicit escape hatch
        msg = (
            "Pretrained CLIP weights loaded but no BPE vocab found — the "
            "HashTokenizer fallback would feed the 66 SPoSE prompts to the "
            "pretrained text tower in the wrong token space and behavioral "
            "RSA would be near zero. Pass bpe_vocab=<path to "
            "bpe_simple_vocab_16e6.txt.gz> or set CLIP_BPE_PATH; set "
            "allow_hash_tokenizer=True to proceed anyway (testing only).")
        if not cfg.allow_hash_tokenizer:
            logger.error(msg)
            raise ValueError(msg)
        logger.warning("allow_hash_tokenizer=True: " + msg)
    prompts = vtok.tokenize(classnames66, tokenizer=tok,
                            context_length=clip_cfg.text.context_length,
                            truncate=isinstance(tok, vtok.HashTokenizer))
    prompts = np.minimum(prompts, clip_cfg.text.vocab_size - 1)

    # DoRA surgery (ref :1147-1152), the init stream seeded from random_seed
    spec = adora.dora_spec(clip_cfg.visual.layers, clip_cfg.text.layers,
                           cfg.vision_layers, cfg.transformer_layers)
    trainable, static, acfg = adora.apply_dora(
        model, spec, r=cfg.rank, alpha=cfg.dora_alpha,
        dropout=cfg.dora_dropout,
        generator=torch.Generator(device=device).manual_seed(
            cfg.random_seed + 123))

    return SimpleNamespace(
        loaded_pretrained=loaded_pretrained, model=model, clip_cfg=clip_cfg,
        dataset=dataset, mean=mean, std=std, train_idx=train_idx,
        test_idx=test_idx, inference=inference, reference_rdm=reference_rdm,
        prompts=prompts, spec=spec, trainable=trainable, static=static,
        acfg=acfg)


def _check_sp(cfg: ClipRunConfig) -> None:
    """The sequence-parallel run's refusals, before anything is written:
    JAX's, and a mesh that needs a process group."""
    if cfg.sp_ring and cfg.sp_devices <= 1:
        raise ValueError("sp_ring needs sp=True")
    if cfg.sp_devices > 1 and not dist.is_initialized():
        raise ValueError(
            "sp_devices shards the visual tower's tokens over the ranks of "
            "a process group: launch with torchrun (--nproc_per_node "
            "sp_devices or a multiple of it)")
    if cfg.sp_devices > 1 and dist.world_size() % cfg.sp_devices != 0:
        raise ValueError(f"sp_devices ({cfg.sp_devices}) must divide the "
                         f"device count ({dist.world_size()})")


def run_behavioral_training(config, preempt_guard=None, device=None) -> dict:
    """Config-dict entry point (reference run_behavioral_training
    :1066-1227). Accepts the reference's dict config surface or a
    ClipRunConfig; runs on `device` (default the GPU; 'cpu' for tests).
    Returns {last_epoch0, training_res_path, trainable, preempted}.

    In a process group (torchrun; the CLIs join it, ``parallel/dist.py``)
    the run is data-parallel over its ranks, JAX's data mesh over every
    device it sees (module docstring); at world size 1 that is the
    one-process run through the dp step. The batch size must pad into
    equal blocks (``ClipHBATrainer._prep_idx``).

    With cfg.preempt_save (default) a SIGTERM stops the run cleanly at the
    next epoch boundary and the summary carries `preempted=True`;
    `preempt_guard` injects a prebuilt guard (tests use stubs)."""
    cfg = (config if isinstance(config, ClipRunConfig)
           else ClipRunConfig.from_dict(config))
    _check_sp(cfg)
    device = resolve_device(device)

    log_dir = os.path.dirname(cfg.checkpoint_path) or "."
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    logger = setup_logger(os.path.join(log_dir,
                                       f"training_log_{timestamp}.txt"))
    logger.info("=" * 80)
    logger.info("Starting Training Run")
    logger.info("=" * 80)

    a = build_run_assets(cfg, logger, device)
    trainable, spec = a.trainable, a.spec
    training_run = cfg.training_run

    # DoRA checkpoint to fork from (ref :1156-1171)
    dora_path = None
    if cfg.resume_from_epoch > 0 and cfg.resume_dora_parameters_path:
        dora_path = os.path.join(cfg.resume_dora_parameters_path,
                                 f"epoch{cfg.resume_from_epoch}_dora_params.pth")
    elif cfg.baseline_dora_directory:
        dora_path = os.path.join(cfg.baseline_dora_directory,
                                 f"epoch{training_run - 1}_dora_params.pth")
    # an explicit resume source always loads (the reference gates on
    # training_run >= 1 only, which would skip an in-place baseline resume)
    explicit_resume = (cfg.resume_from_epoch > 0
                       and bool(cfg.resume_dora_parameters_path))
    if dora_path and os.path.exists(dora_path) and (training_run >= 1
                                                    or explicit_resume):
        trainable = clip_ckpt.load_dora_parameters(dora_path, trainable, spec,
                                                   logger)
        logger.info(f"Loaded DoRA parameters from {dora_path}")
    else:
        if explicit_resume and dora_path:
            raise FileNotFoundError(
                f"resume_from_epoch={cfg.resume_from_epoch} requested but "
                f"the DoRA checkpoint does not exist: {dora_path}")
        logger.info("Using original DoRA parameters from model initialization")
    trainable = adora.make_trainable(trainable, device)

    # data-parallel over the group's ranks (the reference's cuda == -1
    # DataParallel path, ref :1174-1176; JAX's data mesh, :1160-1163);
    # sp_devices > 1 carves a "model" axis out of them for the visual
    # tower's sequence parallelism (gather form, or ring with sp_ring)
    mesh = None
    sp = cfg.sp_devices > 1
    if sp:
        mesh = vmesh.make_mesh(n_data=dist.world_size() // cfg.sp_devices,
                               n_model=cfg.sp_devices)
        logger.info(f"Using {dist.world_size() // cfg.sp_devices}x"
                    f"{cfg.sp_devices} (data x sequence) mesh"
                    + (" with ring attention" if cfg.sp_ring else ""))
    elif dist.is_initialized():
        mesh = vmesh.make_mesh()
        logger.info(f"Using {dist.world_size()} devices (data-parallel "
                    f"mesh)")

    trainer = ClipHBATrainer(
        a.clip_cfg, a.model, a.acfg, a.static, a.prompts, lr=cfg.lr,
        compute_dtype=torch.bfloat16 if cfg.compute_dtype == "bfloat16"
        else torch.float32,
        perturb_distribution=cfg.perturb_distribution,
        dist_mean=a.mean, dist_std=a.std, mesh=mesh, remat=cfg.remat,
        sp=sp, sp_ring=cfg.sp_ring)
    optimizer = trainer.init_optimizer(trainable)

    # random-state restore (ref :1184-1201)
    data_seed = cfg.random_seed
    if cfg.resume_from_epoch > 0:
        prior = cfg.resume_random_state_path or cfg.baseline_random_state_path
        if prior:
            state = clip_ckpt.load_random_states(prior, cfg.resume_from_epoch,
                                                 logger)
            if state is not None:
                if clip_ckpt.adamw_state_matches(state["optimizer_state"],
                                                 trainable):
                    clip_ckpt.adamw_state_from_optax(
                        optimizer, state["optimizer_state"], trainable)
                else:
                    logger.warning(
                        "Restored optimizer state does not match this run's "
                        "adapter config (vision_layers/transformer_layers/"
                        "rank differ from the checkpoint's) - keeping a fresh "
                        "optimizer state")
                data_seed = state["data_seed"]
                logger.info(f"Successfully restored all random states from "
                            f"epoch {cfg.resume_from_epoch}")
            else:
                logger.warning("Could not load random states - starting with "
                               "fresh random state")
        else:
            logger.warning("baseline_random_state_path not provided in config, "
                           "cannot restore random states")

    leaves = [leaf for *_, leaf in adora.trainable_leaves(trainable)]
    dist.check_replicas_equal(
        leaves + [t for leaf in leaves for _, t in sorted(
            optimizer.state.get(leaf, {}).items())
                  if isinstance(t, torch.Tensor)],
        "adapters or AdamW state")
    logger.info("\nModel Configuration:")
    logger.info("-------------------")
    for k, v in cfg.to_dict().items():
        logger.info(f"{k}: {v}")
    logger.info(f"\nNumber of trainable parameters: "
                f"{adora.count_trainable_parameters(trainable)}\n")

    dataset = a.dataset
    shuffler = dthings.EpochShuffler(len(a.train_idx), cfg.batch_size,
                                     data_seed)
    dump_dir = cfg.inference_dump_dir if cfg.dump_inference_embeddings \
        else None
    nod_images = nod_names = None
    # its dumps are the primary's (every rank embeds it under sp, whose
    # forward is collective)
    if cfg.nod_csv_file and os.path.exists(cfg.nod_csv_file) \
            and (dist.is_primary() or cfg.sp_devices > 1):
        nod_names = read_image_names(cfg.nod_csv_file)
        nod_images = dthings.decode_images(cfg.nod_img_dir or cfg.img_dir,
                                           nod_names,
                                           a.clip_cfg.visual.image_size)
        logger.info(f"Loaded NOD inference set: {len(nod_names)} images")

    guard = preempt_guard
    own_guard = False
    if guard is None and cfg.preempt_save:
        from ..core.preempt import PreemptionGuard
        guard = PreemptionGuard()
        own_guard = True  # install signal handlers only for our own guard
    with guard if own_guard else contextlib.nullcontext():
        trainable, optimizer, last_epoch0 = train_model(
            trainer, trainable, optimizer, preempt_guard=guard,
            train_images=dataset.images_u8[a.train_idx],
            train_targets=dataset.targets[a.train_idx],
            test_images=dataset.images_u8[a.test_idx],
            test_targets=dataset.targets[a.test_idx],
            inference_images=a.inference.images_u8,
            reference_rdm=a.reference_rdm, shuffler=shuffler,
            epochs=cfg.epochs, batch_size=cfg.batch_size,
            training_res_path=cfg.training_res_path,
            training_run=training_run, perturb_length=cfg.perturb_length,
            perturb_seed=cfg.perturb_seed, perturb_type=cfg.perturb_type,
            logger=logger,
            early_stopping_patience=cfg.early_stopping_patience,
            dora_parameters_path=cfg.dora_parameters_path,
            random_state_path=cfg.random_state_path,
            dropout_seed=cfg.random_seed, data_seed=data_seed,
            resume_from_epoch=cfg.resume_from_epoch,
            previous_training_res_path=cfg.previous_training_res_path,
            dump_dir=dump_dir, inference_names=a.inference.names,
            nod_images=nod_images, nod_names=nod_names,
            nod_dump_dir=cfg.nod_dump_dir, host_prefetch=cfg.host_prefetch,
            frozen_cache=cfg.frozen_cache)

    if cfg.nod_dump_dir and nod_names is not None and dist.is_primary():
        # per-epoch category-RDM archive (the reference runs shipped
        # hba_nod_category_rdms_dict.npz with no producing script; SURVEY.md
        # section 0; schema in analysis/category_rdms.py)
        from ..analysis import category_rdms
        arc = category_rdms.save_category_rdms(
            cfg.nod_dump_dir,
            os.path.join(os.path.dirname(cfg.nod_dump_dir.rstrip("/")) or ".",
                         "hba_nod_category_rdms_dict.npz"))
        if arc:
            logger.info(f"Wrote NOD category-RDM archive: {arc}")
    # the primary's archive is the run's last write: no rank returns (and
    # no chained CLI reads it) before it is whole
    dist.barrier()

    return {"last_epoch0": last_epoch0,
            "training_res_path": cfg.training_res_path,
            "trainable": trainable,
            "preempted": bool(getattr(guard, "stopped_at_epoch", None)
                              if guard is not None else False)}
