"""ViT-B/16 ImageNet supervised training on one card (counterpart of the JAX
package's train/vit_loop.py).

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

One process, one card. The parallel modes (pipeline, sequence, tensor and
expert parallelism, ZeRO-1, FSDP), MoE and the profiler trace are not
ported yet and are refused by name.
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
from ..ops import rsa as vrsa
from ..perturb import injectors

IMAGENET_NORM = (IMAGENET_MEAN, IMAGENET_STD)
# image perturbations, applied in the step; the label kinds go through the
# loader's label_table
IMAGE_PERTURBATIONS = ("gaussian", "uniform_gray")

# ViTTrainConfig fields whose features are not ported yet, with the value
# that leaves them off
_UNPORTED = (("pp_stages", 1), ("sp_devices", 1), ("sp_ring", False),
             ("ep_devices", 1), ("tp_devices", 1), ("zero1", False),
             ("fsdp", False), ("moe_experts", 0), ("profile_dir", None))


def refuse_unported(cfg: ViTTrainConfig) -> None:
    for name, off in _UNPORTED:
        value = getattr(cfg, name)
        if value != off:
            raise NotImplementedError(
                f"ViTTrainConfig.{name}={value!r} is not ported to "
                f"vit_project_torch yet (leave it at {off!r}, or run the "
                f"JAX package)")


def sgd_init(params: dict) -> dict:
    """Momentum buffers, zero (torch SGD's buf_0 = g_0 is the same update:
    m * 0 + g_0)."""
    return {k: torch.zeros_like(v) for k, v in params.items()}


def _device_prefetch(batches, place, depth: int):
    """Overlap the copy of batch k+1 to the card with the step on batch k:
    `place` (pinned host copy + non-blocking transfer) runs on the feeder
    thread (core/feeder.py holds the thread discipline)."""
    from ..core.feeder import feed
    return feed((place(images_u8, labels) for images_u8, labels in batches),
                depth)


class ViTTrainer:
    """The train step and validation of one classifier on one device. The
    step updates the model's parameters and the momentum buffers in place."""

    def __init__(self, vit_cfg: vvit.ViTConfig, train_cfg: ViTTrainConfig,
                 model: vvit.VisionTransformerClassifier, device):
        refuse_unported(train_cfg)
        self.vit_cfg = vit_cfg
        self.cfg = train_cfg
        self.model = model
        self.device = torch.device(device)
        self.compute_dtype = (torch.bfloat16
                              if train_cfg.compute_dtype == "bfloat16"
                              else torch.float32)
        # per trainer, never process-wide: another trainer in the same
        # process keeps its own choice
        self.fused_dw = bool(train_cfg.fused_dw)

    # -- steps ----------------------------------------------------------------

    def logits(self, images: torch.Tensor, remat: bool = False,
               input_norm: tuple | None = IMAGENET_NORM):
        """f32 logits of raw 0..255 images (the normalization folded into
        the patch matrix), or of normalized images with input_norm=None."""
        return vvit.vit_classify(self.model, images, input_norm=input_norm,
                                 compute_dtype=self.compute_dtype,
                                 remat=remat, fused_dw=self.fused_dw)

    def loss(self, images: torch.Tensor, labels: torch.Tensor,
             input_norm: tuple | None = IMAGENET_NORM):
        """Mean cross-entropy on f32 logits."""
        logp = torch.log_softmax(
            self.logits(images, self.cfg.remat, input_norm), -1)
        return -logp.gather(1, labels[:, None].long())[:, 0].mean()

    def batch_grads(self, params: list, images, labels,
                    input_norm: tuple | None = IMAGENET_NORM):
        """(loss, grads) of the batch; with grad_accum = G > 1 the batch is
        split into G microbatches whose gradients are summed in order and
        divided by G (peak activation memory of one microbatch; CE is a mean
        over equal microbatches, so the numbers are the unsplit step's)."""
        G = self.cfg.grad_accum
        if G == 1:
            loss = self.loss(images, labels, input_norm)
            return loss.detach(), torch.autograd.grad(loss, params)
        B = images.shape[0]
        if B % G != 0:
            raise ValueError(f"grad_accum ({G}) must divide the global batch "
                             f"({B})")
        total = torch.zeros((), dtype=torch.float32, device=images.device)
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        for img_g, lbl_g in zip(images.chunk(G), labels.chunk(G)):
            loss = self.loss(img_g, lbl_g, input_norm)
            grads = torch.autograd.grad(loss, params)
            total = total + loss.detach()
            acc = [a + g for a, g in zip(acc, grads)]
        return total / G, [a / G for a in acc]

    def step(self, momentum: dict, images_u8, labels, lr: float,
             perturb: tuple | None = None):
        """One SGD step in place: buf = m * buf + (g + wd * p);
        p = p - lr * buf. Returns the batch loss (a device scalar).

        `perturb` = (perturbation_type, key, epsilon) of an image
        perturbation: the whole batch is normalized explicitly and the
        injector replaces it in normalized space (the reference's
        GaussianNoiseTransform / UniformGrayTransform,
        measure...effect.py:36-60) before any grad_accum split."""
        names = [n for n, _ in self.model.named_parameters()]
        params = [p for _, p in self.model.named_parameters()]
        bufs = [momentum[n] for n in names]
        if perturb is None:
            loss, grads = self.batch_grads(params, images_u8, labels)
        else:
            ptype, key, epsilon = perturb
            images, labels = injectors.apply_vit_perturbation(
                ptype, key, normalize_imagenet(images_u8), labels,
                epsilon=epsilon)
            loss, grads = self.batch_grads(params, images, labels,
                                           input_norm=None)
        with torch.no_grad():
            upd = torch._foreach_mul(params, self.cfg.weight_decay)
            torch._foreach_add_(upd, grads)                 # g + wd * p
            torch._foreach_mul_(bufs, self.cfg.momentum)
            torch._foreach_add_(bufs, upd)                  # m * buf + ...
            torch._foreach_sub_(params, torch._foreach_mul(bufs, lr))
        return loss

    @torch.no_grad()
    def eval_counts(self, images_u8, labels):
        """(sum of CE, correct count, count) of one batch, on the device."""
        logits = self.logits(images_u8)
        logp = torch.log_softmax(logits, -1)
        ce = -logp.gather(1, labels[:, None].long())[:, 0]
        correct = (logits.argmax(-1) == labels.long()).sum()
        return ce.sum(), correct.float(), float(len(labels))

    @torch.no_grad()
    def _feature_step(self, images_u8: torch.Tensor) -> torch.Tensor:
        """CLS embeddings (forward_features, pool='token') of raw 0..255
        images, in the compute dtype."""
        return vvit.forward_features(self.model, images_u8, pool="token",
                                     input_norm=IMAGENET_NORM,
                                     compute_dtype=self.compute_dtype)

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
        """One epoch; returns the average train loss. `guard`
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
        # the loss sums on the device; the host reads it every log_every
        # steps and at the end of the epoch
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
                    f"Loss: {float(loss):.4f} LR: {lr:.6f}")
            if guard is not None and guard.should_stop():
                guard.mid_state = {"epoch": epoch, "batch_idx": batch_idx + 1,
                                   "total_loss": float(total_loss),
                                   "num_batches": num_batches}
                log(f"  Preemption requested - stopping epoch {epoch} after "
                    f"batch {batch_idx} ({num_batches}/{n_batches} done)")
                preempted = True
                break
        avg_loss = float(total_loss) / max(num_batches, 1)
        self.last_epoch = {"steps": num_batches - carry_n,
                           "images": (num_batches - carry_n) * loader.batch_size,
                           "train_s": time.time() - t0}
        if not preempted:
            dt = self.last_epoch["train_s"]
            log(f"Epoch {epoch} training completed in {dt / 60:.2f} minutes. "
                f"Avg Train Loss: {avg_loss:.4f} [images_per_sec="
                f"{self.last_epoch['images'] / max(dt, 1e-9):.1f}]")
        return avg_loss

    def validate(self, loader, logger=None) -> tuple[float, float]:
        """(val loss, val accuracy %) over the whole loader: one sum and one
        count for both, read once at the end."""
        log = logger.info if logger else print
        tot_loss = torch.zeros((), dtype=torch.float32, device=self.device)
        tot_correct = torch.zeros((), dtype=torch.float32, device=self.device)
        tot_n = 0.0
        for images_u8, labels in loader.epoch(0):
            ls, c, n = self.eval_counts(*self.place(images_u8, labels))
            tot_loss = tot_loss + ls
            tot_correct = tot_correct + c
            tot_n += n
        val_loss = float(tot_loss) / max(tot_n, 1.0)
        val_acc = 100.0 * float(tot_correct) / max(tot_n, 1.0)
        log(f"Validation - Loss: {val_loss:.4f}, Accuracy: {val_acc:.2f}%")
        return val_loss, val_acc

    def compute_rsa_score(self, things_images_u8: np.ndarray,
                          reference_rdm: np.ndarray,
                          batch_size: int = 8) -> tuple[float, float]:
        """(rho, p): forward_features CLS embeddings of the THINGS images
        in dataset order, chunks of `batch_size`, -> RDM -> Spearman
        against `reference_rdm` (reference compute_rsa_score,
        measure...effect.py:298-355, without its rank-order concatenation
        across processes)."""
        embs = []
        for s in range(0, len(things_images_u8), batch_size):
            chunk = np.ascontiguousarray(things_images_u8[s:s + batch_size])
            embs.append(self._feature_step(
                torch.from_numpy(chunk).to(self.device)))
        rho, p, _ = vrsa.behavioral_rsa(torch.cat(embs), reference_rdm)
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
    train_vit_sgd.py:246-371) on `device` (default: the card).

    Preemption (cfg.preempt_save): a SIGTERM mid-epoch checkpoints {params,
    momentum, scheduler, epoch, batch_idx, running loss} to
    checkpoint_preempt.pth and returns {"preempted": True}; the next call
    resumes inside that epoch and reproduces the uninterrupted run
    bit-exactly. `preempt_guard` injects a prebuilt guard (tests use a stub
    that trips after N batches). `on_epoch`, if given, is called after each
    completed epoch with its times ({"epoch", "steps", "images", "train_s",
    "val_s", "epoch_s"})."""
    from ..ckpt import serialization as ser
    from ..ckpt import vit_ckpt
    from ..core.preempt import PreemptionGuard
    from ..data.packed import make_loader
    from .schedules import CosineAnnealingLRWithWarmup

    log = logger.info if logger else print
    dev = resolve_device(device)
    refuse_unported(cfg)
    vit_cfg = vit_cfg or vvit.ViTConfig(
        patch=16, width=768, layers=12, heads=12, image_size=cfg.image_size,
        num_classes=cfg.num_classes)

    log("=" * 60)
    log("ViT-Base ImageNet Training (SGD)")
    log("=" * 60)
    log(f"Device: {dev}  processes: 1")
    log(f"Global batch size: {cfg.batch_size}")
    log(f"Total epochs: {cfg.epochs}")
    log(f"Optimizer: SGD lr={cfg.lr} momentum={cfg.momentum} "
        f"wd={cfg.weight_decay} warmup={cfg.warmup_epochs}")
    log(f"Output directory: {cfg.output_dir}")

    gen = torch.Generator(device=dev).manual_seed(cfg.random_seed)
    model = vvit.init_vit_params(vvit.empty_vit(vit_cfg, dev), gen)
    trainer = ViTTrainer(vit_cfg, cfg, model, dev)
    total = sum(p.numel() for p in model.parameters())
    log(f"Model created. Parameters: {total / 1e6:.1f}M")
    momentum = sgd_init(dict(model.named_parameters()))
    scheduler = CosineAnnealingLRWithWarmup(cfg.lr, cfg.warmup_epochs,
                                            cfg.epochs)

    # make_loader routes each split to PackedLoader when it is a packed
    # directory (identical batches either way)
    train_loader = make_loader(
        f"{cfg.data_path}/train", cfg.batch_size, train=True,
        seed=cfg.random_seed, size=cfg.image_size, workers=cfg.num_workers,
        drop_last=True, use_native=cfg.use_native_loader, echo=cfg.data_echo)
    val_loader = make_loader(
        f"{cfg.data_path}/val", cfg.batch_size, train=False,
        size=cfg.image_size, workers=cfg.num_workers,
        use_native=cfg.use_native_loader)
    log(f"Data loaded. Train batches: {len(train_loader)}, "
        f"Val batches: {len(val_loader)}")

    start_epoch = 0
    latest = vit_ckpt.latest_checkpoint(cfg.output_dir)
    if latest:
        ckpt = vit_ckpt.load_checkpoint(latest)
        load_trees(model, ckpt["params"], momentum, ckpt["opt_state"])
        scheduler.load_state_dict(ckpt["scheduler_state"])
        start_epoch = ckpt["epoch"] + 1
        log(f"Resumed from epoch {ckpt['epoch']}")

    # mid-epoch preemption checkpoint: valid only if it continues exactly
    # the next epoch; an older one is superseded by the epoch checkpoint
    # and deleted, a newer one means a torn tree and is ignored loudly
    mid_resume = None
    preempt_path = os.path.join(cfg.output_dir, "checkpoint_preempt.pth")
    if os.path.exists(preempt_path):
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

    guard = preempt_guard
    if guard is None and cfg.preempt_save:
        guard = PreemptionGuard()
    guard_cm = guard if (guard is not None and preempt_guard is None) \
        else contextlib.nullcontext()
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
            train_loss = trainer.train_one_epoch(
                momentum, train_loader, epoch, lr, logger=logger, guard=guard,
                **mid_kw)
            if guard is not None and getattr(guard, "mid_state", None):
                # the scheduler state saved here is the epoch-start state
                # (step() has not run), so the resume's peek() re-derives
                # the lr this partial epoch trained with
                ms = guard.mid_state
                save_p, save_m = _jax_trees(model, momentum)
                ser.save(preempt_path, {
                    "epoch": ms["epoch"], "batch_idx": ms["batch_idx"],
                    "total_loss": ms["total_loss"],
                    "num_batches": ms["num_batches"],
                    "params": save_p, "opt_state": save_m,
                    "scheduler_state": scheduler.state_dict()})
                log(f"Preempted: saved {preempt_path} (epoch {ms['epoch']}, "
                    f"next batch {ms['batch_idx']}); exiting resumable")
                return {"preempted": True, "model": model,
                        "momentum_buf": momentum, "scheduler": scheduler}
            scheduler.step()
            # with host_prefetch the copy of the checkpoint trees runs
            # beside validation (core/hostcopy.py)
            trees = (dict(model.named_parameters()), momentum)
            copies = (hostcopy.prefetch_to_host(*trees) if cfg.host_prefetch
                      else [hostcopy.HostCopy(tree) for tree in trees])
            t_val = time.time()
            val_loss, val_acc = trainer.validate(val_loader, logger=logger)
            val_s = time.time() - t_val
            save_p, save_m = (vconvert.vit_jax_from_state_dict(c.get())
                              for c in copies)
            vit_ckpt.save_checkpoint(
                epoch, save_p, save_m, scheduler.state_dict(), train_loss,
                val_loss, val_acc, cfg.output_dir, logger=logger)
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
    log("Training Complete!")
    return {"model": model, "momentum_buf": momentum, "scheduler": scheduler}
