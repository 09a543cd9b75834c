"""ViT single-epoch perturbation effect measurement (counterpart of the JAX
package's cli/vit_measure.py, with the same flags plus --device).

Reference: Training/vit_training/single_epoch/measure_single_epoch_perturbation_effect.py:
for each (perturb_epoch, perturbation_type) cell: read the baseline row, load the
checkpoint from epoch-1 (model + optimizer + scheduler), train exactly ONE
perturbed epoch, validate + compute THINGS-48 RSA, and emit
delta_loss / delta_rsa rows into one CSV.

Alone, one process on one card (unless --device says otherwise). Under
torchrun every rank trains each cell on its strided shard of the data
(--batch_size is the global batch), the validation sums and the RSA
embeddings are gathered, and rank 0 alone writes the CSVs (atomically;
every rank waits for them before returning).

  python -m vit_project_torch.cli.vit_measure --baseline_checkpoint_dir RUN \\
      --baseline_metrics_csv rsa_results.csv --data_path imagenet/ \\
      --output_csv perturbation_effects.csv --things_csv things48.csv \\
      --things_img_dir THINGS/ --things_rdm_path RDM48_triplet.mat
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import pandas as pd

from ..ckpt import serialization as ser
from ..ckpt import vit_ckpt
from ..core import csvio
from ..core.configs import ViTTrainConfig
from ..core.device import resolve_device
from ..data import imagenet as dimg
from ..models import vit as vvit
from ..parallel import dist
from ..perturb import injectors
from ..train.schedules import CosineAnnealingLRWithWarmup
from ..train.vit_loop import ViTTrainer, load_trees, sgd_init


def load_things_for_vit(things_csv: str, things_img_dir: str, size: int = 224):
    """THINGS-48 images with the ViT val transform (Resize 256 + CenterCrop 224,
    reference measure...effect.py:436-442). Returns (names, images_u8)."""
    from PIL import Image
    df = pd.read_csv(things_csv)
    names = df["image_name"].tolist()
    imgs = []
    for n in names:
        img = Image.open(os.path.join(things_img_dir, n)).convert("RGB")
        imgs.append(np.asarray(dimg.resize_center_crop(img, size), np.uint8))
    return names, np.stack(imgs)


def _clone(tensors: dict) -> dict:
    return {k: t.detach().clone() for k, t in tensors.items()}


def measure_perturbation_effect(
        perturb_epoch: int, perturbation_type: str | None,
        trainer: ViTTrainer, baseline_checkpoint_dir: str,
        baseline_df: pd.DataFrame, train_loader, val_loader, things_images_u8,
        reference_rdm, scheduler_cfg: dict, epsilon: float,
        shuffle_seed: int = 42, logger=None, ckpt_cache: dict | None = None):
    """One grid cell: the baseline's epoch `perturb_epoch - 1` checkpoint,
    one epoch under `perturbation_type` (None: unperturbed), validation and
    RSA. Returns the CSV row, or None when the baseline row or checkpoint is
    missing. `ckpt_cache` (a dict per perturb epoch) keeps the checkpoint as
    the first cell converted it (parameters and momentum on the trainer's
    device, the scheduler state), so the epoch's other types restore it
    with copies instead of reading and converting the file again."""
    log = logger.info if logger else print
    row = baseline_df[baseline_df["epoch"] == perturb_epoch]
    if row.empty:
        log(f"No baseline data for epoch {perturb_epoch}")
        return None
    baseline_loss = float(row["val_loss"].values[0])
    baseline_rsa = float(row["rsa_score"].values[0])
    log(f"Measuring: {perturbation_type} @ epoch {perturb_epoch} "
        f"(baseline loss={baseline_loss:.4f}, RSA={baseline_rsa:.4f})")

    # every perturbation type of one epoch forks from the same baseline
    # checkpoint: read and convert the file (hundreds of MB at ViT-B/16)
    # once per epoch, then restore the converted state on the device
    t0 = time.time()
    cached = ckpt_cache.get("state") if ckpt_cache is not None else None
    if cached is None:
        ckpt_path = vit_ckpt.epoch_checkpoint(baseline_checkpoint_dir,
                                              perturb_epoch - 1)
        if ckpt_path is None:
            log(f"Checkpoint not found: "
                f"checkpoint_epoch_{perturb_epoch - 1:03d}"
                f".pth in {baseline_checkpoint_dir}")
            return None
        ckpt = vit_ckpt.load_checkpoint(ckpt_path)
        momentum = sgd_init(dict(trainer.model.named_parameters()))
        load_trees(trainer.model, ckpt["params"], momentum, ckpt["opt_state"])
        scheduler_state = ckpt["scheduler_state"]
        if ckpt_cache is not None:
            ckpt_cache["state"] = (_clone(trainer.model.state_dict()),
                                   _clone(momentum), scheduler_state)
    else:
        params, saved_momentum, scheduler_state = cached
        trainer.model.load_state_dict(params, strict=True)
        momentum = _clone(saved_momentum)
    scheduler = CosineAnnealingLRWithWarmup(**scheduler_cfg)
    scheduler.load_state_dict(scheduler_state)
    t_load = time.time() - t0

    # label-table perturbations wrap the dataset (reference :180-184)
    if perturbation_type == "label_shuffle":
        table = injectors.shuffled_label_table(train_loader.num_samples(),
                                               shuffle_seed)
        train_loader.label_table = train_loader.labels[table]
    elif perturbation_type == "target_noise":
        train_loader.label_table = injectors.random_target_table(
            train_loader.num_samples(), trainer.cfg.num_classes,
            shuffle_seed)
    else:
        train_loader.label_table = None

    t0 = time.time()
    lr = scheduler.peek()
    try:
        trainer.train_one_epoch(
            momentum, train_loader, perturb_epoch, lr,
            perturbation_type=perturbation_type, epsilon=epsilon,
            perturb_seed=shuffle_seed, logger=logger)
    finally:
        train_loader.label_table = None
    scheduler.step()
    t_epoch = time.time() - t0

    t0 = time.time()
    val_loss, val_acc = trainer.validate(val_loader, logger=logger)
    t_val = time.time() - t0
    t0 = time.time()
    rsa_score, _ = trainer.compute_rsa_score(things_images_u8, reference_rdm)
    t_rsa = time.time() - t0
    result = {
        "perturb_epoch": perturb_epoch,
        "perturbation_type": perturbation_type,
        "baseline_loss": baseline_loss,
        "baseline_rsa": baseline_rsa,
        "perturbed_loss": val_loss,
        "perturbed_rsa": rsa_score,
        "delta_loss": val_loss - baseline_loss,
        "delta_rsa": rsa_score - baseline_rsa,
    }
    log(f"Perturbed: loss={val_loss:.4f}, RSA={rsa_score:.4f} "
        f"(dloss={result['delta_loss']:+.4f}, drsa={result['delta_rsa']:+.4f})")
    log(f"Cell seconds: load={t_load:.3f} epoch={t_epoch:.3f} "
        f"validation={t_val:.3f} rsa={t_rsa:.3f}")
    return result


def _write_csvs(output_csv: str, results: list, df) -> None:
    """The grid CSV and, beside it, the reference runs' companion table
    (Data/vit_results/perturbation_summary_table.csv, committed without
    the script that wrote it: a 4-decimal projection of the grid); each
    written atomically."""
    ser.atomic_write(output_csv,
                     lambda tmp: csvio.write_measure_csv(tmp, results))
    print(f"Saved results to {output_csv}")
    print(df.to_string(index=False))
    if len(df):
        summary = df[["perturb_epoch", "perturbation_type", "delta_loss",
                      "delta_rsa", "baseline_loss", "baseline_rsa"]].round(4)
        spath = os.path.join(os.path.dirname(output_csv) or ".",
                             "perturbation_summary_table.csv")
        ser.atomic_write(spath, lambda tmp: summary.to_csv(tmp, index=False))
        print(f"Saved summary table to {spath}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Measure single-epoch perturbation "
                                            "effects on ViT (PyTorch / CUDA)")
    p.add_argument("--baseline_checkpoint_dir", required=True)
    p.add_argument("--baseline_metrics_csv", required=True,
                   help="CSV with epoch,val_loss,rsa_score columns")
    p.add_argument("--data_path", required=True)
    p.add_argument("--output_csv", required=True)
    p.add_argument("--things_csv", required=True)
    p.add_argument("--things_img_dir", required=True)
    p.add_argument("--things_rdm_path", required=True)
    p.add_argument("--perturbation_types", nargs="+",
                   default=["gaussian", "uniform_gray", "label_shuffle",
                            "target_noise"])
    p.add_argument("--perturb_epochs", type=int, nargs="+",
                   default=[5, 10, 15, 16, 20, 25, 30, 35, 45, 70, 98])
    p.add_argument("--epsilon", type=float, default=0.1)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--warmup_epochs", type=int, default=5)
    p.add_argument("--total_epochs", type=int, default=100)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--random_seed", type=int, default=0,
                   help="MUST match the baseline training run's "
                        "--random_seed: the forked perturbed epoch replays "
                        "the baseline's per-epoch shuffle/augmentation "
                        "stream, so a different seed confounds the measured "
                        "deltas with a data-order change")
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--backbone", default="vit_base_patch16_224",
                   help="model config name (see models.vit.VIT_CONFIGS)")
    p.add_argument("--use_native_loader", action="store_true",
                   help="decode/augment through the C++ core "
                        "(build with: make -C native)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on ('cpu' for tests, gloo "
                        "under torchrun); under torchrun 'cuda' is the "
                        "rank's card")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(dist.local_device(args.device))
    with dist.process_group(dev) as (proc_id, proc_count):
        return _main(args, dev, proc_id, proc_count)


def _main(args, dev, proc_id: int, proc_count: int):
    import scipy.io

    vit_cfg = vvit.VIT_CONFIGS[args.backbone]
    cfg = ViTTrainConfig(
        data_path=args.data_path, batch_size=args.batch_size, lr=args.lr,
        momentum=args.momentum, weight_decay=args.weight_decay,
        warmup_epochs=args.warmup_epochs, epochs=args.total_epochs,
        num_workers=args.num_workers, compute_dtype=args.compute_dtype,
        image_size=vit_cfg.image_size,
        num_classes=vit_cfg.num_classes or 1000)
    # the weights come from each cell's baseline checkpoint
    trainer = ViTTrainer(vit_cfg, cfg, vvit.empty_vit(vit_cfg, dev), dev)

    baseline_df = pd.read_csv(args.baseline_metrics_csv)
    # the batch is global: each rank loads its strided shard and feeds its
    # local share (run_vit_training's contract)
    if args.batch_size % proc_count != 0:   # not an assert: survives -O
        raise SystemExit(f"global batch {args.batch_size} must divide by "
                         f"{proc_count} processes")
    local_bs = args.batch_size // proc_count
    from ..data.packed import make_loader
    train_loader = make_loader(
        f"{args.data_path}/train", local_bs, train=True,
        seed=args.random_seed,  # replay the baseline's shuffle/aug stream
        size=vit_cfg.image_size, workers=args.num_workers, drop_last=True,
        use_native=args.use_native_loader, num_shards=proc_count,
        shard_id=proc_id)
    val_loader = make_loader(
        f"{args.data_path}/val", local_bs, train=False,
        size=vit_cfg.image_size, workers=args.num_workers,
        use_native=args.use_native_loader, num_shards=proc_count,
        shard_id=proc_id)
    _, things_images = load_things_for_vit(args.things_csv,
                                           args.things_img_dir,
                                           size=vit_cfg.image_size)
    reference_rdm = np.asarray(
        scipy.io.loadmat(args.things_rdm_path)["RDM48_triplet"], np.float32)

    scheduler_cfg = dict(base_lr=args.lr, warmup_epochs=args.warmup_epochs,
                         max_epochs=args.total_epochs, eta_min=0.0)

    results = []
    for perturb_epoch in args.perturb_epochs:
        if perturb_epoch == 0:
            continue
        ckpt_cache: dict = {}   # one baseline checkpoint load per epoch
        for ptype in args.perturbation_types:
            r = measure_perturbation_effect(
                perturb_epoch, ptype, trainer,
                args.baseline_checkpoint_dir, baseline_df, train_loader,
                val_loader, things_images, reference_rdm, scheduler_cfg,
                args.epsilon, ckpt_cache=ckpt_cache)
            if r is not None:
                results.append(r)

    df = pd.DataFrame(results)
    if dist.is_primary():   # one CSV writer (reference rank-0 gate)
        _write_csvs(args.output_csv, results, df)
    # a caller may chain another CLI in this group: no rank returns before
    # the primary's files are whole
    dist.barrier()
    return results


if __name__ == "__main__":
    main()
