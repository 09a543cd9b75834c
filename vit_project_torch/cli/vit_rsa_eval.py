"""Per-epoch RSA evaluation over a directory of ViT baseline checkpoints
(counterpart of the JAX package's cli/vit_rsa_eval.py, with the same flags
plus --device).

Produces the enriched metrics CSV
`checkpoint,epoch,train_loss,val_loss,val_acc,rsa_score`
(the reference ships this as Data/vit_results/rsa_results_final.csv but commits no
script that writes it; the measurement grid, cli/vit_measure.py, reads its
rsa_score column as the baseline). Under torchrun every rank embeds its
strided share of the THINGS images, the embeddings are gathered in dataset
order, and rank 0 writes the CSV (atomically; every rank waits for it
before returning).

  python -m vit_project_torch.cli.vit_rsa_eval --checkpoint_dir RUN \\
      --output_csv rsa_results.csv --things_csv things48.csv \\
      --things_img_dir THINGS/ --things_rdm_path RDM48_triplet.mat
"""
from __future__ import annotations

import argparse
import os
import re

import numpy as np
import pandas as pd

from ..ckpt import serialization as ser
from ..ckpt import vit_ckpt
from ..core.configs import ViTTrainConfig
from ..core.device import resolve_device
from ..models import vit as vvit
from ..parallel import dist
from ..train.vit_loop import ViTTrainer, load_trees
from .vit_measure import load_things_for_vit


def list_epoch_checkpoints(ckpt_dir: str) -> list[tuple[int, str]]:
    """Every per-epoch checkpoint (.pth, .dcp or a pod-written .orbax
    directory), one entry per epoch; vit_ckpt.epoch_checkpoint picks the
    newer when an epoch has several, as JAX's listing does."""
    epochs = set()
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"checkpoint_epoch_(\d+)\.(pth|dcp|orbax)", name)
        if m:
            epochs.add(int(m.group(1)))
    return [(e, vit_ckpt.epoch_checkpoint(ckpt_dir, e))
            for e in sorted(epochs)]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Per-epoch ViT RSA over baseline "
                                            "checkpoints (PyTorch / CUDA)")
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--output_csv", required=True)
    p.add_argument("--things_csv", required=True)
    p.add_argument("--things_img_dir", required=True)
    p.add_argument("--things_rdm_path", required=True)
    p.add_argument("--backbone", default="vit_base_patch16_224")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on ('cpu' for tests, gloo "
                        "under torchrun); under torchrun 'cuda' is the "
                        "rank's card")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(dist.local_device(args.device))
    with dist.process_group(dev):
        return _main(args, dev)


def _main(args, dev):
    import scipy.io
    vit_cfg = vvit.VIT_CONFIGS[args.backbone]
    cfg = ViTTrainConfig(batch_size=args.batch_size,
                         compute_dtype=args.compute_dtype,
                         image_size=vit_cfg.image_size,
                         num_classes=vit_cfg.num_classes or 1000)
    trainer = ViTTrainer(vit_cfg, cfg, vvit.empty_vit(vit_cfg, dev), dev)
    _, things_images = load_things_for_vit(args.things_csv,
                                           args.things_img_dir,
                                           size=vit_cfg.image_size)
    reference_rdm = np.asarray(
        scipy.io.loadmat(args.things_rdm_path)["RDM48_triplet"], np.float32)

    checkpoints = list_epoch_checkpoints(args.checkpoint_dir)
    if not checkpoints:
        # a wrong --checkpoint_dir would otherwise give a headerless empty
        # CSV and a success message, and the grid would fail far from the
        # mistake
        raise SystemExit(f"no checkpoint_epoch_* entries found in "
                         f"{args.checkpoint_dir}")
    rows = []
    for epoch, path in checkpoints:
        ckpt = vit_ckpt.load_checkpoint(path)
        load_trees(trainer.model, ckpt["params"])
        rho, _ = trainer.compute_rsa_score(things_images, reference_rdm,
                                           batch_size=args.batch_size)
        rows.append({
            "checkpoint": f"checkpoint_epoch_{epoch:03d}",
            "epoch": epoch,
            "train_loss": ckpt.get("train_loss"),
            "val_loss": ckpt.get("val_loss"),
            "val_acc": ckpt.get("val_acc"),
            "rsa_score": rho,
        })
        print(f"epoch {epoch}: rsa={rho:.4f}")

    df = pd.DataFrame(rows)
    if dist.is_primary():   # one CSV writer
        ser.atomic_write(args.output_csv,
                         lambda tmp: df.to_csv(tmp, index=False))
        print(f"Wrote {args.output_csv}")
    # a caller may chain another CLI in this group (cli.vit_measure reads
    # this CSV next): no rank returns before the file is whole
    dist.barrier()
    return df


if __name__ == "__main__":
    main()
