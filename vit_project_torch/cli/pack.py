"""Pack an ImageFolder tree into the fipack shard format (data/packed.py).

The counterpart of the JAX package's cli/pack.py; both write the same bytes.

One offline pass replaces the per-image open()/read()/close() tax of
ImageFolder training (the cost the reference's SLURM launcher works around
by rsyncing the whole tree to local SSD, run_vit_sgd_training.slurm) with a
few mmapped shard files + an index. Afterwards, point --data_path at the
packed directory — vit_train routes through PackedLoader automatically and
produces bit-identical batches.

  python -m vit_project_torch.cli.pack --src /data/imagenet --out /data/packed
  # packs src/train and src/val (or a single split with --split)

It joins no process group and gates no write on the rank: run it once,
outside torchrun, before the training CLIs read what it wrote.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="ImageFolder root (containing train/ + val/, or a "
                         "single class tree with --split '')")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--split", nargs="*", default=["train", "val"],
                    help="subdirectories to pack (default: train val); pass "
                         "a single '' to pack --src itself")
    ap.add_argument("--shard_mb", type=int, default=512,
                    help="target shard size in MB")
    args = ap.parse_args(argv)
    if not args.split:
        ap.error("--split needs at least one value (use --split '' to pack "
                 "--src itself)")

    from ..data.packed import pack_image_folder
    pairs = []
    for split in args.split:
        src = os.path.join(args.src, split) if split else args.src
        out = os.path.join(args.out, split) if split else args.out
        # validate every split before packing any: a missing val/ found
        # only after hours of packing train/ would waste the whole run
        if not os.path.isdir(src):
            raise SystemExit(f"not a directory: {src}")
        pairs.append((src, out))
    for src, out in pairs:
        pack_image_folder(src, out, shard_mb=args.shard_mb)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
