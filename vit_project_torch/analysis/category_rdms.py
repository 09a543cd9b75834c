"""Per-epoch category-RDM archives from NOD embedding dumps (copy of the JAX
package's analysis/category_rdms.py; the dumps are read with the standard
library's ``csv`` module instead of pandas).

The reference's actual runs shipped `hba_nod_category_rdms_dict.npz` and
`perturbation_seed42_category_rdms_dict.npz` at the sweep root
(Data/clip_results/single_sweep_experiments/ of the reference tree), but no
committed script produces them and the shipped archives are truncated
placeholders (exactly 768 KiB each, no zip central directory), as are the
nod_embeddings_epochN.csv files (0 bytes) — SURVEY.md section 0 lists them as
evidence of a missing pipeline revision. This module therefore defines the
schema:

  np.savez(path,
           categories=<[C] str array>,
           epoch{N}=<[C, C] float32 category RDM>, ...)

where the category RDM is `1 - corrcoef` (zero diagonal) over category-MEAN
66-d embeddings — the same RDM construction as behavioral_RSA
(new_cvpr…pipeline.py:605-654) lifted from images to categories. An image's
category is the `category` column of the NOD annotation CSV when present,
else the image-name prefix before the last '_' (THINGS-style
`lemon_01b.jpg` -> `lemon`), else the parent directory of a path-like name.
"""
from __future__ import annotations

import csv
import glob
import os
import re

import numpy as np


def category_of(name: str) -> str:
    """Default category rule for an image name (see module docstring)."""
    base = str(name).replace("\\", "/")
    if "/" in base:
        return base.rsplit("/", 2)[-2]
    stem = os.path.splitext(base)[0]
    if "_" in stem:
        return stem.rsplit("_", 1)[0]
    return stem


def category_rdm(emb: np.ndarray, cats: list[str]):
    """[N, D] embeddings + per-image categories -> (sorted unique categories,
    [C, C] 1-corrcoef RDM over category-mean embeddings, zero diagonal)."""
    order = sorted(set(cats))
    means = np.stack([
        np.mean(emb[[i for i, c in enumerate(cats) if c == u]], axis=0)
        for u in order])
    rdm = 1.0 - np.corrcoef(means)
    np.fill_diagonal(rdm, 0.0)
    return order, rdm.astype(np.float32)


def build_category_rdms(dump_dir: str, categories: list[str] | None = None,
                        prefix: str = "nod") -> dict:
    """Scan `{dump_dir}/{prefix}_embeddings_epoch{N}.csv` dumps (written by
    train_model's nod_dump_dir path) into {'categories': [...],
    'epoch{N}': rdm} ready for np.savez."""
    out: dict = {}
    cat_order = None
    pat = os.path.join(dump_dir, f"{prefix}_embeddings_epoch*.csv")
    for f in sorted(glob.glob(pat)):
        m = re.search(r"epoch(\d+)\.csv$", f)
        if not m:
            continue
        names, emb = _read_dump(f)
        cats = categories if categories is not None else \
            [category_of(n) for n in names]
        order, rdm = category_rdm(emb, cats)
        if cat_order is None:
            cat_order = order
        elif order != cat_order:
            # a partial dump or foreign file matching the glob would silently
            # mislabel rows under the first file's 'categories' axis
            raise ValueError(
                f"{f}: category set {order} differs from the other epoch "
                f"dumps' {cat_order} — refusing to build a mislabeled "
                "archive")
        out[f"epoch{int(m.group(1))}"] = rdm
    if cat_order is not None:
        out["categories"] = np.asarray(cat_order)
    return out


def _read_dump(path: str) -> tuple[list[str], np.ndarray]:
    """(image names, [N, D] float32 embeddings) of one dump: the
    `image_name` column + the embedding columns (dump_embeddings in
    train/clip_loop.py), else the first column + the rest."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    col = rows[0].index("image_name") if "image_name" in rows[0] else 0
    names = [r[col] for r in rows[1:]]
    emb = np.array([[float(v) for j, v in enumerate(r) if j != col]
                    for r in rows[1:]], dtype=np.float32)
    return names, emb


def save_category_rdms(dump_dir: str, out_path: str,
                       categories: list[str] | None = None,
                       prefix: str = "nod") -> str | None:
    """Build + savez the archive; returns out_path, or None if no dumps."""
    d = build_category_rdms(dump_dir, categories, prefix)
    if not d:
        return None
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **d)
    return out_path


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Build {prefix}_category_rdms_dict.npz from per-epoch "
                    "embedding dumps")
    ap.add_argument("dump_dir", help="dir with nod_embeddings_epochN.csv")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--prefix", default="nod")
    args = ap.parse_args(argv)
    p = save_category_rdms(args.dump_dir, args.output, prefix=args.prefix)
    if p is None:
        print(f"no {args.prefix}_embeddings_epochN.csv dumps in "
              f"{args.dump_dir}")
        return 1
    print(f"wrote {p}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
