"""Per-run manifests for experiment artifact trees (a copy of the JAX
package's analysis/manifest.py).

The paradigm drives produce multi-GB trees under a scratch dir (per-epoch
DoRA + random-state checkpoints for every baseline epoch / sweep fork /
lengths condition — reference layout, new_cvpr_train_behavior_things_
pipeline.py:657-728). Only figures and summary CSVs are small enough to
commit, so the committed evidence for "run N trained K epochs to loss L"
would otherwise be a narrative. A manifest makes the claim independently
checkable after the scratch tree evaporates: for every run directory it
records the epochs trained, the final CSV row, and content hashes of every
file, so anyone holding the tree (or a regenerated one — the drives are
deterministic from committed seeds) can verify it byte-for-byte.

Layouts understood (both the reference's and ours, which match by design):
  - baseline dirs:   training_res.csv + dora_params/ + random_states/
  - sweep run dirs:  training_run{N}/training_res_run{N}.csv + dora_params_run{N}/ ...
  - lengths dirs:    {type}_e{E}_l{L}/training_res.csv + dora_params_{E}/ ...
  - flat fig2 trees: training_res_run{N}.csv files directly in the type dir
    (reference Data/clip_results/uniform_target/ et al.)
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Any

_CSV_RE = re.compile(r"training_res(_run\d+)?\.csv$")


def _hash_file(path: str, algo: str = "blake2b") -> str:
    h = hashlib.new(algo, digest_size=16) if algo == "blake2b" \
        else hashlib.new(algo)
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _csv_stats(path: str) -> dict[str, Any]:
    """Header + first/last data rows of a training_res CSV, no pandas —
    manifests must be buildable on a minimal host."""
    with open(path) as f:
        header = f.readline().strip().split(",")
        first = last = None
        n = 0
        for line in f:
            line = line.strip()
            if not line:
                continue
            n += 1
            if first is None:
                first = line
            last = line
    out: dict[str, Any] = {"rows": n, "columns": header}
    for tag, line in (("first", first), ("last", last)):
        if line is None:
            continue
        vals = line.split(",")
        row = dict(zip(header, vals))
        try:
            out[f"{tag}_epoch"] = int(float(row["epoch"]))
        except (KeyError, ValueError):
            # a torn write or repeated mid-file header must degrade to a
            # missing stat for this one file, not abort the tree manifest
            out[f"{tag}_epoch"] = None
        for k in ("train_loss", "test_loss", "behavioral_rsa_rho",
                  "val_loss", "val_acc", "rsa_score"):
            if k in row:
                try:
                    out[f"{tag}_{k}"] = float(row[k])
                except ValueError:
                    pass
    return out


def run_manifest(run_dir: str, hash_files: bool = True,
                 algo: str = "blake2b") -> dict[str, Any]:
    """Manifest of ONE run directory: CSV stats + a full file inventory."""
    entry: dict[str, Any] = {"dir": os.path.basename(run_dir.rstrip("/")),
                             "csvs": {}, "files": {}}
    n_bytes = 0
    for root, _dirs, files in os.walk(run_dir):
        for name in sorted(files):
            p = os.path.join(root, name)
            rel = os.path.relpath(p, run_dir)
            size = os.path.getsize(p)
            n_bytes += size
            rec: dict[str, Any] = {"bytes": size}
            if hash_files:
                rec[algo] = _hash_file(p, algo)
            entry["files"][rel] = rec
            if _CSV_RE.search(name):
                entry["csvs"][rel] = _csv_stats(p)
    entry["n_files"] = len(entry["files"])
    entry["total_bytes"] = n_bytes
    return entry


def _run_dirs(tree: str) -> list[str]:
    """Run directories directly under an experiment tree (sweep
    training_run{N}/, lengths {type}_e{E}_l{L}/, or the tree itself when
    it holds a training_res CSV at top level, e.g. a baseline dir)."""
    out = []
    try:
        names = sorted(os.listdir(tree))
    except (FileNotFoundError, NotADirectoryError):
        return out
    if any(_CSV_RE.search(n) for n in names):
        return [tree]
    for n in names:
        p = os.path.join(tree, n)
        if os.path.isdir(p) and (
                re.match(r"training_run\d+$", n)
                or re.match(r".+_e\d+_l\d+$", n)
                or n == "baseline"):
            out.append(p)
    return out


def tree_manifest(trees: dict[str, str], out_path: str | None = None,
                  hash_files: bool = True,
                  extra: dict[str, Any] | None = None) -> dict[str, Any]:
    """Manifest over several experiment trees: {label: tree_root}.

    Returns (and optionally writes as JSON) {label: {run_name: manifest}}
    plus per-tree totals, so a single committed file pins every run the
    drive claims to have produced.
    """
    doc: dict[str, Any] = {"hash": "blake2b-128" if hash_files else None,
                           "trees": {}}
    if extra:
        doc.update(extra)
    for label, root in trees.items():
        runs = {}
        total = 0
        for rd in _run_dirs(root):
            m = run_manifest(rd, hash_files=hash_files)
            runs[m["dir"]] = m
            total += m["total_bytes"]
        doc["trees"][label] = {
            "root": os.path.abspath(root),
            "n_runs": len(runs),
            "total_bytes": total,
            "runs": runs,
        }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
    return doc


def main(argv=None):  # pragma: no cover - thin CLI
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trees", nargs="+",
                    help="label=path pairs (or bare paths, labeled by "
                         "basename)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--no_hash", action="store_true")
    args = ap.parse_args(argv)
    trees = {}
    for t in args.trees:
        label, _, path = t.rpartition("=")
        trees[label or os.path.basename(path.rstrip("/"))] = path
    doc = tree_manifest(trees, args.out, hash_files=not args.no_hash)
    for label, t in doc["trees"].items():
        print(f"{label}: {t['n_runs']} runs, {t['total_bytes']:,} bytes")


if __name__ == "__main__":  # pragma: no cover
    main()
