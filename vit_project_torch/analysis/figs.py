"""Analysis: the reference's four figure notebooks as importable functions + CLI
(a copy of the JAX package's analysis/figs.py).

Reference notebooks (Figures/fig1..fig4):
- fig1: baseline trajectories — behavioral RSA vs test/val loss per epoch (CLIP
  curve trimmed at its min-test-loss epoch).
- fig2: immediate-effect bars — delta test loss / delta RSA of each perturbation
  type at selected epochs vs the baseline.
- fig3: per-epoch sweep — delta bars across every sweep run directory
  `training_run{N}/training_res_run{N}.csv`.
- fig4: recovery — for `{type}_e{E}_l{L}` variable-length runs, the first
  post-window epoch whose test loss is within 1% of the baseline at the same
  epoch ("NR" if never; reference fig4 recovery cell, README.md:49).

All readers consume the CSV contracts in core/csvio.py, so they work on both this
framework's outputs and the reference's shipped Data/ artifacts (which the first 5
columns match).
"""
from __future__ import annotations

import os
import re

import pandas as pd


# -- loading -----------------------------------------------------------------

def load_clip_csv(path: str) -> pd.DataFrame:
    df = pd.read_csv(path)
    df["epoch"] = df["epoch"].astype(int)
    return df


def sweep_run_csv(sweep_dir: str, run: int) -> str:
    """Per-run CSV path in either reference layout: the sweep driver's
    nested `training_run{N}/training_res_run{N}.csv`, or the flat
    `training_res_run{N}.csv` the per-type dirs ship (image_noise/ etc. —
    the fig2 notebook reads 'training_res_run*.csv files from root
    directory')."""
    nested = os.path.join(sweep_dir, f"training_run{run}",
                          f"training_res_run{run}.csv")
    if os.path.exists(nested):
        return nested
    flat = os.path.join(sweep_dir, f"training_res_run{run}.csv")
    return flat if os.path.exists(flat) else nested


def list_sweep_runs(sweep_dir: str) -> list[int]:
    runs = []
    if not os.path.isdir(sweep_dir):
        return runs
    for name in os.listdir(sweep_dir):
        m = re.fullmatch(r"training_run(\d+)", name)
        if m and os.path.exists(sweep_run_csv(sweep_dir, int(m.group(1)))):
            runs.append(int(m.group(1)))
    return sorted(runs)


def list_length_runs(base_dir: str,
                     perturb_type: str | None = None) -> list[dict]:
    """Parse `{type}_e{E}_l{L}` condition directories (fig4 cell 10)."""
    out = []
    if not os.path.isdir(base_dir):
        return out
    for name in sorted(os.listdir(base_dir)):
        m = re.fullmatch(r"(.+)_e(\d+)_l(\d+)", name)
        if not m:
            continue
        ptype, e, l = m.group(1), int(m.group(2)), int(m.group(3))
        if perturb_type and ptype != perturb_type:
            continue
        # the reference's shipped tree mixes two artifact generations:
        # training_res.csv (the committed pipeline's name) and metrics.csv
        # (an earlier revision, same leading columns) — its fig4 notebook
        # reads both, so skipping metrics.csv would silently drop 18 of the
        # 136 conditions (e2/e7/e70 rows)
        for fname in ("training_res.csv", "metrics.csv"):
            csv_path = os.path.join(base_dir, name, fname)
            if os.path.exists(csv_path):
                out.append({"type": ptype, "onset": e, "length": l,
                            "csv": csv_path,
                            "dir": os.path.join(base_dir, name)})
                break
    return out


# -- fig1: trajectories ------------------------------------------------------

def clip_trajectory(baseline_csv: str, trim_at_min_loss: bool = True
                    ) -> pd.DataFrame:
    df = load_clip_csv(baseline_csv)
    if trim_at_min_loss:
        df = df.iloc[:int(df["test_loss"].idxmin()) + 1]
    return df[["epoch", "test_loss", "behavioral_rsa_rho"]]


def vit_trajectory(rsa_csv: str) -> pd.DataFrame:
    """Expects the enriched CSV epoch,...,val_loss,...,rsa_score."""
    df = pd.read_csv(rsa_csv)
    return df[["epoch", "val_loss", "rsa_score"]]


# -- fig2/fig3: deltas -------------------------------------------------------

def load_run_epoch_value(csv_path: str, epoch1: int, column: str):
    """Value of `column` at 1-indexed epoch (fig2 load_run_epoch_value)."""
    df = load_clip_csv(csv_path)
    row = df[df["epoch"] == epoch1]
    return None if row.empty else float(row[column].values[0])


def compute_deltas(baseline_csv: str, run_csv: str, epoch1: int) -> dict | None:
    """Delta test loss / delta RSA of a perturbed run vs baseline at the
    perturbed epoch (fig2 compute_deltas)."""
    out = {}
    for col, key in (("test_loss", "delta_loss"),
                     ("behavioral_rsa_rho", "delta_rsa")):
        b = load_run_epoch_value(baseline_csv, epoch1, col)
        r = load_run_epoch_value(run_csv, epoch1, col)
        if b is None or r is None:
            return None
        out[key] = r - b
    out["epoch"] = epoch1
    return out


def sweep_deltas(baseline_csv: str, sweep_dir: str) -> pd.DataFrame:
    """fig3: one (delta_loss, delta_rsa) row per sweep run."""
    rows = []
    for run in list_sweep_runs(sweep_dir):
        d = compute_deltas(baseline_csv, sweep_run_csv(sweep_dir, run), run)
        if d is not None:
            rows.append(d)
    return pd.DataFrame(rows)


def perturbation_type_deltas(baseline_csv: str, type_dirs: dict,
                             epochs: list[int]) -> pd.DataFrame:
    """fig2 (CLIP side): delta test loss / delta RSA per perturbation type at
    selected epochs. `type_dirs` maps perturbation-type name -> sweep directory
    (one sweep per type, reference fig2 compares epochs [5,15,25,35,45,70,98]
    across the four types)."""
    rows = []
    for ptype, sweep_dir in type_dirs.items():
        for e in epochs:
            csv_path = sweep_run_csv(sweep_dir, e)
            if not os.path.exists(csv_path):
                continue
            d = compute_deltas(baseline_csv, csv_path, e)
            if d is not None:
                rows.append({"perturbation_type": ptype, **d})
    return pd.DataFrame(rows)


def vit_type_deltas(perturbation_effects_csv: str) -> pd.DataFrame:
    """fig2 (ViT side): read the measurement CSV directly."""
    return pd.read_csv(perturbation_effects_csv)


# -- fig4: recovery ----------------------------------------------------------

def recovery_epoch(baseline_csv: str, run_csv: str, onset1: int, length: int,
                   threshold: float = 1.01):
    """First 1-indexed epoch AFTER the window end with
    run_test_loss <= threshold * baseline_test_loss(same epoch); None = "NR"."""
    base = load_clip_csv(baseline_csv).set_index("epoch")["test_loss"]
    run = load_clip_csv(run_csv).set_index("epoch")["test_loss"]
    window_end = onset1 + length - 1
    for epoch in sorted(run.index):
        if epoch <= window_end:
            continue
        if epoch in base.index and run[epoch] <= threshold * base[epoch]:
            return int(epoch)
    return None


def recovery_table(baseline_csv: str, base_dir: str,
                   perturb_type: str = "random_target",
                   threshold: float = 1.01) -> pd.DataFrame:
    """fig4: recovery time per (onset, length) condition; recovery_epochs = -1
    encodes NR (never recovered)."""
    rows = []
    for cond in list_length_runs(base_dir, perturb_type):
        rec = recovery_epoch(baseline_csv, cond["csv"], cond["onset"],
                             cond["length"], threshold)
        rows.append({
            "type": cond["type"], "onset": cond["onset"],
            "length": cond["length"],
            "recovery_epoch": -1 if rec is None else rec,
            "recovery_time": -1 if rec is None
            else rec - (cond["onset"] + cond["length"] - 1),
        })
    return pd.DataFrame(rows)


# -- plotting (optional matplotlib) ------------------------------------------

def plot_fig1(clip_csv: str, out_png: str, vit_csv: str | None = None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    ncols = 2 if vit_csv else 1
    fig, axes = plt.subplots(1, ncols, figsize=(6 * ncols, 4), squeeze=False)
    df = clip_trajectory(clip_csv)
    ax = axes[0][0]
    ax2 = ax.twinx()
    ax.plot(df["epoch"], df["behavioral_rsa_rho"], "o-", ms=3,
            label="behavioral RSA")
    ax2.plot(df["epoch"], df["test_loss"], "s--", ms=3, color="tab:orange",
             label="test loss")
    ax.set_xlabel("epoch")
    ax.set_ylabel("Spearman rho")
    ax2.set_ylabel("test loss")
    ax.set_title("CLIP-HBA baseline")
    if vit_csv:
        dv = vit_trajectory(vit_csv)
        ax = axes[0][1]
        ax2 = ax.twinx()
        ax.plot(dv["epoch"], dv["rsa_score"], "o-", ms=3)
        ax2.plot(dv["epoch"], dv["val_loss"], "s--", ms=3, color="tab:orange")
        ax.set_xlabel("epoch")
        ax.set_title("ViT baseline")
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    return out_png


def plot_fig2(baseline_csv: str, type_dirs: dict, epochs: list[int],
              out_png: str, vit_effects_csv: str | None = None):
    """Grouped delta bars per perturbation type at selected epochs (CLIP),
    optionally alongside the ViT measurement deltas."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    df = perturbation_type_deltas(baseline_csv, type_dirs, epochs)
    nrows = 2
    ncols = 2 if vit_effects_csv else 1
    fig, axes = plt.subplots(nrows, ncols, figsize=(7 * ncols, 7),
                             squeeze=False)
    types = sorted(df["perturbation_type"].unique()) if not df.empty else []
    width = 0.8 / max(len(types), 1)
    for row, metric in enumerate(("delta_loss", "delta_rsa")):
        ax = axes[row][0]
        for i, t in enumerate(types):
            sub = df[df["perturbation_type"] == t].set_index("epoch")
            xs = [j + i * width for j, e in enumerate(epochs)
                  if e in sub.index]
            ys = [sub.loc[e, metric] for e in epochs if e in sub.index]
            ax.bar(xs, ys, width=width, label=t)
        ax.set_xticks(range(len(epochs)))
        ax.set_xticklabels(epochs)
        ax.set_ylabel(metric)
        ax.legend(fontsize=7)
        ax.set_title("CLIP-HBA" if row == 0 else "")
    if vit_effects_csv:
        vdf = vit_type_deltas(vit_effects_csv)
        vtypes = sorted(vdf["perturbation_type"].unique())
        vepochs = sorted(vdf["perturb_epoch"].unique())
        vw = 0.8 / max(len(vtypes), 1)
        for row, metric in enumerate(("delta_loss", "delta_rsa")):
            ax = axes[row][1]
            for i, t in enumerate(vtypes):
                sub = vdf[vdf["perturbation_type"] == t].set_index(
                    "perturb_epoch")
                xs = [j + i * vw for j, e in enumerate(vepochs)
                      if e in sub.index]
                ys = [sub.loc[e, metric] for e in vepochs if e in sub.index]
                ax.bar(xs, ys, width=vw, label=t)
            ax.set_xticks(range(len(vepochs)))
            ax.set_xticklabels(vepochs)
            ax.set_ylabel(metric)
            ax.legend(fontsize=7)
            ax.set_title("ViT" if row == 0 else "")
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    return out_png


def plot_fig3(baseline_csv: str, sweep_dir: str, out_png: str):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    df = sweep_deltas(baseline_csv, sweep_dir)
    if df.empty:
        raise SystemExit(
            f"no training_run*/ sweep runs with CSVs under {sweep_dir}")
    fig, axes = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
    axes[0].bar(df["epoch"], df["delta_loss"])
    axes[0].set_ylabel("delta test loss")
    axes[1].bar(df["epoch"], df["delta_rsa"])
    axes[1].set_ylabel("delta RSA")
    axes[1].set_xlabel("perturbed epoch")
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    return out_png


def plot_fig4(baseline_csv: str, base_dir: str, out_png: str,
              perturb_type: str = "random_target"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    df = recovery_table(baseline_csv, base_dir, perturb_type)
    if df.empty:
        raise SystemExit(f"no {perturb_type}_e*_l* runs under {base_dir}")
    onsets = sorted(df["onset"].unique())
    lengths = sorted(df["length"].unique())
    width = 0.8 / max(len(lengths), 1)
    fig, ax = plt.subplots(figsize=(10, 4))
    for i, ln in enumerate(lengths):
        sub = df[df["length"] == ln].set_index("onset")
        xs, ys = [], []
        for j, onset in enumerate(onsets):
            if onset in sub.index:
                xs.append(j + i * width)
                rt = sub.loc[onset, "recovery_time"]
                ys.append(rt if rt >= 0 else 0)
                if rt < 0:
                    ax.text(j + i * width, 1, "NR", ha="center", fontsize=7,
                            rotation=90)
        ax.bar(xs, ys, width=width, label=f"len {ln}")
    ax.set_xticks(range(len(onsets)))
    ax.set_xticklabels(onsets)
    ax.set_xlabel("perturbation onset epoch")
    ax.set_ylabel("recovery time (epochs)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    return out_png


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="Analysis figures (fig1/fig3/fig4)")
    sub = p.add_subparsers(dest="cmd", required=True)
    f1 = sub.add_parser("fig1")
    f1.add_argument("--clip_csv", required=True)
    f1.add_argument("--vit_csv")
    f1.add_argument("--out", required=True)
    f2 = sub.add_parser("fig2")
    f2.add_argument("--baseline_csv", required=True)
    f2.add_argument("--type_dirs", nargs="+", required=True,
                    help="perturbation_type=sweep_dir pairs")
    f2.add_argument("--epochs", type=int, nargs="+",
                    default=[5, 15, 25, 35, 45, 70, 98])
    f2.add_argument("--vit_effects_csv")
    f2.add_argument("--out", required=True)
    f3 = sub.add_parser("fig3")
    f3.add_argument("--baseline_csv", required=True)
    f3.add_argument("--sweep_dir", required=True)
    f3.add_argument("--out", required=True)
    f4 = sub.add_parser("fig4")
    f4.add_argument("--baseline_csv", required=True)
    f4.add_argument("--base_dir", required=True)
    f4.add_argument("--perturb_type", default="random_target")
    f4.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.cmd == "fig1":
        print(plot_fig1(args.clip_csv, args.out, args.vit_csv))
    elif args.cmd == "fig2":
        type_dirs = dict(kv.split("=", 1) for kv in args.type_dirs)
        print(plot_fig2(args.baseline_csv, type_dirs, args.epochs, args.out,
                        args.vit_effects_csv))
    elif args.cmd == "fig3":
        print(plot_fig3(args.baseline_csv, args.sweep_dir, args.out))
    elif args.cmd == "fig4":
        print(plot_fig4(args.baseline_csv, args.base_dir, args.out,
                        args.perturb_type))


if __name__ == "__main__":
    main()
