"""One-command parity report: our artifact tree vs the reference's Data/
(a copy of the JAX package's analysis/parity.py, on the port's figs).

The reference ships its measured science as a CSV tree
(`Data/clip_results/` + `Data/vit_results/`); our drives produce the same
layouts (mirrored commit-sized under results/paradigm_r5/clip_results).
This tool diffs the two tree-for-tree and emits a single report:

  1. schema/coverage checks — baseline CSV columns (the 7- and 9-column
     generations both ship in the reference tree), the 98 sweep run dirs,
     the four fig2 type trees at runs {5,15,25,35,45,70,98}, the
     136-condition lengths grid, the ViT rsa/effects CSVs;
  2. trajectory overlays — baseline test-loss and RSA vs epoch, ours and
     reference on shared axes (fig1 semantics);
  3. Δ-bar side-by-sides — per-type Δtest-loss/ΔRSA at the fig2 epochs and
     the 98-run fig3 sweep deltas;
  4. recovery-table side-by-side — fig4's 1.01x/NR rule over both lengths
     trees, merged per (onset, length), with agreement stats.

Either half may be missing: `--ours` alone reports our tree,
`--reference` alone (run against a checkout of the reference's Data/) reports
the reference's. Numeric agreement is only meaningful once our tree is
produced from real weights/data (zero-egress boxes train on synthetic
data, so trajectories differ by construction); the report states which
regime it was generated in via --regime.

Reference semantics: fig1-4 notebooks (Figures/), baseline_clip_results_
seed1.csv, perturbation_effects.csv, rsa_results_final.csv.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import pandas as pd

from . import figs

FIG2_EPOCHS = [5, 15, 25, 35, 45, 70, 98]
FIG2_TYPES = ["target_noise", "label_shuffle", "image_noise",
              "uniform_target"]
SWEEP_DIRNAME = "single_sweep_experiments"
LENGTHS_DIRNAME = "perturb_length_experiments_baselineseed1_perturbseed0"
BASELINE_NAME = "baseline_clip_results_seed1.csv"

# fixed two-entity palette (ours always blue, reference always orange —
# identity never depends on how many series a panel happens to have)
C_OURS, C_REF = "#3B6FB6", "#D9822B"


# -- schema / coverage checks -------------------------------------------------

def _check(name: str, ok: bool, detail: str) -> dict:
    return {"check": name, "ok": bool(ok), "detail": detail}


def clip_inventory(root: str) -> list[dict]:
    """Coverage checklist for one clip_results tree."""
    out = []
    base = os.path.join(root, BASELINE_NAME)
    if os.path.exists(base):
        cols = list(pd.read_csv(base, nrows=0).columns)
        core = ["epoch", "train_loss", "test_loss", "behavioral_rsa_rho",
                "behavioral_rsa_p_value"]
        out.append(_check(
            "baseline_csv_schema", cols[:5] == core,
            f"{len(cols)} columns, first5={cols[:5]}"))
        n = len(figs.load_clip_csv(base))
        out.append(_check("baseline_epochs", n >= 98, f"{n} epochs"))
    else:
        out.append(_check("baseline_csv_schema", False, f"missing {base}"))

    sweep = os.path.join(root, SWEEP_DIRNAME)
    runs = figs.list_sweep_runs(sweep)
    out.append(_check("sweep_98_runs", len(runs) >= 97,
                      f"{len(runs)} run dirs (reference lost run 56 of its "
                      f"own 98)" if runs else "missing"))
    for t in FIG2_TYPES:
        tdir = os.path.join(root, t)
        have = [e for e in FIG2_EPOCHS
                if os.path.exists(figs.sweep_run_csv(tdir, e))]
        out.append(_check(f"fig2_{t}", len(have) == len(FIG2_EPOCHS),
                          f"runs {have}"))
    lengths = os.path.join(root, LENGTHS_DIRNAME)
    conds = figs.list_length_runs(lengths)
    out.append(_check("lengths_grid", len(conds) >= 136,
                      f"{len(conds)} condition dirs (reference: 136)"))
    return out


def vit_inventory(root: str) -> list[dict]:
    out = []
    for name, cols in (("rsa_results_final.csv",
                        ["epoch", "val_loss", "rsa_score"]),
                       ("perturbation_effects.csv",
                        ["perturb_epoch", "perturbation_type", "delta_loss",
                         "delta_rsa"])):
        # our grid mirror names the first file rsa_results.csv
        cands = [os.path.join(root, name),
                 os.path.join(root, name.replace("_final", ""))]
        path = next((p for p in cands if os.path.exists(p)), None)
        if path is None:
            out.append(_check(f"vit_{name}", False, "missing"))
            continue
        have = list(pd.read_csv(path, nrows=0).columns)
        out.append(_check(f"vit_{name}", all(c in have for c in cols),
                          f"columns {have}"))
        if name == "perturbation_effects.csv":
            n = len(pd.read_csv(path))
            out.append(_check("vit_grid_cells", n >= 44,
                              f"{n} rows (reference: 44)"))
    return out


# -- overlays and side-by-sides ----------------------------------------------

def _axstyle(ax, title, xlabel, ylabel):
    ax.set_title(title, fontsize=10)
    ax.set_xlabel(xlabel, fontsize=9)
    ax.set_ylabel(ylabel, fontsize=9)
    ax.grid(True, alpha=0.25, linewidth=0.5)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)


def plot_trajectory_overlay(ours_csv: str | None, ref_csv: str | None,
                            out_png: str) -> dict:
    """fig1 side: baseline test-loss and RSA vs epoch, both trees."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    stats: dict[str, Any] = {}
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 3.6))
    series = []
    if ours_csv and os.path.exists(ours_csv):
        series.append(("ours", figs.clip_trajectory(ours_csv,
                                                    trim_at_min_loss=False),
                       C_OURS))
    if ref_csv and os.path.exists(ref_csv):
        series.append(("reference", figs.clip_trajectory(
            ref_csv, trim_at_min_loss=False), C_REF))
    for label, df, color in series:
        ax1.plot(df["epoch"], df["test_loss"], color=color, linewidth=1.6,
                 label=label)
        ax2.plot(df["epoch"], df["behavioral_rsa_rho"], color=color,
                 linewidth=1.6, label=label)
        stats[f"{label}_peak_rsa"] = float(df["behavioral_rsa_rho"].max())
        stats[f"{label}_min_test_loss"] = float(df["test_loss"].min())
    _axstyle(ax1, "Baseline test loss", "epoch", "test loss")
    _axstyle(ax2, "Baseline behavioral RSA", "epoch", "Spearman rho")
    if len(series) == 2:
        a, b = series[0][1], series[1][1]
        m = a.merge(b, on="epoch", suffixes=("_o", "_r"))
        if len(m) >= 3:
            stats["rsa_trajectory_corr"] = float(np.corrcoef(
                m["behavioral_rsa_rho_o"], m["behavioral_rsa_rho_r"])[0, 1])
            stats["common_epochs"] = int(len(m))
    for ax in (ax1, ax2):
        if len(series) >= 2:
            ax.legend(fontsize=8, frameon=False)
    fig.tight_layout()
    fig.savefig(out_png, dpi=140)
    plt.close(fig)
    return stats


def type_deltas_table(root: str) -> pd.DataFrame:
    base = os.path.join(root, BASELINE_NAME)
    dirs = {t: os.path.join(root, t) for t in FIG2_TYPES}
    return figs.perturbation_type_deltas(base, dirs, FIG2_EPOCHS)


def plot_type_deltas_side_by_side(ours_root: str | None,
                                  ref_root: str | None,
                                  out_png: str) -> pd.DataFrame:
    """fig2 side: grouped Δ bars per type/epoch, ours next to reference."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    frames = []
    if ours_root:
        d = type_deltas_table(ours_root)
        if len(d):
            frames.append(d.assign(tree="ours"))
    if ref_root:
        d = type_deltas_table(ref_root)
        if len(d):
            frames.append(d.assign(tree="reference"))
    if not frames:
        return pd.DataFrame()
    all_d = pd.concat(frames, ignore_index=True)
    fig, axes = plt.subplots(2, len(FIG2_TYPES), figsize=(16, 6),
                             sharex=True)
    width = 0.38
    for j, t in enumerate(FIG2_TYPES):
        for i, col in enumerate(("delta_loss", "delta_rsa")):
            ax = axes[i][j]
            for k, (tree, color) in enumerate(
                    (("ours", C_OURS), ("reference", C_REF))):
                sub = all_d[(all_d["perturbation_type"] == t)
                           & (all_d["tree"] == tree)]
                if not len(sub):
                    continue
                x = np.array([FIG2_EPOCHS.index(e) for e in sub["epoch"]],
                             float)
                ax.bar(x + (k - 0.5) * width, sub[col], width=width,
                       color=color, label=tree, edgecolor="none")
            ax.axhline(0, color="#444", linewidth=0.7)
            ax.set_xticks(range(len(FIG2_EPOCHS)))
            ax.set_xticklabels(FIG2_EPOCHS, fontsize=7)
            _axstyle(ax, f"{t}" if i == 0 else "",
                     "perturbed epoch" if i == 1 else "",
                     ("Δ test loss" if j == 0 else "") if i == 0
                     else ("Δ RSA" if j == 0 else ""))
    axes[0][0].legend(fontsize=8, frameon=False)
    fig.tight_layout()
    fig.savefig(out_png, dpi=140)
    plt.close(fig)
    return all_d


def plot_sweep_deltas_overlay(ours_root: str | None, ref_root: str | None,
                              out_png: str) -> dict:
    """fig3 side: per-epoch sweep Δs over all 98 runs, both trees."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    stats: dict[str, Any] = {}
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(11, 5.4), sharex=True)
    for label, root, color in (("ours", ours_root, C_OURS),
                               ("reference", ref_root, C_REF)):
        if not root:
            continue
        d = figs.sweep_deltas(os.path.join(root, BASELINE_NAME),
                              os.path.join(root, SWEEP_DIRNAME))
        if not len(d):
            continue
        ax1.plot(d["epoch"], d["delta_loss"], color=color, linewidth=1.2,
                 label=label)
        ax2.plot(d["epoch"], d["delta_rsa"], color=color, linewidth=1.2,
                 label=label)
        stats[f"{label}_sweep_runs"] = int(len(d))
    _axstyle(ax1, "Single-epoch sweep: Δ test loss per perturbed epoch",
             "", "Δ test loss")
    _axstyle(ax2, "", "perturbed epoch", "Δ RSA")
    for ax in (ax1, ax2):
        ax.axhline(0, color="#444", linewidth=0.7)
        ax.legend(fontsize=8, frameon=False)
    fig.tight_layout()
    fig.savefig(out_png, dpi=140)
    plt.close(fig)
    return stats


def recovery_side_by_side(ours_root: str | None, ref_root: str | None
                          ) -> tuple[pd.DataFrame, dict]:
    """fig4 side: 1.01x/NR recovery per condition, merged per (onset,
    length)."""
    tables = {}
    for label, root in (("ours", ours_root), ("reference", ref_root)):
        if not root:
            continue
        base = os.path.join(root, BASELINE_NAME)
        ldir = os.path.join(root, LENGTHS_DIRNAME)
        if os.path.exists(base) and os.path.isdir(ldir):
            t = figs.recovery_table(base, ldir)
            if len(t):
                tables[label] = t
    if len(tables) == 2:
        merged = tables["ours"].merge(
            tables["reference"], on=["type", "onset", "length"],
            suffixes=("_ours", "_ref"), how="outer")
        both = merged.dropna(subset=["recovery_time_ours",
                                     "recovery_time_ref"])
        nr_agree = int(((both["recovery_time_ours"] < 0)
                        == (both["recovery_time_ref"] < 0)).sum())
        rec = both[(both["recovery_time_ours"] >= 0)
                   & (both["recovery_time_ref"] >= 0)]
        stats = {
            "conditions_ours": int(len(tables["ours"])),
            "conditions_reference": int(len(tables["reference"])),
            "conditions_common": int(len(both)),
            "nr_classification_agreement": nr_agree,
            "mean_abs_recovery_time_diff": (
                float((rec["recovery_time_ours"]
                       - rec["recovery_time_ref"]).abs().mean())
                if len(rec) else None),
        }
        return merged, stats
    if tables:
        label, t = next(iter(tables.items()))
        return t, {f"conditions_{label}": int(len(t))}
    return pd.DataFrame(), {}


# -- the report ---------------------------------------------------------------

def build_report(ours_clip: str | None, ref_clip: str | None,
                 out_dir: str, ours_vit: str | None = None,
                 ref_vit: str | None = None,
                 regime: str = "synthetic") -> dict:
    os.makedirs(out_dir, exist_ok=True)
    report: dict[str, Any] = {"regime": regime, "checks": {}, "stats": {},
                              "artifacts": []}

    for label, root in (("ours", ours_clip), ("reference", ref_clip)):
        if root:
            report["checks"][f"clip_{label}"] = clip_inventory(root)
    for label, root in (("ours", ours_vit), ("reference", ref_vit)):
        if root:
            report["checks"][f"vit_{label}"] = vit_inventory(root)

    p1 = os.path.join(out_dir, "parity_fig1_trajectory.png")
    report["stats"]["trajectory"] = plot_trajectory_overlay(
        os.path.join(ours_clip, BASELINE_NAME) if ours_clip else None,
        os.path.join(ref_clip, BASELINE_NAME) if ref_clip else None, p1)
    report["artifacts"].append(p1)

    p2 = os.path.join(out_dir, "parity_fig2_type_deltas.png")
    d2 = plot_type_deltas_side_by_side(ours_clip, ref_clip, p2)
    if len(d2):
        d2.to_csv(os.path.join(out_dir, "parity_type_deltas.csv"),
                  index=False)
        report["artifacts"] += [p2, "parity_type_deltas.csv"]

    p3 = os.path.join(out_dir, "parity_fig3_sweep_deltas.png")
    report["stats"]["sweep"] = plot_sweep_deltas_overlay(ours_clip,
                                                         ref_clip, p3)
    report["artifacts"].append(p3)

    merged, rstats = recovery_side_by_side(ours_clip, ref_clip)
    if len(merged):
        merged.to_csv(os.path.join(out_dir, "parity_recovery.csv"),
                      index=False)
        report["artifacts"].append("parity_recovery.csv")
    report["stats"]["recovery"] = rstats

    # ViT trajectory overlay when both enriched CSVs exist
    ours_rsa = ref_rsa = None
    if ours_vit:
        for nm in ("rsa_results_final.csv", "rsa_results.csv"):
            p = os.path.join(ours_vit, nm)
            if os.path.exists(p):
                ours_rsa = p
                break
    if ref_vit:
        p = os.path.join(ref_vit, "rsa_results_final.csv")
        ref_rsa = p if os.path.exists(p) else None
    if ours_rsa or ref_rsa:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 3.6))
        for label, p, color in (("ours", ours_rsa, C_OURS),
                                ("reference", ref_rsa, C_REF)):
            if not p:
                continue
            df = figs.vit_trajectory(p)
            ax1.plot(df["epoch"], df["val_loss"], color=color,
                     linewidth=1.6, label=label)
            ax2.plot(df["epoch"], df["rsa_score"], color=color,
                     linewidth=1.6, label=label)
            report["stats"][f"vit_{label}_peak_rsa"] = float(
                df["rsa_score"].max())
        _axstyle(ax1, "ViT val loss", "epoch", "val loss")
        _axstyle(ax2, "ViT THINGS-48 RSA", "epoch", "Spearman rho")
        for ax in (ax1, ax2):
            ax.legend(fontsize=8, frameon=False)
        p4 = os.path.join(out_dir, "parity_vit_trajectory.png")
        fig.tight_layout()
        fig.savefig(p4, dpi=140)
        plt.close(fig)
        report["artifacts"].append(p4)

    n_fail = sum(1 for checks in report["checks"].values()
                 for c in checks if not c["ok"])
    report["n_failed_checks"] = n_fail
    with open(os.path.join(out_dir, "parity_report.json"), "w") as f:
        json.dump(report, f, indent=2)

    # human summary
    lines = [f"# Parity report ({regime} regime)", ""]
    for tree, checks in report["checks"].items():
        lines.append(f"## {tree}")
        for c in checks:
            lines.append(f"- [{'x' if c['ok'] else ' '}] {c['check']}: "
                         f"{c['detail']}")
        lines.append("")
    lines.append("## stats")
    lines.append("```json")
    lines.append(json.dumps(report["stats"], indent=2))
    lines.append("```")
    with open(os.path.join(out_dir, "PARITY_REPORT.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return report


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ours", default=None,
                    help="our clip_results tree (e.g. "
                         "results/paradigm_r5/clip_results)")
    ap.add_argument("--reference", default=None,
                    help="the reference Data/ dir (clip_results/vit_results "
                         "subdirs) or a clip_results tree directly")
    ap.add_argument("--ours_vit", default=None,
                    help="our vit results dir (rsa_results.csv + "
                         "perturbation_effects.csv)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--regime", default="synthetic",
                    choices=["synthetic", "pretrained"],
                    help="data regime our tree was produced in; numeric "
                         "agreement only matters under 'pretrained'")
    args = ap.parse_args(argv)
    ref_clip = ref_vit = None
    if args.reference:
        r = args.reference
        ref_clip = os.path.join(r, "clip_results") \
            if os.path.isdir(os.path.join(r, "clip_results")) else r
        rv = os.path.join(r, "vit_results")
        ref_vit = rv if os.path.isdir(rv) else None
    rep = build_report(args.ours, ref_clip, args.out,
                       ours_vit=args.ours_vit, ref_vit=ref_vit,
                       regime=args.regime)
    print(f"parity report -> {args.out} "
          f"({rep['n_failed_checks']} failed checks)")
    return rep


if __name__ == "__main__":
    main()
