"""The port's copies of the analysis tools (``analysis/figs.py``,
``parity.py``, ``manifest.py``) against the JAX package's on the committed
result mirrors: ``results/paradigm_r5/`` (a CLIP clip_results tree),
``results/vit_grid_r4/`` (a ViT grid) and ``results/parity_r5/``. The
port-produced trees are held in tests/test_torch_paradigm.py (CLIP) and
tests/test_torch_vit_grid.py (ViT). Equal results are required: the tools
read the same CSVs with the same pandas code."""
import json
import os

import pandas as pd
import pytest

from vit_project_tpu.analysis import figs as jfigs
from vit_project_tpu.analysis import manifest as jmanifest
from vit_project_tpu.analysis import parity as jparity
from vit_project_torch.analysis import figs as tfigs
from vit_project_torch.analysis import manifest as tmanifest
from vit_project_torch.analysis import parity as tparity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP = os.path.join(REPO, "results", "paradigm_r5", "clip_results")
VIT = os.path.join(REPO, "results", "vit_grid_r4")
PARITY = os.path.join(REPO, "results", "parity_r5")
BASELINE = os.path.join(CLIP, jparity.BASELINE_NAME)
SWEEP = os.path.join(CLIP, jparity.SWEEP_DIRNAME)
LENGTHS = os.path.join(CLIP, jparity.LENGTHS_DIRNAME)
TYPE_DIRS = {t: os.path.join(CLIP, t) for t in jparity.FIG2_TYPES}


def _equal(got, want):
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want)
    else:
        assert got == want


FIGS_CALLS = {
    "clip_trajectory": (BASELINE,),
    "clip_trajectory_untrimmed": (BASELINE, False),
    "vit_trajectory": (os.path.join(VIT, "rsa_results.csv"),),
    "vit_type_deltas": (os.path.join(VIT, "perturbation_effects.csv"),),
    "list_sweep_runs": (SWEEP,),
    "list_length_runs": (LENGTHS,),
    "sweep_deltas": (BASELINE, SWEEP),
    "perturbation_type_deltas": (BASELINE, TYPE_DIRS, jparity.FIG2_EPOCHS),
    "recovery_table": (BASELINE, LENGTHS),
    "compute_deltas": (BASELINE, jfigs.sweep_run_csv(SWEEP, 15), 15),
}


@pytest.mark.parametrize("call", sorted(FIGS_CALLS))
def test_figs_match_jax_on_the_mirrors(call):
    name = call.replace("_untrimmed", "")
    args = FIGS_CALLS[call]
    want = getattr(jfigs, name)(*args)
    assert len(want) > 0
    _equal(getattr(tfigs, name)(*args), want)


@pytest.mark.parametrize("fig", ["fig1", "fig2", "fig3", "fig4"])
def test_figs_cli_writes_each_figure(fig, tmp_path):
    argv = {"fig1": ["--clip_csv", BASELINE, "--vit_csv",
                     os.path.join(VIT, "rsa_results.csv")],
            "fig2": ["--baseline_csv", BASELINE, "--type_dirs",
                     *[f"{t}={d}" for t, d in TYPE_DIRS.items()],
                     "--vit_effects_csv",
                     os.path.join(VIT, "perturbation_effects.csv")],
            "fig3": ["--baseline_csv", BASELINE, "--sweep_dir", SWEEP],
            "fig4": ["--baseline_csv", BASELINE, "--base_dir", LENGTHS]}[fig]
    out = tmp_path / f"{fig}.png"
    tfigs.main([fig, *argv, "--out", str(out)])
    assert out.stat().st_size > 0


def _relative(rep, out):
    """A report with its artifacts' paths made relative to `out`."""
    rep["artifacts"] = [os.path.relpath(a, out) if os.path.isabs(a) else a
                        for a in rep["artifacts"]]
    return rep


def _report(mod, out, **kw):
    return _relative(mod.build_report(out_dir=str(out), **kw), out)


def test_parity_report_matches_jax_on_the_mirrors(tmp_path):
    """The CLIP and ViT mirrors as 'ours': the same report dict, the same
    JSON (up to the output directory in the artifacts' paths), markdown and
    CSV files (the figures are only checked to exist)."""
    assert tparity.figs is tfigs
    kw = dict(ours_clip=CLIP, ref_clip=None, ours_vit=VIT)
    want = _report(jparity, tmp_path / "jax", **kw)
    got = _report(tparity, tmp_path / "port", **kw)
    assert got == want
    assert want["checks"]["clip_ours"] and want["checks"]["vit_ours"]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        a, b = (tmp_path / k / name for k in ("port", "jax"))
        if name.endswith(".png"):
            assert a.stat().st_size > 0
        elif name == "parity_report.json":
            assert _relative(json.loads(a.read_text()), tmp_path / "port") \
                == _relative(json.loads(b.read_text()), tmp_path / "jax")
        else:
            assert a.read_bytes() == b.read_bytes(), name


@pytest.mark.parametrize("which", ["clip", "vit"])
def test_parity_inventories_match_jax(which):
    fn, root = (("clip_inventory", CLIP) if which == "clip"
                else ("vit_inventory", VIT))
    want = getattr(jparity, fn)(root)
    assert want
    assert getattr(tparity, fn)(root) == want


def test_parity_report_of_the_committed_run_reproduces(tmp_path):
    """results/parity_r5's report, whose 'ours' half is the committed CLIP
    mirror: the port's report on that mirror has the same checks and stats
    for that half."""
    with open(os.path.join(PARITY, "parity_report.json")) as f:
        committed = json.load(f)
    got = _report(tparity, tmp_path, ours_clip=CLIP, ref_clip=None)
    assert got["checks"]["clip_ours"] == committed["checks"]["clip_ours"]
    for key, value in got["stats"]["trajectory"].items():
        if key.startswith("ours"):
            assert value == pytest.approx(
                committed["stats"]["trajectory"][key], rel=1e-12), key


def test_manifest_matches_jax_on_the_mirrors(tmp_path):
    trees = {"sweep": SWEEP, "lengths": LENGTHS, "vit": VIT,
             "parity": PARITY, "types": os.path.join(CLIP, "label_shuffle")}
    want = jmanifest.tree_manifest(trees, str(tmp_path / "j.json"))
    got = tmanifest.tree_manifest(trees, str(tmp_path / "t.json"))
    assert got == want
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert want["trees"]["sweep"]["n_runs"] >= 97
