"""The port's sweep and lengths CLIs, host side: the training orders against
the JAX package's, the parser's propagation to workers, the done and failed
ledgers, failure aggregation across worker processes, the lengths
directory scan and checkpoint anchor, and the refusals (no GPU without
--device cpu; the fork axis over several devices). Mirrors the host-only cases of the JAX
package's sweep tests."""
import json
import os
import subprocess

import pytest
import torch

from vit_project_tpu.cli import lengths as jlengths
from vit_project_tpu.cli import sweep as jsweep
from vit_project_torch.cli import lengths as tlengths
from vit_project_torch.cli import sweep as tsweep

REQUIRED = ["--csv_file", "c", "--img_dir", "i", "--inference_csv_file", "v",
            "--RDM48_triplet_dir", "r", "--baseline_dora_directory", "d",
            "--baseline_random_state_path", "s",
            "--baseline_split_indices_path", "x"]


class _Log:
    def info(self, msg):
        pass


# -- orders -------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["midpoint", "hybrid", "sweep", "range:3-9",
                                  "7,9,11", "5"])
def test_orders_match_jax(spec):
    assert tsweep.parse_order(spec) == jsweep.parse_order(spec)


def test_order_generators():
    order = tsweep.generate_midpoint_order(1, 98)
    assert order[:3] == [1, 98, 49] and sorted(order) == list(range(1, 99))
    assert tsweep.generate_midpoint_order(5, 5) == [5]
    assert tsweep.generate_midpoint_order(6, 5) == []
    h = tsweep.generate_hybrid_training_order()
    assert h[:15] == list(range(1, 16)) and set(h) == set(range(1, 99))
    s = tsweep.generate_sweep_training_order()
    assert s[:40] == list(range(1, 41)) and s[40:43] == [41, 44, 47]


# -- the parser and the worker argv -------------------------------------------

def test_every_parser_option_propagates():
    """_worker_argv comes from the parser's actions: every option but the
    dispatcher's own reaches a worker with its value."""
    parser = tsweep.build_parser()
    args = parser.parse_args(REQUIRED + [
        "--output_base_directory", "o", "--remat", "--frozen_cache",
        "--perturb_seed", "123", "--device", "cpu", "--no-host_prefetch",
        "--compute_dtype", "float32", "--perturb_distribution", "normal"])
    reparsed = parser.parse_args(tsweep._worker_argv(args)
                                 + ["--training_order", "1"])
    for action in parser._actions:
        if action.dest == "help" or action.dest in tsweep._DISPATCH_ONLY:
            continue
        assert getattr(reparsed, action.dest) == getattr(args, action.dest), \
            action.dest


def test_dispatch_only_flags_are_not_forwarded():
    args = tsweep.build_parser().parse_args(REQUIRED + [
        "--output_base_directory", "o", "--workers", "4",
        "--worker_device_env", "none"])
    argv = tsweep._worker_argv(args)
    for flag in ("--workers", "--fork_devices", "--training_order",
                 "--worker_device_env"):
        assert flag not in argv


def test_parsers_take_the_jax_flags():
    """Every flag of the JAX CLIs exists in the port's (plus --device), with
    the same defaults except the device pinning variable."""
    for jp, tp in ((jsweep.build_parser(), tsweep.build_parser()),
                   (jlengths.build_parser(), tlengths.build_parser())):
        tdefaults = {a.dest: a.default for a in tp._actions}
        for a in jp._actions:
            assert a.dest in tdefaults, a.dest
            if a.dest != "worker_device_env":
                assert tdefaults[a.dest] == a.default, a.dest
        assert tdefaults["device"] == "cuda"
    assert tsweep.build_parser().get_default("worker_device_env") == \
        "CUDA_VISIBLE_DEVICES"


# -- ledgers ------------------------------------------------------------------

def test_report_done_accumulates_atomically(tmp_path, monkeypatch):
    ledger = tmp_path / "done.json"
    monkeypatch.setenv("VIT_SWEEP_DONE_JSON", str(ledger))
    tsweep._report_done([5])
    tsweep._report_done([2, 5])
    assert json.loads(ledger.read_text()) == [2, 5]
    ledger.write_text("[2,")   # torn by a pre-atomic writer: starts over
    tsweep._report_done([7])
    assert json.loads(ledger.read_text()) == [7]
    assert os.listdir(tmp_path) == ["done.json"]


def test_reports_are_noops_without_env(tmp_path, monkeypatch):
    monkeypatch.delenv("VIT_SWEEP_DONE_JSON", raising=False)
    monkeypatch.delenv("VIT_SWEEP_FAILED_JSON", raising=False)
    monkeypatch.chdir(tmp_path)
    tsweep._report_done([1])
    tsweep._report_failed([1])
    assert os.listdir(tmp_path) == []


def test_report_failed_writes_atomically(tmp_path, monkeypatch):
    report = tmp_path / "failed.json"
    monkeypatch.setenv("VIT_SWEEP_FAILED_JSON", str(report))
    tsweep._report_failed([5, 2])
    assert json.loads(report.read_text()) == [5, 2]
    assert os.listdir(tmp_path) == ["failed.json"]


# -- worker dispatch accounting ------------------------------------------------

def _args(out_base, workers=1):
    return tsweep.build_parser().parse_args(REQUIRED + [
        "--output_base_directory", out_base, "--workers", str(workers),
        "--worker_device_env", "none"])


def _fake_popen(monkeypatch, rc, side_effect=None, seen=None):
    class FakeProc:
        def __init__(self, cmd, env=None, stdout=None, stderr=None):
            self.env = env
            if seen is not None:
                seen.append((cmd, env))

        def wait(self):
            if side_effect is not None:
                side_effect(self.env)
            return rc
    monkeypatch.setattr(subprocess, "Popen", FakeProc)


def test_stale_reports_do_not_mask_a_crash(tmp_path, monkeypatch):
    """A previous dispatch's "all ok" report and a partial CSV of the run in
    flight: a worker killed without reporting fails all its runs."""
    out = str(tmp_path)
    (tmp_path / "worker0_failed.json").write_text("[]")
    (tmp_path / "worker0_done.json").write_text("[2, 5]")
    os.makedirs(tmp_path / "training_run5")
    (tmp_path / "training_run5" / "training_res_run5.csv").write_text(
        "epoch,train_loss\n5,0.1\n")
    _fake_popen(monkeypatch, rc=137)
    assert tsweep._run_workers(_args(out), [2, 5], _Log()) == [2, 5]


def test_crash_fallback_spares_ledgered_runs(tmp_path, monkeypatch):
    def record_then_die(env):
        with open(env["VIT_SWEEP_DONE_JSON"], "w") as f:
            f.write("[2]")
    _fake_popen(monkeypatch, rc=137, side_effect=record_then_die)
    assert tsweep._run_workers(_args(str(tmp_path)), [2, 5], _Log()) == [5]


def test_corrupt_report_reconstructs_from_ledger(tmp_path, monkeypatch):
    def torn_report(env):
        with open(env["VIT_SWEEP_FAILED_JSON"], "w") as f:
            f.write("[2,")
        with open(env["VIT_SWEEP_DONE_JSON"], "w") as f:
            f.write("[2]")
    _fake_popen(monkeypatch, rc=0, side_effect=torn_report)
    assert tsweep._run_workers(_args(str(tmp_path)), [2, 5], _Log()) == [5]


def test_workers_get_round_robin_slices_and_pinning(tmp_path, monkeypatch):
    """Worker i runs order[i::N] through `python -m
    vit_project_torch.cli.sweep`, pinned by CUDA_VISIBLE_DEVICES=i; each
    reports; the failures are the union of the reports."""
    seen = []

    def report(env):
        failed = [5] if env["CUDA_VISIBLE_DEVICES"] == "1" else []
        with open(env["VIT_SWEEP_FAILED_JSON"], "w") as f:
            json.dump(failed, f)
    _fake_popen(monkeypatch, rc=0, side_effect=report, seen=seen)
    args = tsweep.build_parser().parse_args(REQUIRED + [
        "--output_base_directory", str(tmp_path), "--workers", "2"])
    assert tsweep._run_workers(args, [2, 5, 9], _Log()) == [5]
    (cmd0, env0), (cmd1, env1) = seen
    assert cmd0[1:3] == ["-m", "vit_project_torch.cli.sweep"]
    assert cmd0[-2:] == ["--training_order", "2,9"]
    assert cmd1[-2:] == ["--training_order", "5"]
    assert (env0["CUDA_VISIBLE_DEVICES"], env1["CUDA_VISIBLE_DEVICES"]) == \
        ("0", "1")


def test_dispatched_worker_log_name_is_pid_unique(tmp_path, monkeypatch):
    """A dispatched worker (VIT_SWEEP_FAILED_JSON set) suffixes its main log
    with its pid, so workers starting in the same second do not truncate
    one another's log."""
    monkeypatch.setenv("VIT_SWEEP_FAILED_JSON", str(tmp_path / "f.json"))
    seen = []

    class _Bail(Exception):
        pass

    def fake_logger(path):
        seen.append(os.path.basename(path))
        raise _Bail
    monkeypatch.setattr(tsweep, "setup_main_logger", fake_logger)
    with pytest.raises(_Bail):
        tsweep.main(REQUIRED + ["--output_base_directory", str(tmp_path),
                                "--device", "cpu"])
    assert seen[0].endswith(f"_p{os.getpid()}.txt")


def test_failed_run_is_isolated_and_reported(tmp_path, monkeypatch):
    """In process: a run whose directory cannot be made fails alone; the
    others train; the failed report and done ledger say which."""
    monkeypatch.setenv("VIT_SWEEP_FAILED_JSON", str(tmp_path / "f.json"))
    monkeypatch.setenv("VIT_SWEEP_DONE_JSON", str(tmp_path / "d.json"))
    out = tmp_path / "out"
    os.makedirs(out)
    (out / "training_run9").write_text("not a directory")
    trained = []

    def fake_run(config, device=None):
        trained.append((config["training_run"], config["resume_from_epoch"],
                        str(device)))
        return {"preempted": False}
    monkeypatch.setattr(tsweep, "run_behavioral_training", fake_run)
    failed = tsweep.main(REQUIRED + ["--output_base_directory", str(out),
                                     "--device", "cpu",
                                     "--training_order", "2,9,4,2"])
    assert failed == [9]
    assert trained == [(2, 1, "cpu"), (4, 3, "cpu")]
    assert json.loads((tmp_path / "f.json").read_text()) == [9]
    assert json.loads((tmp_path / "d.json").read_text()) == [2, 4]


def test_preempted_run_exits_143(tmp_path, monkeypatch):
    monkeypatch.setattr(tsweep, "run_behavioral_training",
                        lambda config, device=None: {"preempted": True})
    with pytest.raises(SystemExit) as e:
        tsweep.main(REQUIRED + ["--output_base_directory", str(tmp_path),
                                "--device", "cpu", "--training_order", "3"])
    assert e.value.code == 143


# -- refusals -----------------------------------------------------------------

@pytest.mark.parametrize("flag", [["--fork_devices", "2"]])
def test_sweep_refuses_batched_forks_before_writing(tmp_path, monkeypatch,
                                                    flag):
    """The fork axis over several cards (two left after the clamp on a
    host with four) waits for a later slice; one card runs as without the
    flag (tests/test_torch_clip_parallel.py)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    out = tmp_path / "out"
    with pytest.raises(NotImplementedError, match="several cards"):
        tsweep.main(REQUIRED + ["--output_base_directory", str(out),
                                "--device", "cpu", "--batched_forks", "2",
                                *flag])
    assert not out.exists()


def test_lengths_refuses_fork_devices_before_writing(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    out = tmp_path / "out"
    with pytest.raises(NotImplementedError, match="several cards"):
        tlengths.main(["--perturb_type", "random_target", "--perturb_length",
                       "2", "--onsets", "3,8", "--fork_devices", "2",
                       "--device", "cpu", "--baseline_dora_directory", "d",
                       "--baseline_random_state_path", "s",
                       "--baseline_split_indices_path", "x",
                       "--output_base_directory", str(out)])
    assert not out.exists()


@pytest.mark.parametrize("cli", ["sweep", "lengths"])
def test_clis_need_a_gpu_unless_told_otherwise(tmp_path, monkeypatch, cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if cli == "sweep":
            tsweep.main(REQUIRED + ["--output_base_directory", str(out)])
        else:
            tlengths.main(["--perturb_epoch", "2", "--perturb_length", "1",
                           "--output_dir", "random_target_e2_l1",
                           "--baseline_dora_directory", "d",
                           "--baseline_random_state_path", "s",
                           "--baseline_split_indices_path", "x",
                           "--output_base_directory", str(out)])
    assert not out.exists()


# -- the lengths directory scan and anchor ------------------------------------

def _anchor(base, name, onset, length):
    epoch1 = max(0, onset - 1) + length
    for sub, f in ((f"dora_params_{onset}", f"epoch{epoch1}_dora_params.pth"),
                   (f"random_states_{onset}",
                    f"epoch{epoch1}_random_states.pth")):
        os.makedirs(base / name / sub, exist_ok=True)
        (base / name / sub / f).touch()


@pytest.mark.parametrize("kind,onset,length", [
    ("random_target", 2, 5), ("random_target", 2, 1), ("image_noise", 2, 5),
    ("label_shuffle", 2, 3), ("baseline", 2, 5), ("random_target", 3, 9)])
def test_previous_run_scan_matches_jax(tmp_path, kind, onset, length):
    """The longest anchored shorter sibling at the onset, torn siblings and
    files skipped: the port's choice equals JAX's on one tree."""
    for name, o, ln in (("random_target_e2_l1", 2, 1),
                        ("random_target_e2_l3", 2, 3),
                        ("random_target_e3_l2", 3, 2),
                        ("label_shuffle_e2_l2", 2, 2)):
        _anchor(tmp_path, name, o, ln)
    os.makedirs(tmp_path / "random_target_e2_l4")       # torn: no files
    (tmp_path / "random_target_e2_l2").touch()          # a file, not a dir
    os.makedirs(tmp_path / "junk")
    got = tlengths.find_previous_run_dir(str(tmp_path), kind, onset, length)
    assert got == jlengths.find_previous_run_dir(str(tmp_path), kind, onset,
                                                 length)
    assert tlengths.find_previous_run_dir(str(tmp_path / "none"), kind, onset,
                                          length) == (None, None)


def test_rollback_to_checkpoint_matches_jax(tmp_path):
    d, rs = tmp_path / "dora", tmp_path / "rs"
    os.makedirs(d)
    os.makedirs(rs)
    for e in (2, 3):
        (d / f"epoch{e}_dora_params.pth").touch()
    (rs / "epoch2_random_states.pth").touch()
    for last, rs_dir in ((2, None), (4, None), (-1, None), (2, str(rs)),
                         (4, str(rs))):
        assert tlengths.rollback_to_checkpoint(str(d), last, rs_dir) == \
            jlengths.rollback_to_checkpoint(str(d), last, rs_dir)
    assert tlengths.rollback_to_checkpoint(str(d), 2) == 3
    assert tlengths.rollback_to_checkpoint(str(d), 2, str(rs)) == 2
    assert tlengths.rollback_to_checkpoint(str(tmp_path / "x"), 4) == 0
