"""Single-epoch perturbation sweep (counterpart of the JAX package's
cli/sweep.py, with the same flags plus --device).

Reference: Training/clip_behavioral_finetuning/uniform_sweep/clip_train_behavior_sweep.py.
For each epoch N in the training order: fork from the baseline's epoch N-1
checkpoints, perturb exactly epoch N, train to early stopping, write results
under `training_run{N}/`, continuing on a per-run failure with a tally (the
reference's 64-hour 98-run sweep survived run 56 failing this way). Exits 1
when a run failed and 143 when a SIGTERM stopped a run at an epoch boundary
(re-invoke to resume).

  python -m vit_project_torch.cli.sweep --csv_file spose_train.csv \\
      --img_dir things/ --inference_csv_file spose_val.csv \\
      --RDM48_triplet_dir RDM48_triplet.mat --clip_weights ViT-L-14.pt \\
      --baseline_dora_directory runs/baseline/dora_params_T \\
      --baseline_random_state_path runs/baseline/random_states_T \\
      --baseline_split_indices_path \\
          runs/baseline/random_states_T/dataset_split_indices.pth \\
      --output_base_directory runs/sweep --frozen_cache

`--workers N` runs N single-GPU worker processes over round-robin slices of
the order, each pinned to one card through `--worker_device_env`.
`--batched_forks R` trains the forks in lock-step groups of R on one card
(train/multi_fork.py): one setup for every group, one step on R*64 rows.
`--fork_devices N` is clamped to this host's cards and the group (JAX's
make_fork_mesh): on one card the groups run as without it; the fork axis
over several cards is not ported and raises.

Under torchrun (one rank per GPU; `--device cpu` takes gloo) each run
trains data-parallel over the ranks, and `--batched_forks` runs every group
on every rank; rank 0 writes the files and the reports. `--workers` then
raises: a worker would inherit the launcher's RANK and WORLD_SIZE.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from datetime import datetime

from ..core.device import resolve_device
from ..core.logs import setup_main_logger
from ..core.preempt import PreemptionGuard, exit_if_undispatched
from ..parallel import dist
from ..train.clip_loop import run_behavioral_training


def generate_midpoint_order(start: int = 1, end: int = 98) -> list[int]:
    """Progressive midpoint refinement: the endpoints first, then generation by
    generation each open interval contributes its midpoint and splits in two
    (matches the sequence of reference :8-52): early sweep results cover the
    whole epoch range coarsely, later runs fill in the detail."""
    if start > end:
        return []
    order = [start] if start == end else [start, end]
    generation = [(start, end)]
    while generation:
        offspring = []
        for lo, hi in generation:
            pivot = (lo + hi) // 2
            if lo < pivot < hi:
                order.append(pivot)
            offspring += [iv for iv in ((lo, pivot), (pivot, hi))
                          if iv[1] - iv[0] > 1]
        generation = offspring
    return order


def generate_hybrid_training_order() -> list[int]:
    """Epochs 1-15 sequentially, then midpoint order over [16, 98]
    (reference :55-68)."""
    return list(range(1, 16)) + generate_midpoint_order(16, 98)


def generate_sweep_training_order() -> list[int]:
    """Epochs 1-40 sequentially, then every 3 epochs (reference :71-78)."""
    return list(range(1, 41)) + list(range(41, 103, 3))


def parse_order(spec: str) -> list[int]:
    if spec == "midpoint":
        return generate_midpoint_order()
    if spec == "hybrid":
        return generate_hybrid_training_order()
    if spec == "sweep":
        return generate_sweep_training_order()
    if spec.startswith("range:"):
        a, b = spec[len("range:"):].split("-")
        return list(range(int(a), int(b) + 1))
    return [int(x) for x in spec.split(",") if x.strip()]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="CLIP-HBA single-epoch "
                                            "perturbation sweep "
                                            "(PyTorch / CUDA)")
    p.add_argument("--csv_file", required=True)
    p.add_argument("--img_dir", required=True)
    p.add_argument("--inference_csv_file", required=True)
    p.add_argument("--RDM48_triplet_dir", required=True)
    p.add_argument("--backbone", default="ViT-L/14")
    p.add_argument("--clip_weights", default=None)
    p.add_argument("--bpe_vocab", default=None)
    p.add_argument("--allow_hash_tokenizer", action="store_true",
                   help="permit pretrained weights without a BPE vocab "
                        "(RSA will be scientifically void; testing only)")
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--early_stopping_patience", type=int, default=20)
    p.add_argument("--random_seed", type=int, default=1)
    p.add_argument("--vision_layers", type=int, default=2)
    p.add_argument("--transformer_layers", type=int, default=1)
    p.add_argument("--rank", type=int, default=32)
    p.add_argument("--perturb_type", default="random_target",
                   choices=["random_target", "label_shuffle", "uniform_images",
                            "image_noise"])
    p.add_argument("--perturb_length", type=int, default=1)
    p.add_argument("--perturb_distribution", default="target",
                   choices=["normal", "target"])
    p.add_argument("--perturb_seed", type=int, default=42)
    p.add_argument("--baseline_dora_directory", required=True)
    p.add_argument("--baseline_random_state_path", required=True)
    p.add_argument("--baseline_split_indices_path", required=True)
    p.add_argument("--output_base_directory", required=True)
    p.add_argument("--training_order", default="midpoint",
                   help="midpoint | hybrid | sweep | range:A-B | "
                        "comma-separated epochs")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda",
                   help="torch device to train on ('cpu' for tests)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block in the backward "
                        "(torch.utils.checkpoint)")
    p.add_argument("--host_prefetch", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="copy the per-epoch checkpoint trees to the host "
                        "asynchronously, beside the eval and RSA work "
                        "(core/hostcopy.py); --no-host_prefetch copies "
                        "them synchronously before the write")
    p.add_argument("--frozen_cache", action="store_true",
                   help="cache the frozen tower prefixes once per run and "
                        "train only the adapted suffix blocks (costs "
                        "[N, S, width] of device memory in the compute dtype)")
    p.add_argument("--workers", type=int, default=1,
                   help="run N fork workers concurrently, each pinned to one "
                        "GPU of the host (the sweep's runs are independent: "
                        "each forks from the baseline artifacts). "
                        "1 = in-process.")
    p.add_argument("--worker_device_env", default="CUDA_VISIBLE_DEVICES",
                   help="env var used to pin each worker to its GPU "
                        "(worker i gets '<i>'); set to 'none' to skip "
                        "pinning (CPU tests)")
    p.add_argument("--batched_forks", type=int, default=1,
                   help="train the forks in lock-step groups of N on one "
                        "GPU, the fork axis folded into the batch "
                        "(train/multi_fork.py); 1 = one fork at a time")
    p.add_argument("--fork_devices", type=int, default=1,
                   help="shard the batched fork axis over N devices, "
                        "clamped to this host's cards and the group; more "
                        "than one after the clamp is not ported yet")
    return p


# options the dispatcher itself consumes; everything else propagates to the
# workers verbatim (the dispatcher overrides --workers/--training_order)
_DISPATCH_ONLY = frozenset(
    {"workers", "worker_device_env", "training_order", "fork_devices"})


def _worker_argv(args) -> list[str]:
    """Re-serialize the parsed namespace into CLI args for a worker process.

    Derived from the parser's registered actions (not a hand-kept list), so
    a flag added to build_parser reaches the workers instead of silently
    falling back to its default in them."""
    out: list[str] = []
    for action in build_parser()._actions:
        dest = action.dest
        if dest == "help" or dest in _DISPATCH_ONLY \
                or not action.option_strings:
            continue
        v = getattr(args, dest, None)
        opt = action.option_strings[0]
        if isinstance(v, bool):
            if v:
                out.append(opt)
            else:
                # a default-True BooleanOptionalAction turned off must be
                # propagated explicitly or the worker re-parses the default
                neg = [s for s in action.option_strings
                       if s.startswith("--no-")]
                if neg:
                    out.append(neg[0])
        elif v is not None:
            out += [opt, str(v)]
    return out


def _write_json_atomically(path: str, value) -> None:
    """tmp + os.replace: a worker killed mid-write leaves the old file or
    the new one, never truncated JSON. Rank 0 alone writes it."""
    if not dist.is_primary():
        return
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(value, f)
    os.replace(tmp, path)


def _report_done(runs: list[int]) -> None:
    """Add completed run numbers to the dispatcher's done ledger
    (VIT_SWEEP_DONE_JSON), so a parent _run_workers can tell finished runs
    from in-flight ones even after this worker is hard-killed and never
    writes its failed report."""
    path = os.environ.get("VIT_SWEEP_DONE_JSON")
    if not path or not runs:
        return
    done: list[int] = []
    if os.path.exists(path):
        try:
            with open(path) as f:
                done = json.load(f)
        except ValueError:
            done = []
    _write_json_atomically(path, sorted(set(done) | set(runs)))


def _report_failed(failed: list[int]) -> None:
    """Write the per-run outcome for a parent worker dispatcher
    (VIT_SWEEP_FAILED_JSON), if one asked for it."""
    report = os.environ.get("VIT_SWEEP_FAILED_JSON")
    if report:
        _write_json_atomically(report, failed)


def _run_workers(args, training_order: list[int], logger) -> list[int]:
    """Spawn N single-GPU sweep subprocesses over round-robin slices of the
    training order (slice i = order[i::N], keeping each worker's
    coarse-to-fine coverage). The runs are independent: each forks from the
    baseline artifacts. Returns the union of failed runs.

    Failure accounting: a worker that exits normally reports through its
    failed.json; one that dies without reporting (OOM kill) is reconstructed
    from its done ledger: every slice run not recorded done failed. A
    partial CSV is not taken as completion (the run in progress at the
    crash has one), and completed runs are never re-queued."""
    procs = []
    for i in range(args.workers):
        part = training_order[i::args.workers]
        if not part:
            continue
        fj = os.path.join(args.output_base_directory,
                          f"worker{i}_failed.json")
        dj = os.path.join(args.output_base_directory,
                          f"worker{i}_done.json")
        for stale in (fj, dj):  # a previous dispatch's report must not mask
            if os.path.exists(stale):  # this one's crash (stale [] = "all ok")
                os.remove(stale)
        cmd = [sys.executable, "-m", "vit_project_torch.cli.sweep",
               *_worker_argv(args), "--workers", "1",
               "--training_order", ",".join(map(str, part))]
        env = dict(os.environ)
        env["VIT_SWEEP_FAILED_JSON"] = fj
        env["VIT_SWEEP_DONE_JSON"] = dj
        if args.worker_device_env.lower() != "none":
            env[args.worker_device_env] = str(i)
        log_path = os.path.join(args.output_base_directory, f"worker{i}.log")
        logger.info(f"worker {i}: runs {part} -> {log_path}")
        log = open(log_path, "w")
        procs.append((i, part, fj, dj, log,
                      subprocess.Popen(cmd, env=env, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed: set[int] = set()
    for i, part, fj, dj, log, p in procs:
        rc = p.wait()
        log.close()
        reported, corrupt = None, False
        if os.path.exists(fj):
            try:
                with open(fj) as f:
                    reported = json.load(f)
            except ValueError:
                corrupt = True
                logger.info(f"worker {i}: corrupt failure report {fj}; "
                            f"reconstructing from the done ledger")
        if reported is not None:
            failed.update(reported)
        elif rc != 0 or corrupt:
            # died before reporting: everything its done ledger does not
            # vouch for failed (the run in flight included)
            done: set[int] = set()
            if os.path.exists(dj):
                with open(dj) as f:
                    done = set(json.load(f))
            failed.update(set(part) - done)
        logger.info(f"worker {i} exited rc={rc}")
    return sorted(failed)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.workers > 1 and dist.launched():
        raise ValueError(
            f"--workers {args.workers} under torchrun: each dispatched worker "
            f"would inherit RANK / WORLD_SIZE and join the launcher's group "
            f"as a rank; launch the sweep once, without torchrun, to "
            f"dispatch workers")
    device = resolve_device(dist.local_device(args.device))
    if args.workers > 1:
        return _dispatch(args)
    with dist.process_group(device):
        return _run(args, device)


def _logger(args, timestamp: str):
    # dispatched workers share the dispatcher's output dir and start within
    # the same second: a pid suffix keeps them from truncating one another's
    # (or the dispatcher's) main log
    suffix = f"_p{os.getpid()}" if os.environ.get(
        "VIT_SWEEP_FAILED_JSON") else ""
    return setup_main_logger(os.path.join(
        args.output_base_directory,
        f"main_training_log_{timestamp}{suffix}.txt"))


def _dispatch(args) -> list[int]:
    """--workers N: the runs over N worker processes (pure host work)."""
    logger = _logger(args, datetime.now().strftime("%Y%m%d_%H%M%S"))
    # stable dedup before any dispatch: duplicate run numbers share one
    # artifact dir
    training_order = list(dict.fromkeys(parse_order(args.training_order)))
    logger.info(f"Dispatching {len(training_order)} runs across "
                f"{args.workers} single-GPU workers")
    failed_run_list = _run_workers(args, training_order, logger)
    logger.info(f"All workers done. Failed runs: {failed_run_list}")
    _report_failed(failed_run_list)
    return failed_run_list


def _run(args, device) -> list[int]:
    """The runs in this process (and its torchrun ranks): sequentially, or
    in batched fork groups."""
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    logger = _logger(args, timestamp)
    # stable dedup: duplicate run numbers share one artifact dir
    training_order = list(dict.fromkeys(parse_order(args.training_order)))

    config = {
        "csv_file": args.csv_file,
        "img_dir": args.img_dir,
        "inference_csv_file": args.inference_csv_file,
        "RDM48_triplet_dir": args.RDM48_triplet_dir,
        "backbone": args.backbone,
        "clip_weights": args.clip_weights,
        "bpe_vocab": args.bpe_vocab,
        "allow_hash_tokenizer": args.allow_hash_tokenizer,
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "train_portion": 0.8,
        "lr": args.lr,
        "logger": None,
        "early_stopping_patience": args.early_stopping_patience,
        "random_seed": args.random_seed,
        "vision_layers": args.vision_layers,
        "transformer_layers": args.transformer_layers,
        "rank": args.rank,
        "criterion": "mse",
        "cuda": 0,
        "compute_dtype": args.compute_dtype,
        "remat": args.remat,
        "host_prefetch": args.host_prefetch,
        "frozen_cache": args.frozen_cache,
        "baseline_dora_directory": args.baseline_dora_directory,
        "baseline_random_state_path": args.baseline_random_state_path,
        "baseline_split_indices_path": args.baseline_split_indices_path,
        "perturb_type": args.perturb_type,
        "perturb_length": args.perturb_length,
        "perturb_distribution": args.perturb_distribution,
        "perturb_seed": args.perturb_seed,
        "output_base_directory": args.output_base_directory,
    }

    if args.batched_forks > 1:
        from ..train.multi_fork import make_fork_mesh, run_batched_sweep
        make_fork_mesh(args.fork_devices, args.batched_forks, logger)
        logger.info(f"Batched-fork mode: {len(training_order)} runs in "
                    f"lock-step groups of {args.batched_forks}")
        guard = PreemptionGuard()
        with guard:
            failed_run_list = run_batched_sweep(
                config, training_order, group_size=args.batched_forks,
                logger=logger, done_report=_report_done,
                preempt_guard=guard, device=device)
        if failed_run_list:
            logger.info(f"Failed runs: {failed_run_list}")
        # exit 143 before the failed report: a parent --workers dispatcher
        # takes a written report as authoritative, and without one it
        # rebuilds the undispatched runs from the done ledger
        exit_if_undispatched(guard)
        _report_failed(failed_run_list)
        return failed_run_list

    logger.info("=" * 80)
    logger.info("STARTING MAIN TRAINING LOOP")
    logger.info(f"Timestamp: {timestamp}")
    logger.info(f"Perturbation Type: {config['perturb_type']}")
    logger.info(f"Perturbation Seed: {config['perturb_seed']}")
    logger.info(f"Output Directory: {config['output_base_directory']}")
    logger.info(f"Training order (first 20): {training_order[:20]}")
    logger.info(f"Total runs: {len(training_order)}")
    logger.info("=" * 80)

    successful_runs, failed_runs, failed_run_list = 0, 0, []
    for idx, training_run in enumerate(training_order, 1):
        logger.info("-" * 80)
        logger.info(f"TRAINING RUN {idx}/{len(training_order)} "
                    f"(Epoch {training_run})")
        run_dir = os.path.join(args.output_base_directory,
                               f"training_run{training_run}")
        config["training_run"] = training_run
        config["checkpoint_path"] = os.path.join(
            run_dir, f"model_checkpoint_run{training_run}.pth")
        config["training_res_path"] = os.path.join(
            run_dir, f"training_res_run{training_run}.csv")
        config["dora_parameters_path"] = os.path.join(
            run_dir, f"dora_params_run{training_run}")
        config["random_state_path"] = os.path.join(
            run_dir, f"random_states_run{training_run}")
        config["resume_from_epoch"] = training_run - 1
        try:
            os.makedirs(run_dir, exist_ok=True)
            summary = run_behavioral_training(dict(config), device=device)
        except Exception:  # one run's failure must not end the sweep
            failed_runs += 1
            failed_run_list.append(training_run)
            logger.exception(f"  Training run {training_run} FAILED")
            if dist.world_size() > 1:
                # the other ranks may be waiting in the run's collectives:
                # end the job (torchrun stops the other ranks) rather than
                # leave them waiting
                raise
        else:
            if summary.get("preempted"):
                # the interrupted run resumes from its own artifacts; the
                # untouched forks re-dispatch on the next invocation
                logger.info(f"  PREEMPTED during training run {training_run};"
                            f" stopping the sweep (re-invoke to resume)")
                sys.exit(143)
            successful_runs += 1
            _report_done([training_run])
            logger.info(f"  Training run {training_run} completed successfully")
        logger.info(f"  Progress: {successful_runs} successful, "
                    f"{failed_runs} failed")

    logger.info("=" * 80)
    logger.info("MAIN TRAINING LOOP COMPLETED")
    logger.info(f"Total runs: {len(training_order)}")
    logger.info(f"Successful: {successful_runs}")
    logger.info(f"Failed: {failed_runs}")
    if failed_run_list:
        logger.info(f"Failed runs: {failed_run_list}")
    logger.info("=" * 80)
    _report_failed(failed_run_list)
    return failed_run_list


if __name__ == "__main__":
    # nonzero exit when any run failed, so grid automation can detect an
    # incomplete sweep (the lengths CLI's contract too)
    sys.exit(1 if main() else 0)
