"""Variable-length perturbation CLI (counterpart of the JAX package's
cli/lengths.py, with the same flags plus --device).

Reference: Training/clip_behavioral_finetuning/length_experiments/
clip_train_behavior_lengths.py: one (onset epoch E, duration L) condition per
invocation, output layout `{base}/{type}_e{E}_l{L}/training_res.csv` parsed
by the fig4 recovery analysis. The resume ladder:
1. in place, from the newest epoch of the existing CSV whose checkpoints
   exist;
2. otherwise across runs, from the longest shorter-length run at the same
   onset (find_previous_run_dir), pre-populating the CSV;
3. otherwise fresh, forked from the baseline's epoch E-1.
`--perturb_type baseline` trains the unperturbed trajectory.

  python -m vit_project_torch.cli.lengths --perturb_type random_target \\
      --perturb_epoch 2 --perturb_length 2 --output_dir random_target_e2_l2 \\
      --output_base_directory runs/lengths --baseline_dora_directory ... \\
      --baseline_random_state_path ... --baseline_split_indices_path ...

Exits 143 when a SIGTERM stopped the run at an epoch boundary (re-invoke to
resume in place). `--onsets 3,8,15` trains every (onset x --perturb_length)
condition of one length in lock-step groups of `--batched_forks` on one
card (train/multi_fork.run_batched_lengths), each condition keeping its
`{type}_e{E}_l{L}/` layout and the resume ladder above; `--fork_devices` is
clamped as the sweep's is. Under torchrun a condition trains data-parallel
over the ranks (the batched mode runs every group on every rank), rank 0
writes, and every rank reads the ladder after a barrier.
"""
from __future__ import annotations

import argparse
import os
import re
import sys
from datetime import datetime
from pathlib import Path

from ..core import csvio
from ..core.device import resolve_device
from ..core.logs import setup_main_logger
from ..core.preempt import PreemptionGuard, exit_if_undispatched
from ..parallel import dist
from ..train.clip_loop import run_behavioral_training

# the `{type}_e{E}_l{L}` condition-directory naming shared with the fig4
# recovery analysis (reference layout: clip_train_behavior_lengths.py:128-134)
_CONDITION_DIR = re.compile(r"(?P<kind>.+)_e(?P<onset>\d+)_l(?P<length>\d+)$")
_INJECTOR_KINDS = frozenset(
    ["random_target", "label_shuffle", "uniform_images", "image_noise"])


def find_previous_run_dir(base_dir: str, perturb_type: str, start_epoch: int,
                          current_length: int):
    """The longest already-trained condition at the same onset with a
    strictly smaller window, for cross-run resume (reference
    clip_train_behavior_lengths.py:188-218). Returns (dir_path, length) or
    (None, None).

    A sibling qualifies only if its resume epoch's DoRA and random-state
    files exist: a torn sibling (crashed mid-run) falls through to the next
    shorter one or a fresh start, never resumes into a fresh adapter."""
    def _sibling_anchored(path: str, length: int) -> bool:
        epoch1 = max(0, start_epoch - 1) + length
        return (os.path.exists(os.path.join(
                    path, f"dora_params_{start_epoch}",
                    f"epoch{epoch1}_dora_params.pth"))
                and os.path.exists(os.path.join(
                    path, f"random_states_{start_epoch}",
                    f"epoch{epoch1}_random_states.pth")))

    def shorter_siblings():
        for entry in Path(base_dir).iterdir():
            m = _CONDITION_DIR.match(entry.name)
            if m is None or not entry.is_dir():
                continue
            if int(m["onset"]) != start_epoch:
                continue
            if perturb_type in _INJECTOR_KINDS and m["kind"] != perturb_type:
                continue
            length = int(m["length"])
            if length < current_length and _sibling_anchored(str(entry),
                                                             length):
                yield length, str(entry)

    if not os.path.isdir(base_dir):
        return None, None
    best = max(shorter_siblings(), default=None)
    return (None, None) if best is None else (best[1], best[0])


def rollback_to_checkpoint(dora_dir: str, last_epoch0: int,
                           rs_dir: str | None = None) -> int:
    """Newest 1-indexed epoch <= last_epoch0+1 whose checkpoint state exists
    (0 = none). An in-place resume must anchor on an epoch whose state is on
    disk: pointed at a missing epoch{N} file, run_behavioral_training would
    start a fresh adapter under a mid-lineage CSV. With `rs_dir` the anchor
    also needs that epoch's random-states file (else the resume would
    restart AdamW and the data seed)."""
    def _anchored(epoch1: int) -> bool:
        if not os.path.exists(
                os.path.join(dora_dir, f"epoch{epoch1}_dora_params.pth")):
            return False
        return rs_dir is None or os.path.exists(
            os.path.join(rs_dir, f"epoch{epoch1}_random_states.pth"))

    rfe = last_epoch0 + 1
    while rfe > 0 and not _anchored(rfe):
        rfe -= 1
    return rfe


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="CLIP-HBA variable-length "
                                            "perturbation run "
                                            "(PyTorch / CUDA)")
    p.add_argument("--model", default="clip_hba")
    p.add_argument("--perturb_type", default="random_target",
                   choices=["random_target", "label_shuffle", "uniform_images",
                            "image_noise", "baseline"])
    p.add_argument("--perturb_epoch", type=int, default=None,
                   help="Epoch to perturb (0 for baseline); required unless "
                        "--onsets is given")
    p.add_argument("--perturb_length", type=int, required=True,
                   help="Length of perturbation (0 for baseline)")
    p.add_argument("--perturb_distribution", default="target",
                   choices=["normal", "target"])
    p.add_argument("--perturb_seed", type=int, default=0)
    p.add_argument("--output_dir", default=None,
                   help="e.g. random_target_e2_l2 (relative to base)")
    p.add_argument("--cuda", type=int, default=0)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--early_stopping_patience", type=int, default=20)
    p.add_argument("--random_seed", type=int, default=1)
    p.add_argument("--baseline_dora_directory", required=True)
    p.add_argument("--baseline_random_state_path", required=True)
    p.add_argument("--baseline_split_indices_path", required=True)
    p.add_argument("--output_base_directory", required=True)
    # data/model args (the reference hardcodes relative ../Data paths)
    p.add_argument("--csv_file",
                   default="../Data/spose_embedding66d_rescaled_1806train.csv")
    p.add_argument("--img_dir", default="../Data/Things1854")
    p.add_argument("--inference_csv_file",
                   default="../Data/spose_embedding66d_rescaled_48val_reordered.csv")
    p.add_argument("--RDM48_triplet_dir", default="../Data/RDM48_triplet.mat")
    p.add_argument("--backbone", default="ViT-L/14")
    p.add_argument("--clip_weights", default=None)
    p.add_argument("--bpe_vocab", default=None)
    p.add_argument("--allow_hash_tokenizer", action="store_true",
                   help="permit pretrained weights without a BPE vocab "
                        "(RSA will be scientifically void; testing only)")
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
    # reference hardcodes these (clip_train_behavior_lengths.py:110-112);
    # exposed as flags so forks can match any baseline's adapter config
    p.add_argument("--vision_layers", type=int, default=2)
    p.add_argument("--transformer_layers", type=int, default=1)
    p.add_argument("--rank", type=int, default=32)
    p.add_argument("--onsets", default=None,
                   help="comma-separated perturb onsets, e.g. '3,8,15': "
                        "train all (onset x perturb_length) conditions of "
                        "this length as lock-step fork groups on one GPU "
                        "(train/multi_fork.run_batched_lengths) instead of "
                        "one condition per invocation; --perturb_epoch and "
                        "--output_dir are ignored, each condition keeps "
                        "the {type}_e{E}_l{L}/ layout and the resume ladder")
    p.add_argument("--batched_forks", type=int, default=8,
                   help="group size for --onsets batching")
    p.add_argument("--fork_devices", type=int, default=1,
                   help="shard the batched fork axis over N devices, "
                        "clamped to this host's cards and the group; more "
                        "than one after the clamp is not ported yet")
    return p


def _base_config(args) -> dict:
    """The run-config template of one condition."""
    return {
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
        "cuda": args.cuda,
        "compute_dtype": args.compute_dtype,
        "remat": args.remat,
        "host_prefetch": args.host_prefetch,
        "frozen_cache": args.frozen_cache,
        "baseline_dora_directory": args.baseline_dora_directory,
        "baseline_random_state_path": args.baseline_random_state_path,
        "baseline_split_indices_path": args.baseline_split_indices_path,
        "perturb_type": args.perturb_type,
        "perturb_distribution": args.perturb_distribution,
        "perturb_seed": args.perturb_seed,
        "output_base_directory": args.output_base_directory,
    }


def _resume_in_place(config: dict, resume_epoch: int, last_completed: int,
                     logger) -> None:
    config["resume_from_epoch"] = resume_epoch
    config["previous_training_res_path"] = config["training_res_path"]
    config["resume_random_state_path"] = config["random_state_path"]
    config["resume_dora_parameters_path"] = config["dora_parameters_path"]
    if resume_epoch <= last_completed:
        logger.info(f"CSV reaches epoch {last_completed + 1} but the newest "
                    f"checkpoint is epoch {resume_epoch} - rolled back (torn "
                    f"tree)")


def _main_batched(args, parser, device, timestamp: str) -> list[str]:
    """--onsets mode: every (onset, perturb_length) condition of one length
    in lock-step fork groups. Returns the failed condition names."""
    if args.perturb_type == "baseline":
        parser.error("--onsets batching is for perturbed conditions; run "
                     "the baseline mode per condition")
    onsets = [int(x) for x in args.onsets.split(",") if x.strip()]
    config = {**_base_config(args), "perturb_length": args.perturb_length}
    from ..train.multi_fork import make_fork_mesh, run_batched_lengths
    logger = setup_main_logger(os.path.join(
        args.output_base_directory, f"lengths_batched_log_{timestamp}.txt"))
    # the clamp sees one vmapped group's forks, not the whole onset list;
    # a refusal comes before any file is written
    make_fork_mesh(args.fork_devices, min(args.batched_forks, len(onsets)),
                   logger)
    os.makedirs(args.output_base_directory, exist_ok=True)
    logger.info(f"Batched lengths mode: type={args.perturb_type} "
                f"length={args.perturb_length} onsets={onsets}")
    guard = PreemptionGuard()
    with guard:
        failed = run_batched_lengths(
            config, onsets, args.perturb_length,
            group_size=args.batched_forks, logger=logger,
            preempt_guard=guard, device=device)
    if failed:
        logger.info(f"Failed conditions: {failed}")
    exit_if_undispatched(guard)  # 143: the rest resume in place
    return failed


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.onsets is None and (args.perturb_epoch is None
                                or args.output_dir is None):
        parser.error("--perturb_epoch and --output_dir are required (or "
                     "pass --onsets for the batched multi-condition mode)")
    device = resolve_device(dist.local_device(args.device))
    with dist.process_group(device):
        return _main(args, parser, device)


def _main(args, parser, device):
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    if args.onsets is not None:
        return _main_batched(args, parser, device, timestamp)

    config = {
        **_base_config(args),
        "training_run": args.perturb_epoch,
        "resume_from_epoch": max(0, args.perturb_epoch - 1),
    }
    out_dir = os.path.join(args.output_base_directory, args.output_dir)
    config["checkpoint_path"] = os.path.join(
        out_dir, f"model_checkpoint_{args.perturb_epoch}.pth")
    config["training_res_path"] = os.path.join(out_dir, "training_res.csv")
    config["dora_parameters_path"] = os.path.join(
        out_dir, f"dora_params_{args.perturb_epoch}")
    config["random_state_path"] = os.path.join(
        out_dir, f"random_states_{args.perturb_epoch}")

    # in-place resume scan (reference :141-160), anchored on the newest
    # epoch whose checkpoint actually exists; every rank reads the same
    # tree
    dist.barrier()
    last_completed_epoch = csvio.last_completed_epoch0(
        config["training_res_path"])
    resume_epoch = rollback_to_checkpoint(config["dora_parameters_path"],
                                          last_completed_epoch,
                                          rs_dir=config["random_state_path"])
    resume_from_existing = last_completed_epoch >= 0 and resume_epoch > 0

    os.makedirs(out_dir, exist_ok=True)
    logger = setup_main_logger(
        os.path.join(out_dir, f"training_log_{timestamp}.txt"))
    logger.info("=" * 80)
    logger.info("STARTING SINGLE TRAINING RUN")
    logger.info(f"Perturbation Type: {args.perturb_type}")
    logger.info(f"Perturbation Epoch: {args.perturb_epoch}")
    logger.info(f"Perturbation Length: {args.perturb_length}")
    logger.info(f"Output Directory: {out_dir}")
    logger.info("=" * 80)

    if args.perturb_type == "baseline":
        logger.info("Running baseline training (no perturbations)")
        config["perturb_type"] = "baseline"
        config["perturb_length"] = 0
        config["training_run"] = 0
        if resume_from_existing:
            _resume_in_place(config, resume_epoch, last_completed_epoch,
                             logger)
            logger.info(f"Resuming existing baseline run from epoch "
                        f"{config['resume_from_epoch'] + 1}")
        else:
            config["resume_from_epoch"] = 0
    else:
        config["perturb_length"] = args.perturb_length
        if resume_from_existing:
            _resume_in_place(config, resume_epoch, last_completed_epoch,
                             logger)
            logger.info(f"Resuming existing run from epoch "
                        f"{config['resume_from_epoch'] + 1}")
        else:
            prev_dir, prev_length = find_previous_run_dir(
                args.output_base_directory, args.perturb_type,
                args.perturb_epoch, args.perturb_length)
            if prev_dir and prev_length is not None:
                last_epoch = max(0, args.perturb_epoch - 1) + prev_length
                config["resume_from_epoch"] = last_epoch
                config["previous_training_res_path"] = os.path.join(
                    prev_dir, "training_res.csv")
                config["resume_random_state_path"] = os.path.join(
                    prev_dir, f"random_states_{args.perturb_epoch}")
                config["resume_dora_parameters_path"] = os.path.join(
                    prev_dir, f"dora_params_{args.perturb_epoch}")
                logger.info(f"Detected previous run at '{prev_dir}' with "
                            f"length {prev_length}; resuming from epoch "
                            f"{last_epoch + 1}")
            else:
                logger.info("No previous matching run found; starting from "
                            "baseline epoch.")

    try:
        summary = run_behavioral_training(config, device=device)
    except Exception:
        logger.exception("TRAINING RUN FAILED")
        raise
    if summary.get("preempted"):
        logger.info("TRAINING RUN PREEMPTED (artifacts saved; re-invoke to "
                    "resume in place)")
        sys.exit(143)
    logger.info("TRAINING RUN COMPLETED SUCCESSFULLY")
    logger.info(f"Results saved to: {out_dir}")


if __name__ == "__main__":
    # --onsets returns the failed conditions (the solo mode raises): exit
    # nonzero so grid automation retries them
    sys.exit(1 if main() else 0)
