"""Batched forks: R sweep forks or lengths conditions trained in one
lock-step loop on one card (counterpart of the JAX package's
train/multi_fork.py).

The reference sweep trains its 98 forks one after another, each a whole
process at batch 64, which leaves most of a GPU idle and pays the weights
load, the dataset decode and the frozen-prefix cache once per fork. The
forks share the frozen CLIP, the decoded THINGS sets, the baseline split
and the prompts; only their DoRA adapters, AdamW states, data orders and
random keys differ. So a group of R forks runs as one step on R*64 rows:

- the fork axis is folded into the batch (``ClipHBATrainer.
  train_step_forks``, ``models/clip.py clip_hba_forward_forks``): every
  layer that reads only frozen weights runs once on [R*B, S, D], the
  attention is one launch a block, and only the adapted out_proj is per
  fork (one product a fork, on its rows). A lock-step batch launches the
  solo step's attention kernels: 36 forwards on the full tower or 3 from
  the cache, and one backward;
- each fork keeps its own trainable tensors and its own AdamW
  (``make_optimizer``), so forks resumed at different epochs keep their
  own step counts and bias correction, and a fork's checkpoints are its
  solo run's (``clip_ckpt``);
- the loss that is backpropagated is the sum of the forks' own masked
  means; a fork with a non-finite batch skips its own update;
- fork f's perturbation window is absolute ([run-1, run-1+L-1],
  perturb/windows.py), so forks with different onsets, lengths and resume
  points lock-step together: inside its window a fork draws its own
  perturbation from its run's keys, outside it trains on the clean batch.

Each fork writes the solo layout (training_run{N}/training_res_run{N}.csv,
per-epoch DoRA and random-state files; the lengths grid's
{type}_e{E}_l{L}/), so the figure readers and both packages' resume ladders
read a batched tree unchanged. In f32 on the CPU a fork's numbers are its
solo run's, bit for bit; in bf16 on the card the products over R*B rows
may sum in another order than the solo ones.

Early stopping is per fork, with patience frozen inside the window. A fork
that has stopped or finished leaves the stack at the next lock-step (JAX
keeps it in its compiled program as a rider whose updates are dropped;
eager PyTorch has no fixed shape to keep), so the ride-along accounting
counts no rider epochs. Groups are built from the ascending, deduplicated
order. The preemption guard is polled at every group boundary and at every
lock-step after the first.

Under torchrun every rank runs every group, as JAX's processes all run the
same program (its trainer has no data mesh here): the primary writes the
CSVs and checkpoints, the early-stopping decisions read the primary's eval
losses, and the ranks meet at a barrier after each lock-step's writes and
at the collective polls. ``--fork_devices`` is clamped as JAX's
``make_fork_mesh`` clamps it; the fork axis over several cards comes with
a later slice of the port.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..adapters import dora as adora
from ..ckpt import clip_ckpt
from ..core import csvio, hostcopy
from ..core.configs import ClipRunConfig
from ..core.device import resolve_device
from ..core.prng import Key, perturb_base_key
from ..data import things as dthings
from ..parallel import dist
from ..perturb import injectors, windows
from .clip_loop import ClipHBATrainer, build_run_assets

def make_fork_mesh(n_requested: int, n_items: int, logger=None):
    """The fork axis's devices, clamped as JAX's ``make_fork_mesh`` clamps
    them: min(requested, this host's cards, the group's forks). One device
    (or none requested) gives None, and the group runs on this rank's card
    as it does without the flag; more than one raises, since the fork axis
    over several cards is not ported yet."""
    if n_requested <= 1:
        return None
    import torch
    n = min(n_requested, torch.cuda.device_count(), n_items)
    if n <= 1:
        (logger.info if logger else print)(
            f"Fork axis on 1 device (requested {n_requested})")
        return None
    raise NotImplementedError(
        f"--fork_devices {n_requested} ({n} cards after the clamp): the "
        f"fork axis over several cards is not ported yet: it comes with "
        f"port slice 9b")


def per_chip_forks(group_size: int, mesh=None) -> int:
    """Forward passes one batched call materializes on a card: the group's
    forks over the fork axis's devices (JAX's signature; `mesh` is None
    until the fork axis spans cards)."""
    n_dev = 1 if mesh is None else mesh.size()
    return max(1, -(-int(group_size) // int(n_dev)))


class _ForkState:
    """Host-side bookkeeping of one fork: paths, window, early stopping.

    `run` is the 1-indexed epoch the fork's window starts at (the sweep's
    training_run N, the lengths grid's onset E) and `window_len` its length;
    absolute window arithmetic then covers sweep forks, lengths conditions
    and cross-resumed conditions alike."""

    def __init__(self, run: int, window_len: int, start_epoch0: int,
                 res_path: str, dora_path: str, state_path: str,
                 prepop_csv: str | None = None):
        self.run = run
        self.window_len = window_len
        self.label = str(run)   # reporting unit (lengths: the dir name)
        self.start_epoch0 = start_epoch0    # first trained epoch, 0-indexed
        self.res_path = res_path
        self.dora_path = dora_path
        self.state_path = state_path
        self.prepop_csv = prepop_csv        # CSV to pre-populate rows from
        self.best_test_loss = 500000.0      # reference init (ref :790)
        self.no_improve = 0
        self.stopped = False
        # all epochs trained (or early-stopped) and the artifacts written: a
        # later group failure must not report this fork as failed
        self.finished = False

    def epoch0_at(self, t: int) -> int:
        return self.start_epoch0 + t

    def in_window_at(self, t: int, perturb_type: str) -> bool:
        return (perturb_type in windows.PERTURB_TYPES
                and windows.in_window(self.epoch0_at(t), self.run,
                                      self.window_len))


class _PrintLogger:
    def info(self, msg):
        print(msg)

    warning = error = info


class _Setup:
    """What a batched invocation sets up once, for every group: the assets,
    one trainer, the resident datasets, one frozen-prefix cache and the eval
    batching (a sequential sweep pays this for every fork)."""

    def __init__(self, base_config: dict, logger, group_size: int = 1,
                 device=None):
        if base_config.get("sp_devices", 1) > 1:
            raise ValueError(
                "batched multi-fork execution does not compose with "
                "sequence parallelism: the fork axis is vmapped/mesh-sharded "
                "and the per-fork token-sharding constraints are not "
                "validated under that batching — run sp forks sequentially "
                "or via --workers")
        self.log = logger.info if logger else print
        self.device = resolve_device(device)
        self.vmap_factor = per_chip_forks(group_size)
        self.cfg = ClipRunConfig.from_dict({
            **base_config, "training_run": 0,
            "checkpoint_path": os.path.join(
                base_config["output_base_directory"], "unused.ckpt"),
            "training_res_path": "unused.csv",
            "dora_parameters_path": "unused",
            "random_state_path": os.path.join(
                base_config["output_base_directory"],
                "random_states_unused"),
        })
        cfg = self.cfg
        self.host_prefetch = bool(cfg.host_prefetch)
        self.assets = build_run_assets(cfg, logger or _PrintLogger(),
                                       self.device)
        a = self.assets
        self.trainer = ClipHBATrainer(
            a.clip_cfg, a.model, a.acfg, a.static, a.prompts, lr=cfg.lr,
            compute_dtype=torch.bfloat16 if cfg.compute_dtype == "bfloat16"
            else torch.float32,
            perturb_distribution=cfg.perturb_distribution,
            dist_mean=a.mean, dist_std=a.std, remat=cfg.remat)
        trainer = self.trainer
        self.train_imgs_dev, self.train_tgts_dev = trainer.upload_dataset(
            a.dataset.images_u8[a.train_idx], a.dataset.targets[a.train_idx])
        self.test_imgs_dev, self.test_tgts_dev = trainer.upload_dataset(
            a.dataset.images_u8[a.test_idx], a.dataset.targets[a.test_idx])
        self.inf_imgs_dev, _ = trainer.upload_dataset(a.inference.images_u8)
        self.rdm = a.reference_rdm
        self.n_train, self.n_test = len(a.train_idx), len(a.test_idx)

        # one cache build serves every fork of every group. An image kind
        # changes the tower's input inside the window, and the per-fork gate
        # mixes in-window and clean forks in one step, so those groups run
        # the full tower
        self.use_cache = bool(cfg.frozen_cache)
        if self.use_cache and cfg.perturb_type in injectors.IMAGE_KINDS:
            self.log(f"frozen_cache requested but perturb_type="
                     f"{cfg.perturb_type!r} replaces the tower input - "
                     f"batched groups run the full tower")
            self.use_cache = False
        self.train_cache = self.test_cache = self.inf_cache = None
        self.prefix_build_s = None
        if self.use_cache:
            t0 = time.perf_counter()
            self.train_cache = trainer.build_prefix_cache(self.train_imgs_dev)
            self.test_cache = trainer.build_prefix_cache(self.test_imgs_dev)
            self.inf_cache = trainer.build_prefix_cache(self.inf_imgs_dev)
            trainer.text_prefix_cache  # noqa: B018  (built once, timed here)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.prefix_build_s = time.perf_counter() - t0
            self.log(f"Frozen-prefix caches built in "
                     f"{self.prefix_build_s:.2f}s: batched steps train only "
                     f"the adapted suffix blocks")

    def load_state(self, label: str, dora_file: str | None,
                   rs_dir: str | None, rfe: int, *, require: bool = False):
        """One fork's initial (trainable, optimizer, data_seed), the solo
        run's semantics: a strict=False DoRA overlay from `dora_file` (the
        fresh init if absent), and the AdamW state and data seed from
        `rs_dir` at epoch `rfe` when rfe > 0.

        `require=True` (resuming an existing trajectory, in place or across
        runs) makes a missing `dora_file` an error: a mid-lineage CSV must
        not continue from a fresh adapter."""
        cfg, assets, log = self.cfg, self.assets, self.log
        trainable = assets.trainable
        if dora_file and os.path.exists(dora_file):
            trainable = clip_ckpt.load_dora_parameters(dora_file, trainable,
                                                       assets.spec)
            log(f"  {label}: DoRA fork loaded from {dora_file}")
        elif require:
            raise FileNotFoundError(
                f"{label}: resume checkpoint {dora_file} is missing - "
                "refusing to continue an existing trajectory from a fresh "
                "adapter (torn artifact tree)")
        else:
            log(f"  {label}: fresh DoRA init (no {dora_file})")
        trainable = adora.make_trainable(trainable, self.device)
        optimizer = self.trainer.init_optimizer(trainable)
        data_seed = cfg.random_seed
        if rfe > 0 and rs_dir:
            state = clip_ckpt.load_random_states(rs_dir, rfe, logger=None)
            if state is not None:
                if clip_ckpt.adamw_state_matches(state["optimizer_state"],
                                                 trainable):
                    clip_ckpt.adamw_state_from_optax(
                        optimizer, state["optimizer_state"], trainable)
                else:
                    log(f"  {label}: optimizer-state structure mismatch - "
                        f"fresh AdamW state")
                data_seed = state["data_seed"]
        return trainable, optimizer, data_seed


def _groups(items: list, group_size: int) -> list:
    return [items[i:i + group_size] for i in range(0, len(items), group_size)]


def run_batched_sweep(base_config: dict, training_order: list[int], *,
                      group_size: int = 8, logger=None, done_report=None,
                      preempt_guard=None, device=None) -> list[int]:
    """Train the sweep's forks in lock-step groups of `group_size`.

    `base_config` is the sweep CLI's per-run config without the run's paths
    (derived here, layout `{output_base_directory}/training_run{N}/`).
    Returns the failed runs, as the sequential sweep does: a fork whose
    init fails is reported alone and its group trains without it, and a
    group failure reports only the forks whose trees are incomplete.

    `done_report(runs)` receives the runs whose trees completed after every
    group (a dispatcher's progress ledger). `preempt_guard` is polled at
    every group boundary and lock-step; on a stop the unfinished and
    undispatched runs go on `preempt_guard.undispatched`. `device` defaults
    to the card."""
    su = _Setup(base_config, logger, group_size, device)
    cfg, log = su.cfg, su.log
    out_base = base_config["output_base_directory"]

    # ascending, so a group's forks have similar remaining spans; deduped,
    # since two forks of one run would share one artifact tree
    order = sorted(set(training_order))
    groups = _groups(order, group_size)
    log(f"Batched sweep: {len(order)} forks in {len(groups)} group(s) of "
        f"<= {group_size} (one lock-step loop per group)")

    failed: list[int] = []
    totals = {"lock_steps": 0, "live": 0, "rider": 0}
    for gi, runs in enumerate(groups):
        if _stop_batched(preempt_guard, gi, groups, lambda g: g, log,
                         "re-invoke with --training_order "
                         "<the undispatched list>"):
            break
        forks: list[_ForkState] = []
        inits = []
        for run in runs:
            try:
                run_dir = os.path.join(out_base, f"training_run{run}")
                os.makedirs(run_dir, exist_ok=True)
                fk = _ForkState(
                    run, cfg.perturb_length, run - 1,
                    os.path.join(run_dir, f"training_res_run{run}.csv"),
                    os.path.join(run_dir, f"dora_params_run{run}"),
                    os.path.join(run_dir, f"random_states_run{run}"))
                init = su.load_state(
                    f"run {run}",
                    os.path.join(cfg.baseline_dora_directory,
                                 f"epoch{run - 1}_dora_params.pth"),
                    cfg.baseline_random_state_path, run - 1)
            except Exception as e:
                log(f"  run {run}: init FAILED: {e!r}")
                failed.append(run)
                continue
            forks.append(fk)
            inits.append(init)
        if not forks:
            continue
        try:
            st = _run_group(su, forks, inits, guard=preempt_guard)
            interrupted = st.pop("interrupted", False)
            _tally_ride_along(totals, st)
            if interrupted:
                _record_group_preemption(
                    preempt_guard, [f.run for f in forks if not f.finished],
                    [r for g in groups[gi + 1:] for r in g], log,
                    "re-invoke with --training_order <the undispatched "
                    "list>; partial runs restart from the baseline")
                done = sorted(f.run for f in forks if f.finished)
                if done_report is not None and done:
                    done_report(done)
                break
            log(f"Group {gi + 1}/{len(groups)} (runs "
                f"{[f.run for f in forks]}) completed "
                f"({_ride_along_str(st)})")
            if done_report is not None:
                done_report([f.run for f in forks])
        except Exception as e:
            _end_the_job_across_ranks()
            # a fork that finished has its whole tree: reporting it failed
            # would invite a re-run that truncates it
            done = sorted(f.run for f in forks if f.finished)
            bad = [f.run for f in forks if not f.finished]
            log(f"Group {gi + 1}/{len(groups)} (runs {runs}) FAILED: {e!r} "
                f"(incomplete runs: {bad})")
            failed.extend(bad)
            if done_report is not None and done:
                done_report(done)
    if totals["lock_steps"]:
        log(f"Batched sweep ride-along total: {_ride_along_str(totals)}")
    return failed


def _end_the_job_across_ranks() -> None:
    """Re-raise a group's failure when other ranks share the job: they may
    be waiting at the group's barriers and polls, and ending the job
    (torchrun then stops them) beats leaving them waiting. One process
    reports the group failed and goes on."""
    if dist.world_size() > 1:
        raise


def _tally_ride_along(totals: dict, st: dict) -> None:
    for k in totals:
        totals[k] += st[k]


def _ride_along_str(st: dict) -> str:
    """JAX's live / rider fork-epoch accounting line: rider% is the share
    of trained fork-epochs spent on stopped forks (none here: they leave
    the stack)."""
    trained = st["live"] + st["rider"]
    pct = 100.0 * st["rider"] / trained if trained else 0.0
    return (f"{st['lock_steps']} lock-steps, {st['live']} live + "
            f"{st['rider']} rider fork-epochs = {pct:.1f}% ride-along "
            f"waste")


def _record_group_preemption(guard, unfinished, later_items, log,
                             hint) -> None:
    """A group stopped at a lock-step boundary: its unfinished members and
    every undispatched group go on `guard.undispatched` (the CLI's exit-143
    contract). Their completed epochs are on disk."""
    remaining = list(unfinished) + list(later_items)
    if guard is not None:
        guard.undispatched = remaining
    log(f"Preemption requested - stopped at a lock-step boundary with "
        f"{len(remaining)} item(s) to re-dispatch: {remaining} ({hint})")


def _poll(guard):
    """The guard's collective poll, else its local one."""
    return (getattr(guard, "should_stop_collective", None)
            or getattr(guard, "should_stop"))


def _stop_batched(guard, gi: int, groups, items_of, log, hint) -> bool:
    """The group-boundary preemption poll of the batched sweep and lengths,
    made at the top of every group after the first. On a stop the
    remaining groups (group gi included) go on `guard.undispatched`."""
    if guard is None or gi == 0:
        return False
    if not _poll(guard)():
        return False
    remaining = [it for g in groups[gi:] for it in items_of(g)]
    guard.undispatched = remaining
    log(f"Preemption requested - stopping with {len(remaining)} "
        f"undispatched item(s): {remaining} ({hint})")
    return True


def run_batched_lengths(base_config: dict, onsets: list[int], length: int, *,
                        group_size: int = 8, logger=None,
                        preempt_guard=None, device=None) -> list[str]:
    """Train one length's (onset x L) conditions of the variable-length grid
    in lock-step groups (the batched counterpart of cli/lengths.py; the
    reference trains its 136 conditions one process at a time).

    Each condition keeps the sequential CLI's resume ladder: in place from
    its own CSV, else across runs from the longest shorter sibling at the
    same onset, else fresh from the baseline at epoch onset-1. Conditions
    with different onsets and resume points train in one group: each fork's
    window is absolute. Returns the failed condition names (e.g.
    'random_target_e3_l2')."""
    su = _Setup(base_config, logger, group_size, device)
    cfg, log = su.cfg, su.log
    out_base = base_config["output_base_directory"]
    ptype = cfg.perturb_type

    conds = [(E, f"{ptype}_e{E}_l{length}") for E in sorted(set(onsets))]
    groups = _groups(conds, group_size)
    log(f"Batched lengths: {len(conds)} conditions (length {length}) in "
        f"{len(groups)} group(s) of <= {group_size}")

    failed: list[str] = []
    totals = {"lock_steps": 0, "live": 0, "rider": 0}
    for gi, group in enumerate(groups):
        if _stop_batched(preempt_guard, gi, groups,
                         lambda g: [name for _, name in g], log,
                         "conditions resume in place on re-invoke"):
            break
        names = [name for _, name in group]
        forks: list[_ForkState] = []
        inits = []
        for E, name in group:
            try:
                fk, init = _init_length_condition(su, out_base, ptype, E,
                                                  name, length)
            except Exception as e:
                log(f"  {name}: init FAILED: {e!r}")
                failed.append(name)
                continue
            forks.append(fk)
            inits.append(init)
        if not forks:
            continue
        try:
            st = _run_group(su, forks, inits, guard=preempt_guard)
            interrupted = st.pop("interrupted", False)
            _tally_ride_along(totals, st)
            if interrupted:
                _record_group_preemption(
                    preempt_guard,
                    [f.label for f in forks if not f.finished],
                    [name for g in groups[gi + 1:] for _, name in g], log,
                    "conditions resume in place on re-invoke")
                break
            log(f"Group {gi + 1}/{len(groups)} ({names}) completed "
                f"({_ride_along_str(st)})")
        except Exception as e:
            _end_the_job_across_ranks()
            bad = [f.label for f in forks if not f.finished]
            log(f"Group {gi + 1}/{len(groups)} ({names}) FAILED: {e!r} "
                f"(incomplete conditions: {bad})")
            failed.extend(bad)
    if totals["lock_steps"]:
        log(f"Batched lengths ride-along total: {_ride_along_str(totals)}")
    return failed


def _init_length_condition(su: _Setup, out_base: str, ptype: str, E: int,
                           name: str, length: int):
    """One condition's fork state and initial (trainable, optimizer, seed)
    through the resume ladder: in place (anchored on the newest epoch whose
    own checkpoints exist: a CSV row without them is a torn tree and rolls
    back), else across runs from the longest shorter sibling, else fresh
    from the baseline."""
    from ..cli.lengths import find_previous_run_dir, rollback_to_checkpoint
    cfg, log = su.cfg, su.log
    out_dir = os.path.join(out_base, name)
    os.makedirs(out_dir, exist_ok=True)
    res_path = os.path.join(out_dir, "training_res.csv")
    dora_dir = os.path.join(out_dir, f"dora_params_{E}")
    rs_dir = os.path.join(out_dir, f"random_states_{E}")

    last = csvio.last_completed_epoch0(res_path)
    anchored = (rollback_to_checkpoint(dora_dir, last, rs_dir=rs_dir)
                if last >= 0 else 0)
    resuming = False
    if last >= 0 and anchored > 0:
        rfe, prepop = anchored, res_path
        src_dora, src_rs = dora_dir, rs_dir
        resuming = True
        if anchored <= last:
            log(f"  {name}: CSV reaches epoch {last + 1} but the newest "
                f"checkpoint is epoch {anchored} - rolled back (torn tree)")
        log(f"  {name}: in-place resume from epoch {rfe + 1}")
    else:
        if last >= 0:
            log(f"  {name}: CSV has epochs through {last + 1} but NO own "
                f"checkpoints (torn tree) - restarting from the ladder")
        prev_dir, prev_len = find_previous_run_dir(out_base, ptype, E,
                                                   length)
        if prev_dir and prev_len is not None:
            rfe = max(0, E - 1) + prev_len
            prepop = os.path.join(prev_dir, "training_res.csv")
            src_dora = os.path.join(prev_dir, f"dora_params_{E}")
            src_rs = os.path.join(prev_dir, f"random_states_{E}")
            resuming = True
            log(f"  {name}: resuming from '{prev_dir}' "
                f"(length {prev_len}) at epoch {rfe + 1}")
        else:
            rfe, prepop = max(0, E - 1), None
            src_dora, src_rs = (cfg.baseline_dora_directory,
                                cfg.baseline_random_state_path)

    dora_file = (os.path.join(src_dora, f"epoch{rfe}_dora_params.pth")
                 if rfe > 0 else None)
    fk = _ForkState(E, length, rfe, res_path, dora_dir, rs_dir,
                    prepop_csv=prepop)
    fk.label = name
    # resuming an existing trajectory must find its checkpoint; only the
    # fresh fork keeps the reference's strict=False fallback
    init = su.load_state(name, dora_file, src_rs, rfe, require=resuming)
    return fk, init


def _run_group(su: _Setup, forks: list[_ForkState], inits, guard=None):
    """Train one group of forks to completion in lock-steps.

    `inits` holds each fork's (trainable, optimizer, data_seed) from
    _Setup.load_state. Lock-step t trains fork f's absolute epoch
    f.start_epoch0 + t on the forks still live; each fork's window gates its
    own perturbation. Returns the accounting {lock_steps, live, rider}
    (rider stays 0: stopped forks leave the stack), with `interrupted` when
    the guard stopped the group."""
    cfg, trainer, log = su.cfg, su.trainer, su.log
    primary = dist.is_primary()
    # every rank has read the group's trees (the ladder) before the primary
    # rewrites them
    dist.barrier()
    for f in forks:
        f.finished = f.stopped or f.epoch0_at(0) >= cfg.epochs
        if primary:
            csvio.init_clip_csv(f.res_path, f.start_epoch0, f.prepop_csv,
                                None)
    trainables = [t for t, _, _ in inits]
    optimizers = [o for _, o, _ in inits]
    seeds = [int(s) for _, _, s in inits]
    shufflers = [dthings.EpochShuffler(su.n_train, cfg.batch_size, s)
                 for s in seeds]
    dropout_root = Key.root(cfg.random_seed)
    base_pkeys = [perturb_base_key(cfg.perturb_seed, f.run) for f in forks]
    train_src = su.train_cache if su.use_cache else su.train_imgs_dev

    stats = {"lock_steps": 0, "live": 0, "rider": 0}
    # a stop notice ends the group within one lock-step: every completed
    # lock-step has written its checkpoints and rows
    poll = _poll(guard) if guard is not None else None
    t = 0
    while True:
        live = [i for i, f in enumerate(forks)
                if not (f.stopped or f.epoch0_at(t) >= cfg.epochs)]
        if not live:
            break
        if t > 0 and poll is not None and poll():
            stats["interrupted"] = True
            break
        stats["lock_steps"] += 1
        stats["live"] += len(live)
        e0s = [forks[i].epoch0_at(t) for i in live]
        batch_lists = [list(shufflers[i].batches(e0))
                       for i, e0 in zip(live, e0s)]
        in_win = [forks[i].in_window_at(t, cfg.perturb_type) for i in live]
        # patience freezes on pure window arithmetic (reference :1044-1056);
        # in_win (type-checked) gates the injection only
        win = [windows.in_window(forks[i].epoch0_at(t), forks[i].run,
                                 forks[i].window_len) for i in live]
        if t == 0:
            _log_injection_evidence(su, [forks[i] for i in live], in_win,
                                    [b[0] for b in batch_lists], log)
        kind = cfg.perturb_type if any(in_win) else "none"
        tr_live = [trainables[i] for i in live]
        opt_live = [optimizers[i] for i in live]
        epoch_keys = [dropout_root.fold_in(e0) for e0 in e0s]
        n_b = len(batch_lists[0])
        losses = np.zeros((len(live), n_b))
        oks = np.zeros((len(live), n_b), bool)
        for bi in range(n_b):
            losses[:, bi], oks[:, bi] = trainer.train_step_forks(
                tr_live, opt_live, train_src, su.train_tgts_dev,
                [b[bi] for b in batch_lists],
                [k.fold_in(bi) for k in epoch_keys], perturb_type=kind,
                perturb_keys=[base_pkeys[i].fold_in(bi) for i in live],
                in_win=in_win, batch_size=cfg.batch_size,
                cached=su.use_cache)
        # one bulk copy-out of the live forks' checkpoint trees, started
        # now so it runs beside the eval and RSA work (core/hostcopy.py)
        if primary:
            trees = (tr_live, [clip_ckpt.adamw_moments(o, tr)
                               for o, tr in zip(opt_live, tr_live)])
            copies = (hostcopy.prefetch_to_host(*trees) if su.host_prefetch
                      else [hostcopy.HostCopy(tree) for tree in trees])
        test_losses = trainer.evaluate_forks(
            tr_live, su.test_imgs_dev, su.test_tgts_dev, su.n_test,
            cfg.batch_size, vmap_factor=su.vmap_factor, cache=su.test_cache)
        # the stopping decisions (and so the lock-steps, and the polls in
        # them) follow the primary's numbers on every rank
        test_losses = dist.primary_values(test_losses)
        rsa = trainer.behavioral_rsa_forks(tr_live, su.inf_imgs_dev, su.rdm,
                                           cache=su.inf_cache)
        if primary:
            host_tr, host_mom = (c.get() for c in copies)

        sizes = np.array([len(b) for b in batch_lists[0]])
        for j, i in enumerate(live):
            f, e0 = forks[i], e0s[j]
            for bi in np.nonzero(~oks[j])[0]:
                log(f"  run {f.run}: WARNING non-finite batch {bi} skipped "
                    f"(epoch {e0 + 1})")
            # mask before multiplying: a skipped batch's loss is NaN
            train_loss = float(np.sum(np.where(oks[j], losses[j], 0.0)
                                      * sizes)) / su.n_train
            test_loss = test_losses[j]
            rho, p = rsa[j]
            flags = windows.epoch_flags(e0, f.run, f.window_len,
                                        cfg.perturb_type)
            log(f"  run {f.run} epoch {e0 + 1}: train {train_loss:.4f} "
                f"test {test_loss:.4f} rsa {rho:.4f} (p={p:.4f})")
            # checkpoints before the CSV row: a crash between the two leaves
            # "checkpoint without row" (retrained on resume), never "row
            # without checkpoint"
            if primary:
                clip_ckpt.save_dora_parameters(host_tr[j], f.dora_path, e0)
                clip_ckpt.save_random_states(
                    clip_ckpt.optax_state_from_moments(*host_mom[j]), e0,
                    f.state_path, seeds[i],
                    {"dropout_seed": cfg.random_seed})
                csvio.append_clip_row(f.res_path, e0 + 1, train_loss,
                                      test_loss, rho, p, **flags)
            if test_loss < f.best_test_loss:
                f.best_test_loss = test_loss
                f.no_improve = 0
            elif not win[j]:  # patience paused inside the window
                f.no_improve += 1
            if f.no_improve == cfg.early_stopping_patience:
                log(f"  run {f.run}: early stopping at epoch {e0 + 1}")
                f.stopped = True
            f.finished = f.stopped or f.epoch0_at(t + 1) >= cfg.epochs
        # the lock-step's files are whole before any rank goes on
        dist.barrier()
        t += 1
    return stats


@torch.no_grad()
def _log_injection_evidence(su: _Setup, forks, in_win, first_batches, log):
    """Each in-window fork's first batch after its injector (the reference's
    debug-print verification, ref :886-982); logged by the primary."""
    if not dist.is_primary():
        return
    cfg, trainer = su.cfg, su.trainer
    for f, inw, idx in zip(forks, in_win, first_batches):
        if not inw:
            continue
        rows = torch.as_tensor(np.asarray(idx, np.int64), device=su.device)
        img0 = dthings.normalize_uint8(su.train_imgs_dev[rows])
        tgt0 = su.train_tgts_dev[rows]
        pi, pt = trainer.perturb(cfg.perturb_type,
                                 perturb_base_key(cfg.perturb_seed,
                                                  f.run).fold_in(0),
                                 img0, tgt0, cfg.batch_size)
        log(f"  run {f.run} perturbed batch 0: images mean "
            f"{float(pi.mean()):.3f} (was {float(img0.mean()):.3f}), "
            f"targets changed: {not torch.equal(pt, tgt0)}, "
            f"images changed: {not torch.equal(pi, img0)}")
