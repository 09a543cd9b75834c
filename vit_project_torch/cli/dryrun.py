"""The port's compile check and multi-rank dry run (counterpart of the JAX
package's ``__graft_entry__.py``).

- ``entry(device)``: (fn, example_args), where ``fn(*example_args)`` is the
  flagship forward step: uint8 images normalized and classified by ViT-B/16
  at full width in bf16, 12 ``flash3_fwd`` launches on the card. The port is
  eager, so nothing is compiled ahead: the first call builds the kernels.
- ``dryrun_multichip(n, device)``: every parallel mode's training step over
  n ranks, run once at tiny shapes. It provisions itself, as JAX's does:
  it re-executes this module under ``torch.distributed.run --standalone
  --nproc_per_node n`` (a free port, the caller's rendezvous variables
  removed, so it works from a process that already holds a group or the
  card), echoes the ranks' output and raises ``RuntimeError`` if any rank
  fails. The ranks run under gloo; with ``device="cuda"`` they share
  ``cuda:0`` (NCCL takes one rank a card) and gloo moves the collectives'
  tensors through the host, while every kernel launches on the card. There
  is no fallback: ``device="cuda"`` without a card raises.

Run it as ``python -m vit_project_torch.cli.dryrun [N] [--device cpu]``.

The shapes are tiny and the same on the CPU and on the card. The head
width is 64, the only one the attention kernels take (JAX's dry run uses
width 64 with 2 heads of 32):

- ViT: patch 16, width 128, 2 layers, 2 heads, 64^2 images, 10 classes;
- CLIP: width 128, 2 heads, 2 layers a tower, 32^2 images, rank-4 DoRA on
  the last block of each tower;
- MoE: the ViT with 4 experts (its second block is the MoE block);

all in float32 (on the card without TF32, so float32 means float32). The
weights are drawn on the host from one seed, so every rank and every
process starts from the same numbers.

The sections, in JAX's order, on a global batch B = 2n whose images and
labels are ``np.random.RandomState(0)``'s draws, as JAX draws them. Each is
the port's own trainer step (``ViTTrainer.step``, ``ClipHBATrainer
.train_step`` / ``train_step_forks``); a data rank takes the strided rows
of the global batch, as the loaders' shards deal them:

1. ``dp``: ViT data parallelism over the n ranks, grad_accum 2, zero1;
2. ``fsdp``: FSDP2, within LOSS_ATOL of dp; after the step every leaf is
   still a DTensor on dim 0, and every leaf the ranks divide holds 1/n;
3. ``clip``: the CLIP-HBA DoRA step (AdamW, MSE, random_target targets)
   over the data mesh;
4. ``forks``: R = n forks of the stepped adapters in two lock-steps on
   every rank under that mesh (the fork axis over cards is not ported:
   train/multi_fork.py); losses [R, 2], all finite;

and for n >= 4 (even), on (n/2, 2) meshes:

5. ``tp``: tensor parallelism, within LOSS_ATOL of dp; the qkv stays split
   by heads;
6. ``clip_sp_ring``: the CLIP step with the visual tower sequence-parallel
   in the ring form;
7. ``sp`` and ``sp_ring``: ViT sequence parallelism, the gather form, then
   the ring within LOSS_ATOL of the gather;
8. ``ep``: the MoE ViT with its experts over ("data", "expert");
9. ``pp``: 2 stages over ("data", "stage") at batch n, 2 microbatches a
   data rank, within LOSS_ATOL of ``pp_oracle``, the dp step at batch n.

In place of JAX's two-process leg, two checks:

- ``oracle``: the dp section in one process alone (a group of one, the
  same global batch) runs beside the n ranks, and their dp losses agree
  within ORACLE_ATOL;
- ``ckpt``: the dp parameters with the ZeRO-1 momentum, and the FSDP
  state, go through ``vit_ckpt.save_checkpoint(sharded=True)`` and
  ``load_checkpoint(template=...)`` into zeroed leaves of the same
  placement: every leaf comes back bit-equal, and each rank's file holds
  its own shards and no other rank's (by the metadata and by the bytes).

The bounds are JAX's: 1e-4 between modes, 1e-5 between the one-process
and the multi-process runs. JAX also fails its dry run on an XLA
"Involuntary full rematerialization" message, GSPMD's sign that a sharding
stopped propagating. The port has no GSPMD, so there is no such message;
the shard checks of sections 2 and 5 take its place.

The output ends with one JSON line of every section's loss and seconds,
the checks and the ranks' kernel launches, then
``dryrun_dp_loss_repr=<repr>`` and JAX's summary line,
``dryrun_multichip(N): ViT dp loss ... - OK``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..models import vit as vvit

SEED = 0
LR = 0.1
LOSS_ATOL = 1e-4      # JAX's bound between two modes' losses
ORACLE_ATOL = 1e-5    # JAX's bound between its one- and two-process runs
LAUNCH_TIMEOUT = 900.0
# the environment variable that plants a failure in a section (on the last
# rank): how the tests show that one rank's failure fails the call
FAIL_ENV = "VIT_DRYRUN_FAIL_SECTION"
# the caller's rendezvous, which the launch must not inherit
_RENDEZVOUS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT")
_MODULE = "vit_project_torch.cli.dryrun"     # also when run as __main__
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

VIT_TINY = vvit.ViTConfig(patch=16, width=128, layers=2, heads=2,
                          image_size=64, num_classes=10)
MOE_TINY = vvit.ViTConfig(patch=16, width=128, layers=2, heads=2,
                          image_size=64, num_classes=10, moe_experts=4)
CLIP_TINY = dict(width=128, layers=2, heads=2, patch=16, image_size=32,
                 embed_dim=16)


def entry(device="cuda", cfg: vvit.ViTConfig = vvit.VIT_B16):
    """(fn, example_args): ``fn(model, images_u8)`` normalizes uint8
    images and runs ``vit_classify`` in bf16; the args are a `cfg`
    classifier (ViT-B/16 by default) with weights from seed 0 and
    ``RandomState(0)``'s uint8 images [8, size, size, 3], on `device`."""
    from ..data.imagenet import normalize_imagenet
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = vvit.init_vit_params(vvit.empty_vit(cfg, dev), gen)
    size = cfg.image_size
    images_u8 = torch.from_numpy(np.random.RandomState(0).randint(
        0, 255, (8, size, size, 3), np.uint8)).to(dev)

    @torch.no_grad()
    def fn(model, images_u8):
        return vvit.vit_classify(model, normalize_imagenet(images_u8),
                                 compute_dtype=torch.bfloat16)

    return fn, (model, images_u8)


# -- the ranks ----------------------------------------------------------------

def _draws(n: int) -> dict:
    """The global batches, in the order JAX's dry run draws them."""
    rs = np.random.RandomState(0)
    B = 2 * n
    d = {"images": rs.randint(0, 255, (B, 64, 64, 3), np.uint8),
         "labels": rs.randint(0, 10, B).astype(np.int32)}
    d["prompts"] = rs.randint(1, 500, (66, 16)).astype(np.int32)
    d["clip_images"] = rs.randint(0, 255, (B, 32, 32, 3), np.uint8)
    d["clip_targets"] = rs.rand(B, 66).astype(np.float32)
    d["fork_images"] = rs.randint(0, 255, (8, 32, 32, 3), np.uint8)
    d["fork_targets"] = rs.rand(8, 66).astype(np.float32)
    return d


def vit_model(cfg: vvit.ViTConfig, device):
    """A classifier with the dry run's weights: drawn on the host from
    SEED, then moved to `device`."""
    gen = torch.Generator().manual_seed(SEED)
    return vvit.init_vit_params(vvit.empty_vit(cfg, "cpu"), gen).to(device)


def vit_step(device, images, labels, cfg: vvit.ViTConfig = VIT_TINY,
             **train):
    """One ``ViTTrainer`` step of a fresh `cfg` model on the global batch
    (this data rank's strided rows) in the mode the ViTTrainConfig fields
    `train` pick: (the global loss, the trainer, its momentum)."""
    from ..core.configs import ViTTrainConfig
    from ..train.vit_loop import ViTTrainer
    tcfg = ViTTrainConfig(batch_size=len(images), compute_dtype="float32",
                          image_size=cfg.image_size,
                          num_classes=cfg.num_classes,
                          moe_experts=cfg.moe_experts, **train)
    trainer = ViTTrainer(cfg, tcfg, vit_model(cfg, device), device)
    momentum = trainer.init_momentum()
    d, nd = trainer.data_rank, trainer.n_data
    loss = trainer.step(momentum, *trainer.place(images[d::nd],
                                                 labels[d::nd]), LR)
    return float(trainer.global_mean(loss)), trainer, momentum


class _Sections:
    """Runs the sections on this rank and keeps what they give."""

    def __init__(self, rank: int):
        self.rank = rank
        self.losses: dict = {}
        self.seconds: dict = {}
        self.checks: dict = {}
        self.fail = os.environ.get(FAIL_ENV)

    def run(self, name: str, fn):
        import torch.distributed as tdist
        if self.fail == name and self.rank == tdist.get_world_size() - 1:
            raise RuntimeError(f"planted failure in section {name} "
                               f"({FAIL_ENV})")
        t0 = time.time()
        out = fn()
        self.seconds[name] = time.time() - t0
        return out

    def loss(self, name: str, value) -> None:
        arr = np.asarray(value, np.float64)
        if not np.isfinite(arr).all():
            self.check(f"{name}_finite", False, f"{name} loss {value}")
        self.losses[name] = value

    def check(self, name: str, ok: bool, detail: str) -> None:
        self.checks[name] = {"ok": bool(ok), "detail": detail}

    def near(self, name: str, a: float, b: float, bound: float,
             what: str) -> None:
        self.check(name, abs(a - b) <= bound,
                   f"{what}: |{a!r} - {b!r}| = {abs(a - b):.3e} "
                   f"(bound {bound:g})")


def _fsdp_sharded(trainer, momentum, world: int) -> tuple[bool, str]:
    """Every parameter and momentum leaf a DTensor sharded on dim 0, and
    every leaf whose dim 0 the ranks divide holding 1/world of it."""
    from torch.distributed.tensor import DTensor, Shard
    from ..parallel import mesh as vmesh
    bad, even = [], 0
    leaves = list(trainer.model.named_parameters()) + [
        ("momentum." + n, m) for n, m in momentum.items()]
    for name, t in leaves:
        if not isinstance(t, DTensor) or tuple(t.placements) != (Shard(0),):
            bad.append(name)
        elif vmesh.zero1_sharding(world, t):
            even += 1
            if t.to_local().shape[0] * world != t.shape[0]:
                bad.append(name)
    return (not bad and even > 0,
            f"{len(leaves)} leaves, {even} of them 1/{world} shards"
            + (f"; not sharded: {bad[:4]}" if bad else ""))


def _flat_leaves(tree: dict, prefix: str = "") -> list:
    out = []
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out += _flat_leaves(v, name + ".")
        elif isinstance(v, torch.Tensor):
            out.append((name, v))
    return out


def _own_shards_only(path: str, tree: dict, rank: int) -> tuple[bool, str]:
    """Whether this rank's file of a ``save_sharded`` directory holds its
    own chunk of every DTensor leaf of `tree` and no other rank's: by the
    metadata (which file holds each chunk) and by the bytes (its chunks'
    bytes are in the file, the other ranks' are not; all-zero chunks are
    left out of the byte test). A collective (it gathers each DTensor)."""
    from torch.distributed.tensor import DTensor
    from ..ckpt import serialization as ser
    from ..parallel import dist
    where = {(f, o): name for name, items in ser.shard_files(path).items()
             for f, o in items}
    mine, others, problems = set(), [], []
    for fqn, t in _flat_leaves(tree):
        if not isinstance(t, DTensor):
            continue
        chunks = dist.full_tensor(t).cpu().chunk(t.device_mesh.size())
        off = 0
        for r, c in enumerate(chunks):
            key = (fqn, (off,) + (0,) * (c.ndim - 1))
            off += c.shape[0]
            if r == rank:
                mine.add(where.get(key))
                local = t.to_local().detach().cpu()
                if not torch.equal(local, c):
                    problems.append(f"{fqn}: local shard is not chunk {r}")
            elif c.numel() and c.any():
                others.append(c)
            if key not in where:
                problems.append(f"{fqn}: chunk at {key[1]} not in metadata")
    if len(mine) != 1 or None in mine:
        return False, f"own chunks in files {sorted(map(str, mine))}"
    fname = mine.pop()
    with open(os.path.join(path, fname), "rb") as f:
        data = f.read()
    own = [t.to_local().detach().cpu().contiguous()
           for _, t in _flat_leaves(tree) if isinstance(t, DTensor)]
    missing = sum(1 for c in own if c.numel() and c.any()
                  and c.numpy().tobytes() not in data)
    leaked = sum(1 for c in others if c.contiguous().numpy().tobytes()
                 in data)
    if missing or leaked or problems:
        return False, (f"{fname}: {missing} own chunks missing, {leaked} "
                       f"other ranks' chunks present; {problems[:3]}")
    return True, (f"{fname}: {len(data)} bytes, its {len(own)} chunks, "
                  f"none of the other ranks' {len(others)}")


def _ckpt_round_trip(sec: _Sections, out_dir: str, rank: int,
                     states: dict) -> dict:
    """Each (trainer, momentum) of `states` through the sharded checkpoint
    and back into zeroed leaves of the same placement."""
    from torch.distributed.tensor import DTensor
    from ..ckpt import vit_ckpt
    info = {}
    for epoch, (name, (trainer, momentum, loss)) in enumerate(
            states.items()):
        params, mom = trainer.sharded_state(momentum)
        sched = {"last_epoch": epoch + 1, "base_lr": LR}
        path = vit_ckpt.save_checkpoint(
            epoch, params, mom, sched, loss, 0.0, 0.0,
            os.path.join(out_dir, "ckpt"), sharded=True)
        own, detail = _own_shards_only(path, {"params": params,
                                             "opt_state": mom}, rank)
        sec.check(f"ckpt_{name}_own_shards", own, detail)
        template = {"params": {k: torch.zeros_like(v)
                               for k, v in params.items()},
                    "opt_state": {k: torch.zeros_like(v)
                                  for k, v in mom.items()}}
        back = vit_ckpt.load_checkpoint(path, template=template)

        def local(t):
            return t.to_local() if isinstance(t, DTensor) else t
        unequal = [f"{tree}.{k}" for tree, src in (("params", params),
                                                   ("opt_state", mom))
                   for k, v in src.items()
                   if not torch.equal(local(back[tree][k]), local(v))]
        extras = (back["epoch"], back["scheduler_state"], back["train_loss"])
        sec.check(f"ckpt_{name}_bit_equal",
                  not unequal and extras == (epoch, sched, loss),
                  f"{len(params) + len(mom)} leaves, unequal {unequal[:4]}; "
                  f"epoch, scheduler, loss {extras}")
        files = sorted(f for f in os.listdir(path) if f.endswith(".distcp"))
        info[name] = {"bytes": {f: os.path.getsize(os.path.join(path, f))
                                for f in files}}
    return info


def _worker(n: int, device: str, out_dir: str, oracle: bool) -> None:
    """One rank of a launch: the sections (only dp for the oracle), then
    rank 0 writes the report to `out_dir`/report.json; raises if a check
    failed."""
    import faulthandler
    import torch.distributed as tdist
    from ..ops import attention as vattn

    faulthandler.enable()
    tdist.init_process_group("gloo")
    rank, world = tdist.get_rank(), tdist.get_world_size()
    dev = torch.device(device)
    if dev.type == "cuda":
        # every rank on the one card the launch shares
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    vattn.reset_launch_counts()
    sec = _Sections(rank)
    d = _draws(n)
    images, labels = d["images"], d["labels"]

    loss, dp_tr, dp_mom = sec.run(
        "dp", lambda: vit_step(dev, images, labels, grad_accum=2,
                               zero1=True))
    sec.loss("dp", loss)
    info = {"n": n, "world": world, "device": str(dev)}
    if not oracle:
        floss, f_tr, f_mom = sec.run(
            "fsdp", lambda: vit_step(dev, images, labels, fsdp=True))
        sec.loss("fsdp", floss)
        sec.near("fsdp_vs_dp", floss, loss, LOSS_ATOL, "fsdp vs dp")
        sec.check("fsdp_sharded", *_fsdp_sharded(f_tr, f_mom, world))
        info["ckpt"] = sec.run("ckpt", lambda: _ckpt_round_trip(
            sec, out_dir, rank, {"dp_zero1": (dp_tr, dp_mom, loss),
                                 "fsdp": (f_tr, f_mom, floss)}))
        del f_tr, f_mom
        _clip_sections(sec, d, dev, n)
        if n >= 4:
            _mesh_sections(sec, d, dev, n, loss)
    del dp_tr, dp_mom
    launches = [None] * world
    tdist.all_gather_object(launches, {k: v for k, v in vattn.LAUNCHES.items()
                                       if k.startswith("flash3")})
    if rank == 0:
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump({**info, "losses": sec.losses, "seconds": sec.seconds,
                       "checks": sec.checks, "launches": launches}, f)
    tdist.barrier()
    tdist.destroy_process_group()
    failed = {k: c["detail"] for k, c in sec.checks.items() if not c["ok"]}
    if failed:
        raise RuntimeError(f"rank {rank}: checks failed: {failed}")


def _clip_sections(sec, d, dev, n) -> None:
    """Sections 3, 4 and (n >= 4) 6: the CLIP-HBA DoRA step over the data
    mesh, R = n forks of its adapters, and the visual tower's ring sp."""
    from ..adapters import dora as adora
    from ..core.prng import Key
    from ..models import clip as vclip
    from ..parallel import mesh as vmesh
    from ..train.clip_loop import ClipHBATrainer
    cfg = vclip.tiny_clip_config(**CLIP_TINY)
    model = vclip.init_clip_weights_(vclip.empty_clip(cfg, "cpu"),
                                     torch.Generator().manual_seed(SEED))
    spec = adora.dora_spec(cfg.visual.layers, cfg.text.layers, 1, 1)
    init, static, acfg = adora.apply_dora(
        model, spec, r=4, generator=torch.Generator().manual_seed(1))
    model = model.to(dev)
    B = len(d["clip_images"])

    def trainer(mesh, **sp):
        return ClipHBATrainer(cfg, model, acfg, static, d["prompts"],
                              lr=3e-4, compute_dtype=torch.float32,
                              mesh=mesh, **sp)

    def step(tr, adapters, opt):
        imgs, tgts = tr.upload_dataset(d["clip_images"], d["clip_targets"])
        return tr.train_step(adapters, opt, imgs, tgts, np.arange(B),
                             Key.root(2), perturb_type="random_target",
                             perturb_key=Key.root(3), batch_size=B)

    ctr = trainer(vmesh.make_mesh())
    adapters = adora.make_trainable(init, dev)
    opt = ctr.init_optimizer(adapters)
    closs, ok = sec.run("clip", lambda: step(ctr, adapters, opt))
    sec.loss("clip", closs)
    sec.check("clip_step_ok", ok, f"CLIP dp step ok={ok}")

    def forks():
        R = n
        ts = [adora.make_trainable(adapters, dev) for _ in range(R)]
        opts = []
        for t in ts:
            o = ctr.init_optimizer(t)
            o.load_state_dict(opt.state_dict())
            opts.append(o)
        imgs, tgts = ctr.upload_dataset(d["fork_images"], d["fork_targets"])
        idx = np.arange(len(d["fork_images"]))
        steps = []
        for s in range(2):
            losses, _ = ctr.train_step_forks(
                ts, opts, imgs, tgts, [idx] * R,
                [Key.root(i).fold_in(s) for i in range(R)],
                perturb_type="random_target",
                perturb_keys=[Key.root(100 + i).fold_in(s)
                              for i in range(R)],
                in_win=[True] * R, batch_size=len(idx))
            steps.append(losses)
        return np.asarray(steps).T.tolist()        # [R, 2]
    flosses = sec.run("forks", forks)
    sec.loss("forks", flosses)
    sec.check("forks_shape", np.shape(flosses) == (n, 2),
              f"fork losses shape {np.shape(flosses)}")
    if n >= 4:
        sptr = trainer(vmesh.make_mesh(n_model=2), sp=True, sp_ring=True)
        sp_adapters = adora.make_trainable(adapters, dev)
        sploss, ok = sec.run("clip_sp_ring", lambda: step(
            sptr, sp_adapters, sptr.init_optimizer(sp_adapters)))
        sec.loss("clip_sp_ring", sploss)
        sec.check("clip_sp_ring_ok", ok, f"CLIP sp ring step ok={ok}")


def _mesh_sections(sec, d, dev, n, dp_loss) -> None:
    """Sections 5, 7, 8 and 9 on (n/2, 2) meshes (section 6, CLIP's ring,
    runs with the other CLIP sections)."""
    images, labels = d["images"], d["labels"]
    width = VIT_TINY.width

    tloss, ttr, _ = sec.run("tp", lambda: vit_step(dev, images, labels,
                                                   tp_devices=2))
    sec.loss("tp", tloss)
    sec.near("tp_vs_dp", tloss, dp_loss, LOSS_ATOL, "tp vs dp")
    shapes = {tuple(b.attn.qkv.weight.shape) for b in ttr.model.blocks}
    sec.check("tp_qkv_split", shapes == {(3 * width // 2, width)},
              f"qkv weights {sorted(shapes)} a rank (whole: "
              f"{(3 * width, width)})")
    del ttr
    sp_loss = sec.run("sp", lambda: vit_step(dev, images, labels,
                                             sp_devices=2)[0])
    sec.loss("sp", sp_loss)
    ring = sec.run("sp_ring", lambda: vit_step(
        dev, images, labels, sp_devices=2, sp_ring=True)[0])
    sec.loss("sp_ring", ring)
    sec.near("ring_vs_gather", ring, sp_loss, LOSS_ATOL,
             "sp ring vs gather")
    sec.loss("ep", sec.run("ep", lambda: vit_step(
        dev, images, labels, cfg=MOE_TINY, ep_devices=2)[0]))
    pp = sec.run("pp", lambda: vit_step(dev, images[:n], labels[:n],
                                        pp_stages=2, pp_micro=2)[0])
    sec.loss("pp", pp)
    plain = sec.run("pp_oracle", lambda: vit_step(dev, images[:n],
                                                  labels[:n])[0])
    sec.loss("pp_oracle", plain)
    sec.near("pp_vs_unpipelined", pp, plain, LOSS_ATOL,
             f"pp vs the dp step at batch {n}")


# -- the launch -----------------------------------------------------------------

def _start(nproc: int, args: list, log: str) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if k not in _RENDEZVOUS}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    with open(log, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(nproc), "-m", _MODULE, *args],
            cwd=_ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
            start_new_session=True)


def _finish(proc: subprocess.Popen, deadline: float):
    """The launch's exit code, or None when it outlived `deadline` (then
    its whole session is killed)."""
    try:
        return proc.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        return None
    finally:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()


def dryrun_multichip(n_devices: int = 8, device="cuda",
                     timeout: float = LAUNCH_TIMEOUT) -> dict:
    """Run the dry run over `n_devices` gloo ranks on `device` and the
    one-process oracle beside it (module docstring); print the ranks'
    output, the JSON line and the summary; return the JSON's dict. Raises
    ``RuntimeError`` when a launch fails, outlives `timeout` seconds, or a
    check misses its bound."""
    dev = resolve_device(device)
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if n_devices >= 4 and n_devices % 2:
        raise ValueError(f"the (n/2, 2) mesh sections need an even n, got "
                         f"{n_devices}")
    t0 = time.time()
    if dev.type == "cuda":
        # the ranks' kernels, built once here rather than by every rank
        from ..ops import cuda_build
        cuda_build.build(["flash3_fwd", "flash3_bwd"])
    work = tempfile.mkdtemp(prefix="vit_dryrun_")
    runs = {"ranks": n_devices, "oracle": 1}
    try:
        procs = {}
        for name, nproc in runs.items():
            out = os.path.join(work, name)
            os.makedirs(out)
            procs[name] = _start(nproc, [
                "--worker", out, "--device", dev.type, str(n_devices)]
                + (["--oracle"] if name == "oracle" else []),
                os.path.join(work, f"{name}.log"))
        rcs = {name: _finish(p, t0 + timeout) for name, p in procs.items()}
        reports = {}
        for name in runs:
            with open(os.path.join(work, f"{name}.log")) as f:
                sys.stdout.write(f.read())
            path = os.path.join(work, name, "report.json")
            if os.path.exists(path):
                with open(path) as f:
                    reports[name] = json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    sys.stdout.flush()
    bad = {k: ("timed out" if rc is None else f"exit {rc}")
           for k, rc in rcs.items() if rc != 0}
    if len(reports) < len(runs):
        raise RuntimeError(f"dryrun_multichip({n_devices}) on {dev.type}: "
                           f"launch failed ({bad}); see the output above")
    rep, one = reports["ranks"], reports["oracle"]
    losses = rep["losses"]
    dp, single = losses["dp"], one["losses"]["dp"]
    checks = dict(rep["checks"])
    checks["oracle"] = {
        "ok": abs(dp - single) <= ORACLE_ATOL,
        "detail": f"{n_devices} ranks vs one process: |{dp!r} - {single!r}| "
                  f"= {abs(dp - single):.3e} (bound {ORACLE_ATOL:g})"}
    result = {"n": n_devices, "device": rep["device"],
              "losses": {**losses, "oracle": single},
              "seconds": {**rep["seconds"], "oracle": one["seconds"]["dp"],
                          "total": time.time() - t0},
              "checks": checks, "launches": rep["launches"],
              "oracle_launches": one["launches"], "ckpt": rep["ckpt"]}
    # the readings, also when a check missed its bound
    print(json.dumps(result), flush=True)
    missed = {k: c["detail"] for k, c in checks.items() if not c["ok"]}
    if missed or bad:
        raise RuntimeError(f"dryrun_multichip({n_devices}) on {dev.type}: "
                           f"checks missed {missed}; launches {bad or 'ok'}")
    print(f"dryrun_dp_loss_repr={dp!r}")
    parts = [f"ViT dp loss {dp:.4f} (fsdp equal, one-process oracle equal)",
             f"CLIP dp loss {losses['clip']:.4f}",
             f"{n_devices} forks x 2 lock-steps finite"]
    if n_devices >= 4:
        parts += [f"ViT tp+dp loss {losses['tp']:.4f}",
                  f"CLIP sp ring loss {losses['clip_sp_ring']:.4f}",
                  f"ViT sp+dp loss {losses['sp']:.4f} (ring equal)",
                  f"ViT ep+dp loss {losses['ep']:.4f}",
                  f"ViT pp+dp loss {losses['pp']:.4f} (oracle equal)"]
    print(f"dryrun_multichip({n_devices}): " + ", ".join(parts)
          + " (collective sharded ckpt round-trip OK) - OK", flush=True)
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="The multi-rank dry run: every "
                                            "parallel mode's step over N "
                                            "ranks at tiny shapes")
    p.add_argument("n", nargs="?", type=int, default=8,
                   help="ranks (default 8)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the ranks share cuda:0) or cpu")
    p.add_argument("--timeout", type=float, default=LAUNCH_TIMEOUT,
                   help="seconds the launches may take")
    # a rank of the launch dryrun_multichip makes
    p.add_argument("--worker", metavar="DIR", help=argparse.SUPPRESS)
    p.add_argument("--oracle", action="store_true", help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.worker:
        _worker(args.n, args.device, args.worker, args.oracle)
    else:
        dryrun_multichip(args.n, args.device, args.timeout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
