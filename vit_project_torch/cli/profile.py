"""Step profiler: a reproducible per-bucket device-time table of the
production ViT train step (counterpart of the JAX package's
cli/profile.py, with the same flags plus --device).

The reference has no profiler at all (coarse time.time() prints,
train_vit_sgd.py:130,159-163). This CLI runs the REAL train step
(``ViTTrainer.step``: the forward with the normalization folded into the
patch matmul, the backward, the SGD update) on a synthetic uint8 batch
already on the card: one warm-up step, then ``--steps`` steps under
``torch.profiler`` with CPU and CUDA activity (``core/profiling.trace``),
and prints

  - the per-bucket table (cuBLAS GEMMs / the dW+db kernel / the flash3
    attention forward and backward / elementwise and reduce kernels /
    copies / other) in device ms per step, in the JAX table's order and
    layout, and
  - the top-K kernels by self device time,

with the hand-written kernels' launches a step from their wrappers'
counters:

    python -m vit_project_torch.cli.profile --batch 256 --steps 3 --fused_dw

It needs the card: a trace with no CUDA device time raises. The
classification (``bucket_of``, ``summarize``, ``render``) is pure and
unit-tested on synthetic tables.

`--memory` is the planner. Eager PyTorch has no abstract lowering to read
buffer assignments from, so on the card it runs one real step at the
flags (``--remat``, ``--grad_accum``, ``--fsdp``, ``--zero1``; over
torchrun's ranks, and ``--fsdp`` / ``--zero1`` only under torchrun, as the
trainer rules: ``torchrun --nproc_per_node 1`` for one card) and prints
the per-rank arguments (parameters, momentum and batch, from the tensors
the rank holds: FSDP2's local shards, ZeRO-1's momentum rows) beside
``torch.cuda.max_memory_allocated`` / ``max_memory_reserved`` over a step
after ``reset_peak_memory_stats``. On the CPU (``--device cpu``) it prints
the argument rows and a note that the peak needs the card.
``--virtual_devices N`` plans N ranks from any host: the same rows from
parameter shapes on the ``meta`` device under the port's sharding rules
(ZeRO-1's row partition, ``parallel/mesh.zero1_sharding``; FSDP2's dim-0
chunks, the last ones short or empty), with no step and no re-exec:

    python -m vit_project_torch.cli.profile --memory --batch 64 \\
        --fsdp --virtual_devices 8

The per-rank rows are rank 0's, the largest share. They differ from the
JAX planner's arguments by design in three places: labels are int64 here
(int32 there), the learning rate is a Python float here (an f32 argument
there), and FSDP2 shards 1-D leaves and leaves whose leading axis the
ranks do not divide (rank 0 holding the first chunk) where JAX keeps them
whole; ZeRO-1's "leading axis" is the other dimension of a matrix in the
port's [out, in] layout.
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile

# bucket names, in the order of the JAX package's table (its labels mapped
# to what the port launches)
BUCKETS = ("cuBLAS GEMMs (fwd + dx; dW without --fused_dw)",
           "dW+db kernel + fix-up (dw_db, CUDA)",
           "attention kernels fwd (flash3, CUDA)",
           "attention kernels bwd (flash3, CUDA)",
           "elementwise/reduce (LayerNorm, GELU, casts, optimizer foreach)",
           "copies (memcpy/memset)",
           "other")

# substrings of a kernel's name, lower case, by bucket
_GEMM = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas",
         "splitkreduce")
_ELEMENTWISE = ("at::native", "elementwise", "reduce_kernel", "foreach",
                "multi_tensor", "softmax", "ln_fwd", "ln_bwd", "ln_sum_parts")


def bucket_of(name: str) -> str:
    """Classify one CUDA kernel, by its name as torch.profiler reports it,
    into a bucket:

    - the dW+db kernel's routes and its fix-up (csrc/dw_db.cu:
      ``dw_db_tma_kernel``, ``dw_db_mma_kernel``, ``dw_db_fma_kernel``,
      ``dw_db_fixup_kernel``);
    - the attention forward (csrc/flash3_fwd.cu: ``attn_fwd_bf16_kernel``,
      the whole-head ``attn_fwd_head_bf16_kernel``, ``attn_fwd_f32_kernel``)
      and backward (csrc/flash3_bwd.cu: ``attn_bwd_dq_*``,
      ``attn_bwd_dkv_*``, the whole-head ``attn_bwd_head_bf16_kernel``);
    - cuBLAS / cuBLASLt products (``nvjet_*``, ``sm90_xmma_gemm_*``,
      CUTLASS kernels, gemv, the split-K reduction);
    - memcpy / memset;
    - PyTorch's own kernels (``at::native::``: LayerNorm, GELU, casts and
      copies, reductions, the optimizer's foreach; the loss's
      ``softmax_warp_*`` outside that namespace) and the port's LayerNorm
      kernels;
    - anything else (collectives among them)."""
    n = name.lower()
    if "dw_db" in n:
        return BUCKETS[1]
    if "attn_fwd" in n:
        return BUCKETS[2]
    if "attn_bwd" in n:
        return BUCKETS[3]
    if any(k in n for k in _GEMM):
        return BUCKETS[0]
    if n.startswith(("memcpy", "memset")):
        return BUCKETS[5]
    if any(k in n for k in _ELEMENTWISE):
        return BUCKETS[4]
    return BUCKETS[6]


def device_rows(events) -> list:
    """torch.profiler ``key_averages()`` -> [(kernel name, count, self
    device µs)] of the CUDA-side events (kernels, memcpy, memset); the CPU
    ops, whose device time repeats their kernels', are left out."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.key, int(e.count), float(e.self_device_time_total))
            for e in events if e.device_type == cuda]


def summarize(rows, steps: int):
    """[(name, count, self µs)] -> (bucket table, top kernels).

    Returns ({bucket: {"ms": per-step ms, "ops": n}}, [(self_ms, count,
    bucket, name), ...] sorted desc); "ops" counts the distinct kernels of
    a bucket. A missing count or time reads as 0."""
    table = {b: {"ms": 0.0, "ops": 0} for b in BUCKETS}
    tops = []
    for name, count, self_us in rows:
        b = bucket_of(name)
        ms = float(self_us or 0.0) / 1000.0 / max(steps, 1)
        table[b]["ms"] += ms
        table[b]["ops"] += 1
        tops.append((ms, int(count or 0), b, name))
    tops.sort(reverse=True)
    return table, tops


def render(table, tops, steps: int, batch: int, top_k: int) -> str:
    total = sum(v["ms"] for v in table.values())
    lines = [f"per-step device time ({steps} traced steps, batch {batch}):",
             "",
             "| bucket | ms/step | % | ops |",
             "|---|---|---|---|"]
    for b in BUCKETS:
        v = table[b]
        if v["ops"] == 0:
            continue
        lines.append(f"| {b} | {v['ms']:.2f} | "
                     f"{100 * v['ms'] / max(total, 1e-9):.1f}% | {v['ops']} |")
    lines.append(f"| **total** | **{total:.2f}** | 100% | "
                 f"{sum(v['ops'] for v in table.values())} |")
    if total > 0:
        lines.append("")
        lines.append(f"device-bound throughput bound: "
                     f"{batch / (total / 1000.0):.1f} img/s "
                     f"(batch {batch} / {total:.1f} ms)")
    if top_k > 0:
        lines.append("")
        lines.append(f"top {top_k} ops by self time:")
        for ms, occ, b, name in tops[:top_k]:
            lines.append(f"  {ms:8.3f} ms  x{occ:<4d} [{b.split(' (')[0]}] "
                         f"{name}")
    return "\n".join(lines)


def _mib(n: float) -> str:
    return f"{n / (1 << 20):,.1f} MiB"


def tree_bytes(tensors) -> int:
    """Bytes of the tensors' elements (the local shard of a DTensor)."""
    total = 0
    for t in tensors:
        t = t.to_local() if hasattr(t, "to_local") else t
        total += t.numel() * t.element_size()
    return total


def render_memory(stats: dict, n_ranks: int, global_bytes: dict) -> str:
    """Per-rank bytes + global tree sizes -> the planning table. `stats`
    holds "params", "momentum", "batch" and "arguments" (their sum), and
    "peak_allocated" / "peak_reserved" where a step on the card measured
    them (None otherwise: no row)."""
    lines = [f"per-rank memory of one step (one process a device, over "
             f"{n_ranks} rank(s); rank 0's share):",
             "",
             "| buffer class | bytes/rank |",
             "|---|---|",
             f"| arguments (params + momentum + batch) | "
             f"{_mib(stats['arguments'])} |",
             f"| params | {_mib(stats['params'])} |",
             f"| momentum | {_mib(stats['momentum'])} |",
             f"| batch (uint8 images + int64 labels) | "
             f"{_mib(stats['batch'])} |"]
    if stats.get("peak_allocated") is not None:
        lines += [f"| **peak allocated** (max_memory_allocated) | "
                  f"**{_mib(stats['peak_allocated'])}** |",
                  f"| peak reserved (max_memory_reserved) | "
                  f"{_mib(stats['peak_reserved'])} |"]
    lines += ["", "global (unsharded) tree sizes for reference:"]
    for name, b in global_bytes.items():
        lines.append(f"  {name}: {_mib(b)} ({_mib(b / n_ranks)}/device if "
                     "fully sharded)")
    return "\n".join(lines)


def _vit_cfg(model: str):
    from ..models import vit as vvit
    return vvit.VIT_CONFIGS[model]


def _batch_bytes(vit_cfg, batch: int) -> int:
    """uint8 images [batch, side, side, 3] and int64 labels [batch]."""
    return batch * (vit_cfg.image_size ** 2 * 3 + 8)


def _global_bytes(vit_cfg, batch: int, n: int, param_bytes: int) -> dict:
    return {"params": param_bytes, "momentum": param_bytes,
            "batch (uint8 images + labels)": _batch_bytes(vit_cfg,
                                                          batch * n)}


def _meta_params(model: str) -> list:
    """The classifier's parameters on the meta device (shapes, no data)."""
    import torch
    from ..models import vit as vvit
    with torch.device("meta"):
        return list(vvit.VisionTransformerClassifier(
            _vit_cfg(model)).parameters())


def _rows_of_rank(d0: int, n: int, rank: int) -> int:
    """Rows of a leading axis of `d0` that rank `rank` of `n` holds under
    FSDP2: torch.chunk's split, ceil(d0 / n) a rank, the last ones short
    or empty."""
    per = -(-d0 // n)
    return max(0, min(per, d0 - rank * per))


def plan_memory(model: str, batch: int, n: int, *, fsdp=False, zero1=False,
                rank: int = 0):
    """The per-rank arguments of the train step over `n` ranks from the
    parameters' shapes on the meta device (no tensor allocated, no step):
    (stats, n, global_bytes) as ``render_memory`` takes them. fsdp wins
    over zero1, as in the trainer."""
    from ..parallel import mesh as vmesh
    vit_cfg = _vit_cfg(model)
    params = _meta_params(model)
    full = tree_bytes(params)
    if fsdp:
        held = sum(_rows_of_rank(p.shape[0], n, rank) * (p.numel()
                   // p.shape[0]) * p.element_size() for p in params)
        mine = {"params": held, "momentum": held}
    elif zero1:
        mom = sum(p.numel() // (n if vmesh.zero1_sharding(n, p) else 1)
                  * p.element_size() for p in params)
        mine = {"params": full, "momentum": mom}
    else:
        mine = {"params": full, "momentum": full}
    mine["batch"] = _batch_bytes(vit_cfg, batch)
    mine["arguments"] = sum(mine.values())
    return mine, n, _global_bytes(vit_cfg, batch, n, full)


def _trainer(model: str, batch: int, device, *, compute_dtype, remat=False,
             grad_accum=1, fused_dw=False, fsdp=False, zero1=False):
    """(trainer, momentum, images, labels): seeded ViT weights on
    `device`, the trainer of this process's mode (FSDP2 shards the model in
    place), its momentum, and a seeded uint8 batch of `batch` images on the
    device (``ViTTrainer.place``)."""
    import numpy as np
    import torch
    from ..core.configs import ViTTrainConfig
    from ..models import vit as vvit
    from ..train.vit_loop import ViTTrainer
    vit_cfg = _vit_cfg(model)
    tcfg = ViTTrainConfig(batch_size=batch, compute_dtype=compute_dtype,
                          remat=remat, grad_accum=grad_accum,
                          fused_dw=fused_dw, fsdp=fsdp, zero1=zero1,
                          image_size=vit_cfg.image_size,
                          num_classes=vit_cfg.num_classes or 1000)
    gen = torch.Generator(device=device).manual_seed(0)
    net = vvit.init_vit_params(vvit.empty_vit(vit_cfg, device), gen)
    trainer = ViTTrainer(vit_cfg, tcfg, net, device)
    momentum = trainer.init_momentum()
    rs = np.random.RandomState(0)
    side = vit_cfg.image_size
    images = rs.randint(0, 255, (batch, side, side, 3), np.uint8)
    labels = rs.randint(0, vit_cfg.num_classes or 1000, batch)
    imgs, lbls = trainer.place(images, labels)
    return trainer, momentum, imgs, lbls


def analyze_memory(model: str, batch: int, *, compute_dtype="bfloat16",
                   remat=False, grad_accum=1, fsdp=False, zero1=False,
                   device="cuda"):
    """The train step's per-rank memory at the given flags, on `device`
    over this process's ranks: (stats, n_ranks, global_bytes). The
    arguments are the tensors this rank holds; on the card one warm-up
    step runs, then the peaks are reset and read over a second step. On
    the CPU no step runs and the peaks are None."""
    import torch
    from ..core.device import resolve_device
    from ..parallel import dist
    dev = resolve_device(dist.local_device(device))
    with dist.process_group(dev) as (_, n):
        trainer, momentum, imgs, lbls = _trainer(
            model, batch, dev, compute_dtype=compute_dtype, remat=remat,
            grad_accum=grad_accum, fsdp=fsdp, zero1=zero1)
        params = tree_bytes(trainer.model.parameters())
        stats = {"params": params,
                 "momentum": tree_bytes(momentum.values()),
                 "batch": tree_bytes([imgs, lbls]),
                 "peak_allocated": None, "peak_reserved": None}
        stats["arguments"] = (stats["params"] + stats["momentum"]
                              + stats["batch"])
        if dev.type == "cuda":
            trainer.step(momentum, imgs, lbls, 0.1)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            trainer.step(momentum, imgs, lbls, 0.1)
            torch.cuda.synchronize(dev)
            stats["peak_allocated"] = torch.cuda.max_memory_allocated(dev)
            stats["peak_reserved"] = torch.cuda.max_memory_reserved(dev)
        return stats, n, _global_bytes(_vit_cfg(model), batch, n,
                                       tree_bytes(_meta_params(model)))


def _flags(args) -> str:
    flags = [f for f, on in (("remat", args.remat), ("fsdp", args.fsdp),
                             ("zero1", args.zero1)) if on]
    if args.grad_accum > 1:
        flags.append(f"grad_accum={args.grad_accum}")
    return f", {'+'.join(flags)}" if flags else ""


def _memory_main(args) -> int:
    from ..parallel import dist
    if args.virtual_devices:
        stats, n, global_bytes = plan_memory(
            args.model, args.batch, args.virtual_devices, fsdp=args.fsdp,
            zero1=args.zero1)
    else:
        stats, n, global_bytes = analyze_memory(
            args.model, args.batch, compute_dtype=args.compute_dtype,
            remat=args.remat, grad_accum=args.grad_accum, fsdp=args.fsdp,
            zero1=args.zero1, device=args.device)
    if not dist.is_primary():
        return 0
    print(f"{args.model} train step, global batch {args.batch * n}, "
          f"{args.compute_dtype}" + _flags(args))
    print(render_memory(stats, n, global_bytes))
    if args.raw:
        with open(args.raw, "w") as f:
            json.dump({"n_ranks": n, **stats, "global": global_bytes}, f)
    if args.virtual_devices:
        print(f"\nNOTE: planned for {n} ranks from parameter shapes on the "
              "meta device (no tensor allocated, no step): the peak needs "
              "a step on the card.")
    elif stats["peak_allocated"] is None:
        print("\nNOTE: on the CPU the arguments are the tensors this rank "
              "holds and no step runs: the peak needs the card's "
              "allocator (run with --device cuda).")
    return 0


def _launches() -> dict:
    from ..ops import attention as vattn
    from ..ops import fused_dw as vfdw
    return {k: v for k, v in {**vattn.LAUNCHES, **vfdw.LAUNCHES}.items()
            if k in ("flash3_fwd", "flash3_bwd", "dw_db")}


def _trace_main(args) -> int:
    import torch
    from ..core.device import resolve_device
    from ..core.profiling import trace
    from ..parallel import dist
    dev = resolve_device(dist.local_device(args.device))
    with dist.process_group(dev) as (_, world):
        trainer, momentum, imgs, lbls = _trainer(
            args.model, args.batch, dev, compute_dtype=args.compute_dtype,
            remat=args.remat, grad_accum=args.grad_accum,
            fused_dw=args.fused_dw)
        # warm: kernel libraries loaded, cuBLAS handles and the allocator's
        # pool in place (a host read of the loss waits for the step)
        loss = trainer.step(momentum, imgs, lbls, 0.1)
        float(loss)
        trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="vitprof_")
        try:
            before = _launches()
            with trace(trace_dir) as prof:
                acc = loss * 0
                for _ in range(args.steps):
                    acc = acc + trainer.step(momentum, imgs, lbls, 0.1)
                float(acc)  # one sync depending on every traced step
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            per_step = {k: (v - before[k]) / args.steps
                        for k, v in _launches().items()}
            rows = device_rows(prof.key_averages())
            if args.raw and dist.is_primary():
                with open(args.raw, "w") as f:
                    json.dump([{"name": n, "count": c, "self_device_us": us}
                               for n, c, us in rows], f)
            table, tops = summarize(rows, args.steps)
            if sum(v["ms"] for v in table.values()) <= 0:
                raise RuntimeError(
                    f"no CUDA device time in the trace of the step on "
                    f"{dev}: the profiler needs the card (torch.profiler's "
                    f"CUDA activity)")
            if dist.is_primary():
                print(render(table, tops, args.steps, args.batch * world,
                             args.top))
                print("\nkernel launches a step (the wrappers' counters): "
                      + ", ".join(f"{k} {v:g}" for k, v in per_step.items()))
        finally:
            # a failed table must not leak the capture (tens of MB for a
            # real step) when the directory is ours
            if args.trace_dir:
                if dist.is_primary():
                    print(f"\ntrace kept at {trace_dir} "
                          f"(tensorboard --logdir {trace_dir})")
            else:
                shutil.rmtree(trace_dir, ignore_errors=True)
    return 0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="vit_base_patch16_224",
                   help="name from models.vit.VIT_CONFIGS")
    p.add_argument("--batch", type=int, default=256,
                   help="images a rank (the global batch is batch x ranks)")
    p.add_argument("--steps", type=int, default=3,
                   help="steps inside the trace window (after 1 warmup)")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--trace_dir", default=None,
                   help="where to write the trace (kept for TensorBoard); "
                        "default: a temp dir, deleted after the table")
    p.add_argument("--top", type=int, default=12,
                   help="also list the top-K kernels by self time (0 = off)")
    p.add_argument("--raw", default=None,
                   help="dump the raw table as JSON to this path: the "
                        "device events (name, count, self µs), or with "
                        "--memory the byte counts")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--fused_dw", action="store_true",
                   help="route the dense layers' dW and db through the "
                        "fused CUDA kernel (ops/fused_dw.py)")
    p.add_argument("--memory", action="store_true",
                   help="print the step's per-rank memory (arguments, and "
                        "on the card the allocator's peak) instead of the "
                        "time table")
    p.add_argument("--fsdp", action="store_true",
                   help="analyze the FSDP2 step (params + momentum "
                        "sharded over the ranks; --memory mode)")
    p.add_argument("--zero1", action="store_true",
                   help="analyze the ZeRO-1 step (momentum sharded over "
                        "the ranks; --memory mode)")
    p.add_argument("--virtual_devices", type=int, default=None,
                   help="with --memory: plan N ranks from parameter shapes "
                        "(any host, no step)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; under torchrun the rank's card) "
                        "or cpu (--memory's argument rows only)")
    return p.parse_args(argv)


def main(argv=None):
    import sys
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = parse_args(argv)
    if args.steps < 1:
        raise SystemExit("--steps must be at least 1")
    if args.virtual_devices and not args.memory:
        raise SystemExit("--virtual_devices is a --memory planning option "
                         "(tracing needs real devices)")
    if args.memory:
        return _memory_main(args)
    if args.fsdp or args.zero1:
        raise SystemExit("--fsdp/--zero1 profiling applies to --memory mode; "
                         "trace mode runs the plain dp step")
    return _trace_main(args)


if __name__ == "__main__":
    raise SystemExit(main())
