"""ViT-B/16 ImageNet training entry point (counterpart of the JAX package's
cli/vit_train.py, with the same flags plus --device).

Reference: Training/vit_training/baseline/train_vit_sgd.py (torchrun/DDP).
Alone, one process trains on one card (or on --device). Under torchrun each
rank joins the process group (NCCL on its card, cuda:LOCAL_RANK; gloo with
--device cpu) and trains data-parallel: dp by default, --zero1 shards the
momentum, --fsdp the parameters and the momentum (FSDP2); --tp_devices T
shards the blocks over model groups of T consecutive ranks (Megatron
tensor parallelism; the ranks of a group read the same data); with
--moe_experts N every other block's MLP is a MoE of N experts, and
--ep_devices E shards them over expert groups of E consecutive ranks;
--sp_devices N shards each image's tokens over model groups of N
consecutive ranks (sequence parallelism: the gather form on the flash
kernels, or ring attention with --sp_ring); --pp_stages S splits the
blocks over stage groups of S consecutive ranks (GPipe pipeline
parallelism, --pp_micro M microbatches a step; a stage group reads one data
shard). --batch_size is the global batch. --fused_dw
(no JAX flag; JAX's ViTTrainConfig field) routes the dense layers' dW and
db through the fused kernel, one process only. --profile_dir writes a
torch.profiler trace of the first epoch. Exits 143 when a SIGTERM stopped
the run (run it again to resume).

  python -m vit_project_torch.cli.vit_train --data_path imagenet/ \\
      --output_dir runs/vit_b16
  torchrun --nproc_per_node 4 -m vit_project_torch.cli.vit_train \\
      --data_path imagenet/ --output_dir runs/vit_b16 --batch_size 512
  torchrun --nproc_per_node 4 -m vit_project_torch.cli.vit_train \\
      --data_path imagenet/ --output_dir runs/vit_b16_tp --tp_devices 2
  torchrun --nproc_per_node 4 -m vit_project_torch.cli.vit_train \\
      --data_path imagenet/ --output_dir runs/vit_moe --moe_experts 8 \\
      --ep_devices 2
  torchrun --nproc_per_node 2 -m vit_project_torch.cli.vit_train \\
      --data_path imagenet/ --output_dir runs/vit_sp --sp_devices 2 \\
      [--sp_ring]
  torchrun --nproc_per_node 2 -m vit_project_torch.cli.vit_train \\
      --data_path imagenet/ --output_dir runs/vit_pp --pp_stages 2 \\
      --pp_micro 4
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from ..core.configs import ViTTrainConfig
from ..parallel import dist
from ..train.vit_loop import run_vit_training


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train ViT-Base on ImageNet "
                                            "(PyTorch / CUDA)")
    p.add_argument("--data_path", type=str, required=True,
                   help="Path to ImageNet data (train/ + val/ ImageFolders)")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=256,
                   help="global batch size (split over the ranks); the "
                        "reference's 256/GPU x 2 GPUs = --batch_size 512")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--warmup_epochs", type=int, default=5)
    p.add_argument("--random_seed", type=int, default=0)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--backbone", default="vit_base_patch16_224",
                   help="model config name (see models.vit.VIT_CONFIGS)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the first epoch "
                        "here")
    p.add_argument("--use_native_loader", action="store_true",
                   help="decode/augment through the C++ core "
                        "(native/libfastimage.so; build with: make -C native)")
    p.add_argument("--data_echo", type=int, default=1,
                   help="repeat each decoded train batch N times — mitigation "
                        "when host decode cannot feed the device step rate")
    p.add_argument("--remat", action="store_true",
                   help="recompute each transformer block in the backward "
                        "(O(1)-block activation memory for ~1/3 extra "
                        "FLOPs) — for batch sizes/models whose activations "
                        "outgrow device memory")
    p.add_argument("--pp_stages", type=int, default=1,
                   help="partition the block depth over N pipeline stages "
                        "of a ('data','stage') mesh (GPipe schedule, "
                        "parallel/pipeline.py; under torchrun, N consecutive "
                        "ranks a stage group); 1 = plain data parallelism")
    p.add_argument("--pp_micro", type=int, default=1,
                   help="microbatches per pipelined step (with --pp_stages; "
                        "bubble (S-1)/(M+S-1) — use >= 4*stages)")
    p.add_argument("--device_prefetch", type=int, default=2,
                   help="lookahead depth: copy batch k+1 to the card on a "
                        "feeder thread while batch k trains; 0 disables")
    p.add_argument("--zero1", action="store_true",
                   help="shard the SGD momentum over the ranks (ZeRO-1)")
    p.add_argument("--tp_devices", type=int, default=1,
                   help="Megatron tensor parallelism: block weights sharded "
                        "over the 'model' axis of a ('data','model') mesh "
                        "(head-aligned qkv; one all-reduce per block); "
                        "checkpoints stay flat so dp and tp runs resume "
                        "each other; must divide the model heads")
    p.add_argument("--fsdp", action="store_true",
                   help="shard params and momentum over the ranks (FSDP2)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="split each batch into N gradient microbatches "
                        "inside one step: peak activation memory = one "
                        "microbatch, same numbers as the unsplit step")
    p.add_argument("--host_prefetch", action="store_true",
                   help="copy the per-epoch checkpoint trees to the host "
                        "asynchronously, beside validation "
                        "(core/hostcopy.py)")
    p.add_argument("--sp_devices", type=int, default=1,
                   help="sequence parallelism: each image's tokens sharded "
                        "over the 'model' axis of a ('data','model') mesh; "
                        "attention gathers the packed qkv along the "
                        "sequence (the flash kernels on the whole "
                        "sequence); checkpoints stay flat")
    p.add_argument("--sp_ring", action="store_true",
                   help="with --sp_devices: ring attention (k/v rotate "
                        "around the sequence shards, one hop a step) "
                        "instead of the gather")
    p.add_argument("--moe_experts", type=int, default=0,
                   help="replace every other block's MLP with a Switch "
                        "top-1 MoE of N experts (ops/moe.py; "
                        "beyond-reference model variant)")
    p.add_argument("--moe_topk", type=int, default=1, choices=[1, 2],
                   help="MoE routing: 1 = Switch top-1, 2 = GShard top-2 "
                        "(combine weights renormalized over the pair)")
    p.add_argument("--moe_capacity", type=float, default=1.25,
                   help="per-expert capacity factor (scaled by topk "
                        "GShard-style; over-capacity tokens are dropped "
                        "onto the residual)")
    p.add_argument("--ep_devices", type=int, default=1,
                   help="expert parallelism: shard the MoE expert FFNs over "
                        "N ranks of a ('data','expert') mesh (needs "
                        "--moe_experts and torchrun); 1 = off")
    p.add_argument("--keep_last", type=int, default=0,
                   help="delete per-epoch checkpoints older than the last N "
                        "after each save (0 = keep all, the default — sweep "
                        "forks and the measurement grid restore arbitrary "
                        "epochs)")
    p.add_argument("--no_preempt_save", action="store_true",
                   help="disable the SIGTERM mid-epoch checkpoint "
                        "(core/preempt.py); by default a preemption notice "
                        "saves checkpoint_preempt.pth and exits 143, and "
                        "the next invocation resumes inside the epoch")
    p.add_argument("--fused_dw", action="store_true",
                   help="dense-layer dW and db through the fused kernel "
                        "(ops/fused_dw.py); one process only")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on ('cpu' for tests, gloo "
                        "under torchrun); under torchrun 'cuda' is the "
                        "rank's card")
    return p


def main(argv=None):
    from ..models.vit import VIT_CONFIGS
    args = build_parser().parse_args(argv)
    vit_cfg = VIT_CONFIGS[args.backbone]
    if args.moe_experts > 0:
        vit_cfg = dataclasses.replace(vit_cfg, moe_experts=args.moe_experts,
                                      moe_topk=args.moe_topk,
                                      moe_capacity=args.moe_capacity)
    cfg = ViTTrainConfig(
        data_path=args.data_path, output_dir=args.output_dir,
        batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
        momentum=args.momentum, weight_decay=args.weight_decay,
        num_workers=args.num_workers, warmup_epochs=args.warmup_epochs,
        random_seed=args.random_seed, compute_dtype=args.compute_dtype,
        image_size=vit_cfg.image_size,
        num_classes=vit_cfg.num_classes or 1000,
        profile_dir=args.profile_dir,
        use_native_loader=args.use_native_loader, remat=args.remat,
        data_echo=args.data_echo,
        pp_stages=args.pp_stages, pp_micro=args.pp_micro,
        grad_accum=args.grad_accum, device_prefetch=args.device_prefetch,
        zero1=args.zero1, fsdp=args.fsdp, tp_devices=args.tp_devices,
        host_prefetch=args.host_prefetch,
        sp_devices=args.sp_devices, sp_ring=args.sp_ring,
        ep_devices=args.ep_devices, moe_experts=args.moe_experts,
        moe_topk=args.moe_topk, preempt_save=not args.no_preempt_save,
        keep_last=args.keep_last, fused_dw=args.fused_dw)
    device = dist.local_device(args.device)
    with dist.process_group(device):
        result = run_vit_training(cfg, vit_cfg=vit_cfg, device=device)
    if result.get("preempted"):
        # conventional SIGTERM exit status: orchestration layers (and the
        # reference's SLURM habit of requeueing nonzero exits) see the run
        # as interrupted, not finished
        sys.exit(143)


if __name__ == "__main__":
    main()
