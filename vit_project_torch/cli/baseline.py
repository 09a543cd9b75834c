"""CLIP-HBA behavioral baseline training entry point (counterpart of the JAX
package's cli/baseline.py, with the same flags plus --device).

Reference: Training/clip_behavioral_finetuning/baseline/clip_train_behavior_baseline.py
— a literal config dict handed to run_behavioral_training. Same defaults
(ViT-L/14, 500 epochs, bs 64, lr 3e-4, patience 20, seed 1, DoRA rank 32 on
the last 2 vision + 1 text layers, MSE), overridable from the command line.
Runs on the GPU unless --device says otherwise; exits 143 when a SIGTERM
stopped the run at an epoch boundary (resume it in place). Under torchrun
the run is data-parallel over the ranks (one per GPU, NCCL; `--device cpu`
takes gloo), `--batch_size` is the global batch and rank 0 writes every
file; `--sp_devices N` makes model groups of N consecutive ranks that
shard the visual tower's tokens (sequence parallelism; `--sp_ring` for
ring attention), each group reading one data shard:

  torchrun --standalone --nproc_per_node 2 -m vit_project_torch.cli.baseline \
      ... (the flags above) [--sp_devices 2 [--sp_ring]]

  python -m vit_project_torch.cli.baseline --csv_file spose_train.csv \\
      --img_dir things/ --inference_csv_file spose_val.csv \\
      --RDM48_triplet_dir RDM48_triplet.mat --clip_weights ViT-L-14.pt \\
      --bpe_vocab bpe_simple_vocab_16e6.txt.gz --output_dir runs/baseline
"""
from __future__ import annotations

import argparse
import sys
from datetime import datetime

from ..parallel import dist
from ..train.clip_loop import run_behavioral_training


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="CLIP-HBA behavioral baseline "
                                            "training (PyTorch / CUDA)")
    p.add_argument("--csv_file", required=True,
                   help="training stimuli CSV (image_name + 66 target cols)")
    p.add_argument("--img_dir", required=True)
    p.add_argument("--inference_csv_file", required=True,
                   help="48 held-out inference stimuli CSV")
    p.add_argument("--RDM48_triplet_dir", required=True,
                   help="human triplet RDM .mat file")
    p.add_argument("--backbone", default="ViT-L/14")
    p.add_argument("--clip_weights", default=None,
                   help="OpenAI CLIP checkpoint (.pt) to load")
    p.add_argument("--bpe_vocab", default=None,
                   help="CLIP BPE merge table (bpe_simple_vocab_16e6.txt.gz)")
    p.add_argument("--allow_hash_tokenizer", action="store_true",
                   help="permit pretrained weights without a BPE vocab "
                        "(RSA will be scientifically void; testing only)")
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--train_portion", type=float, default=0.8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--early_stopping_patience", type=int, default=20)
    p.add_argument("--random_seed", type=int, default=1)
    p.add_argument("--vision_layers", type=int, default=2)
    p.add_argument("--transformer_layers", type=int, default=1)
    p.add_argument("--rank", type=int, default=32)
    p.add_argument("--output_dir", default="./clip_hba_baseline")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda",
                   help="torch device to train on ('cpu' for tests, gloo "
                        "under torchrun); under torchrun 'cuda' is the "
                        "rank's card")
    p.add_argument("--sp_devices", type=int, default=1,
                   help="sequence parallelism of the visual tower under "
                        "torchrun: each image's tokens sharded over model "
                        "groups of N consecutive ranks (gather form); the "
                        "text tower runs whole on every rank")
    p.add_argument("--sp_ring", action="store_true",
                   help="with --sp_devices: ring attention (k/v rotate "
                        "around the sequence shards) instead of the "
                        "gather")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block in the backward "
                        "(torch.utils.checkpoint): memory for ~1/3 more "
                        "forward work")
    p.add_argument("--host_prefetch", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="copy the per-epoch checkpoint trees to the host "
                        "asynchronously, beside the eval and RSA work "
                        "(core/hostcopy.py); --no-host_prefetch copies "
                        "them synchronously before the write")
    p.add_argument("--frozen_cache", action="store_true",
                   help="cache the frozen tower prefixes once and train only "
                        "the adapted suffix blocks (costs [N, S, width] of "
                        "device memory in the compute dtype)")
    p.add_argument("--dump_inference_embeddings", action="store_true",
                   help="write the 48 inference embeddings of every epoch "
                        "(things_48_embeddings_epochN.csv)")
    p.add_argument("--nod_csv_file", default=None,
                   help="optional second inference set (per-epoch "
                        "nod_embeddings_epochN.csv dumps and the category-RDM "
                        "archive)")
    p.add_argument("--nod_img_dir", default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    out = args.output_dir
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
        "train_portion": args.train_portion,
        "lr": args.lr,
        "logger": None,
        "early_stopping_patience": args.early_stopping_patience,
        "checkpoint_path": f"{out}/cliphba_behavior_{timestamp}.pth",
        "training_res_path": f"{out}/training_res_{timestamp}.csv",
        "dora_parameters_path": f"{out}/dora_params_{timestamp}",
        "random_state_path": f"{out}/random_states_{timestamp}",
        "random_seed": args.random_seed,
        "vision_layers": args.vision_layers,
        "transformer_layers": args.transformer_layers,
        "rank": args.rank,
        "criterion": "mse",
        "cuda": 0,
        "compute_dtype": args.compute_dtype,
        "remat": args.remat,
        "sp_devices": args.sp_devices,
        "sp_ring": args.sp_ring,
        "host_prefetch": args.host_prefetch,
        "frozen_cache": args.frozen_cache,
        "dump_inference_embeddings": args.dump_inference_embeddings,
        "inference_dump_dir": f"{out}/things_48_inference_results",
        "nod_csv_file": args.nod_csv_file,
        "nod_img_dir": args.nod_img_dir,
        "nod_dump_dir": f"{out}/nod_inference_results",
    }
    device = dist.local_device(args.device)
    with dist.process_group(device):
        result = run_behavioral_training(config, device=device)
    if result.get("preempted"):
        sys.exit(143)  # SIGTERM convention: interrupted, resume in place


if __name__ == "__main__":
    main()
