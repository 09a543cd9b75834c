"""Config surface and dataset constants the port needs (copies of the JAX
package's core/configs.py: ``ClipRunConfig``, ``ViTTrainConfig`` and the
THINGS and ImageNet statistics).

``ClipRunConfig`` mirrors the reference's plain-dict config contract
(reference clip_train_behavior_baseline.py:11-33) so drivers are written the
same way in both packages. The sequence-parallel fields are kept so a
config dict means the same thing to both packages; the training loop
refuses them by name until the parallel modes are ported. ``ViTTrainConfig`` keeps
every field of the JAX package's, with its defaults, for the same reason:
the ViT loop refuses the parallel modes, MoE, the native loader, the
asynchronous checkpoint copy and the profiler by name.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class ClipRunConfig:
    """One CLIP-HBA behavioral training run (baseline, sweep fork, or lengths fork)."""

    # data
    csv_file: str = ""
    img_dir: str = ""
    inference_csv_file: str = ""
    RDM48_triplet_dir: str = ""

    # model
    backbone: str = "ViT-L/14"
    clip_weights: Optional[str] = None     # path to converted (or OpenAI .pt) weights
    bpe_vocab: Optional[str] = None        # path to the CLIP BPE vocab (gz or txt)
    allow_hash_tokenizer: bool = False     # escape hatch: permit pretrained
                                           # weights with the hash tokenizer
                                           # (RSA will be scientifically void)
    vision_layers: int = 2                 # last-n visual blocks that get DoRA
    transformer_layers: int = 1            # last-n text blocks that get DoRA
    rank: int = 32
    dora_alpha: int = 16
    dora_dropout: float = 0.1

    # optimization
    epochs: int = 500
    batch_size: int = 64
    train_portion: float = 0.8
    lr: float = 3e-4
    criterion: str = "mse"
    early_stopping_patience: int = 20
    random_seed: int = 1
    compute_dtype: str = "bfloat16"        # frozen-tower compute dtype
    remat: bool = False                    # recompute each block in the
                                           # backward
    sp_devices: int = 1                    # >1: visual-tower sequence
                                           # parallelism (torchrun)
    sp_ring: bool = False                  # with sp_devices: ring attention
    host_prefetch: bool = True             # asynchronous copy-out of the
                                           # per-epoch checkpoint trees
                                           # (core/hostcopy.py)
    preempt_save: bool = True              # stop cleanly at the next epoch
                                           # boundary on SIGTERM (per-epoch
                                           # checkpoints make the stop
                                           # exactly resumable in place)
    frozen_cache: bool = False             # cache the frozen tower prefixes
                                           # once and train only the adapted
                                           # suffix blocks

    # perturbation
    perturb_type: str = "baseline"         # random_target | label_shuffle |
                                           # uniform_images | image_noise | baseline
    perturb_length: int = 0
    perturb_distribution: str = "target"   # normal | target
    perturb_seed: int = 42
    training_run: int = 0                  # 1-indexed epoch the perturbation starts at

    # resume / fork
    resume_from_epoch: int = 0
    baseline_dora_directory: Optional[str] = None
    baseline_random_state_path: Optional[str] = None
    baseline_split_indices_path: Optional[str] = None
    resume_dora_parameters_path: Optional[str] = None
    resume_random_state_path: Optional[str] = None
    previous_training_res_path: Optional[str] = None

    # outputs
    checkpoint_path: str = "clip_hba_model.ckpt"
    training_res_path: str = "training_res.csv"
    dora_parameters_path: str = "./dora_params"
    random_state_path: str = "./random_states"

    # optional per-epoch inference-embedding dumps (reference runs produced
    # things_48_embeddings_epochN.csv files; see SURVEY.md section 0)
    dump_inference_embeddings: bool = False
    inference_dump_dir: Optional[str] = None
    # optional second per-epoch inference set (nod_embeddings_epochN.csv dumps)
    nod_csv_file: Optional[str] = None
    nod_img_dir: Optional[str] = None
    nod_dump_dir: Optional[str] = None

    # misc knobs kept for dict-compat with the reference config surface
    logger: Any = None
    cuda: int = 0
    output_base_directory: Optional[str] = None
    output_directory: Optional[str] = None
    output_dir: Optional[str] = None
    perturb_epoch: int = 0
    model: Optional[str] = None

    @classmethod
    def from_dict(cls, d: dict) -> "ClipRunConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in names:
                continue
            if k == "criterion" and not isinstance(v, str):
                v = "mse"  # reference passes nn.MSELoss(); we key on a string
            kwargs[k] = v
        return cls(**kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class ViTTrainConfig:
    """ViT-B/16 ImageNet supervised training (reference train_vit_sgd.py:246-257)."""

    data_path: str = ""
    output_dir: str = "./vit_out"
    batch_size: int = 256          # global batch (one process, one card)
    epochs: int = 100
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    num_workers: int = 8
    warmup_epochs: int = 5
    num_classes: int = 1000
    random_seed: int = 0
    compute_dtype: str = "bfloat16"  # AMP-equivalent; bf16 needs no GradScaler
    image_size: int = 224
    profile_dir: Optional[str] = None  # torch.profiler trace of the first
                                       # epoch (core/profiling.py)
    use_native_loader: bool = False    # C++ decode core (data/fastimage.py)
    data_echo: int = 1                 # yield each decoded train batch N times
                                       # (mitigation when host decode cannot
                                       # feed the device step rate)
    remat: bool = False  # recompute each block in the backward: O(1)-block
                         # activation memory for ~1/3 extra FLOPs
    fused_dw: bool = False  # route every dense backward with a bias through
                            # the fused dW+db kernel (ops/fused_dw.py)
    pp_stages: int = 1   # pipeline stages (not ported yet)
    pp_micro: int = 1    # microbatches per pipelined step (with pp_stages)
    grad_accum: int = 1  # >1: split each batch into N gradient microbatches
                         # in one step; peak activation memory drops to one
                         # microbatch's, numerically the unsplit step (CE is
                         # a mean over the batch)
    device_prefetch: int = 2  # h2d lookahead: a feeder thread copies batch
                              # k+1 to the card while batch k trains; 0 = off.
                              # Same batches in the same order either way.
    zero1: bool = False  # shard the SGD momentum over the ranks
    fsdp: bool = False   # shard params and momentum over the ranks
    tp_devices: int = 1  # tensor parallelism: ranks in a model group
    sp_devices: int = 1  # sequence parallelism: ranks in a model group
    sp_ring: bool = False  # ring attention with sp_devices
    ep_devices: int = 1  # expert parallelism: ranks in an expert group
    moe_experts: int = 0  # MoE MLPs in every other block (ops/moe.py)
    moe_topk: int = 1     # 1 = Switch top-1 routing, 2 = GShard top-2
    moe_capacity: float = 1.25  # per-expert capacity factor
    moe_aux_weight: float = 0.01  # weight of the MoE load-balance loss
    host_prefetch: bool = False  # asynchronous copy-out of the per-epoch
                                 # checkpoint trees (core/hostcopy.py)
    preempt_save: bool = True  # catch SIGTERM mid-epoch, write
                               # checkpoint_preempt.pth, exit resumable
                               # (core/preempt.py)
    keep_last: int = 0  # >0: delete per-epoch checkpoints older than the
                        # last N after each save (~1 GB each at ViT-B scale
                        # with the momentum). Keep-all default: the
                        # measurement grid and sweep forks restore
                        # arbitrary epochs.

    @classmethod
    def from_dict(cls, d: dict) -> "ViTTrainConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


# Normalization constants (exact values from the reference).
THINGS_MEAN = (0.52997664, 0.48070561, 0.41943838)
THINGS_STD = (0.27608301, 0.26593025, 0.28238822)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
