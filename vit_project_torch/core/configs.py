"""Config surface and dataset constants the port needs (copies of the JAX
package's core/configs.py: ``ClipRunConfig`` and the THINGS statistics).

``ClipRunConfig`` mirrors the reference's plain-dict config contract
(reference clip_train_behavior_baseline.py:11-33) so drivers are written the
same way in both packages. Fields for features that later slices of the port
bring (remat, sequence parallelism, the frozen-prefix cache, NOD dumps) are
kept so a config dict means the same thing to both packages; the training
loop refuses them by name until they are ported.
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
    remat: bool = False                    # recompute each visual block in
                                           # the backward (not ported yet)
    sp_devices: int = 1                    # >1: visual-tower sequence
                                           # parallelism (not ported yet)
    sp_ring: bool = False                  # with sp_devices: ring attention
                                           # (not ported yet)
    host_prefetch: bool = True             # asynchronous copy-out of the
                                           # per-epoch checkpoint trees; the
                                           # port copies synchronously
    preempt_save: bool = True              # stop cleanly at the next epoch
                                           # boundary on SIGTERM (per-epoch
                                           # checkpoints make the stop
                                           # exactly resumable in place)
    frozen_cache: bool = False             # cache the frozen tower prefixes
                                           # once and train only the adapted
                                           # suffix blocks (not ported yet)

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


# THINGS image normalization (exact values from the reference).
THINGS_MEAN = (0.52997664, 0.48070561, 0.41943838)
THINGS_STD = (0.27608301, 0.26593025, 0.28238822)
