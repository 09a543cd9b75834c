"""DoRA adapters on a ``CLIP``: surgery, checkpoint names and baking.

Counterpart of the JAX package's adapters/dora.py. The adapters live in two
trees beside the model:

- ``trainable``: {tower: {block_idx: {m, delta_D_A, delta_D_B}}};
- ``static``:    {tower: {block_idx: {D, bias}}}, the frozen unit-column
  direction matrix and the cloned out_proj bias.

Serving bakes them into the attention out_proj of the adapted blocks
(``bake``), so the served forward carries no adapter math.
"""
from __future__ import annotations

import torch

from ..ops import dora as vdora

# the three per-adapter parameter names of the reference checkpoint format
ADAPTER_PARAM_NAMES = ("m", "delta_D_A", "delta_D_B")


def _blocks(model, tower: str):
    return (model.visual.transformer.resblocks if tower == "visual"
            else model.transformer.resblocks)


def dora_spec(visual_layers_total: int, text_layers_total: int,
              n_vision_layers: int, n_transformer_layers: int) -> dict:
    """Which block indices get adapters: the LAST n of each tower."""
    return {
        "visual": list(range(visual_layers_total - n_vision_layers,
                             visual_layers_total)),
        "text": list(range(text_layers_total - n_transformer_layers,
                           text_layers_total)),
    }


@torch.no_grad()
def apply_dora(model, spec: dict, *, r: int, alpha: int = 16,
               dropout: float = 0.1, generator: torch.Generator):
    """Build DoRA trees for the out_proj of the blocks in `spec`.

    Returns (trainable, static, adapter_cfg). The model is not modified."""
    trainable = {"visual": {}, "text": {}}
    static = {"visual": {}, "text": {}}
    for tower, indices in spec.items():
        blocks = _blocks(model, tower)
        for idx in indices:
            proj = blocks[idx].attn.out_proj
            tr, buf = vdora.dora_init(generator, proj.weight.t(), r=r)
            buf["bias"] = proj.bias.detach().clone()
            trainable[tower][idx] = tr
            static[tower][idx] = buf
    return trainable, static, {"r": r, "alpha": alpha, "dropout": dropout}


def count_trainable_parameters(trainable: dict) -> int:
    return vdora.count_params(trainable)


# -- reference-compatible checkpoint naming ---------------------------------
# The reference saves {module_path}.{m,delta_D_A,delta_D_B} with module paths
# like clip_model.visual.transformer.resblocks.22.attn.out_proj.

def _module_path(tower: str, idx: int) -> str:
    t = "visual.transformer" if tower == "visual" else "transformer"
    return f"clip_model.{t}.resblocks.{idx}.attn.out_proj"


def to_reference_names(trainable: dict) -> dict:
    """Flatten a trainable tree to reference-style {path.param: tensor}."""
    return {f"{_module_path(tower, int(idx))}.{name}": val
            for tower, blocks in trainable.items()
            for idx, tr in blocks.items() for name, val in tr.items()}


def from_reference_names(flat: dict, spec: dict) -> dict:
    """Inverse of to_reference_names for the blocks named in `spec`.

    Fully missing blocks are skipped (the reference loads with strict=False);
    a block with only SOME of its three params is a torn checkpoint and
    raises."""
    out = {"visual": {}, "text": {}}
    for tower, indices in spec.items():
        for idx in indices:
            base = _module_path(tower, int(idx))
            entry = {name: flat[f"{base}.{name}"] for name in ADAPTER_PARAM_NAMES
                     if f"{base}.{name}" in flat}
            if len(entry) == 3:
                out[tower][idx] = entry
            elif entry:
                missing = sorted(set(ADAPTER_PARAM_NAMES) - set(entry))
                raise ValueError(
                    f"DoRA checkpoint is torn: block {base} has "
                    f"{sorted(entry)} but is missing {missing}")
    return out


def merge_loaded(trainable: dict, loaded: dict) -> dict:
    """Overlay loaded adapter params onto an initialized trainable tree
    (strict=False load semantics)."""
    out = {t: dict(b) for t, b in trainable.items()}
    for tower, blocks in loaded.items():
        for idx, tr in blocks.items():
            if idx in out.get(tower, {}):
                out[tower][idx] = {k: torch.as_tensor(v, dtype=torch.float32)
                                   for k, v in tr.items()}
    return out


@torch.no_grad()
def bake(model, trainable: dict, static: dict, *, alpha: int, r: int):
    """Merge trained DoRA adapters into the model's weights, IN PLACE (the
    JAX package returns a copy; a ViT-L-sized copy is not worth its memory
    here). Each adapted block's out_proj weight becomes the adapted weight
    m * colnorm(D + B@A * alpha/r), transposed to [out, in], and its bias
    the adapter's cloned bias: a plain CLIP whose forward equals the adapted
    forward with dropout off. Returns the model."""
    for tower, blocks in trainable.items():
        tower_blocks = _blocks(model, tower)
        for idx, tr in blocks.items():
            buf = static[tower][idx]
            proj = tower_blocks[int(idx)].attn.out_proj
            dev = proj.weight.device
            tr = {k: v.to(dev) for k, v in tr.items()}
            w = vdora.dora_weight(tr, buf["D"].to(dev), alpha=alpha, r=r)
            proj.weight.copy_(w.t())
            if buf.get("bias") is not None:
                proj.bias.copy_(buf["bias"])
    return model
