"""DoRA adapters on a ``CLIP``: surgery, checkpoint names and baking.

Counterpart of the JAX package's adapters/dora.py. The adapters live in two
trees beside the model:

- ``trainable``: {tower: {block_idx: {m, delta_D_A, delta_D_B}}};
- ``static``:    {tower: {block_idx: {D, bias}}}, the frozen unit-column
  direction matrix and the cloned out_proj bias.

Training makes the trainable leaves f32 tensors that require grad
(``make_trainable``) and hands ``assemble(trainable, static)`` to the
forward; serving bakes them into the attention out_proj of the adapted
blocks (``bake``), so the served forward carries no adapter math.
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


def assemble(trainable: dict, static: dict) -> dict:
    """Zip trainable+static into {"visual": {idx: {trainable, buffers}}, ...}
    for clip_hba_forward."""
    return {tower: {idx: {"trainable": trainable[tower][idx],
                          "buffers": static[tower][idx]}
                    for idx in trainable[tower]}
            for tower in trainable}


def assemble_forks(trainables: list, static: dict) -> dict:
    """`assemble` for R forks: each adapted block carries the list of the
    forks' trainable trees beside the one static tree, for the fork-axis
    forward (models/clip.py clip_hba_forward_forks), which stacks the
    forks' adapted weights."""
    first = trainables[0]
    return {tower: {idx: {"trainable": [t[tower][idx] for t in trainables],
                          "buffers": static[tower][idx]}
                    for idx in first[tower]}
            for tower in first}


def make_trainable(trainable: dict, device=None) -> dict:
    """A copy of the tree whose leaves are f32 leaf tensors on `device`
    that require grad: what the optimizer updates (in place)."""
    return {tower: {idx: {k: torch.as_tensor(v).detach().to(
                              device=device, dtype=torch.float32)
                          .clone().requires_grad_(True)
                          for k, v in tr.items()}
                    for idx, tr in blocks.items()}
            for tower, blocks in trainable.items()}


def trainable_leaves(trainable: dict) -> list:
    """[(tower, block_idx, name, tensor)] in one fixed order (towers as
    given, blocks ascending, names in ADAPTER_PARAM_NAMES order): the
    optimizer's parameter order and the key of the optax-layout state."""
    return [(tower, idx, name, blocks[idx][name])
            for tower, blocks in trainable.items()
            for idx in sorted(blocks) for name in ADAPTER_PARAM_NAMES]


def count_trainable_parameters(trainable: dict) -> int:
    return vdora.count_params(trainable)


# -- reference-compatible checkpoint naming ---------------------------------
# The reference saves {module_path}.{m,delta_D_A,delta_D_B} with module paths
# like clip_model.visual.transformer.resblocks.22.attn.out_proj.

def _module_path(tower: str, idx: int) -> str:
    t = "visual.transformer" if tower == "visual" else "transformer"
    return f"clip_model.{t}.resblocks.{idx}.attn.out_proj"


def spec_module_paths(spec: dict) -> set:
    """Reference-style module paths of every adapter a spec covers."""
    return {_module_path(t, int(i)) for t, idxs in spec.items() for i in idxs}


def checkpoint_module_paths(flat: dict) -> set:
    """Reference-style module paths of every adapter present in a flat
    {path.param: tensor} checkpoint mapping (to_reference_names layout)."""
    suffixes = tuple(f".{n}" for n in ADAPTER_PARAM_NAMES)
    return {k.rsplit(".", 1)[0] for k in flat if k.endswith(suffixes)}


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
