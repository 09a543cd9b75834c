"""Full and partial tower fine-tuning as a selection of parameters.

Counterpart of the JAX package's adapters/finetune.py. The reference's
RN50-path unfreezers (unfreeze_image_layers / unfreeze_image_layers_all)
flip ``requires_grad`` on whole submodules. In PyTorch's idiom a selection
is a set of parameter names: each split returns (trainable, frozen), two
{name: Parameter} maps of the model's own parameters under its state-dict
names, the first to hand to an optimizer, and sets ``requires_grad`` to
match. No name is in both halves; together they are every parameter.
BatchNorm's running statistics are buffers, so no split trains them (the
reference's unfreezers flip parameters only; the JAX trees hold them as
leaves beside the affine ones).

    trainable, frozen = split_visual_tower(model)          # the whole tower
    trainable, frozen = split_last_blocks(model, "visual", n=2)
    trainable, frozen = split_rn_image_layers(model)       # RN layer3-4 + pool
    opt = torch.optim.AdamW(trainable.values(), lr=3e-4)
"""
from __future__ import annotations

from torch import nn

# each tower's transformer blocks under OpenAI's names
_BLOCKS = {"visual": "visual.transformer.resblocks.",
           "text": "transformer.resblocks."}


def _split(model: nn.Module, trains) -> tuple[dict, dict]:
    """({name: Parameter} where trains(name), the rest), with
    requires_grad set to match."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        keep = bool(trains(name))
        p.requires_grad_(keep)
        (trainable if keep else frozen)[name] = p
    return trainable, frozen


def split_visual_tower(model: nn.Module) -> tuple[dict, dict]:
    """unfreeze_image_layers_all: the whole visual tower trains."""
    return _split(model, lambda n: n.startswith("visual."))


def split_last_blocks(model: nn.Module, tower: str,
                      n: int) -> tuple[dict, dict]:
    """unfreeze_image_layers on a transformer tower: its last `n` blocks
    train ("visual" or "text")."""
    prefix = _BLOCKS[tower]
    total = len({k[len(prefix):].split(".")[0]
                 for k, _ in model.named_parameters() if k.startswith(prefix)})
    if total == 0:
        raise ValueError(f"the {tower} tower has no transformer blocks; use "
                         "split_rn_image_layers for an RN tower")
    cut = total - n
    return _split(model, lambda k: k.startswith(prefix) and
                  int(k[len(prefix):].split(".")[0]) >= cut)


def split_rn_image_layers(model: nn.Module) -> tuple[dict, dict]:
    """unfreeze_image_layers on an RN50 tower: the visual tower's layer3,
    layer4 and attnpool train; everything else stays frozen."""
    keys = ("layer3", "layer4", "attnpool")
    missing = [k for k in keys if not hasattr(model.visual, k)]
    if missing:
        raise ValueError(f"not an RN visual tower (missing {missing}); "
                         "use split_last_blocks for transformer towers")
    prefixes = tuple(f"visual.{k}." for k in keys)
    return _split(model, lambda n: n.startswith(prefixes))


def merge(frozen: dict, trainable: dict) -> dict:
    """The full {name: tensor} map from the two halves, e.g. updated
    trainable tensors for ``torch.func.functional_call``. A name in both
    halves is refused."""
    both = sorted(set(frozen) & set(trainable))
    if both:
        raise ValueError(f"names in both halves: {both[:5]}")
    return {**frozen, **trainable}


def count_params(params: dict) -> int:
    """Elements of a {name: tensor} map."""
    return sum(int(p.numel()) for p in params.values())
