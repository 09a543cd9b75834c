"""Int8 inference quantization for the serving path (counterpart of the JAX
package's ops/quant.py, with its arithmetic in its order).

A ViT forward is ~98% dense-layer multiply-adds (qkv, out, fc1, fc2), so
quantizing the four block matmuls of every block captures nearly all of it:

- weights: symmetric per-OUTPUT-CHANNEL int8 (``quantize_weight``), computed
  once from the finished weights: each output channel gets its own scale
  ``max(max|w| / 127, 1e-8)``, so one outlier channel cannot crush the
  others' resolution;
- activations: symmetric dynamic per-ROW int8 (``int8_dense``): the scale is
  max|x| of each token's feature vector, taken on the fly, so no
  calibration set is needed;
- products: int8 x int8 -> int32 (``torch._int_mm``, cuBLASLt's int8 GEMM
  on the card), then ONE f32 rescale by (row scale x channel scale), cast
  to x's dtype, then the bias.

The port's weights are [out, in] (``nn.Linear``), so the channel scale is
taken over dim 1 where JAX takes it over axis 0 of [in, out].

A quantized weight lives in a ``QuantizedWeight`` module put in the place
of the float parameter (``blocks.{i}.attn.qkv.weight`` becomes
``blocks.{i}.attn.qkv.weight.q`` and ``.s``). A module rather than a pair of
bare tensors, because ``Module.to(dtype)`` casts every floating buffer: the
holder moves its scales between devices but keeps them float32 (a bf16
scale would stack a second rounding on the int8 one), and ``named_buffers``
still lists them, so a serving artifact stores them with the weights.

Training never sees this path: these are serving-only transforms of a
finished model, after the DoRA bake (adapters/dora.py).
"""
from __future__ import annotations

import torch
from torch import nn

_EPS = 1e-8


class QuantizedWeight(nn.Module):
    """An int8 weight ``q`` [out, in] and its float32 per-output-channel
    scale ``s`` [out], both buffers. ``Module.to`` / ``.half()`` /
    ``.bfloat16()`` move them to another device and leave their dtypes."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)

    def _apply(self, fn, recurse=True):
        # fn may cast as well as move; keep only where it puts a tensor,
        # learnt from an empty one, and move each buffer once
        for name in ("q", "s"):
            t = getattr(self, name)
            setattr(self, name, t.to(fn(t.new_empty(0)).device))
        return self


def _over_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true division, as JAX computes it: on CUDA, PyTorch
    turns a Python-scalar divisor into a multiplication by its reciprocal,
    which can be one bit off; a 0-dim tensor on t's device divides."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def is_quantized(w) -> bool:
    return isinstance(w, QuantizedWeight)


def quantize_weight(w: torch.Tensor) -> QuantizedWeight:
    """[out, in] float weight -> ``QuantizedWeight`` (symmetric
    per-output-channel; rounding half to even, as jnp.round)."""
    w = w.detach().float()
    s = torch.clamp_min(_over_127(w.abs().amax(dim=1)), _EPS)
    q = torch.clamp(torch.round(w / s[:, None]), -127, 127).to(torch.int8)
    return QuantizedWeight(q, s)


def dequantize_weight(wq: QuantizedWeight) -> torch.Tensor:
    """The float32 [out, in] weight ``q * s``."""
    return wq.q.float() * wq.s[:, None]


def int8_dense(x: torch.Tensor, wq: QuantizedWeight,
               b: torch.Tensor | None = None) -> torch.Tensor:
    """x [..., in] @ dequant(wq).T (+ b) as an int8 product; the output is
    in x.dtype, like ``ops.nn.dense``.

    JAX's values in JAX's order, in fewer eager passes: the row abs-max is
    taken in x's dtype (exact), x / sx promotes x to f32 in the division,
    round and clip run in place, and the int32 product is promoted to f32
    inside the rescale's multiply."""
    sx = torch.clamp_min(_over_127(x.abs().amax(dim=-1, keepdim=True)
                                   .float()), _EPS)
    xq = torch.div(x, sx).round_().clamp_(-127, 127).to(torch.int8)
    # q [out, in] is the column-major [in, out] operand the int8 GEMM takes
    y = torch._int_mm(xq.reshape(-1, xq.shape[-1]), wq.q.t())
    y = torch.mul(y.reshape(*x.shape[:-1], -1), sx * wq.s).to(x.dtype)
    if b is not None:
        y = y.add_(b.to(y.dtype))
    return y


# the four dense layers of a block: (attention, attribute) paths per layout
_CLASSIFIER_SLOTS = (("attn.qkv", "weight"), ("attn.proj", "weight"),
                     ("mlp.fc1", "weight"), ("mlp.fc2", "weight"))
_CLIP_SLOTS = (("attn", "in_proj_weight"), ("attn.out_proj", "weight"),
               ("mlp.c_fc", "weight"), ("mlp.c_proj", "weight"))


def block_weight_slots(blk: nn.Module):
    """(module, attribute) of the four dense weights of a transformer block:
    a classifier ``Block`` or a CLIP ``ResidualAttentionBlock``."""
    slots = _CLASSIFIER_SLOTS if hasattr(blk, "norm1") else _CLIP_SLOTS
    return [(blk.get_submodule(path), attr) for path, attr in slots]


def _quantize_slot(module: nn.Module, attr: str) -> None:
    w = getattr(module, attr)
    if is_quantized(w):
        return
    wq = quantize_weight(w)
    delattr(module, attr)          # the float parameter goes ...
    setattr(module, attr, wq)      # ... and the holder takes its name


def _quantize_blocks(blocks) -> None:
    for blk in blocks:
        if hasattr(blk, "moe"):    # as JAX: expert dispatch has no int8 path
            continue
        for module, attr in block_weight_slots(blk):
            _quantize_slot(module, attr)


@torch.no_grad()
def quantize_vit_blocks(model):
    """Quantize the four dense weights of every transformer block of a ViT
    classifier or a CLIP visual tower, IN PLACE (the JAX package returns a
    new tree; a ViT-L-sized copy is not worth its memory here). Everything
    else (patch embed, positions and CLS, LayerNorms, biases, head and
    projections) stays float: together ~2% of the forward, and the
    LayerNorms and softmax need the precision. MoE blocks are left float
    whole, as JAX leaves them. Returns the model."""
    _quantize_blocks(model.blocks if hasattr(model, "blocks")
                     else model.transformer.resblocks)
    return model


@torch.no_grad()
def quantize_clip_blocks(model):
    """``quantize_vit_blocks`` on BOTH towers of a CLIP (the text tower's
    blocks share the visual block layout). Bake adapters first
    (adapters.dora.bake), then quantize the baked model. Returns it."""
    quantize_vit_blocks(model.visual)
    _quantize_blocks(model.transformer.resblocks)
    return model
