"""The CLIP visual tower: a pre-norm Vision Transformer with OpenAI's names.

Counterpart of the CLIP side of the JAX package's models/vit.py. The
modules only hold parameters, under OpenAI CLIP's state-dict names
(``conv1.weight``, ``transformer.resblocks.{i}.attn.in_proj_weight``,
``ln_1``, ``mlp.c_fc``, ...); the forward is plain functions on them:

- ``block_forward``: the pre-norm block with the semantics of the JAX
  block's fused-kernel branch. The 1/sqrt(dh) score scale is folded into the
  q rows of the packed [3D, D] projection (weight and bias), ONE matmul
  emits [B, S, 3D], and that goes whole to the flash attention op.
- ``clip_visual_encode``: stem (patch embed + CLS + positions + ln_pre),
  blocks, then ln_post over the CLS token and the projection, in f32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..ops import attention as vattn
from ..ops import nn as vnn


@dataclass(frozen=True)
class ViTConfig:
    patch: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    image_size: int = 224
    out_dim: Optional[int] = None  # CLIP projection dim (768 for ViT-L/14)

    @property
    def seq_len(self) -> int:
        return (self.image_size // self.patch) ** 2 + 1


CLIP_VIT_L14_VISUAL = ViTConfig(patch=14, width=1024, layers=24, heads=16,
                                out_dim=768)


class MultiheadAttention(nn.Module):
    """Parameter holder with torch.nn.MultiheadAttention's names: packed
    in_proj_weight [3D, D] (rows q, k, v), in_proj_bias [3D], out_proj."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)


class MLP(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.c_fc = nn.Linear(width, hidden)
        self.c_proj = nn.Linear(hidden, width)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, causal: bool = False):
        super().__init__()
        self.heads = heads
        self.causal = causal
        self.ln_1 = nn.LayerNorm(width)
        self.attn = MultiheadAttention(width)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = MLP(width, 4 * width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return block_forward(self, x)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 causal: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal=causal)
            for _ in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x)
        return x


class PatchConv(nn.Module):
    """Holds the patch embedding as OpenAI's bias-free conv kernel
    ``conv1.weight`` [D, 3, p, p]. It is never run as a convolution:
    ``patch_embed`` does reshape + matmul."""

    def __init__(self, width: int, patch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(width, 3, patch, patch))


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.conv1 = PatchConv(cfg.width, cfg.patch)
        self.class_embedding = nn.Parameter(torch.empty(cfg.width))
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.seq_len, cfg.width))
        self.ln_pre = nn.LayerNorm(cfg.width)
        self.transformer = Transformer(cfg.width, cfg.layers, cfg.heads)
        self.ln_post = nn.LayerNorm(cfg.width)
        self.proj = nn.Parameter(torch.empty(cfg.width, cfg.out_dim))


def _prescaled_in_proj(attn: MultiheadAttention, dh: int, dtype):
    """The packed projection with 1/sqrt(dh) folded into its q rows: weight
    [3D, D] and bias [3D] in `dtype`. The product is taken in f32 and then
    rounded, as the JAX block does (exact for dh=64, where the scale is
    0.125)."""
    w, b = attn.in_proj_weight, attn.in_proj_bias
    D = w.shape[1]
    scale = 1.0 / (dh ** 0.5)
    w = torch.cat([(w[:D].float() * scale).to(dtype), w[D:].to(dtype)])
    b = torch.cat([(b[:D].float() * scale).to(dtype), b[D:].to(dtype)])
    return w, b


def block_forward(blk: ResidualAttentionBlock, x: torch.Tensor) -> torch.Tensor:
    """Pre-norm transformer block on x [B, S, D] (x.dtype is the compute
    dtype). Attention goes through the packed flash op."""
    h = vnn.layer_norm(x, blk.ln_1.weight, blk.ln_1.bias)
    D = h.shape[-1]
    w, b = _prescaled_in_proj(blk.attn, D // blk.heads, h.dtype)
    qkv = vnn.dense(h, w.t(), b)                                  # [B, S, 3D]
    o = vattn.flash_mha_packed_qkv(qkv, num_heads=blk.heads,
                                   causal=blk.causal)
    o = vnn.dense(o, blk.attn.out_proj.weight.t(), blk.attn.out_proj.bias)
    x = x + o
    h = vnn.layer_norm(x, blk.ln_2.weight, blk.ln_2.bias)
    h = vnn.mlp(h, blk.mlp.c_fc.weight.t(), blk.mlp.c_fc.bias,
                blk.mlp.c_proj.weight.t(), blk.mlp.c_proj.bias)
    return x + h


def _clip_visual_stem(visual: VisionTransformer, images: torch.Tensor, *,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """Patch embed + CLS + positions + ln_pre; images NHWC."""
    cfg = visual.cfg
    x = images.to(compute_dtype)
    w = vnn.conv_kernel_to_patch_matrix(visual.conv1.weight)
    x = vnn.patch_embed(x, w, None, cfg.patch)
    cls = visual.class_embedding.to(x.dtype).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    x = x + visual.positional_embedding.to(x.dtype)
    return vnn.layer_norm(x, visual.ln_pre.weight, visual.ln_pre.bias)


def _clip_visual_out(visual: VisionTransformer, x: torch.Tensor) -> torch.Tensor:
    """ln_post over the CLS token, then the projection: [B, out_dim] f32.
    The projection is cast to the compute dtype and multiplied in f32 (the
    f32-accumulating dot of the JAX tail)."""
    cls_tok = vnn.layer_norm(x[:, 0], visual.ln_post.weight, visual.ln_post.bias)
    return torch.matmul(cls_tok.float(), visual.proj.to(cls_tok.dtype).float())


def clip_visual_encode(visual: VisionTransformer, images: torch.Tensor, *,
                       compute_dtype=torch.float32) -> torch.Tensor:
    """CLIP visual tower: images [B, H, W, 3] (normalized, NHWC) ->
    [B, out_dim] f32."""
    x = _clip_visual_stem(visual, images, compute_dtype=compute_dtype)
    x = visual.transformer(x)
    return _clip_visual_out(visual, x)
