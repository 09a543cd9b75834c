"""CLIP image+text towers and the CLIP-HBA prompt-similarity head.

Counterpart of the JAX package's models/clip.py (ViT visual towers only).
``CLIP`` holds the parameters under OpenAI CLIP's state-dict names, so an
OpenAI checkpoint (or one converted from the JAX package by
``models.convert.clip_state_dict_from_jax_params``) loads with
``load_state_dict(strict=True)``. ``clip_hba_forward`` returns the
[B, n_prompts] logit-scaled cosine similarities between each image and each
prompt, re-encoding the prompts on every call as the JAX forward does.
With DoRA adapters (training) the adapted blocks' out_proj is the DoRA
layer, as in the JAX forward.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..ops import dora as vdora
from ..ops import nn as vnn
from . import vit as vvit
from .vit import CLIP_VISUAL_FLAGS, ViTConfig


@dataclass(frozen=True)
class TextConfig:
    width: int = 768
    layers: int = 12
    heads: int = 12
    vocab_size: int = 49408
    context_length: int = 77


@dataclass(frozen=True)
class CLIPConfig:
    visual: ViTConfig
    text: TextConfig
    embed_dim: int


CLIP_VIT_L14 = CLIPConfig(visual=vvit.CLIP_VIT_L14_VISUAL,
                          text=TextConfig(width=768, layers=12, heads=12),
                          embed_dim=768)


# random-init backbones by name (the ViT entries of the JAX package's
# CLIP_CONFIGS that the port runs)
CLIP_CONFIGS = {
    "ViT-L/14": CLIP_VIT_L14,
    "test-tiny": CLIPConfig(
        visual=ViTConfig(patch=32, width=32, layers=2, heads=2,
                         image_size=224, out_dim=16, **CLIP_VISUAL_FLAGS),
        text=TextConfig(width=32, layers=2, heads=2, vocab_size=49408,
                        context_length=77),
        embed_dim=16),
}


def tiny_clip_config(width=32, layers=2, heads=2, patch=16, image_size=32,
                     embed_dim=16, vocab=512, context=16) -> CLIPConfig:
    """Miniature CLIP for tests."""
    return CLIPConfig(
        visual=ViTConfig(patch=patch, width=width, layers=layers, heads=heads,
                         image_size=image_size, out_dim=embed_dim,
                         **CLIP_VISUAL_FLAGS),
        text=TextConfig(width=width, layers=layers, heads=heads,
                        vocab_size=vocab, context_length=context),
        embed_dim=embed_dim)


class CLIP(nn.Module):
    """Parameters of a ViT CLIP under OpenAI's names. Build it with
    ``empty_clip`` (no init work) and fill it from a state dict or with
    ``init_clip_weights_``."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        t = cfg.text
        self.visual = vvit.VisionTransformer(cfg.visual)
        self.transformer = vvit.Transformer(t.width, t.layers, t.heads,
                                            causal=True)
        self.token_embedding = nn.Embedding(t.vocab_size, t.width)
        self.positional_embedding = nn.Parameter(
            torch.empty(t.context_length, t.width))
        self.ln_final = nn.LayerNorm(t.width)
        self.text_projection = nn.Parameter(torch.empty(t.width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.empty(()))


def empty_clip(cfg: CLIPConfig, device) -> CLIP:
    """A CLIP whose parameters are allocated on `device` and not initialized
    (built on the meta device, so no init kernels run at ViT-L size)."""
    with torch.device("meta"):
        model = CLIP(cfg)
    return model.to_empty(device=device).eval()


@torch.no_grad()
def init_clip_weights_(model: CLIP, generator: torch.Generator) -> CLIP:
    """Random weights in place, with the JAX package's init distributions
    (init_clip_params): truncated normals of std 0.02 for dense weights and
    embeddings, unit LayerNorms, zero biases, width^-0.5 projections and a
    logit scale of log(1/0.07). The numbers differ from JAX's: a test that
    compares the two packages converts one set of weights instead."""
    def tn(p, std):
        nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std,
                              generator=generator)

    def blocks(transformer):
        for blk in transformer.resblocks:
            for ln in (blk.ln_1, blk.ln_2):
                ln.weight.fill_(1.0)
                ln.bias.zero_()
            for w in (blk.attn.in_proj_weight, blk.attn.out_proj.weight,
                      blk.mlp.c_fc.weight, blk.mlp.c_proj.weight):
                tn(w, 0.02)
            for b in (blk.attn.in_proj_bias, blk.attn.out_proj.bias,
                      blk.mlp.c_fc.bias, blk.mlp.c_proj.bias):
                b.zero_()

    v = model.visual
    tn(v.conv1.weight, 0.02)
    tn(v.class_embedding, 0.02)
    tn(v.positional_embedding, 0.02)
    blocks(v.transformer)
    for ln in (v.ln_pre, v.ln_post, model.ln_final):
        ln.weight.fill_(1.0)
        ln.bias.zero_()
    tn(v.proj, model.cfg.visual.width ** -0.5)
    model.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
    model.positional_embedding.normal_(0.0, 0.01, generator=generator)
    blocks(model.transformer)
    model.text_projection.normal_(0.0, model.cfg.text.width ** -0.5,
                                  generator=generator)
    model.logit_scale.fill_(math.log(1.0 / 0.07))
    return model


def encode_text(model: CLIP, tokens: torch.Tensor, *,
                compute_dtype=torch.float32, adapters: dict | None = None,
                adapter_cfg: dict | None = None,
                dropout_key: vdora.DropoutKey | None = None,
                deterministic: bool = True) -> torch.Tensor:
    """tokens [N, context] -> [N, embed_dim] f32.

    Causal transformer; features at the EOT position (the argmax of the
    token ids, since EOT is the largest id), then projected in f32."""
    x = model.token_embedding.weight[tokens].to(compute_dtype)
    x = x + model.positional_embedding.to(x.dtype)
    x = vvit.run_blocks(model.transformer, x, adapters=adapters,
                        adapter_cfg=adapter_cfg, dropout_key=dropout_key,
                        deterministic=deterministic)
    x = vnn.layer_norm(x, model.ln_final.weight, model.ln_final.bias)
    eot = torch.argmax(tokens, dim=-1)
    feats = x[torch.arange(x.shape[0], device=x.device), eot]
    return torch.matmul(feats.float(),
                        model.text_projection.to(feats.dtype).float())


def encode_image(model: CLIP, images: torch.Tensor, *,
                 compute_dtype=torch.float32, adapters: dict | None = None,
                 adapter_cfg: dict | None = None,
                 dropout_key: vdora.DropoutKey | None = None,
                 deterministic: bool = True) -> torch.Tensor:
    """images [B, H, W, 3] (normalized, NHWC) -> [B, embed_dim] f32."""
    return vvit.clip_visual_encode(model.visual, images,
                                   compute_dtype=compute_dtype,
                                   adapters=adapters, adapter_cfg=adapter_cfg,
                                   dropout_key=dropout_key,
                                   deterministic=deterministic)


def clip_hba_forward(model: CLIP, images: torch.Tensor,
                     prompt_tokens: torch.Tensor, *,
                     compute_dtype=torch.float32, adapters: dict | None = None,
                     adapter_cfg: dict | None = None,
                     dropout_key: vdora.DropoutKey | None = None,
                     deterministic: bool = True) -> torch.Tensor:
    """images -> [B, n_prompts] scores (the CLIPHBA contract): the logit
    scale times the cosine similarity of each image and prompt embedding.

    adapters = {"visual": {idx: dora}, "text": {idx: dora}}
    (adapters/dora.py assemble); `dropout_key` splits into a vision and a
    text stream, as the JAX forward splits its key."""
    adapters = adapters or {}
    kv = kt = None
    if dropout_key is not None:
        kv, kt = dropout_key.split()
    img = encode_image(model, images, compute_dtype=compute_dtype,
                       adapters=adapters.get("visual"),
                       adapter_cfg=adapter_cfg, dropout_key=kv,
                       deterministic=deterministic)
    txt = encode_text(model, prompt_tokens, compute_dtype=compute_dtype,
                      adapters=adapters.get("text"), adapter_cfg=adapter_cfg,
                      dropout_key=kt, deterministic=deterministic)
    img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
    scale = torch.exp(model.logit_scale)
    return scale * torch.matmul(img, txt.t())
