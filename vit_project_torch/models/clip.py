"""CLIP image+text towers and the CLIP-HBA prompt-similarity head.

Counterpart of the JAX package's models/clip.py (ViT visual towers only).
``CLIP`` holds the parameters under OpenAI CLIP's state-dict names, so an
OpenAI checkpoint (or one converted from the JAX package by
``models.convert.clip_state_dict_from_jax_params``) loads with
``load_state_dict(strict=True)``. ``clip_hba_forward`` returns the
[B, n_prompts] logit-scaled cosine similarities between each image and each
prompt, re-encoding the prompts on every call as the JAX forward does.
With DoRA adapters (training) the adapted blocks' out_proj is the DoRA
layer, as in the JAX forward. ``encode_text_prefix`` / ``encode_text_suffix``
and ``clip_hba_suffix_forward`` split both towers at their first adapted
block, for the trainer's frozen-prefix cache. ``clip_hba_forward_forks``
and ``clip_hba_suffix_forward_forks`` run R forks' adapters on one forward
(train/multi_fork.py) -> [R, B, n_prompts].
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

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
CLIP_VIT_B32 = CLIPConfig(visual=vvit.CLIP_VIT_B32_VISUAL,
                          text=TextConfig(width=512, layers=12, heads=8),
                          embed_dim=512)
CLIP_VIT_B16 = CLIPConfig(visual=vvit.CLIP_VIT_B16_VISUAL,
                          text=TextConfig(width=512, layers=12, heads=8),
                          embed_dim=512)
# the same towers as ViT-L/14 on a 24x24 patch grid (S = 577)
CLIP_VIT_L14_336 = CLIPConfig(
    visual=replace(vvit.CLIP_VIT_L14_VISUAL, image_size=336),
    text=TextConfig(width=768, layers=12, heads=12),
    embed_dim=768)


# random-init backbones by name: every ViT entry of the JAX package's
# CLIP_CONFIGS, test-tiny included (its RN50 family is not ported)
CLIP_CONFIGS = {
    "ViT-L/14": CLIP_VIT_L14,
    "ViT-B/32": CLIP_VIT_B32,
    "ViT-B/16": CLIP_VIT_B16,
    "ViT-L/14@336px": CLIP_VIT_L14_336,
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


def _text_stem(model: CLIP, tokens: torch.Tensor,
               compute_dtype) -> torch.Tensor:
    x = model.token_embedding.weight[tokens].to(compute_dtype)
    return x + model.positional_embedding.to(x.dtype)


def _text_out(model: CLIP, x: torch.Tensor, eot: torch.Tensor) -> torch.Tensor:
    """ln_final, the features at each prompt's EOT position, the projection
    in f32."""
    x = vnn.layer_norm(x, model.ln_final.weight, model.ln_final.bias)
    feats = x[torch.arange(x.shape[0], device=x.device), eot]
    return torch.matmul(feats.float(),
                        model.text_projection.to(feats.dtype).float())


def encode_text(model: CLIP, tokens: torch.Tensor, *,
                compute_dtype=torch.float32, adapters: dict | None = None,
                adapter_cfg: dict | None = None,
                dropout_key: vdora.DropoutKey | None = None,
                deterministic: bool = True,
                remat: bool = False) -> torch.Tensor:
    """tokens [N, context] -> [N, embed_dim] f32.

    Causal transformer; features at the EOT position (the argmax of the
    token ids, since EOT is the largest id), then projected in f32."""
    x = vvit.run_blocks(model.transformer,
                        _text_stem(model, tokens, compute_dtype),
                        adapters=adapters, adapter_cfg=adapter_cfg,
                        dropout_key=dropout_key,
                        deterministic=deterministic, remat=remat)
    return _text_out(model, x, torch.argmax(tokens, dim=-1))


def encode_text_prefix(model: CLIP, tokens: torch.Tensor, *, n_suffix: int,
                       compute_dtype=torch.float32):
    """The frozen prefix of the text tower: the embeddings and the first
    `layers - n_suffix` blocks -> (hidden [N, context, width], eot [N]).
    The prompts are fixed for a whole run, so this is computed once."""
    layers = model.cfg.text.layers
    vvit.check_suffix(None, 0, layers, n_suffix, "text")
    x = vvit.run_blocks(model.transformer,
                        _text_stem(model, tokens, compute_dtype),
                        stop=layers - n_suffix)
    return x, torch.argmax(tokens, dim=-1)


def encode_text_suffix(model: CLIP, hidden: torch.Tensor, eot: torch.Tensor,
                       *, n_suffix: int, adapters: dict | None = None,
                       adapter_cfg: dict | None = None,
                       dropout_key: vdora.DropoutKey | None = None,
                       deterministic: bool = True,
                       remat: bool = False) -> torch.Tensor:
    """The trainable text suffix: blocks [layers - n_suffix, layers), then
    ln_final, the EOT gather and the projection. Absolute block indices keep
    encode_text's adapter lookup and dropout streams."""
    layers = model.cfg.text.layers
    start = layers - n_suffix
    vvit.check_suffix(adapters, start, layers, n_suffix, "text")
    x = vvit.run_blocks(model.transformer, hidden, adapters=adapters,
                        adapter_cfg=adapter_cfg, dropout_key=dropout_key,
                        deterministic=deterministic, start=start, remat=remat)
    return _text_out(model, x, eot)


def encode_image(model: CLIP, images: torch.Tensor, *,
                 compute_dtype=torch.float32, adapters: dict | None = None,
                 adapter_cfg: dict | None = None,
                 dropout_key: vdora.DropoutKey | None = None,
                 deterministic: bool = True,
                 remat: bool = False, seq_shard=None,
                 ring_attn: bool = False) -> torch.Tensor:
    """images [B, H, W, 3] (normalized, NHWC) -> [B, embed_dim] f32;
    `seq_shard` / `ring_attn` as ``models.vit.clip_visual_encode``."""
    return vvit.clip_visual_encode(model.visual, images,
                                   compute_dtype=compute_dtype,
                                   adapters=adapters, adapter_cfg=adapter_cfg,
                                   dropout_key=dropout_key,
                                   deterministic=deterministic, remat=remat,
                                   seq_shard=seq_shard, ring_attn=ring_attn)


def _scores(model: CLIP, img: torch.Tensor, txt: torch.Tensor) -> torch.Tensor:
    """The logit scale times the cosine similarity of each image and prompt
    embedding: [B, n_prompts]."""
    img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
    scale = torch.exp(model.logit_scale)
    return scale * torch.matmul(img, txt.t())


def clip_hba_forward(model: CLIP, images: torch.Tensor,
                     prompt_tokens: torch.Tensor, *,
                     compute_dtype=torch.float32, adapters: dict | None = None,
                     adapter_cfg: dict | None = None,
                     dropout_key: vdora.DropoutKey | None = None,
                     deterministic: bool = True,
                     remat: bool = False, seq_shard=None,
                     ring_attn: bool = False) -> torch.Tensor:
    """images -> [B, n_prompts] scores (the CLIPHBA contract): the logit
    scale times the cosine similarity of each image and prompt embedding.

    adapters = {"visual": {idx: dora}, "text": {idx: dora}}
    (adapters/dora.py assemble); `dropout_key` splits into a vision and a
    text stream, as the JAX forward splits its key. `remat` recomputes every
    block of both towers in the backward. `seq_shard` / `ring_attn` run the
    VISUAL tower sequence-parallel (the text tower is 66 x 77 tokens, whole
    on every rank)."""
    adapters = adapters or {}
    kv = kt = None
    if dropout_key is not None:
        kv, kt = dropout_key.split()
    img = encode_image(model, images, compute_dtype=compute_dtype,
                       adapters=adapters.get("visual"),
                       adapter_cfg=adapter_cfg, dropout_key=kv,
                       deterministic=deterministic, remat=remat,
                       seq_shard=seq_shard, ring_attn=ring_attn)
    txt = encode_text(model, prompt_tokens, compute_dtype=compute_dtype,
                      adapters=adapters.get("text"), adapter_cfg=adapter_cfg,
                      dropout_key=kt, deterministic=deterministic,
                      remat=remat)
    return _scores(model, img, txt)


def clip_hba_suffix_forward(model: CLIP, vis_hidden: torch.Tensor,
                            txt_hidden: torch.Tensor, txt_eot: torch.Tensor,
                            *, n_vis_suffix: int, n_txt_suffix: int,
                            adapters: dict | None = None,
                            adapter_cfg: dict | None = None,
                            dropout_key: vdora.DropoutKey | None = None,
                            deterministic: bool = True,
                            remat: bool = False) -> torch.Tensor:
    """clip_hba_forward from cached frozen-prefix activations:
    `vis_hidden` = clip_visual_prefix(images), (`txt_hidden`, `txt_eot`) =
    encode_text_prefix(prompt_tokens). Only the adapted suffix blocks and
    the heads run. The dropout key splits into (vision, text) and folds the
    absolute block index as clip_hba_forward does, so a cached step draws
    the full-tower step's masks."""
    adapters = adapters or {}
    kv = kt = None
    if dropout_key is not None:
        kv, kt = dropout_key.split()
    img = vvit.clip_visual_suffix(
        model.visual, vis_hidden, n_suffix=n_vis_suffix,
        adapters=adapters.get("visual"), adapter_cfg=adapter_cfg,
        dropout_key=kv, deterministic=deterministic, remat=remat)
    txt = encode_text_suffix(
        model, txt_hidden, txt_eot, n_suffix=n_txt_suffix,
        adapters=adapters.get("text"), adapter_cfg=adapter_cfg,
        dropout_key=kt, deterministic=deterministic, remat=remat)
    return _scores(model, img, txt)


# -- a fork axis: R adapter sets on one forward -------------------------------

def _split_keys(dropout_keys):
    """Each fork's (vision, text) dropout streams, as clip_hba_forward
    splits its key."""
    if dropout_keys is None:
        return None, None
    pairs = [k.split() for k in dropout_keys]
    return [v for v, _ in pairs], [t for _, t in pairs]


def _text_suffix_forks(model: CLIP, hidden: torch.Tensor, eot: torch.Tensor,
                       n_forks: int, start: int, *, adapters, adapter_cfg,
                       dropout_keys, deterministic: bool,
                       remat: bool) -> torch.Tensor:
    """Text blocks [start, layers) for R forks from the prompts' hidden
    states [N, context, width] (shared: the prompts are every fork's), then
    the heads: [R*N, embed_dim] f32, fork-major."""
    x, forked = vvit.run_blocks_forks(
        model.transformer, hidden, n_forks, False, adapters=adapters,
        adapter_cfg=adapter_cfg, dropout_keys=dropout_keys,
        deterministic=deterministic, start=start, remat=remat)
    if not forked:
        x = x.unsqueeze(0).expand(n_forks, *x.shape).flatten(0, 1)
    return _text_out(model, x, eot.repeat(n_forks))


def _scores_forks(model: CLIP, img: torch.Tensor, img_forked: bool,
                  txt: torch.Tensor, n_forks: int) -> torch.Tensor:
    """`_scores` for each fork: img [R*B or B, E], txt [R*N, E] ->
    [R, B, N]."""
    imgs = img.unflatten(0, (n_forks, -1)) if img_forked else [img] * n_forks
    return torch.stack([_scores(model, i, t) for i, t in
                        zip(imgs, txt.unflatten(0, (n_forks, -1)))])


def clip_hba_forward_forks(model: CLIP, images: torch.Tensor,
                           prompt_tokens: torch.Tensor, n_forks: int, *,
                           forked: bool = True, compute_dtype=torch.float32,
                           adapters: dict | None = None,
                           adapter_cfg: dict | None = None,
                           dropout_keys=None, deterministic: bool = True,
                           remat: bool = False) -> torch.Tensor:
    """clip_hba_forward for R forks that share the frozen CLIP and differ in
    their adapters (adapters/dora.py assemble_forks: the forks' trees per
    adapted block) -> [R, B, n_prompts].

    `images` is [R*B, H, W, 3], each fork's own rows (training: every fork
    has its own data order), or with `forked=False` [B, H, W, 3] seen by
    every fork (eval, RSA). The fork axis is folded into the batch: every
    layer that reads only shared weights runs once on the whole batch (the
    attention is one launch a block), blocks before a tower's first adapter
    run once for shared inputs (the prompts always), and only the adapted
    out_proj (one product a fork) and the scores are per fork.
    `dropout_keys` holds each fork's batch key; fork f draws the masks of
    its solo step."""
    adapters = adapters or {}
    kv, kt = _split_keys(dropout_keys)
    img, img_forked = vvit.clip_visual_encode_forks(
        model.visual, images, n_forks, forked, compute_dtype=compute_dtype,
        adapters=adapters.get("visual"), adapter_cfg=adapter_cfg,
        dropout_keys=kv, deterministic=deterministic, remat=remat)
    txt = _text_suffix_forks(
        model, _text_stem(model, prompt_tokens, compute_dtype),
        torch.argmax(prompt_tokens, dim=-1), n_forks, 0,
        adapters=adapters.get("text"), adapter_cfg=adapter_cfg,
        dropout_keys=kt, deterministic=deterministic, remat=remat)
    return _scores_forks(model, img, img_forked, txt, n_forks)


def clip_hba_suffix_forward_forks(model: CLIP, vis_hidden: torch.Tensor,
                                  txt_hidden: torch.Tensor,
                                  txt_eot: torch.Tensor, n_forks: int, *,
                                  n_vis_suffix: int, n_txt_suffix: int,
                                  forked: bool = True,
                                  adapters: dict | None = None,
                                  adapter_cfg: dict | None = None,
                                  dropout_keys=None,
                                  deterministic: bool = True,
                                  remat: bool = False) -> torch.Tensor:
    """clip_hba_forward_forks from the frozen-prefix caches: `vis_hidden`
    [R*B, S, width] (each fork's rows) or, with `forked=False`, [B, S,
    width] shared; the text prefix (`txt_hidden`, `txt_eot`) is every
    fork's. -> [R, B, n_prompts]."""
    adapters = adapters or {}
    kv, kt = _split_keys(dropout_keys)
    img, img_forked = vvit.clip_visual_suffix_forks(
        model.visual, vis_hidden, n_forks, forked, n_suffix=n_vis_suffix,
        adapters=adapters.get("visual"), adapter_cfg=adapter_cfg,
        dropout_keys=kv, deterministic=deterministic, remat=remat)
    layers = model.cfg.text.layers
    start = layers - n_txt_suffix
    vvit.check_suffix(adapters.get("text"), start, layers, n_txt_suffix,
                      "text")
    txt = _text_suffix_forks(
        model, txt_hidden, txt_eot, n_forks, start,
        adapters=adapters.get("text"), adapter_cfg=adapter_cfg,
        dropout_keys=kt, deterministic=deterministic, remat=remat)
    return _scores_forks(model, img, img_forked, txt, n_forks)
