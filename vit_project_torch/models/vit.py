"""Vision Transformers: the CLIP visual tower under OpenAI's names and the
timm-style ViT classifier under timm's names.

Counterpart of the JAX package's models/vit.py. The modules hold the
parameters; the forward is plain functions on them (the classifier's and
its blocks' ``forward`` call those functions, so module hooks such as
FSDP2's see every block).

The CLIP visual tower (``conv1.weight``,
``transformer.resblocks.{i}.attn.in_proj_weight``, ``ln_1``, ``mlp.c_fc``,
...):

- ``block_forward``: the pre-norm block with the semantics of the JAX
  block's fused-kernel branch. The 1/sqrt(dh) score scale is folded into the
  q rows of the packed [3D, D] projection (weight and bias), ONE matmul
  emits [B, S, 3D], and that goes whole to the flash attention op. A DoRA
  adapter, when given, replaces the attention out_proj.
- ``run_blocks``: a range of a tower's blocks with their adapters and
  per-block dropout streams, each optionally recomputed in the backward
  (shared by the image and text towers).
- ``clip_visual_encode``: stem (patch embed + CLS + positions + ln_pre),
  blocks, then ln_post over the CLS token and the projection, in f32;
  ``clip_visual_prefix`` / ``clip_visual_suffix`` split it at the first
  adapted block (the frozen-prefix cache) on the same stem, blocks and
  tail;
- ``block_forward_forks`` / ``run_blocks_forks`` (and the
  ``clip_visual_*_forks`` encoders): R forks' adapters on one forward, the
  fork axis folded into the batch. Shared layers and the attention run
  once on [R*B, S, D] (or once on [B, S, D] while the input is shared);
  each adapted out_proj is the fork's own solo product on its rows.

The classifier (``VisionTransformerClassifier``: ``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.{i}.norm1/attn.qkv/attn.proj/norm2/
mlp.fc1/mlp.fc2``, ``norm``, ``head``), the model of ViT-B/16 ImageNet
training:

- ``classifier_block``: the same fused-kernel branch of the JAX block, with
  the tanh GELU by default and a per-call ``fused_dw`` that routes every
  dense layer's weight and bias gradients through ``ops/fused_dw.py``;
- ``vit_embed`` (patch embed with the input normalization folded in, CLS,
  positions), ``vit_encode`` (``classifier_blocks``: the blocks, each
  optionally recomputed in the backward; the final LayerNorm over all
  tokens), ``vit_classify`` (``classifier_head``: f32 logits from the CLS
  token) and ``forward_features`` (``pool_tokens``: CLS or mean pooling).
  A pipeline stage (``parallel/pipeline.py``) runs the stem, a range of
  the blocks, or ``vit_pool`` (the final LayerNorm and the pool) and the
  head, on the same functions.

Both block functions serve int8 weights (``ops/quant.py``, the JAX block's
quantized branch): ONE packed int8 projection [B, S, 3D], its q lanes then
multiplied by 1/sqrt(dh) in the compute dtype (not folded into the weights),
then the packed flash op; the other three dense layers take the int8
product through ``ops.nn.dense``.

Tensor parallelism (``tp``, a model group of T ranks): each block is
``classifier_block_tp``, Megatron's form on the rank's shards of the block
(``parallel/mesh.shard_vit_params_tp``: whole heads, fc1's output rows,
the input columns of the attention output and fc2). The packed attention
op runs on the rank's own heads, [B, S, 3D/T] with H/T heads; JAX's tp
forward takes its XLA einsum path there (a pallas_call has no GSPMD rule),
and attention is independent per head, so the function is the same.

MoE blocks (``cfg.moe_experts`` > 0, ``ops/moe.py``): the last block of
each ``moe_every`` group holds a ``MoEMlp`` in the place of its MLP, and
``classifier_block`` runs it after norm2; with ``with_aux`` the blocks
return (x, aux) and ``vit_encode`` / ``vit_classify`` sum aux over them.
Under expert parallelism (``moe_groups``) each rank holds its experts;
the rest of the block is whole on every rank.

Sequence parallelism (``seq_shard``, a model group's
``parallel/mesh.SeqShard``; the classifier and the CLIP visual tower):
each rank of the group runs the stem whole, keeps its tokens ``bounds(S)``
(GSPMD's ragged split) and runs every per-token layer (LayerNorms,
projections, MLP) on them alone. Two forms of the attention, which is the
only token-mixing op:

- the gather form (the default): each rank gathers the packed, prescaled
  qkv of the group along S (``parallel/dist.GatherSeq``), runs the packed
  flash op on the whole sequence and keeps its own rows of the output;
  the gather's backward sums the whole-sequence dqkv over the group. Every
  rank does the whole sequence's attention (n times the FLOPs of its
  share). A MoE block gathers its input the same way, routes the whole
  sequence (so capacity and queue order are one process's) and keeps its
  rows;
- the ring form (``ring_attn``): the stem's tokens are padded to n *
  ceil(S / n) (``parallel/ring.pad_seq``), each rank takes its block and
  the attention is ``parallel/ring.ring_attention_bshd`` on its q, k, v
  [B, S_pad/n, H, dh] (unscaled, as JAX's einsum path has them), k/v
  rotating around the group. No attention kernel runs there.

At the end of the trunk each rank drops its padding and the group's
tokens are gathered (``GatherSeq``) into the whole [B, S, D], which every
rank returns. The gathers' backward sums over the group, so a loss on
those tokens must be differentiated on one rank of the group only (the
trainers seed model rank 0's loss with 1 and the others' with 0); every
rank still runs every backward collective.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as tdist
import torch.utils.checkpoint
from torch import nn

from ..ops import attention as vattn
from ..ops import dora as vdora
from ..ops import moe as vmoe
from ..ops import nn as vnn
from ..ops import quant as vquant
from ..parallel import dist
from ..parallel import ring as vring


@dataclass(frozen=True)
class ViTConfig:
    patch: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    image_size: int = 224
    pre_norm: bool = False        # LayerNorm after the stem (CLIP's ln_pre)
    patch_bias: bool = True       # CLIP's conv1 has no bias
    quick_gelu: bool = False      # CLIP uses QuickGELU
    gelu_approx: bool = True      # tanh-approximate GELU, the JAX package's
                                  # default (timm's is the exact erf GELU)
    out_dim: Optional[int] = None  # CLIP projection dim (768 for ViT-L/14)
    num_classes: Optional[int] = None  # classifier head (timm path)
    # Mixture-of-Experts (ops/moe.py): > 0 replaces the dense MLP of every
    # `moe_every`-th block with a MoE of this many experts; 0 = dense
    moe_experts: int = 0
    moe_every: int = 2             # Switch default: every other block
    moe_capacity: float = 1.25     # per-expert capacity factor
    moe_topk: int = 1              # 1 = Switch routing, 2 = GShard top-2

    @property
    def seq_len(self) -> int:
        return (self.image_size // self.patch) ** 2 + 1

    def is_moe_block(self, i: int) -> bool:
        """MoE goes in the LAST block of each `moe_every` group (JAX's
        rule: Switch's odd depths for moe_every=2)."""
        return (self.moe_experts > 0
                and i % self.moe_every == self.moe_every - 1)


# the CLIP visual tower's flags (models/clip.py builds its towers with them)
CLIP_VISUAL_FLAGS = dict(pre_norm=True, patch_bias=False, quick_gelu=True)
CLIP_VIT_L14_VISUAL = ViTConfig(patch=14, width=1024, layers=24, heads=16,
                                out_dim=768, **CLIP_VISUAL_FLAGS)
CLIP_VIT_B32_VISUAL = ViTConfig(patch=32, width=768, layers=12, heads=12,
                                out_dim=512, **CLIP_VISUAL_FLAGS)
CLIP_VIT_B16_VISUAL = ViTConfig(patch=16, width=768, layers=12, heads=12,
                                out_dim=512, **CLIP_VISUAL_FLAGS)

VIT_B16 = ViTConfig(patch=16, width=768, layers=12, heads=12, num_classes=1000)

# name registry for CLI surfaces (timm-style names; the reference uses
# timm.create_model('vit_base_patch16_224'), train_vit_sgd.py:283)
VIT_CONFIGS = {
    "vit_base_patch16_224": VIT_B16,
    "vit_small_patch16_224": ViTConfig(patch=16, width=384, layers=12, heads=6,
                                       num_classes=1000),
    "vit_large_patch16_224": ViTConfig(patch=16, width=1024, layers=24,
                                       heads=16, num_classes=1000),
    "test-tiny": ViTConfig(patch=8, width=32, layers=2, heads=2,
                           image_size=32, num_classes=10),
}


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
    """Holds the patch embedding as a conv kernel ``weight`` [D, 3, p, p]
    (and ``bias`` [D] when asked for; OpenAI's ``conv1`` has none). It is
    never run as a convolution: ``patch_embed`` does reshape + matmul."""

    def __init__(self, width: int, patch: int, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(width, 3, patch, patch))
        self.bias = nn.Parameter(torch.empty(width)) if bias else None


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


def _wt(w):
    """The [in, out] operand ``vnn.dense`` takes for an [out, in] weight
    slot: a float weight's transposed view, or a ``QuantizedWeight`` as it
    is (``dense`` sends it to the int8 product)."""
    return w if vquant.is_quantized(w) else w.t()


def _quantized_qkv(h: torch.Tensor, wq, b: torch.Tensor,
                   dh: int) -> torch.Tensor:
    """The int8 packed projection [B, S, 3D] with its q lanes multiplied by
    1/sqrt(dh) in h's dtype after the product, as the packed kernel expects
    them (JAX models/vit.py:196-201)."""
    qkv = vnn.dense(h, wq, b)
    qkv[..., :qkv.shape[-1] // 3].mul_(1.0 / (dh ** 0.5))
    return qkv


@dataclass(frozen=True)
class SeqParallel:
    """A sequence-parallel trunk's context for its blocks: the layout
    `seq`, the real token count `S` and the form (`ring`; the gather form
    otherwise). Built by ``_seq_parallel_enter``."""
    seq: object
    S: int
    ring: bool

    def bounds(self) -> tuple[int, int]:
        return self.seq.bounds(self.S)


def _attention(qkv: torch.Tensor, heads: int, sp: SeqParallel | None,
               causal: bool = False) -> torch.Tensor:
    """The attention core on a packed qkv [B, s, 3D] -> [B, s, D]: the
    packed flash op (q lanes prescaled), or under `sp` the gather form on
    the whole sequence (prescaled) or the ring (unscaled q)."""
    if sp is None:
        return vattn.flash_mha_packed_qkv(qkv, num_heads=heads, causal=causal)
    B, s, D3 = qkv.shape
    if sp.ring:
        q, k, v = qkv.view(B, s, 3, heads, D3 // (3 * heads)).unbind(2)
        o = vring.ring_attention_bshd(q, k, v, sp.seq, s_valid=sp.S,
                                      causal=causal)
        return o.reshape(B, s, D3 // 3)
    lo, hi = sp.bounds()
    full = dist.GatherSeq.apply(qkv, sp.seq, sp.S)
    return vattn.flash_mha_packed_qkv(full, num_heads=heads,
                                      causal=causal)[:, lo:hi]


def block_forward(blk: ResidualAttentionBlock, x: torch.Tensor, *,
                  adapter: dict | None = None,
                  adapter_cfg: dict | None = None,
                  dropout_key: vdora.DropoutKey | None = None,
                  deterministic: bool = True,
                  sp: SeqParallel | None = None) -> torch.Tensor:
    """Pre-norm transformer block on x [B, S, D] (x.dtype is the compute
    dtype). Attention goes through the packed flash op; with `adapter`
    ({trainable, buffers}) the out_proj is the DoRA layer instead. Int8
    weights (serving) take the quantized branch. Under `sp` x holds this
    rank's tokens (module docstring)."""
    h = vnn.layer_norm(x, blk.ln_1.weight, blk.ln_1.bias)
    dh = h.shape[-1] // blk.heads
    ring = sp is not None and sp.ring
    if vquant.is_quantized(blk.attn.in_proj_weight):
        qkv = _quantized_qkv(h, blk.attn.in_proj_weight,
                             blk.attn.in_proj_bias, dh)
    elif ring:
        qkv = vnn.dense(h, blk.attn.in_proj_weight.t(),
                        blk.attn.in_proj_bias)
    else:
        w, b = _prescaled_in_proj(blk.attn, dh, h.dtype)
        qkv = vnn.dense(h, w.t(), b)                              # [B, S, 3D]
    o = _attention(qkv, blk.heads, sp, causal=blk.causal)
    if adapter is not None:
        o = vdora.dora_linear(
            o, adapter["trainable"], adapter["buffers"],
            alpha=adapter_cfg["alpha"], r=adapter_cfg["r"],
            dropout_p=adapter_cfg.get("dropout", 0.0),
            dropout_key=dropout_key, deterministic=deterministic)
    else:
        o = vnn.dense(o, _wt(blk.attn.out_proj.weight), blk.attn.out_proj.bias)
    x = x + o
    h = vnn.layer_norm(x, blk.ln_2.weight, blk.ln_2.bias)
    h = vnn.mlp(h, _wt(blk.mlp.c_fc.weight), blk.mlp.c_fc.bias,
                _wt(blk.mlp.c_proj.weight), blk.mlp.c_proj.bias)
    return x + h


def run_blocks(transformer: Transformer, x: torch.Tensor, *,
               adapters: dict | None = None, adapter_cfg: dict | None = None,
               dropout_key: vdora.DropoutKey | None = None,
               deterministic: bool = True, start: int = 0,
               stop: int | None = None, remat: bool = False,
               sp: SeqParallel | None = None) -> torch.Tensor:
    """Blocks [start, stop) of `transformer` on x; block i takes adapters[i]
    (if any) and the dropout stream dropout_key.fold_in(i), with i the
    absolute index, so a split tower draws the masks of the whole one.

    `remat=True` recomputes each block's forward in the backward
    (torch.utils.checkpoint) instead of holding its activations. The
    recompute rebuilds the dropout generator from its key, so it draws the
    same mask and the gradients are the same numbers."""
    adapters = adapters or {}
    blocks = transformer.resblocks
    for i in range(start, len(blocks) if stop is None else stop):
        ad = adapters.get(i)
        dk = None
        if ad is not None and dropout_key is not None:
            dk = dropout_key.fold_in(i)
        kw = dict(adapter=ad, adapter_cfg=adapter_cfg, dropout_key=dk,
                  deterministic=deterministic, sp=sp)
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                block_forward, blocks[i], x, use_reentrant=False, **kw)
        else:
            x = block_forward(blocks[i], x, **kw)
    return x


def _fork_out_proj(o: torch.Tensor, n_forks: int, forked: bool,
                   adapter: dict, adapter_cfg: dict,
                   dropout_keys, deterministic: bool) -> torch.Tensor:
    """The adapted out_proj of R forks on the attention output o: [R*B, S, D]
    (each fork's rows, in fork order) or, when `forked` is False, [B, S, D]
    shared by the forks. `adapter["trainable"]` lists the forks' adapter
    leaves; each fork's weight is its own `dora_weight` in f32 (its
    keep-mask drawn from its own key in `dropout_keys`), and each fork's
    product is the solo layer's (`ops.nn.dense` in o's dtype on that fork's
    rows), so a fork's forward and gradients are its solo step's, bit for
    bit in f32 on the CPU. (One bmm over the stacked [R, in, out] weights
    sums the weight gradient in another order, which is enough to flip
    near-tied ranks of the RSA.) Returns [R*B, S, out]."""
    p = adapter_cfg.get("dropout", 0.0)
    D = adapter["buffers"]["D"]
    drop = not deterministic and p > 0.0
    if drop and dropout_keys is None:
        raise ValueError("the forks' dropout needs their dropout_keys")
    ws = [vdora.dora_weight(
        tr, D, alpha=adapter_cfg["alpha"], r=adapter_cfg["r"], dropout_p=p,
        deterministic=deterministic,
        keep=vdora.dropout_keep_mask(D.shape, p, dropout_keys[f], o.device)
        if drop else None) for f, tr in enumerate(adapter["trainable"])]
    bias = adapter["buffers"]["bias"]
    # chunk, not indexing: its backward is one cat, where R selects would
    # each fill a zero tensor of all R forks' rows
    rows = o.chunk(n_forks) if forked else [o] * n_forks
    return torch.cat([vnn.dense(x, w, bias) for x, w in zip(rows, ws)])


def block_forward_forks(blk: ResidualAttentionBlock, x: torch.Tensor,
                        n_forks: int, forked: bool, *,
                        adapter: dict | None = None,
                        adapter_cfg: dict | None = None,
                        dropout_keys=None,
                        deterministic: bool = True) -> torch.Tensor:
    """`block_forward` over a fork axis folded into the batch. x is
    [R*B, S, D] when `forked` (R forks' rows, fork-major), else [B, S, D]
    shared by the R forks. The LayerNorms, the packed projection, the
    attention (one launch on x's whole batch) and the MLP use the shared
    frozen weights; with `adapter` (the forks' trainable trees, a list) the
    out_proj is each fork's own, and the block's output is forked from
    there on. Returns x, [R*B, S, D] if forked or adapted."""
    h = vnn.layer_norm(x, blk.ln_1.weight, blk.ln_1.bias)
    D = h.shape[-1]
    w, b = _prescaled_in_proj(blk.attn, D // blk.heads, h.dtype)
    qkv = vnn.dense(h, w.t(), b)
    o = vattn.flash_mha_packed_qkv(qkv, num_heads=blk.heads,
                                   causal=blk.causal)
    if adapter is not None:
        o = _fork_out_proj(o, n_forks, forked, adapter, adapter_cfg,
                           dropout_keys, deterministic)
        if not forked:
            x = x.unsqueeze(0).expand(n_forks, *x.shape).reshape(o.shape)
    else:
        o = vnn.dense(o, blk.attn.out_proj.weight.t(), blk.attn.out_proj.bias)
    x = x + o
    h = vnn.layer_norm(x, blk.ln_2.weight, blk.ln_2.bias)
    h = vnn.mlp(h, blk.mlp.c_fc.weight.t(), blk.mlp.c_fc.bias,
                blk.mlp.c_proj.weight.t(), blk.mlp.c_proj.bias)
    return x + h


def run_blocks_forks(transformer: Transformer, x: torch.Tensor,
                     n_forks: int, forked: bool, *,
                     adapters: dict | None = None,
                     adapter_cfg: dict | None = None, dropout_keys=None,
                     deterministic: bool = True, start: int = 0,
                     stop: int | None = None, remat: bool = False):
    """`run_blocks` over a fork axis: blocks [start, stop) on x ([R*B, S, D]
    if `forked`, else [B, S, D] shared by the R forks). Block i takes
    adapters[i] (the forks' trainable trees) and fork f's dropout stream
    dropout_keys[f].fold_in(i), the solo run's key path. Blocks before the
    first adapter run once for all forks when x is shared. Returns
    (x, forked)."""
    adapters = adapters or {}
    blocks = transformer.resblocks
    for i in range(start, len(blocks) if stop is None else stop):
        ad = adapters.get(i)
        dks = None
        if ad is not None and dropout_keys is not None:
            dks = [k.fold_in(i) for k in dropout_keys]
        kw = dict(adapter=ad, adapter_cfg=adapter_cfg, dropout_keys=dks,
                  deterministic=deterministic)
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                block_forward_forks, blocks[i], x, n_forks, forked,
                use_reentrant=False, **kw)
        else:
            x = block_forward_forks(blocks[i], x, n_forks, forked, **kw)
        forked = forked or ad is not None
    return x, forked


def check_suffix(adapters: dict | None, start: int, layers: int,
                 n_suffix: int, tower: str) -> None:
    """Refuse a split whose frozen prefix would hold an adapted block."""
    if not 0 <= n_suffix <= layers:
        raise ValueError(f"n_suffix={n_suffix} outside [0, {layers}]")
    below = sorted(i for i in (adapters or {}) if i < start)
    if below:
        raise ValueError(
            f"{tower} adapters at blocks {below} live below the prefix/suffix "
            f"split ({start}): the cached prefix would silently exclude them")


def _clip_visual_stem(visual: VisionTransformer, images: torch.Tensor, *,
                      use_pos_embedding: bool = True,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """Patch embed + CLS + (unless `use_pos_embedding` is False) positions
    + ln_pre; images NHWC."""
    cfg = visual.cfg
    x = images.to(compute_dtype)
    w = vnn.conv_kernel_to_patch_matrix(visual.conv1.weight)
    x = vnn.patch_embed(x, w, None, cfg.patch)
    cls = visual.class_embedding.to(x.dtype).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    if use_pos_embedding:
        x = x + visual.positional_embedding.to(x.dtype)
    return vnn.layer_norm(x, visual.ln_pre.weight, visual.ln_pre.bias)


def _clip_visual_out(visual: VisionTransformer, x: torch.Tensor) -> torch.Tensor:
    """ln_post over the CLS token, then the projection: [B, out_dim] f32.
    The projection is cast to the compute dtype and multiplied in f32 (the
    f32-accumulating dot of the JAX tail)."""
    cls_tok = vnn.layer_norm(x[:, 0], visual.ln_post.weight, visual.ln_post.bias)
    return torch.matmul(cls_tok.float(), visual.proj.to(cls_tok.dtype).float())


def clip_visual_encode(visual: VisionTransformer, images: torch.Tensor, *,
                       compute_dtype=torch.float32,
                       adapters: dict | None = None,
                       adapter_cfg: dict | None = None,
                       dropout_key: vdora.DropoutKey | None = None,
                       deterministic: bool = True,
                       use_pos_embedding: bool = True,
                       remat: bool = False, seq_shard=None,
                       ring_attn: bool = False) -> torch.Tensor:
    """CLIP visual tower: images [B, H, W, 3] (normalized, NHWC) ->
    [B, out_dim] f32. `adapters` maps block index -> {trainable, buffers}.
    `use_pos_embedding` is the reference CLIPHBA's pos_embedding flag (True
    for its ViT runs): False skips the learned positions. `seq_shard` /
    `ring_attn`: sequence parallelism, gather or ring form (module
    docstring)."""
    _seq_parallel_checks(visual.cfg, seq_shard, ring_attn,
                         [b.attn.in_proj_weight
                          for b in visual.transformer.resblocks])
    x = _clip_visual_stem(visual, images, use_pos_embedding=use_pos_embedding,
                          compute_dtype=compute_dtype)
    x, sp = _seq_parallel_enter(x, seq_shard, ring_attn)
    x = run_blocks(visual.transformer, x, adapters=adapters,
                   adapter_cfg=adapter_cfg, dropout_key=dropout_key,
                   deterministic=deterministic, remat=remat, sp=sp)
    return _clip_visual_out(visual, _seq_parallel_exit(x, sp))


def clip_visual_prefix(visual: VisionTransformer, images: torch.Tensor, *,
                       n_suffix: int, use_pos_embedding: bool = True,
                       compute_dtype=torch.float32) -> torch.Tensor:
    """The frozen prefix of the CLIP visual tower: the stem and the first
    `layers - n_suffix` blocks -> hidden tokens [B, S, width] in the compute
    dtype.

    The CLIP-HBA fine-tune adapts only the last `vision_layers` blocks and
    THINGS has no random augmentation, so these activations are a pure
    function of the image: computed once per run and reused every epoch
    (train/clip_loop.py build_prefix_cache)."""
    layers = visual.cfg.layers
    check_suffix(None, 0, layers, n_suffix, "visual")
    x = _clip_visual_stem(visual, images, use_pos_embedding=use_pos_embedding,
                          compute_dtype=compute_dtype)
    return run_blocks(visual.transformer, x, stop=layers - n_suffix)


def clip_visual_suffix(visual: VisionTransformer, hidden: torch.Tensor, *,
                       n_suffix: int, adapters: dict | None = None,
                       adapter_cfg: dict | None = None,
                       dropout_key: vdora.DropoutKey | None = None,
                       deterministic: bool = True,
                       remat: bool = False) -> torch.Tensor:
    """The trainable suffix: blocks [layers - n_suffix, layers), ln_post and
    the projection, from cached prefix activations -> [B, out_dim] f32.
    Block indices stay absolute, so the adapter lookup and the per-block
    dropout streams are clip_visual_encode's."""
    layers = visual.cfg.layers
    start = layers - n_suffix
    check_suffix(adapters, start, layers, n_suffix, "visual")
    x = run_blocks(visual.transformer, hidden, adapters=adapters,
                   adapter_cfg=adapter_cfg, dropout_key=dropout_key,
                   deterministic=deterministic, start=start, remat=remat)
    return _clip_visual_out(visual, x)


def clip_visual_encode_forks(visual: VisionTransformer,
                             images: torch.Tensor, n_forks: int,
                             forked: bool, *, compute_dtype=torch.float32,
                             adapters: dict | None = None,
                             adapter_cfg: dict | None = None,
                             dropout_keys=None, deterministic: bool = True,
                             remat: bool = False):
    """`clip_visual_encode` for R forks: images [R*B, H, W, 3] (each fork's
    rows) when `forked`, else [B, H, W, 3] shared. Returns
    ([R*B or B, out_dim] f32, forked)."""
    x = _clip_visual_stem(visual, images, compute_dtype=compute_dtype)
    x, forked = run_blocks_forks(visual.transformer, x, n_forks, forked,
                                 adapters=adapters, adapter_cfg=adapter_cfg,
                                 dropout_keys=dropout_keys,
                                 deterministic=deterministic, remat=remat)
    return _clip_visual_out(visual, x), forked


def clip_visual_suffix_forks(visual: VisionTransformer, hidden: torch.Tensor,
                             n_forks: int, forked: bool, *, n_suffix: int,
                             adapters: dict | None = None,
                             adapter_cfg: dict | None = None,
                             dropout_keys=None, deterministic: bool = True,
                             remat: bool = False):
    """`clip_visual_suffix` for R forks, from cached prefix activations
    ([R*B, S, width] when `forked`, else [B, S, width] shared). Returns
    ([R*B or B, out_dim] f32, forked)."""
    layers = visual.cfg.layers
    start = layers - n_suffix
    check_suffix(adapters, start, layers, n_suffix, "visual")
    x, forked = run_blocks_forks(visual.transformer, hidden, n_forks, forked,
                                 adapters=adapters, adapter_cfg=adapter_cfg,
                                 dropout_keys=dropout_keys,
                                 deterministic=deterministic, start=start,
                                 remat=remat)
    return _clip_visual_out(visual, x), forked


# -- the timm-style classifier -------------------------------------------------

class Attention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)


class Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)


class Block(nn.Module):
    """A classifier block: ``mlp`` (dense) or, with `moe_experts`, ``moe``
    (``ops.moe.MoEMlp``) after norm2."""

    def __init__(self, width: int, mlp_ratio: int, moe_experts: int = 0):
        super().__init__()
        self.norm1 = nn.LayerNorm(width)
        self.attn = Attention(width)
        self.norm2 = nn.LayerNorm(width)
        if moe_experts:
            self.moe = vmoe.MoEMlp(width, width * mlp_ratio, moe_experts)
        else:
            self.mlp = Mlp(width, width * mlp_ratio)

    def forward(self, x: torch.Tensor, heads: int, *, act,
                fused_dw: bool = False, tp=None, with_aux: bool = False,
                moe: dict | None = None, sp: SeqParallel | None = None):
        """``classifier_block`` on this block (through the module call, so
        FSDP2's hooks gather a sharded block's parameters around it), or
        ``classifier_block_tp`` over the model group `tp`."""
        if tp is not None:
            y = classifier_block_tp(self, x, heads, act=act, group=tp)
            return (y, _no_aux(y)) if with_aux else y
        return classifier_block(self, x, heads, act=act, fused_dw=fused_dw,
                                with_aux=with_aux, moe=moe, sp=sp)


class PatchEmbed(nn.Module):
    def __init__(self, width: int, patch: int, bias: bool):
        super().__init__()
        self.proj = PatchConv(width, patch, bias=bias)


class VisionTransformerClassifier(nn.Module):
    """Parameters of the ViT classifier under timm's state-dict names (f32
    master weights, [out, in] linear layout)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        if cfg.num_classes is None:
            raise ValueError("the classifier needs cfg.num_classes")
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.width, cfg.patch, cfg.patch_bias)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.width))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.seq_len, cfg.width))
        self.norm_pre = nn.LayerNorm(cfg.width) if cfg.pre_norm else None
        self.blocks = nn.ModuleList(
            Block(cfg.width, cfg.mlp_ratio,
                  cfg.moe_experts if cfg.is_moe_block(i) else 0)
            for i in range(cfg.layers))
        self.norm = nn.LayerNorm(cfg.width)
        self.head = nn.Linear(cfg.width, cfg.num_classes)

    def forward(self, images: torch.Tensor, *, pool: str | None = None,
                **kw) -> torch.Tensor:
        """``vit_classify`` (or, with `pool`, ``forward_features``) on this
        model through the module call, which FSDP2 hooks on a sharded
        model."""
        if pool is None:
            return vit_classify(self, images, **kw)
        return forward_features(self, images, pool=pool, **kw)


def empty_vit(cfg: ViTConfig, device) -> VisionTransformerClassifier:
    """A classifier whose parameters are allocated on `device` and not
    initialized (built on the meta device: no init kernels run)."""
    with torch.device("meta"):
        model = VisionTransformerClassifier(cfg)
    return model.to_empty(device=device)


@torch.no_grad()
def init_vit_params(model: VisionTransformerClassifier,
                    generator: torch.Generator) -> VisionTransformerClassifier:
    """Random weights in place, with the distributions of the JAX package's
    init_vit_params: truncated normals of std 0.02 (cut at two deviations)
    for the patch, block and head weights and the CLS and position
    embeddings, unit LayerNorms, zero biases; a MoE block's router and
    expert weights as JAX's init_moe_mlp draws them (the same normals, zero
    biases). The numbers differ from JAX's: a test that compares the two
    packages converts one set of weights."""
    def tn(p):
        p.copy_(vnn.trunc_normal(p.shape, 0.02, generator=generator,
                                 device=p.device))

    tn(model.patch_embed.proj.weight)
    if model.patch_embed.proj.bias is not None:
        model.patch_embed.proj.bias.zero_()
    tn(model.cls_token)
    tn(model.pos_embed)
    lns = [model.norm] + ([model.norm_pre] if model.norm_pre is not None
                          else [])
    for blk in model.blocks:
        lns += [blk.norm1, blk.norm2]
        dense = [blk.attn.qkv, blk.attn.proj]
        if hasattr(blk, "moe"):
            vmoe.init_moe_mlp(blk.moe, tn)
        else:
            dense += [blk.mlp.fc1, blk.mlp.fc2]
        for lin in dense:
            tn(lin.weight)
            lin.bias.zero_()
    for ln in lns:
        ln.weight.fill_(1.0)
        ln.bias.zero_()
    tn(model.head.weight)
    model.head.bias.zero_()
    return model


def _activation(cfg: ViTConfig):
    if cfg.quick_gelu:
        return vnn.quick_gelu
    return vnn.gelu_tanh if cfg.gelu_approx else vnn.gelu


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    """A dense block's aux term (JAX's jnp.zeros((), f32))."""
    return torch.zeros((), dtype=torch.float32, device=x.device)


def classifier_block(blk: Block, x: torch.Tensor, heads: int, *, act,
                     fused_dw: bool = False, with_aux: bool = False,
                     moe: dict | None = None, sp: SeqParallel | None = None):
    """Pre-norm block on x [B, S, D] in the compute dtype, as the JAX block's
    fused-kernel branch computes it: the 1/sqrt(dh) score scale multiplies
    the q columns of the one packed projection (weight and bias, in f32, as
    JAX's colscale does), the [B, S, 3D] result goes whole to the packed
    flash attention op, then the output projection and the MLP, or in a MoE
    block ``ops.moe.moe_mlp`` (`moe`: its capacity_factor, topk and
    groups). With `fused_dw` every dense layer here takes (dW, db) from the
    fused kernel (the expert FFNs are batched products). Int8 weights
    (serving) take the quantized branch; MoE blocks stay float. With
    `with_aux` the result is (x, aux), aux 0 for a dense block. Under `sp`
    x holds this rank's tokens (module docstring)."""
    h = vnn.layer_norm(x, blk.norm1.weight, blk.norm1.bias)
    D = h.shape[-1]
    ring = sp is not None and sp.ring
    if vquant.is_quantized(blk.attn.qkv.weight):
        qkv = _quantized_qkv(h, blk.attn.qkv.weight, blk.attn.qkv.bias,
                             D // heads)
    elif ring:
        qkv = vnn.dense(h, blk.attn.qkv.weight.t(), blk.attn.qkv.bias,
                        fused_dw=fused_dw)
    else:
        colscale = torch.ones(3 * D, dtype=torch.float32, device=h.device)
        colscale[:D] = 1.0 / ((D // heads) ** 0.5)
        w = blk.attn.qkv.weight * colscale[:, None]          # [3D, D]
        b = blk.attn.qkv.bias * colscale
        qkv = vnn.dense(h, w.t(), b, fused_dw=fused_dw)      # [B, S, 3D]
    o = _attention(qkv, heads, sp)
    o = vnn.dense(o, _wt(blk.attn.proj.weight), blk.attn.proj.bias,
                  fused_dw=fused_dw)
    x = x + o
    h = vnn.layer_norm(x, blk.norm2.weight, blk.norm2.bias)
    if hasattr(blk, "moe"):
        if sp is not None:
            # the gather form: route the whole sequence, keep this rank's
            # rows (the ring is refused with MoE blocks)
            lo, hi = sp.bounds()
            h, aux = vmoe.moe_mlp(dist.GatherSeq.apply(h, sp.seq, sp.S),
                                  blk.moe, act=act, **(moe or {}))
            h = h[:, lo:hi]
        else:
            h, aux = vmoe.moe_mlp(h, blk.moe, act=act, **(moe or {}))
    else:
        h = vnn.mlp(h, _wt(blk.mlp.fc1.weight), blk.mlp.fc1.bias,
                    _wt(blk.mlp.fc2.weight), blk.mlp.fc2.bias, act=act,
                    fused_dw=fused_dw)
        aux = _no_aux(h) if with_aux else None
    x = x + h
    return (x, aux) if with_aux else x


def classifier_block_tp(blk: Block, x: torch.Tensor, heads: int, *, act,
                        group) -> torch.Tensor:
    """``classifier_block`` on a model rank's shards of the block (x [B, S,
    D] whole on every rank of `group`, T ranks): the packed projection of
    the rank's heads [B, S, 3D/T] ([q_t | k_t | v_t], the 1/sqrt(dh)
    colscale on its q columns), the packed attention op on its H/T heads,
    its part of the output projection, summed over the group, then the
    whole bias once; the MLP the same way (fc1's rows of the rank, its
    part of fc2, the sum, fc2's bias). Two all-reduces forward, two
    backward, in the same order on every rank."""
    T = tdist.get_world_size(group)
    h = vnn.layer_norm(x, blk.norm1.weight, blk.norm1.bias)
    h = dist.CopyToGroup.apply(h, group)
    dl = blk.attn.qkv.weight.shape[0] // 3                   # D / T
    colscale = torch.ones(3 * dl, dtype=torch.float32, device=h.device)
    colscale[:dl] = 1.0 / ((h.shape[-1] // heads) ** 0.5)
    w = blk.attn.qkv.weight * colscale[:, None]                # [3D/T, D]
    b = blk.attn.qkv.bias * colscale
    qkv = vnn.dense(h, w.t(), b)                               # [B, S, 3D/T]
    o = vattn.flash_mha_packed_qkv(qkv, num_heads=heads // T)
    o = dist.ReduceFromGroup.apply(vnn.dense(o, blk.attn.proj.weight.t()),
                                   group)
    x = x + (o + blk.attn.proj.bias.to(o.dtype))
    h = vnn.layer_norm(x, blk.norm2.weight, blk.norm2.bias)
    h = dist.CopyToGroup.apply(h, group)
    h = act(vnn.dense(h, blk.mlp.fc1.weight.t(), blk.mlp.fc1.bias))
    h = dist.ReduceFromGroup.apply(vnn.dense(h, blk.mlp.fc2.weight.t()), group)
    return x + (h + blk.mlp.fc2.bias.to(h.dtype))


def _seq_parallel_checks(cfg: ViTConfig, seq_shard, ring_attn: bool,
                         qkv_weights) -> None:
    """JAX's sp / ring argument checks, shared by both trunks, and the
    port's refusal of int8 weights (a serving path; sp is training's)."""
    if ring_attn and seq_shard is None:
        raise ValueError("ring_attn=True needs seq_shard (the sequence-"
                         "parallel mesh constraint)")
    if seq_shard is not None and any(map(vquant.is_quantized, qkv_weights)):
        raise ValueError("seq_shard (sequence parallelism) takes float "
                         "weights: int8 weights are a serving path")
    if ring_attn and cfg.moe_experts > 0:
        raise ValueError(
            "ring_attn does not compose with MoE blocks: ring padding "
            "tokens would compete for expert capacity and pollute the "
            "aux loss — use the gather sp path (no padding)")


def _seq_parallel_enter(x: torch.Tensor, seq_shard, ring_attn: bool):
    """The top of a sequence-parallel block stack: this rank's tokens of
    the stem's x [B, S, D] (for the ring, its block of the sequence
    zero-padded by ``pad_seq``: padded keys are masked, padded rows
    dropped at the end), and the blocks' context. (x, None) without
    `seq_shard`."""
    if seq_shard is None:
        return x, None
    S = x.shape[1]
    lo, hi = seq_shard.bounds(S)
    if ring_attn:
        x, _ = vring.pad_seq(x, seq_shard.n)
        lo = seq_shard.index * seq_shard.shard_len(S)
        hi = lo + seq_shard.shard_len(S)
    return x[:, lo:hi], SeqParallel(seq_shard, S, ring_attn)


def _seq_parallel_exit(x: torch.Tensor, sp: SeqParallel | None):
    """The whole [B, S, D] from the group's shards (this rank's padding
    dropped), on every rank; x itself without `sp`."""
    if sp is None:
        return x
    lo, hi = sp.bounds()
    return dist.GatherSeq.apply(x[:, :hi - lo], sp.seq, sp.S)


def vit_embed(model: VisionTransformerClassifier, images: torch.Tensor, *,
              input_norm: tuple | None = None, compute_dtype=torch.float32,
              fused_dw: bool = False) -> torch.Tensor:
    """The stem: patchify + embed (the normalization folded into the patch
    matrix when `input_norm=(mean, std)` marks `images` as raw 0..255 NHWC),
    CLS concat, positional add, optional pre-norm."""
    cfg = model.cfg
    pe = model.patch_embed.proj
    w = vnn.conv_kernel_to_patch_matrix(pe.weight)
    if input_norm is not None:
        mean, std = input_norm
        x = vnn.patch_embed_affine(images, w, pe.bias, cfg.patch, mean=mean,
                                   std=std, compute_dtype=compute_dtype)
    else:
        x = vnn.patch_embed(images.to(compute_dtype), w, pe.bias, cfg.patch,
                            fused_dw=fused_dw)
    cls = model.cls_token.to(x.dtype).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    x = x + model.pos_embed.to(x.dtype)
    if model.norm_pre is not None:
        x = vnn.layer_norm(x, model.norm_pre.weight, model.norm_pre.bias)
    return x


def vit_encode(model: VisionTransformerClassifier, images: torch.Tensor, *,
               input_norm: tuple | None = None, compute_dtype=torch.float32,
               remat: bool = False, fused_dw: bool = False, tp=None,
               moe_groups: vmoe.MoEGroups | None = None,
               with_aux: bool = False, seq_shard=None,
               ring_attn: bool = False):
    """images [B, H, W, 3] -> tokens [B, S, width] after the final LayerNorm
    (timm's forward_features contract); with `with_aux`, (tokens, the sum of
    the MoE blocks' load-balance losses), 0.0 for a dense model.

    `remat=True` recomputes each block's forward in the backward
    (torch.utils.checkpoint) instead of holding its activations: peak memory
    drops from O(layers) to O(1) block activations for ~1/3 more work; the
    gradients are the same numbers (under `tp` the recomputed forward
    repeats its all-reduces, and a MoE block its routing and aux, on every
    rank of the group alike).

    `tp` (a model group) runs each block tensor-parallel on the model's
    shards (``classifier_block_tp``); the stem, the final LayerNorm and
    the head run whole on every rank. `moe_groups` places the MoE blocks'
    rows and experts across ranks (``ops.moe.MoEGroups``).

    `seq_shard` (``parallel/mesh.seq_sharding``) runs the blocks and the
    final LayerNorm sequence-parallel on this rank's tokens, in the gather
    form or with `ring_attn` the ring form, and returns the gathered
    tokens (module docstring)."""
    cfg = model.cfg
    _seq_parallel_checks(cfg, seq_shard, ring_attn,
                         [b.attn.qkv.weight for b in model.blocks])
    if tp is not None and fused_dw:
        raise ValueError("fused_dw is a single-chip path; disable it under "
                         "tensor parallelism")
    if tp is not None and cfg.moe_experts:
        raise ValueError("tp_devices does not compose with MoE blocks: the "
                         "expert FFNs shard over 'expert', not 'model' (use "
                         "ep_devices)")
    x = vit_embed(model, images, input_norm=input_norm,
                  compute_dtype=compute_dtype, fused_dw=fused_dw)
    x, sp = _seq_parallel_enter(x, seq_shard, ring_attn)
    moe = dict(capacity_factor=cfg.moe_capacity, topk=cfg.moe_topk,
               groups=moe_groups)
    out = classifier_blocks(model, x, remat=remat, with_aux=with_aux,
                            fused_dw=fused_dw, tp=tp, moe=moe, sp=sp)
    if with_aux:
        x, aux_total = out
    else:
        x = out
    out = _seq_parallel_exit(
        vnn.layer_norm(x, model.norm.weight, model.norm.bias), sp)
    return (out, aux_total) if with_aux else out


def classifier_blocks(model: VisionTransformerClassifier, x: torch.Tensor,
                      start: int = 0, stop: int | None = None, *,
                      remat: bool = False, with_aux: bool = False, **kw):
    """Blocks [start, stop) of the classifier on x [B, S, D], each through
    its module call (``Block.forward``: ``classifier_block``, or its tp
    form; `kw` are its keywords), each recomputed in the backward with
    `remat`. With `with_aux`, (x, the blocks' summed MoE aux). The trunk of
    ``vit_encode``, and a pipeline stage's blocks
    (``parallel/pipeline.py``)."""
    cfg = model.cfg
    act = _activation(cfg)
    aux_total = _no_aux(x)
    for blk in model.blocks[start:stop]:
        if remat and torch.is_grad_enabled():
            out = torch.utils.checkpoint.checkpoint(
                blk, x, cfg.heads, use_reentrant=False, act=act,
                with_aux=with_aux, **kw)
        else:
            out = blk(x, cfg.heads, act=act, with_aux=with_aux, **kw)
        if with_aux:
            x, aux = out
            aux_total = aux_total + aux
        else:
            x = out
    return (x, aux_total) if with_aux else x


def pool_tokens(tokens: torch.Tensor, pool: str = "token") -> torch.Tensor:
    """pool='token': the CLS token; 'avg': the mean of the patch tokens."""
    if pool == "avg":
        return tokens[:, 1:].mean(dim=1)
    return tokens[:, 0]


def vit_pool(model: VisionTransformerClassifier, x: torch.Tensor,
             pool: str = "token") -> torch.Tensor:
    """The last block's tokens x [B, S, D] -> the final LayerNorm over
    every token, then ``pool_tokens``: the pooled features."""
    return pool_tokens(vnn.layer_norm(x, model.norm.weight, model.norm.bias),
                       pool)


def classifier_head(model: VisionTransformerClassifier, feats: torch.Tensor,
                    fused_dw: bool = False) -> torch.Tensor:
    """f32 logits [B, num_classes] from the CLS features."""
    return vnn.dense(feats, model.head.weight.t(), model.head.bias,
                     fused_dw=fused_dw).float()


def vit_classify(model: VisionTransformerClassifier, images: torch.Tensor, *,
                 input_norm: tuple | None = None, compute_dtype=torch.float32,
                 remat: bool = False, fused_dw: bool = False,
                 with_aux: bool = False, **parallel):
    """Classifier logits [B, num_classes] in f32 from the CLS token; with
    `with_aux`, (logits, the MoE load-balance loss)."""
    tokens = vit_encode(model, images, input_norm=input_norm,
                        compute_dtype=compute_dtype, remat=remat,
                        fused_dw=fused_dw, with_aux=with_aux, **parallel)
    if with_aux:
        tokens, aux = tokens
    logits = classifier_head(model, tokens[:, 0], fused_dw=fused_dw)
    return (logits, aux) if with_aux else logits


def forward_features(model: VisionTransformerClassifier, images: torch.Tensor,
                     *, pool: str = "token", input_norm: tuple | None = None,
                     compute_dtype=torch.float32, **parallel) -> torch.Tensor:
    """timm forward_features + pooling, the ViT RSA embeddings: pool='token'
    is the CLS token, pool='avg' the mean of the patch tokens."""
    tokens = vit_encode(model, images, input_norm=input_norm,
                        compute_dtype=compute_dtype, **parallel)
    return pool_tokens(tokens, pool)
