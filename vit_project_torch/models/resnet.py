"""The CLIP ModifiedResNet visual tower (the RN50 family).

Counterpart of the JAX package's models/resnet.py. ``ModifiedResNet``
holds the parameters under OpenAI CLIP's state-dict names (``conv1-3``,
``bn1-3``, ``layer{1-4}.{i}.conv1-3 / bn1-3 / downsample.0-1``,
``attnpool.positional_embedding`` and ``q_proj``, ``k_proj``, ``v_proj``,
``c_proj``), so ``CLIP.load_state_dict(strict=True)`` takes an OpenAI RN
checkpoint as it is. The forward is ``resnet_encode``, a plain function on
those modules with the JAX forward's arithmetic:

- the images arrive NHWC; ``permute(0, 3, 1, 2)`` makes them an NCHW view
  whose memory is channels_last, and ``empty_clip`` keeps the conv weights
  channels_last too, so cuDNN runs every convolution in NHWC without a
  transpose around it. Padding is k // 2, as torch's padding=1 for the 3x3s;
- BatchNorm is a function of the stored running statistics, whatever
  ``.train()`` says (the reference's CLIPHBA forces ``eval()``), folded as
  JAX's ``_bn``: scale and shift in f32, cast to the compute dtype, then
  x * scale + shift as one ``addcmul`` (one rounding, as XLA fuses the
  pair). ``nn.BatchNorm2d`` only holds the leaves;
- the rect-2 average pools floor odd sizes (``AvgPool2d(2)``);
- the attention pool computes only the mean-token query row, with the
  scores and the softmax in f32, instead of all HW+1 rows of
  ``F.multi_head_attention_forward``;
- ``remat`` recomputes each of the four stages in the backward.

The convolutions are ``F.conv2d`` (cuDNN on the card) and the pool's
projections ``ops.nn.dense``: the JAX package computes all of them outside
Pallas, so this tower has no kernel of its own. In float32 on the card a
convolution runs in TF32 unless ``torch.backends.cudnn.allow_tf32`` is
cleared (PyTorch's default keeps it set); the dense layers run in full f32.
"""
from __future__ import annotations

import functools
from collections import OrderedDict
from dataclasses import dataclass

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops import nn as vnn

_BN_EPS = 1e-5  # torch BatchNorm2d's default


@dataclass(frozen=True)
class ResNetConfig:
    """ModifiedResNet geometry (what OpenAI's build_model infers)."""
    layers: tuple = (3, 4, 6, 3)   # bottlenecks a stage
    width: int = 64                # stem width; stage c is width * 2^c
    heads: int = 32                # attention-pool heads (width * 32 // 64)
    image_size: int = 224
    out_dim: int = 1024            # c_proj's output, the CLIP embed dim

    @property
    def feature_dim(self) -> int:  # channels entering the attention pool
        return self.width * 32

    @property
    def pool_grid(self) -> int:    # the output grid's side (5 halvings)
        return self.image_size // 32


RN50 = ResNetConfig(layers=(3, 4, 6, 3), width=64, heads=32,
                    image_size=224, out_dim=1024)
RN101 = ResNetConfig(layers=(3, 4, 23, 3), width=64, heads=32,
                     image_size=224, out_dim=512)


def _conv_leaf(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """OpenAI's Bottleneck: 1x1, 3x3, (avgpool when strided), 1x1, with an
    avgpool + 1x1 + bn shortcut when the shape changes. The shortcut's
    pool is the unnamed ``downsample.-1``."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv_leaf(inplanes, planes, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv_leaf(planes, planes, 3)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = _conv_leaf(planes, planes * 4, 1)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = None
        if stride > 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride)),
                ("0", _conv_leaf(inplanes, planes * 4, 1)),
                ("1", nn.BatchNorm2d(planes * 4))]))


class AttentionPool2d(nn.Module):
    def __init__(self, grid: int, width: int, heads: int, out_dim: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(
            torch.empty(grid ** 2 + 1, width))
        self.k_proj = nn.Linear(width, width)
        self.q_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.c_proj = nn.Linear(width, out_dim)


class ModifiedResNet(nn.Module):
    """The RN tower's parameters under OpenAI's names; the forward is
    ``resnet_encode``."""

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.conv1 = nn.Conv2d(3, w // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(w // 2)
        self.conv2 = _conv_leaf(w // 2, w // 2, 3)
        self.bn2 = nn.BatchNorm2d(w // 2)
        self.conv3 = _conv_leaf(w // 2, w, 3)
        self.bn3 = nn.BatchNorm2d(w)
        inplanes = w
        for i, n in enumerate(cfg.layers):
            planes = w * 2 ** i
            blocks = [Bottleneck(inplanes, planes, 1 if i == 0 else 2)]
            inplanes = planes * Bottleneck.expansion
            blocks += [Bottleneck(inplanes, planes) for _ in range(1, n)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.attnpool = AttentionPool2d(cfg.pool_grid, cfg.feature_dim,
                                        cfg.heads, cfg.out_dim)

    def stages(self) -> tuple:
        return (self.layer1, self.layer2, self.layer3, self.layer4)


# -- the forward ----------------------------------------------------------------

def _conv2d(x: torch.Tensor, conv: nn.Conv2d, stride: int = 1) -> torch.Tensor:
    """x [B, C, H, W] (channels_last memory) * OIHW, padding k // 2, in
    x's dtype (cuDNN accumulates in f32)."""
    w = conv.weight
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=w.shape[-1] // 2)


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Inference BatchNorm from the running statistics: the fold in f32,
    then x * scale + shift in x's dtype."""
    inv = torch.rsqrt(bn.running_var.float() + _BN_EPS)
    scale = bn.weight.float() * inv
    shift = bn.bias.float() - bn.running_mean.float() * scale
    return torch.addcmul(shift.to(x.dtype)[:, None, None], x,
                         scale.to(x.dtype)[:, None, None])


def _avgpool2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(2): rect-2 window, stride 2, odd sizes floored."""
    return F.avg_pool2d(x, 2)


def _bottleneck(blk: Bottleneck, x: torch.Tensor) -> torch.Tensor:
    out = F.relu(_bn(_conv2d(x, blk.conv1), blk.bn1))
    out = F.relu(_bn(_conv2d(out, blk.conv2), blk.bn2))
    if blk.stride > 1:
        out = _avgpool2(out)
    out = _bn(_conv2d(out, blk.conv3), blk.bn3)
    sc = x
    if blk.downsample is not None:      # positions 1, 2: "0" and "1"
        sc = _avgpool2(x) if blk.stride > 1 else x
        sc = _bn(_conv2d(sc, blk.downsample[1]), blk.downsample[2])
    return F.relu(out + sc)


def _stage(layer: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    for blk in layer:
        x = _bottleneck(blk, x)
    return x


def _attention_pool(pool: AttentionPool2d, x: torch.Tensor,
                    use_pos_embedding: bool) -> torch.Tensor:
    """AttentionPool2d with one (mean-token) query row -> [B, out_dim].
    `use_pos_embedding` is the reference CLIPHBA's pos_embedding flag (off
    for its RN50 runs): False skips the learned positions."""
    B, C, H, W = x.shape
    x = x.permute(0, 2, 3, 1).reshape(B, H * W, C)    # a view when NHWC
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
    if use_pos_embedding:
        x = x + pool.positional_embedding.to(x.dtype)
    q = vnn.dense(x[:, :1], pool.q_proj.weight.t(), pool.q_proj.bias)
    k = vnn.dense(x, pool.k_proj.weight.t(), pool.k_proj.bias)
    v = vnn.dense(x, pool.v_proj.weight.t(), pool.v_proj.bias)
    heads = pool.heads
    dh = C // heads
    q = q.reshape(B, 1, heads, dh).transpose(1, 2)
    k = k.reshape(B, -1, heads, dh).transpose(1, 2)
    v = v.reshape(B, -1, heads, dh).transpose(1, 2)
    # products of the compute dtype are exact in f32: f32 operands give
    # the f32-accumulating einsums of the JAX pool
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * dh ** -0.5
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(attn.float(), v.float()).to(x.dtype)
    out = out.transpose(1, 2).reshape(B, C)
    return vnn.dense(out, pool.c_proj.weight.t(), pool.c_proj.bias)


def resnet_encode(visual: ModifiedResNet, images: torch.Tensor, *,
                  use_pos_embedding: bool = True,
                  compute_dtype=torch.float32,
                  remat: bool = False) -> torch.Tensor:
    """images [B, H, W, 3] (normalized, NHWC) -> [B, out_dim] f32 CLIP
    embeddings: the three-conv stem (the first strided) and a rect-2
    avgpool, the four stages, then the attention pool. `remat` recomputes
    each stage in the backward (the trunk's activations are
    pyramid-shaped, so a stage is the useful grain)."""
    x = images.to(compute_dtype).permute(0, 3, 1, 2)
    x = F.relu(_bn(_conv2d(x, visual.conv1, stride=2), visual.bn1))
    x = F.relu(_bn(_conv2d(x, visual.conv2), visual.bn2))
    x = F.relu(_bn(_conv2d(x, visual.conv3), visual.bn3))
    x = _avgpool2(x)
    for layer in visual.stages():
        f = functools.partial(_stage, layer)
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(f, x, use_reentrant=False)
        else:
            x = f(x)
    return _attention_pool(visual.attnpool, x, use_pos_embedding).float()


# -- init -------------------------------------------------------------------------

def _he_fan_out_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    cout, _, k, _ = conv.weight.shape
    conv.weight.normal_(0.0, (2.0 / (k * k * cout)) ** 0.5,
                        generator=generator)


def _identity_bn_(bn: nn.BatchNorm2d) -> None:
    bn.weight.fill_(1.0)
    bn.bias.zero_()
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0)
    bn.num_batches_tracked.zero_()


@torch.no_grad()
def init_resnet_weights_(visual: ModifiedResNet,
                         generator: torch.Generator) -> ModifiedResNet:
    """Random weights in place, with the JAX package's distributions
    (init_resnet_params): He fan-out normals for every conv, identity
    BatchNorms (every buffer too, since ``empty_clip`` leaves memory
    uninitialized) with ``bn3``'s scale zero, so a fresh block starts as
    its shortcut, and the attention pool's matrices and positions at std
    width^-0.5 with zero biases. The numbers differ from JAX's."""
    for m in visual.modules():
        if isinstance(m, nn.Conv2d):
            _he_fan_out_(m, generator)
        elif isinstance(m, nn.BatchNorm2d):
            _identity_bn_(m)
    for layer in visual.stages():
        for blk in layer:
            blk.bn3.weight.zero_()
    pool = visual.attnpool
    std = visual.cfg.feature_dim ** -0.5
    pool.positional_embedding.normal_(0.0, std, generator=generator)
    for lin in (pool.q_proj, pool.k_proj, pool.v_proj, pool.c_proj):
        lin.weight.normal_(0.0, std, generator=generator)
        lin.bias.zero_()
    return visual
