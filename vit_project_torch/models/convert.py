"""The weights bridge: checkpoint files and JAX parameter trees -> ``CLIP``,
and the ViT classifier's parameter and momentum trees both ways.

Everything reaches the port's ``CLIP`` as one OpenAI-format state dict,
loaded with ``load_state_dict(strict=True)``:

- OpenAI CLIP ``.pt`` archives (jit or plain) through ``load_torch_state_dict``;
- the JAX package's parameter tree (numpy arrays) through
  ``clip_state_dict_from_jax_params``, which follows that package's
  ``clip_state_dict_from_params``.

The DoRA adapter trees cross between the packages through
``adapters_from_jax`` and ``adapters_to_jax``; the optimizer state through
``ckpt/clip_ckpt.py``.

ViT visual towers only; the ModifiedResNet family is not ported yet.

The ViT classifier crosses as timm-named {name: tensor} maps
(``VisionTransformerClassifier.state_dict()`` names): ``vit_state_dict_from_jax``
and ``vit_jax_from_state_dict`` follow the JAX package's
``vit_params_from_timm_state_dict`` / ``timm_state_dict_from_vit_params``
layout, bit for bit both ways. The same two functions carry the SGD momentum,
which is a tree of the parameters' shapes; the ViT checkpoints store both in
the JAX tree layout, so the two packages resume each other's runs.
``vit_from_jax`` and ``clip_from_jax`` build the models from JAX trees whose
block weights may be int8 (the JAX package's ops/quant.py leaves
{"q": int8 [in, out], "s": f32 [out]}): those go into the port's
``QuantizedWeight`` holders with q transposed to [out, in].
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import quant as vquant
from .clip import CLIP, CLIPConfig, TextConfig, empty_clip
from .vit import (CLIP_VISUAL_FLAGS, ViTConfig, VisionTransformerClassifier,
                  empty_vit)

# integer metadata an OpenAI jit archive keeps beside the weights
_ARCHIVE_METADATA = ("input_resolution", "context_length", "vocab_size")


def load_torch_state_dict(path: str) -> dict:
    """Load a torch checkpoint (jit archive or plain state dict) into
    {name: float32 CPU tensor}, without the archive's integer metadata."""
    try:
        sd = torch.jit.load(path, map_location="cpu").eval().state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    return {k: v.detach().float() for k, v in sd.items()
            if k not in _ARCHIVE_METADATA}


def clip_config_from_state_dict(sd: dict) -> CLIPConfig:
    """Infer the architecture from checkpoint shapes, as OpenAI's
    build_model does (heads = width / 64)."""
    if "visual.proj" not in sd:
        raise ValueError("only ViT CLIP checkpoints are supported (this one "
                         "has no visual.proj: a ModifiedResNet tower)")
    embed_dim = sd["text_projection"].shape[1]
    text_width = sd["ln_final.weight"].shape[0]
    text_layers = len({k.split(".")[2] for k in sd
                       if k.startswith("transformer.resblocks.")})
    text = TextConfig(width=text_width, layers=text_layers,
                      heads=max(1, text_width // 64),
                      vocab_size=sd["token_embedding.weight"].shape[0],
                      context_length=sd["positional_embedding"].shape[0])
    vision_width = sd["visual.conv1.weight"].shape[0]
    patch = sd["visual.conv1.weight"].shape[-1]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    vision_layers = len({k.split(".")[3] for k in sd
                         if k.startswith("visual.transformer.resblocks.")})
    return CLIPConfig(
        visual=ViTConfig(patch=patch, width=vision_width, layers=vision_layers,
                         heads=max(1, vision_width // 64),
                         image_size=grid * patch, out_dim=embed_dim,
                         **CLIP_VISUAL_FLAGS),
        text=text, embed_dim=embed_dim)


def clip_from_state_dict(sd: dict, device, cfg: CLIPConfig | None = None) -> CLIP:
    """A ``CLIP`` on `device` holding the state dict's weights (strict load).
    `cfg` defaults to the one the shapes imply."""
    model = empty_clip(cfg or clip_config_from_state_dict(sd), device)
    model.load_state_dict(sd, strict=True)
    return model


def patch_matrix_to_conv_kernel(mat, patch: int, channels: int = 3) -> np.ndarray:
    """Inverse of conv_kernel_to_patch_matrix: [p*p*C, D] -> [D, C, p, p]."""
    mat = np.asarray(mat)
    k = mat.reshape(patch, patch, channels, mat.shape[1])   # (ph, pw, C, D)
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _ln_out(sd, prefix, p):
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])


def _clip_block_out(sd, prefix, b):
    """One JAX block (weights [in, out]) -> OpenAI names ([out, in])."""
    _ln_out(sd, prefix + ".ln_1", b["ln1"])
    sd[prefix + ".attn.in_proj_weight"] = _t(np.asarray(b["qkv_w"]).T)
    sd[prefix + ".attn.in_proj_bias"] = _t(b["qkv_b"])
    sd[prefix + ".attn.out_proj.weight"] = _t(np.asarray(b["out_w"]).T)
    sd[prefix + ".attn.out_proj.bias"] = _t(b["out_b"])
    _ln_out(sd, prefix + ".ln_2", b["ln2"])
    sd[prefix + ".mlp.c_fc.weight"] = _t(np.asarray(b["fc1_w"]).T)
    sd[prefix + ".mlp.c_fc.bias"] = _t(b["fc1_b"])
    sd[prefix + ".mlp.c_proj.weight"] = _t(np.asarray(b["fc2_w"]).T)
    sd[prefix + ".mlp.c_proj.bias"] = _t(b["fc2_b"])


def clip_state_dict_from_jax_params(tree: dict, cfg: CLIPConfig) -> dict:
    """The JAX package's CLIP parameter tree (arrays convertible with
    np.asarray) -> OpenAI-format {name: float32 tensor} for ``CLIP``."""
    sd: dict = {}
    v = tree["visual"]
    sd["visual.conv1.weight"] = torch.from_numpy(patch_matrix_to_conv_kernel(
        np.asarray(v["patch_w"], np.float32), cfg.visual.patch))
    sd["visual.class_embedding"] = _t(v["cls"])
    sd["visual.positional_embedding"] = _t(v["pos"])
    _ln_out(sd, "visual.ln_pre", v["ln_pre"])
    for i, b in enumerate(v["blocks"]):
        _clip_block_out(sd, f"visual.transformer.resblocks.{i}", b)
    _ln_out(sd, "visual.ln_post", v["norm"])
    sd["visual.proj"] = _t(v["proj"])
    t = tree["text"]
    sd["token_embedding.weight"] = _t(t["token_embedding"])
    sd["positional_embedding"] = _t(t["pos"])
    for i, b in enumerate(t["blocks"]):
        _clip_block_out(sd, f"transformer.resblocks.{i}", b)
    _ln_out(sd, "ln_final", t["ln_final"])
    sd["text_projection"] = _t(t["text_projection"])
    sd["logit_scale"] = _t(tree["logit_scale"])
    return sd


def adapters_from_jax(tree: dict, device=None) -> dict:
    """A JAX-package DoRA tree ({tower: {block_idx: {name: array}}}, the
    trainable or the static half) as f32 tensors on `device`."""
    return {t: {int(i): {k: torch.from_numpy(np.array(v, np.float32)).to(device)
                         for k, v in d.items()}
                for i, d in blocks.items()}
            for t, blocks in tree.items()}


def adapters_to_jax(tree: dict) -> dict:
    """The port's DoRA tree as the JAX package's numpy tree."""
    return {t: {int(i): {k: v.detach().cpu().numpy().astype(np.float32)
                         for k, v in d.items()}
                for i, d in blocks.items()}
            for t, blocks in tree.items()}


# -- the ViT classifier ---------------------------------------------------------

def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def vit_state_dict_from_jax(tree: dict, patch: int) -> dict:
    """A JAX-layout ViT classifier tree (the params or the momentum; arrays
    convertible with np.asarray) -> timm-named {name: float32 tensor}."""
    sd = {"patch_embed.proj.weight": patch_matrix_to_conv_kernel(
              _np(tree["patch_w"]), patch),
          "cls_token": _np(tree["cls"]).reshape(1, 1, -1),
          "pos_embed": _np(tree["pos"])[None]}
    if tree.get("patch_b") is not None:
        sd["patch_embed.proj.bias"] = _np(tree["patch_b"])
    if "ln_pre" in tree:
        sd["norm_pre.weight"] = _np(tree["ln_pre"]["scale"])
        sd["norm_pre.bias"] = _np(tree["ln_pre"]["bias"])
    for i, b in enumerate(tree["blocks"]):
        p = f"blocks.{i}."
        for ours, name in (("ln1", "norm1"), ("ln2", "norm2")):
            sd[p + name + ".weight"] = _np(b[ours]["scale"])
            sd[p + name + ".bias"] = _np(b[ours]["bias"])
        dense = (("qkv", "attn.qkv"), ("out", "attn.proj"))
        if "moe" in b:      # JAX's orientation and names, under "moe."
            for k, v in b["moe"].items():
                sd[p + "moe." + k] = _np(v)
        else:
            dense += (("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"))
        for ours, name in dense:
            sd[p + name + ".weight"] = np.ascontiguousarray(
                _np(b[ours + "_w"]).T)
            sd[p + name + ".bias"] = _np(b[ours + "_b"])
    sd["norm.weight"] = _np(tree["norm"]["scale"])
    sd["norm.bias"] = _np(tree["norm"]["bias"])
    sd["head.weight"] = np.ascontiguousarray(_np(tree["head_w"]).T)
    sd["head.bias"] = _np(tree["head_b"])
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def vit_jax_from_state_dict(sd: dict) -> dict:
    """timm-named {name: tensor or array} (the classifier's parameters or
    its momentum) -> the JAX package's ViT tree of float32 numpy arrays. A
    MoE block's ``blocks.{i}.moe.<leaf>`` become its ``"moe"`` sub-tree."""
    layers = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})

    def ln(prefix):
        return {"scale": _np(sd[prefix + ".weight"]),
                "bias": _np(sd[prefix + ".bias"])}

    def t(name):
        return np.ascontiguousarray(_np(sd[name]).T)

    blocks = []
    for i in range(layers):
        p = f"blocks.{i}."
        block = {
            "ln1": ln(p + "norm1"),
            "qkv_w": t(p + "attn.qkv.weight"), "qkv_b": _np(sd[p + "attn.qkv.bias"]),
            "out_w": t(p + "attn.proj.weight"),
            "out_b": _np(sd[p + "attn.proj.bias"]),
            "ln2": ln(p + "norm2"),
        }
        if p + "moe.router_w" in sd:
            block["moe"] = {k: _np(sd[p + "moe." + k]) for k in (
                "router_w", "fc1_w", "fc1_b", "fc2_w", "fc2_b")}
        else:
            block.update({
                "fc1_w": t(p + "mlp.fc1.weight"),
                "fc1_b": _np(sd[p + "mlp.fc1.bias"]),
                "fc2_w": t(p + "mlp.fc2.weight"),
                "fc2_b": _np(sd[p + "mlp.fc2.bias"])})
        blocks.append(block)
    pos = _np(sd["pos_embed"])
    tree = {
        "patch_w": np.ascontiguousarray(_np(sd["patch_embed.proj.weight"])
                                        .transpose(2, 3, 1, 0)
                                        .reshape(-1, pos.shape[-1])),
        "patch_b": (_np(sd["patch_embed.proj.bias"])
                    if "patch_embed.proj.bias" in sd else None),
        "cls": _np(sd["cls_token"]).reshape(-1),
        "pos": pos.reshape(pos.shape[-2], pos.shape[-1]),
        "blocks": blocks,
        "norm": ln("norm"),
        "head_w": t("head.weight"), "head_b": _np(sd["head.bias"]),
    }
    if "norm_pre.weight" in sd:
        tree["ln_pre"] = ln("norm_pre")
    return tree


# -- int8 trees of the JAX package -----------------------------------------------

# the JAX block's quantized leaves (its ops/quant.py _QKEYS), in the order of
# ops.quant.block_weight_slots
_JAX_QKEYS = ("qkv_w", "out_w", "fc1_w", "fc2_w")


def _jax_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def _dequantized_jax_tree(tree):
    """A JAX tree with every int8 leaf pair {"q", "s"} replaced by its float
    weight q * s [in, out], the layout the state-dict converters read."""
    if _jax_quantized(tree):
        return np.asarray(tree["q"], np.float32) * np.asarray(tree["s"],
                                                              np.float32)
    if isinstance(tree, dict):
        return {k: _dequantized_jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_dequantized_jax_tree(v) for v in tree]
    return tree


def _load_jax_quantized_blocks(blocks, jax_blocks) -> None:
    """Put the int8 leaves of JAX blocks into the port's `blocks` (a
    classifier's or a tower's), each as a ``QuantizedWeight`` on its slot's
    device with q transposed to [out, in]; float leaves are left alone."""
    for blk, jb in zip(blocks, jax_blocks):
        if "moe" in jb:                # JAX leaves MoE blocks float
            continue
        device = next(blk.parameters()).device
        for (module, attr), key in zip(vquant.block_weight_slots(blk),
                                       _JAX_QKEYS):
            w = jb[key]
            if not _jax_quantized(w):
                continue
            q = np.ascontiguousarray(np.asarray(w["q"], np.int8).T)
            holder = vquant.QuantizedWeight(
                torch.from_numpy(q), torch.from_numpy(np.array(w["s"],
                                                               np.float32)))
            delattr(module, attr)
            setattr(module, attr, holder.to(device))


def vit_from_jax(tree: dict, cfg: ViTConfig,
                 device) -> VisionTransformerClassifier:
    """A ViT classifier on `device` from a JAX-layout tree (a checkpoint's
    params), float or with int8 block weights."""
    model = empty_vit(cfg, device)
    model.load_state_dict(vit_state_dict_from_jax(_dequantized_jax_tree(tree),
                                                  cfg.patch), strict=True)
    _load_jax_quantized_blocks(model.blocks, tree["blocks"])
    return model


def clip_from_jax(tree: dict, cfg: CLIPConfig, device) -> CLIP:
    """A ``CLIP`` on `device` from the JAX package's CLIP tree, float or
    with int8 block weights in either tower."""
    model = clip_from_state_dict(
        clip_state_dict_from_jax_params(_dequantized_jax_tree(tree), cfg),
        device, cfg)
    _load_jax_quantized_blocks(model.visual.transformer.resblocks,
                              tree["visual"]["blocks"])
    _load_jax_quantized_blocks(model.transformer.resblocks,
                              tree["text"]["blocks"])
    return model
