"""The weights bridge: checkpoint files and JAX parameter trees -> ``CLIP``.

Everything reaches the port's ``CLIP`` as one OpenAI-format state dict,
loaded with ``load_state_dict(strict=True)``:

- OpenAI CLIP ``.pt`` archives (jit or plain) through ``load_torch_state_dict``;
- the JAX package's parameter tree (numpy arrays) through
  ``clip_state_dict_from_jax_params``, which follows that package's
  ``clip_state_dict_from_params``.

ViT visual towers only; the ModifiedResNet family is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from .clip import CLIP, CLIPConfig, TextConfig, empty_clip
from .vit import ViTConfig

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
                         image_size=grid * patch, out_dim=embed_dim),
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
