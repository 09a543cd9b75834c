"""Export trained runs back to the torch ecosystem (counterpart of the JAX
package's cli/export_torch.py, with --device).

The converters (models/convert.py) bring OpenAI CLIP .pt archives and the
JAX-layout ViT checkpoints INTO the port; this CLI is the return path:

- ``clip``: base CLIP weights + a trained ``epoch{N}_dora_params.pth`` ->
  the adapters baked into the out_proj weights (adapters.dora.bake) -> an
  OpenAI-CLIP-format state dict that ``clip.build_model`` loads;
- ``vit``: a ``checkpoint_epoch_{N:03d}.pth`` full-state checkpoint
  (ckpt/vit_ckpt.py) -> a timm-format state dict that
  ``timm.create_model('vit_base_patch16_224').load_state_dict`` accepts.

Both write float32 tensors under the names the port's models already carry.

  python -m vit_project_torch.cli.export_torch clip \\
      --clip_weights ViT-L-14.pt --dora_checkpoint .../epoch98_dora_params.pth \\
      --vision_layers 2 --transformer_layers 1 --rank 32 --out clip_hba.pth
  python -m vit_project_torch.cli.export_torch vit \\
      --checkpoint runs/vit/checkpoint_epoch_099.pth \\
      --backbone vit_base_patch16_224 --out vit_b16_timm.pth
"""
from __future__ import annotations

import argparse

import torch


def _save(path: str, model: torch.nn.Module) -> str:
    torch.save({k: v.detach().float().cpu().contiguous()
                for k, v in model.state_dict().items()}, path)
    return path


def export_clip(args) -> str:
    from ..adapters import dora as adora
    from ..ckpt import clip_ckpt
    from ..core.device import resolve_device
    from ..models import convert as vconvert

    device = resolve_device(args.device)
    sd = vconvert.load_torch_state_dict(args.clip_weights)
    cfg = vconvert.clip_config_from_state_dict(sd)
    model = vconvert.clip_from_state_dict(sd, device, cfg)
    del sd
    spec = adora.dora_spec(cfg.visual.layers, cfg.text.layers,
                           args.vision_layers, args.transformer_layers)
    # init, then the checkpoint's adapters: one for every block of the spec
    # and none outside it (the loader refuses a mismatch)
    trainable, static, _ = adora.apply_dora(
        model, spec, r=args.rank, alpha=args.alpha,
        generator=torch.Generator(device=device).manual_seed(0))
    try:
        trainable = clip_ckpt.load_dora_parameters(
            args.dora_checkpoint, trainable, spec, strict=True)
    except ValueError as e:
        raise SystemExit(f"--dora_checkpoint: {e}") from None
    adora.bake(model, trainable, static, alpha=args.alpha, r=args.rank)
    return _save(args.out, model)


def export_vit(args) -> str:
    from ..ckpt import vit_ckpt
    from ..core.device import resolve_device
    from ..models import convert as vconvert
    from ..models.vit import VIT_CONFIGS

    if args.backbone not in VIT_CONFIGS:
        raise SystemExit(f"unknown --backbone {args.backbone!r}; one of "
                         f"{sorted(VIT_CONFIGS)}")
    ckpt = vit_ckpt.load_checkpoint(args.checkpoint)
    model = vconvert.vit_from_jax(ckpt["params"], VIT_CONFIGS[args.backbone],
                                  resolve_device(args.device))
    return _save(args.out, model)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)

    pc = sub.add_parser("clip", help="bake DoRA adapters into base CLIP "
                                     "weights, export OpenAI-format .pth")
    pc.add_argument("--clip_weights", required=True,
                    help="base OpenAI CLIP .pt (jit archive or state dict)")
    pc.add_argument("--dora_checkpoint", required=True,
                    help="epoch{N}_dora_params.pth from a training run")
    pc.add_argument("--vision_layers", type=int, default=2,
                    help="adapted vision blocks (reference default 2)")
    pc.add_argument("--transformer_layers", type=int, default=1,
                    help="adapted text blocks (reference default 1)")
    pc.add_argument("--rank", type=int, default=32)
    pc.add_argument("--alpha", type=int, default=16)
    pc.add_argument("--out", required=True, help="output .pth path")

    pv = sub.add_parser("vit", help="export a ViT full-state checkpoint as a "
                                    "timm state dict .pth")
    pv.add_argument("--checkpoint", required=True,
                    help="checkpoint_epoch_{N:03d}.pth")
    pv.add_argument("--backbone", default="vit_base_patch16_224",
                    help="model config name (see models.vit.VIT_CONFIGS)")
    pv.add_argument("--out", required=True, help="output .pth path")
    for p in (pc, pv):
        p.add_argument("--device", default="cuda",
                       help="torch device for the bake ('cpu' for tests)")

    args = ap.parse_args(argv)
    out = export_clip(args) if args.mode == "clip" else export_vit(args)
    print(f"Exported: {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
