"""Serving CLI: a finished checkpoint + an image folder -> predictions.

Counterpart of the JAX package's cli/serve.py. It builds an
InferenceEngine on the GPU from a ViT classifier checkpoint (logits, or
pooled embeddings with --mode features) or from OpenAI-format CLIP weights
with trained DoRA adapters baked in (CLIP-HBA behavioral scores over the 66
SPoSE prompts), optionally int8-quantized (--quantize int8), and either
streams an image folder through it to a CSV / .npy, serves HTTP, writes an
AOT serving artifact (--export_dir) or serves one (--from_export).

  # ViT classifier top-k (or --mode features for pooled embeddings -> .npy)
  python -m vit_project_torch.cli.serve --model vit_base_patch16_224 \\
      --checkpoint runs/checkpoint_epoch_010.pth --images val/ --out preds.csv
  # CLIP-HBA scores
  python -m vit_project_torch.cli.serve --clip_weights ViT-L-14.pt \\
      --dora_checkpoint runs/epoch10_dora.pth --bpe_vocab bpe.txt.gz \\
      --images things/ --out scores.csv
  # CLIP-HBA scores of a ModifiedResNet tower (no adapters; --pos_embedding
  # auto leaves the attention pool's positions off for RN50 geometry only)
  python -m vit_project_torch.cli.serve --clip_weights RN50.pt \\
      --bpe_vocab bpe.txt.gz --images things/ --out scores.csv
  # an int8 artifact, then serving it with no model code
  python -m vit_project_torch.cli.serve --model vit_base_patch16_224 \\
      --checkpoint ckpt.pth --quantize int8 --export_dir art/
  python -m vit_project_torch.cli.serve --from_export art/ \\
      --images val/ --out preds.csv
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def collect_images(root: str) -> list[str]:
    """Every image file under `root` (a file, a flat dir, or a class tree),
    sorted for a deterministic output order."""
    if os.path.isfile(root):
        return [root]
    out = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.lower().endswith(IMAGE_EXTS):
                out.append(os.path.join(dirpath, f))
    out.sort()
    if not out:
        raise SystemExit(f"no images found under {root}")
    return out


def batched_reader(paths: list[str], batch: int, size: int, *,
                   normalize=None):
    """Decode + Resize/CenterCrop `batch` images at a time.
    normalize=(mean, std) emits f32 normalized batches (the CLIP contract);
    None emits uint8."""
    from PIL import Image
    from ..data import imagenet as dimg
    for s in range(0, len(paths), batch):
        imgs = []
        for p in paths[s:s + batch]:
            with Image.open(p) as img:
                imgs.append(np.asarray(
                    dimg.resize_center_crop(img.convert("RGB"), size),
                    np.uint8))
        arr = np.stack(imgs)
        if normalize is not None:
            mean, std = normalize
            arr = ((arr.astype(np.float32) / 255.0 - np.asarray(mean))
                   / np.asarray(std)).astype(np.float32)
        yield arr


def build_vit_engine(args):
    """(engine, image_size, None) for a ViT classifier: --checkpoint (the
    JAX-layout params of a ``checkpoint_epoch_NNN.pth``, float or int8) or
    --random_init (seeded). The engine takes raw 0..255 images and folds
    the ImageNet normalization into the patch matmul."""
    from ..ckpt import vit_ckpt
    from ..core.configs import IMAGENET_MEAN, IMAGENET_STD
    from ..core.device import resolve_device
    from ..models import convert as vconvert
    from ..models import vit as vvit
    from ..serve import vit_classifier_engine, vit_features_engine
    device = resolve_device(args.device)
    cfg = vvit.VIT_CONFIGS[args.model]
    if args.checkpoint:
        model = vconvert.vit_from_jax(
            vit_ckpt.load_checkpoint(args.checkpoint)["params"], cfg, device)
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        model = vvit.init_vit_params(vvit.empty_vit(cfg, device), gen)
    ctor = (vit_features_engine if args.mode == "features"
            else vit_classifier_engine)
    eng = ctor(model, buckets=args.bucket_list,
               input_norm=(IMAGENET_MEAN, IMAGENET_STD),
               param_dtype=args.dtype, quantize=args.quantize, device=device)
    return eng, cfg.image_size, None


def auto_use_pos_embedding(clip_cfg) -> bool:
    """The --pos_embedding auto rule: the reference CLIPHBA turns
    pos_embedding off only when its backbone is 'RN50'; RN101 and the
    RN50xN towers keep it on, as the ViT towers do. The weights are known
    by their geometry (the config is inferred from shapes; there is no
    backbone name here). A plain OpenAI RN50 checkpoint wants
    --pos_embedding on instead."""
    from ..models import resnet as vresnet
    from ..models.clip import is_resnet
    return not (is_resnet(clip_cfg)
                and clip_cfg.visual.layers == vresnet.RN50.layers
                and clip_cfg.visual.width == vresnet.RN50.width)


def build_clip_engine(args):
    """(engine, image_size, (mean, std)) from the CLI arguments. The engine
    carries ``adapter_params``, the DoRA parameter count baked into it, and
    ``use_pos_embedding``, the --pos_embedding rule's outcome."""
    from ..adapters import dora as adora
    from ..ckpt import clip_ckpt
    from ..core.configs import THINGS_MEAN, THINGS_STD
    from ..core.device import resolve_device
    from ..data.spose66 import SPOSE_DIMENSIONS_66
    from ..models import convert as vconvert
    from ..models import tokenizer as vtok
    from ..models.clip import is_resnet
    from ..serve import clip_hba_engine
    device = resolve_device(args.device)
    tok = vtok.default_tokenizer(args.bpe_vocab)
    if isinstance(tok, vtok.HashTokenizer) and not args.allow_hash_tokenizer:
        raise SystemExit(
            "pretrained CLIP weights need the BPE vocab (--bpe_vocab / "
            "CLIP_BPE_PATH); hash-tokenized prompts serve meaningless "
            "scores. --allow_hash_tokenizer overrides (testing only).")
    sd = vconvert.load_torch_state_dict(args.clip_weights)
    clip_cfg = vconvert.clip_config_from_state_dict(sd)
    if args.dora_checkpoint and is_resnet(clip_cfg):
        raise SystemExit(
            "--dora_checkpoint needs a ViT visual tower (DoRA surgery "
            "targets transformer resblocks; the reference's RN50 path "
            "has no DoRA either)")
    model = vconvert.clip_from_state_dict(sd, device, clip_cfg)
    del sd
    prompts = vtok.tokenize(
        SPOSE_DIMENSIONS_66, tokenizer=tok,
        context_length=clip_cfg.text.context_length,
        truncate=isinstance(tok, vtok.HashTokenizer))
    prompts = np.minimum(prompts, clip_cfg.text.vocab_size - 1)
    trainable = static = None
    n_adapter = 0
    if args.dora_checkpoint:
        spec = adora.dora_spec(clip_cfg.visual.layers, clip_cfg.text.layers,
                               args.vision_layers, args.transformer_layers)
        gen = torch.Generator(device=device).manual_seed(0)
        init_tr, static, _ = adora.apply_dora(model, spec, r=args.rank,
                                              alpha=args.dora_alpha,
                                              generator=gen)
        try:
            trainable = clip_ckpt.load_dora_parameters(
                args.dora_checkpoint, init_tr, spec, strict=True)
        except ValueError as e:
            raise SystemExit(f"--dora_checkpoint: {e}") from None
        n_adapter = adora.count_trainable_parameters(trainable)
        print(f"baking {n_adapter} DoRA parameters (rank {args.rank})",
              flush=True)
    use_pos = (auto_use_pos_embedding(clip_cfg) if args.pos_embedding == "auto"
               else args.pos_embedding == "on")
    eng = clip_hba_engine(model, prompts, trainable=trainable, static=static,
                          alpha=args.dora_alpha, r=args.rank,
                          use_pos_embedding=use_pos,
                          buckets=args.bucket_list, param_dtype=args.dtype,
                          quantize=args.quantize, device=device)
    eng.adapter_params = n_adapter
    eng.use_pos_embedding = use_pos
    return eng, clip_cfg.visual.image_size, (THINGS_MEAN, THINGS_STD)


def write_outputs(paths, outputs, args):
    """--mode features: the embeddings as .npy and the file names beside it
    (.filenames.txt). Otherwise a top-k CSV: filename, then (index, score)
    for the k best classes or prompts. Returns the written path."""
    import csv
    names = [os.path.relpath(p, args.images) if os.path.isdir(args.images)
             else os.path.basename(p) for p in paths]
    if args.mode == "features":
        out = args.out if args.out.endswith(".npy") else args.out + ".npy"
        np.save(out, outputs)
        with open(os.path.splitext(out)[0] + ".filenames.txt", "w") as f:
            f.write("\n".join(names) + "\n")
        return out
    k = min(args.topk, outputs.shape[1])
    top = np.argsort(-outputs, axis=1)[:, :k]
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        hdr = ["filename"]
        for i in range(k):
            hdr += [f"top{i+1}_index", f"top{i+1}_score"]
        w.writerow(hdr)
        for name, row, idxs in zip(names, outputs, top):
            rec = [name]
            for i in idxs:
                rec += [int(i), f"{row[i]:.6f}"]
            w.writerow(rec)
    return args.out


def _http_preprocess(norm):
    """Per-request input canonicalization for the HTTP daemon: clients post
    RAW images, uint8 in 0..255 or float in [0, 1]. Runs per request,
    before micro-batch coalescing, so a mixed uint8/float window cannot
    change a client's pixel scale.

    - CLIP engines (``norm=(mean, std)``) take (x - mean) / std of the
      [0, 1] image;
    - ViT engines (norm None) fold the normalization into the patch matmul
      and take 0..255-scale values: uint8 casts, [0, 1] floats scale up."""
    if norm is None:
        def pre(arr):
            return (arr.astype(np.float32) if arr.dtype == np.uint8
                    else arr.astype(np.float32) * 255.0)
        return pre
    mean = np.asarray(norm[0], np.float32)
    std = np.asarray(norm[1], np.float32)

    def pre(arr):
        arr = (arr.astype(np.float32) / 255.0 if arr.dtype == np.uint8
               else arr.astype(np.float32))
        return (arr - mean) / std
    return pre


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images",
                    help="image file, flat dir, or class tree (batch mode)")
    ap.add_argument("--out", help="output CSV (.npy for --mode features)")
    ap.add_argument("--http_port", type=int, default=None,
                    help="run as an online HTTP daemon on this port instead "
                         "of batch mode (0 = ephemeral; POST .npy arrays to "
                         "/v1/predict, GET /v1/healthz, /v1/stats)")
    ap.add_argument("--http_host", default="127.0.0.1",
                    help="bind address for --http_port (0.0.0.0 to expose)")
    ap.add_argument("--max_delay_ms", type=float, default=5.0,
                    help="micro-batching window: max wait for more requests "
                         "before dispatching a partial batch")
    ap.add_argument("--request_timeout", type=float, default=300.0,
                    help="per-request wait bound on the micro-batcher")
    ap.add_argument("--no_warmup", action="store_true",
                    help="skip running every bucket once before the daemon "
                         "binds")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on ('cpu' for tests)")
    ap.add_argument("--model", default="vit_base_patch16_224",
                    help="ViT config name (models.vit.VIT_CONFIGS)")
    ap.add_argument("--checkpoint",
                    help="ViT checkpoint (checkpoint_epoch_NNN.pth)")
    ap.add_argument("--random_init", action="store_true",
                    help="seeded random ViT weights (smoke tests only)")
    ap.add_argument("--clip_weights", help="OpenAI-format CLIP .pt: switches "
                    "to CLIP-HBA scoring over the 66 SPoSE prompts")
    ap.add_argument("--dora_checkpoint", help="trained DoRA adapters to bake")
    ap.add_argument("--bpe_vocab")
    ap.add_argument("--allow_hash_tokenizer", action="store_true")
    ap.add_argument("--pos_embedding", choices=["auto", "on", "off"],
                    default="auto",
                    help="attnpool/CLS positional embedding: 'auto' = the "
                    "reference CLIPHBA convention (on for ViT towers, off "
                    "for RN — cvpr_..._baseline.py:757-758); 'on' restores "
                    "stock OpenAI semantics when serving a plain RN .pt")
    ap.add_argument("--vision_layers", type=int, default=2)
    ap.add_argument("--transformer_layers", type=int, default=1)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--dora_alpha", type=int, default=16)
    ap.add_argument("--mode", choices=["logits", "features"],
                    default="logits",
                    help="ViT output: classifier logits or pooled (CLS) "
                         "embeddings")
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--buckets", default="8,32,128,256")
    ap.add_argument("--param_dtype", choices=["bf16", "f32"], default="bf16")
    ap.add_argument("--quantize", choices=["int8"], default=None,
                    help="int8 block weights and activations (ops/quant.py)")
    ap.add_argument("--depth", type=int, default=2,
                    help="map_stream in-flight chunks")
    ap.add_argument("--export_dir", default=None,
                    help="build the engine, write its bucket programs and "
                         "weights as an AOT artifact (serve/export.py) to "
                         "this directory, and exit")
    ap.add_argument("--from_export", default=None,
                    help="serve an --export_dir artifact instead of building "
                         "an engine (the model, checkpoint and bucket flags "
                         "are ignored: the manifest pins them)")
    return ap


def _check_args(ap, args) -> None:
    """Refuse what cannot run, BEFORE the (possibly minutes-long) weights
    load."""
    if args.export_dir and args.from_export:
        ap.error("--export_dir produces an artifact, --from_export consumes "
                 "one; pass at most one of them")
    if args.from_export:
        pass                    # the manifest pins the model and the mode
    elif args.clip_weights:
        if args.mode == "features":
            ap.error("--mode features is the ViT surface; the CLIP engine "
                     "serves [B, 66] behavioral scores")
    else:
        from ..models.vit import VIT_CONFIGS
        if not (args.checkpoint or args.random_init):
            ap.error("ViT serving needs --checkpoint (or --random_init for "
                     "smoke tests: random weights serve garbage); CLIP-HBA "
                     "serving needs --clip_weights")
        if args.model not in VIT_CONFIGS:
            ap.error(f"unknown --model {args.model!r}; one of "
                     f"{sorted(VIT_CONFIGS)}")
    if (args.http_port is None and not args.export_dir
            and (not args.images or not args.out)):
        ap.error("batch mode needs --images and --out "
                 "(or pass --http_port for the online daemon)")


def parse_args(argv=None) -> argparse.Namespace:
    """Parsed and checked CLI arguments, with the derived ``bucket_list``
    and ``dtype`` that the engine builders read."""
    ap = build_parser()
    args = ap.parse_args(argv)
    _check_args(ap, args)
    args.bucket_list = tuple(int(b) for b in args.buckets.split(","))
    args.dtype = torch.bfloat16 if args.param_dtype == "bf16" else None
    return args


def build_engine(args):
    """(engine, image_size, normalize) from the parsed arguments: an
    artifact's (--from_export, whose manifest also sets ``args.mode``), the
    CLIP-HBA engine's or the ViT engine's."""
    if args.from_export:
        from ..serve.export import load_serving
        eng = load_serving(args.from_export, device=args.device)
        norm = eng.manifest.get("normalize")
        if norm is not None:
            norm = (tuple(norm[0]), tuple(norm[1]))
        args.mode = eng.manifest.get("mode", args.mode)
        print(f"loaded AOT artifact {args.from_export} (buckets "
              f"{eng.buckets}, platform {eng.manifest['platforms']})",
              flush=True)
        return eng, eng.manifest["example_shape"][0], norm
    if args.clip_weights:
        return build_clip_engine(args)
    return build_vit_engine(args)


def main(argv=None):
    args = parse_args(argv)
    eng, size, norm = build_engine(args)

    if args.export_dir:
        from ..serve.export import export_serving
        # float32 requests serve both paths losslessly: the batch reader's
        # uint8 (ViT, raw 0..255) and the HTTP daemon's float32; the
        # normalize constants ride the manifest for --from_export
        manifest = export_serving(
            eng, (size, size, 3), args.export_dir, input_dtype=np.float32,
            extra={"normalize": norm, "mode": args.mode,
                   "model": "clip_hba" if args.clip_weights else args.model})
        print(f"exported {len(manifest['buckets'])} bucket programs + "
              f"params to {args.export_dir} "
              f"(platforms {manifest['platforms']})")
        return 0

    if args.http_port is not None:
        from ..serve import ServingDaemon
        if not args.no_warmup:
            t0 = time.time()
            eng.warmup((size, size, 3), dtype=np.float32)
            print(f"warmed {len(eng.buckets)} buckets in "
                  f"{time.time() - t0:.1f}s", flush=True)
        daemon = ServingDaemon(eng, image_shape=(size, size, 3),
                               port=args.http_port, host=args.http_host,
                               max_delay_ms=args.max_delay_ms,
                               request_timeout=args.request_timeout,
                               preprocess=_http_preprocess(norm))
        print(f"serving on http://{args.http_host}:{daemon.port} "
              f"(buckets {eng.buckets}, POST /v1/predict)", flush=True)
        daemon.serve_forever()
        return 0

    paths = collect_images(args.images)
    reader = batched_reader(paths, args.bucket_list[-1], size, normalize=norm)
    t0 = time.time()
    outputs = np.concatenate(list(eng.map_stream(reader, depth=args.depth)))
    dt = time.time() - t0
    out = write_outputs(paths, outputs, args)
    print(f"served {len(paths)} images in {dt:.1f}s "
          f"({len(paths)/dt:.1f} img/s incl. decode) -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
