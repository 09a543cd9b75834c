"""Serving CLI, CLIP-HBA mode: CLIP weights + DoRA adapters -> scores.

Counterpart of the JAX package's cli/serve.py for CLIP-HBA behavioral
scores over the 66 SPoSE prompts. It loads OpenAI-format CLIP weights and
trained DoRA adapters, bakes the adapters, builds an InferenceEngine on the
GPU and either streams an image folder through it to a CSV or serves HTTP.

  python -m vit_project_torch.cli.serve --clip_weights ViT-L-14.pt \\
      --dora_checkpoint runs/epoch10_dora.pth --bpe_vocab bpe.txt.gz \\
      --images things/ --out scores.csv
  python -m vit_project_torch.cli.serve --clip_weights ViT-L-14.pt \\
      --bpe_vocab bpe.txt.gz --http_port 8000

Not ported yet (refused with a message): ViT classifier/feature serving,
--quantize int8 and the AOT export (--export_dir / --from_export).
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


def build_clip_engine(args):
    """(engine, image_size, (mean, std)) from the CLI arguments. The engine
    carries ``adapter_params``, the DoRA parameter count baked into it."""
    from ..adapters import dora as adora
    from ..ckpt import clip_ckpt
    from ..core.configs import THINGS_MEAN, THINGS_STD
    from ..core.device import resolve_device
    from ..data.spose66 import SPOSE_DIMENSIONS_66
    from ..models import convert as vconvert
    from ..models import tokenizer as vtok
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
        trainable = clip_ckpt.load_dora_parameters(args.dora_checkpoint,
                                                   init_tr, spec)
        n_adapter = adora.count_trainable_parameters(trainable)
        print(f"baking {n_adapter} DoRA parameters (rank {args.rank})",
              flush=True)
    eng = clip_hba_engine(model, prompts, trainable=trainable, static=static,
                          alpha=args.dora_alpha, r=args.rank,
                          buckets=args.bucket_list, param_dtype=args.dtype,
                          device=device)
    eng.adapter_params = n_adapter
    return eng, clip_cfg.visual.image_size, (THINGS_MEAN, THINGS_STD)


def write_outputs(paths, outputs, args):
    """Top-k CSV: filename, then (index, score) for the k best prompts."""
    import csv
    names = [os.path.relpath(p, args.images) if os.path.isdir(args.images)
             else os.path.basename(p) for p in paths]
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
    RAW images, uint8 in 0..255 or float in [0, 1]; the CLIP engine takes
    (x - mean) / std of the [0, 1] image. Runs per request, before
    micro-batch coalescing, so a mixed uint8/float window cannot change a
    client's pixel scale."""
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
    ap.add_argument("--out", help="output CSV")
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
    ap.add_argument("--clip_weights", help="OpenAI-format CLIP .pt")
    ap.add_argument("--dora_checkpoint", help="trained DoRA adapters to bake")
    ap.add_argument("--bpe_vocab")
    ap.add_argument("--allow_hash_tokenizer", action="store_true")
    ap.add_argument("--vision_layers", type=int, default=2)
    ap.add_argument("--transformer_layers", type=int, default=1)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--dora_alpha", type=int, default=16)
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--buckets", default="8,32,128,256")
    ap.add_argument("--param_dtype", choices=["bf16", "f32"], default="bf16")
    ap.add_argument("--depth", type=int, default=2,
                    help="map_stream in-flight chunks")
    # surfaces of the JAX CLI that the port refuses until they are ported
    ap.add_argument("--model", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--checkpoint", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mode", default="logits", help=argparse.SUPPRESS)
    ap.add_argument("--quantize", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--export_dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--from_export", default=None, help=argparse.SUPPRESS)
    return ap


def _refuse_unported(ap, args) -> None:
    if args.model or args.checkpoint or args.mode != "logits":
        ap.error("ViT classifier/feature serving is not ported yet; the port "
                 "serves CLIP-HBA scores (--clip_weights)")
    if args.quantize:
        ap.error("--quantize is not ported yet (int8 serving comes with a "
                 "later slice)")
    if args.export_dir or args.from_export:
        ap.error("AOT export (--export_dir / --from_export) is not ported yet")
    if not args.clip_weights:
        ap.error("pass --clip_weights: the port serves CLIP-HBA scores only")
    if args.http_port is None and (not args.images or not args.out):
        # fail BEFORE the (possibly minutes-long) weights load
        ap.error("batch mode needs --images and --out "
                 "(or pass --http_port for the online daemon)")


def parse_args(argv=None) -> argparse.Namespace:
    """Parsed and checked CLI arguments, with the derived ``bucket_list``
    and ``dtype`` that ``build_clip_engine`` reads."""
    ap = build_parser()
    args = ap.parse_args(argv)
    _refuse_unported(ap, args)
    args.bucket_list = tuple(int(b) for b in args.buckets.split(","))
    args.dtype = torch.bfloat16 if args.param_dtype == "bf16" else None
    return args


def main(argv=None):
    args = parse_args(argv)
    eng, size, norm = build_clip_engine(args)

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
