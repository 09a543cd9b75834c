"""Bucketed batch inference on the GPU (counterpart of the JAX package's
serve/engine.py).

- FIXED SHAPES: requests are zero-padded up to a small ladder of batch
  buckets, so every size a client sends runs one of a few known shapes (the
  ones ``warmup`` has already run); sizes above the largest bucket are
  chunked through it.
- ONE weights placement: the model moves to the device once, at build, with
  its float parameters cast to ``param_dtype`` (bf16 by default in the CLI).
- bf16 compute by default, with LayerNorm statistics, softmax and the final
  projections in f32 inside the ops.
- streaming: ``map_stream`` keeps ``depth`` chunks in flight on the CUDA
  stream, so the host pads, pins and enqueues chunk k+1 while the device
  runs chunk k; a chunk's result is copied back only when it is drained.
- zero-overhead adapters: ``clip_hba_engine`` bakes trained DoRA adapters
  into the weights, so the served forward is a plain CLIP pass.

Every forward runs under ``torch.inference_mode()`` (which is per thread, so
each entry point enters it itself).
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..adapters import dora as adora
from ..core.device import resolve_device
from ..models import clip as vclip

DEFAULT_BUCKETS = (8, 32, 128, 256)


def _cast_float_leaves(model: torch.nn.Module, dtype) -> torch.nn.Module:
    """Cast floating-point parameters and buffers to `dtype` in place, leave
    integer ones alone (what ``Module.to(dtype)`` does). As in the JAX
    engine this includes the logit scale."""
    return model.to(dtype)


class InferenceEngine:
    """Bucketed batch inference over ``apply_fn(model, images[B, ...])``,
    which returns a tensor whose leading axis is B. Padding rows are zeros
    and their outputs are dropped, so apply_fn must be row-independent."""

    def __init__(self, apply_fn, model: torch.nn.Module, *,
                 buckets=DEFAULT_BUCKETS, param_dtype=None, device=None):
        buckets = tuple(sorted({int(b) for b in buckets}))
        if not buckets or buckets[0] <= 0:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.buckets = buckets
        self.device = resolve_device(device)
        model = model.to(self.device).eval()
        if param_dtype is not None:
            model = _cast_float_leaves(model, param_dtype)
        self.model = model
        self._fn = apply_fn

    # -- shape plumbing ------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _chunk_iter(self, batches):
        """(batch_idx, valid_rows, is_last_chunk_of_batch, padded_chunk)."""
        maxb = self.buckets[-1]
        for bi, images in enumerate(batches):
            images = np.asarray(images)
            n = images.shape[0]
            if n == 0:
                raise ValueError("empty batch")
            for s in range(0, n, maxb):
                chunk = images[s:s + maxb]
                m = chunk.shape[0]
                b = self._bucket_for(m)
                if b > m:
                    pad = np.zeros((b - m,) + chunk.shape[1:], chunk.dtype)
                    chunk = np.concatenate([chunk, pad])
                yield bi, m, s + maxb >= n, chunk

    def _place(self, chunk: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(chunk))
        if self.device.type == "cuda":
            # pinned host memory makes the copy asynchronous on the stream
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _dispatch(self, chunk: np.ndarray) -> torch.Tensor:
        """Enqueue one padded chunk; returns its (device) output."""
        with torch.inference_mode():
            return self._fn(self.model, self._place(chunk))

    @staticmethod
    def _fetch(out: torch.Tensor, m: int) -> np.ndarray:
        return out[:m].cpu().numpy()

    # -- serving surfaces ----------------------------------------------

    def warmup(self, example_shape: tuple, dtype=np.float32,
               buckets=None) -> None:
        """Run every bucket (or the given ones) once, so the first request
        never pays for kernel builds, cuBLAS set-up or allocator growth.
        example_shape is ONE example's shape, e.g. (224, 224, 3)."""
        for b in buckets or self.buckets:
            x = np.zeros((b,) + tuple(example_shape), dtype)
            self._fetch(self._dispatch(x), b)

    def __call__(self, images) -> np.ndarray:
        """Inference on one batch of any size; returns host outputs [B, ...]."""
        parts = [self._fetch(self._dispatch(chunk), m)
                 for _, m, _, chunk in self._chunk_iter([images])]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def map_stream(self, batches, depth: int = 2):
        """Yield outputs for an iterable of batches, in order, keeping up to
        `depth` dispatched chunks in flight."""
        if depth < 1:
            raise ValueError("depth must be >= 1")
        pending = deque()  # (batch_idx, valid_rows, is_last, device_out)
        parts: dict[int, list] = {}

        def _drain_one():
            bi, m, last, out = pending.popleft()
            parts.setdefault(bi, []).append(self._fetch(out, m))
            if not last:
                return None
            ps = parts.pop(bi)
            return ps[0] if len(ps) == 1 else np.concatenate(ps)

        for bi, m, last, chunk in self._chunk_iter(batches):
            pending.append((bi, m, last, self._dispatch(chunk)))
            while len(pending) > depth:
                done = _drain_one()
                if done is not None:
                    yield done
        while pending:
            done = _drain_one()
            if done is not None:
                yield done


def clip_hba_engine(model: vclip.CLIP, prompt_tokens, *, trainable=None,
                    static=None, alpha: int = 16, r: int = 8,
                    compute_dtype=torch.bfloat16, buckets=DEFAULT_BUCKETS,
                    param_dtype=None, device=None) -> InferenceEngine:
    """Serve CLIP-HBA behavioral scores [B, n_prompts].

    Trained adapters (trainable + static, as adapters.dora.apply_dora and a
    loaded checkpoint give them) are BAKED into the model's weights first,
    in place, so the served forward is a plain CLIP pass. prompt_tokens
    [n_prompts, context] are fixed at build and re-encoded on every call, as
    the JAX forward does. Runs on `device` (default CUDA; raises without a
    GPU unless device='cpu')."""
    if (trainable is None) != (static is None):
        raise ValueError("pass both trainable and static, or neither")
    device = resolve_device(device)
    model = model.to(device)
    if trainable is not None:
        adora.bake(model, trainable, static, alpha=alpha, r=r)
    tok = torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.long,
                          device=device)

    def apply_fn(m, images):
        return vclip.clip_hba_forward(m, images, tok,
                                      compute_dtype=compute_dtype)
    eng = InferenceEngine(apply_fn, model, buckets=buckets,
                          param_dtype=param_dtype, device=device)
    eng.prompt_tokens = tok
    return eng
