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
- int8 serving: ``quantize="int8"`` rewrites every block's four dense
  weights to int8 (ops/quant.py) after the float cast and the bake; the
  engine then casts nothing, so the scales stay float32.
- mesh serving (``mesh=``, a DeviceMesh from ``parallel/mesh.make_mesh``
  over the ranks of a torch.distributed group, one device a rank): every
  rank calls the engine with the same images (the SPMD contract of the
  trainers). Each padded bucket of b rows is split over the mesh's
  "data" axis: a rank runs its b / n_data rows on its own device, and
  one all-gather over the data group returns the whole [b, ...] output
  on every rank (through host buffers under gloo). Buckets must be
  multiples of the data axis. The model stays whole on every rank unless
  ``shard_params(mesh, state)`` replaces that replication: on a ("data",
  "model") mesh it returns this rank's share of the flat state
  (``parallel/mesh.shard_vit_params_tp_mesh``: whole heads, Megatron's
  split), and the ViT engines run each block tensor-parallel over the
  model group (``models/vit.classifier_block_tp``, the flash3 kernel on
  the rank's H/T heads). JAX's tp serving takes its XLA attention path
  instead; the function is the same. ``clip_hba_engine`` serves over a
  data-parallel mesh only (the port has no tensor-parallel CLIP forward),
  and int8 weights take no ``shard_params`` (JAX's tp placement fails on
  them too).

The ViT engines (``vit_classifier_engine``, ``vit_features_engine``) serve
a ``VisionTransformerClassifier``: logits [B, num_classes] or pooled
embeddings [B, width]. With ``input_norm=(mean, std)`` they take raw
0..255 images (uint8 or float) and fold the normalization into the patch
matmul.

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
from ..models import vit as vvit
from ..ops import quant as vquant
from ..parallel import dist

DEFAULT_BUCKETS = (8, 32, 128, 256)


def _cast_float_leaves(model: torch.nn.Module, dtype) -> torch.nn.Module:
    """Cast floating-point parameters and buffers to `dtype` in place, leave
    integer ones alone (what ``Module.to(dtype)`` does). As in the JAX
    engine this includes the logit scale."""
    return model.to(dtype)


class InferenceEngine:
    """Bucketed batch inference over ``apply_fn(model, images[B, ...])``,
    which returns a tensor whose leading axis is B. Padding rows are zeros
    and their outputs are dropped, so apply_fn must be row-independent.

    `mesh` serves over the ranks of a DeviceMesh (module docstring);
    `shard_params(mesh, state)` takes the model's flat state {name:
    parameter} and returns this rank's (a tensor that differs from the
    parameter replaces it), in place of full replication."""

    def __init__(self, apply_fn, model: torch.nn.Module, *,
                 buckets=DEFAULT_BUCKETS, param_dtype=None, device=None,
                 mesh=None, shard_params=None):
        buckets = tuple(sorted({int(b) for b in buckets}))
        if not buckets or buckets[0] <= 0:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        if shard_params is not None and mesh is None:
            raise ValueError("shard_params requires a mesh")
        if mesh is not None:
            nd = mesh["data"].size()
            bad = [b for b in buckets if b % nd]
            if bad:
                raise ValueError(
                    f"buckets {bad} are not multiples of the mesh data-axis "
                    f"size {nd}; padded batches could not be sharded evenly")
        self.buckets = buckets
        self.mesh = mesh
        self.device = resolve_device(device)
        model = model.to(self.device).eval()
        if param_dtype is not None:
            model = _cast_float_leaves(model, param_dtype)
        if shard_params is not None:
            _load_shards(model, shard_params(mesh, dict(
                model.named_parameters())))
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
        """Enqueue one padded chunk; returns its output (on the device, or
        on the host after a gloo gather)."""
        if self.mesh is not None:
            return self._dispatch_mesh(chunk)
        with torch.inference_mode():
            return self._fn(self.model, self._place(chunk))

    def _dispatch_mesh(self, chunk: np.ndarray) -> torch.Tensor:
        """This rank's rows of the chunk on its device, then every data
        rank's outputs, in rank order, gathered as bytes (any dtype; the
        gather moves bits, so the rows are the ranks' own)."""
        group = self.mesh.get_group("data")
        n, i = self.mesh["data"].size(), self.mesh.get_local_rank("data")
        rows = chunk.shape[0] // n
        with torch.inference_mode():
            out = self._fn(self.model,
                           self._place(chunk[i * rows:(i + 1) * rows]))
            local = out.contiguous().view(-1).view(torch.uint8)
            if dist._via_host(local, group):
                local = local.cpu()
            flat = dist.all_gather_rows(local, group)
            return flat.view(out.dtype).view(n * rows, *out.shape[1:])

    @staticmethod
    def _fetch(out: torch.Tensor, m: int) -> np.ndarray:
        out = out[:m]
        if out.dtype == torch.bfloat16:   # numpy has no bf16; exact in f32
            out = out.float()
        return out.cpu().numpy()

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


@torch.no_grad()
def _load_shards(model: torch.nn.Module, local: dict) -> None:
    """Put each tensor of `local` ({name: tensor}, as ``shard_params``
    returns it) that is not already the model's parameter in its place."""
    named = dict(model.named_parameters())
    for name, t in local.items():
        if t is not named[name]:
            owner, leaf = name.rsplit(".", 1)
            setattr(model.get_submodule(owner), leaf,
                    torch.nn.Parameter(t.to(named[name].device),
                                       requires_grad=False))


def _tp_group(mesh, shard_params):
    """The model group the ViT forward runs tensor-parallel over: the
    mesh's "model" axis when the parameters are sharded over it, else
    None."""
    if shard_params is None or mesh is None or \
            "model" not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group("model")


def _maybe_quantize(model, quantize, param_dtype, quant_fn):
    """Apply the optional serving quantization: (model, the param_dtype the
    engine should cast to). The float cast runs FIRST, so the scales are
    taken from the served weights and stay float32; the engine then casts
    nothing (JAX serve/engine.py _maybe_quantize)."""
    if quantize is None:
        return model, param_dtype
    if quantize != "int8":
        raise ValueError(f"unknown quantize mode {quantize!r} (only 'int8')")
    if param_dtype is not None:
        model = _cast_float_leaves(model, param_dtype)
    return quant_fn(model), None


# -- model-specific constructors ----------------------------------------

def _refuse_int8_tp(quantize, shard_params) -> None:
    if quantize is not None and shard_params is not None:
        raise ValueError(
            "quantize='int8' takes no shard_params: the tensor-parallel "
            "placement splits float weights (JAX's shard_vit_params_tp "
            "fails on int8 leaves too); serve int8 over a data-parallel "
            "mesh")


def vit_classifier_engine(model: vvit.VisionTransformerClassifier, *,
                          compute_dtype=torch.bfloat16, input_norm=None,
                          buckets=DEFAULT_BUCKETS, param_dtype=None,
                          quantize: str | None = None,
                          device=None, mesh=None,
                          shard_params=None) -> InferenceEngine:
    """Serve ViT classifier logits [B, num_classes] (models.vit.vit_classify)
    on `device` (default CUDA). quantize="int8" rewrites every block's dense
    weights to int8 (ops/quant.py), in place. `mesh` / `shard_params`:
    data- and tensor-parallel serving (module docstring)."""
    _refuse_int8_tp(quantize, shard_params)
    model = model.to(resolve_device(device))
    model, param_dtype = _maybe_quantize(model, quantize, param_dtype,
                                         vquant.quantize_vit_blocks)
    tp = _tp_group(mesh, shard_params)

    def apply_fn(m, images):
        return vvit.vit_classify(m, images, input_norm=input_norm,
                                 compute_dtype=compute_dtype, tp=tp)
    return InferenceEngine(apply_fn, model, buckets=buckets,
                           param_dtype=param_dtype, device=device, mesh=mesh,
                           shard_params=shard_params)


def vit_features_engine(model: vvit.VisionTransformerClassifier, *,
                        pool: str = "token", compute_dtype=torch.bfloat16,
                        input_norm=None, buckets=DEFAULT_BUCKETS,
                        param_dtype=None, quantize: str | None = None,
                        device=None, mesh=None,
                        shard_params=None) -> InferenceEngine:
    """Serve pooled ViT embeddings [B, width] (models.vit.forward_features:
    pool "token" is the CLS token, "avg" the mean of the patch tokens).
    quantize, mesh and shard_params as in vit_classifier_engine."""
    _refuse_int8_tp(quantize, shard_params)
    model = model.to(resolve_device(device))
    model, param_dtype = _maybe_quantize(model, quantize, param_dtype,
                                         vquant.quantize_vit_blocks)
    tp = _tp_group(mesh, shard_params)

    def apply_fn(m, images):
        return vvit.forward_features(m, images, pool=pool,
                                     input_norm=input_norm,
                                     compute_dtype=compute_dtype, tp=tp)
    return InferenceEngine(apply_fn, model, buckets=buckets,
                           param_dtype=param_dtype, device=device, mesh=mesh,
                           shard_params=shard_params)


def clip_hba_engine(model: vclip.CLIP, prompt_tokens, *, trainable=None,
                    static=None, alpha: int = 16, r: int = 8,
                    compute_dtype=torch.bfloat16,
                    use_pos_embedding: bool = True, buckets=DEFAULT_BUCKETS,
                    param_dtype=None, quantize: str | None = None,
                    device=None, mesh=None,
                    shard_params=None) -> InferenceEngine:
    """Serve CLIP-HBA behavioral scores [B, n_prompts].

    Trained adapters (trainable + static, as adapters.dora.apply_dora and a
    loaded checkpoint give them) are BAKED into the model's weights first,
    in place, so the served forward is a plain CLIP pass. prompt_tokens
    [n_prompts, context] are fixed at build and re-encoded on every call, as
    the JAX forward does. quantize="int8" quantizes both towers' blocks
    after the bake (the adapted out_proj is the weight that gets the int8
    treatment; an RN visual tower stays float). `use_pos_embedding` is the
    reference CLIPHBA's pos_embedding flag (off for its RN50 runs). Runs on
    `device` (default CUDA; raises without a GPU unless device='cpu').
    `mesh` serves data-parallel; `shard_params` is refused: the port has no
    tensor-parallel CLIP forward."""
    if shard_params is not None:
        raise ValueError(
            "clip_hba_engine takes no shard_params: vit_project_torch has "
            "no tensor-parallel CLIP forward (models/clip.py runs both "
            "towers whole on every rank); serve CLIP over a data-parallel "
            "mesh (mesh= alone)")
    if (trainable is None) != (static is None):
        raise ValueError("pass both trainable and static, or neither")
    device = resolve_device(device)
    model = model.to(device)
    if trainable is not None:
        adora.bake(model, trainable, static, alpha=alpha, r=r)
    model, param_dtype = _maybe_quantize(model, quantize, param_dtype,
                                         vquant.quantize_clip_blocks)
    tok = torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.long,
                          device=device)

    def apply_fn(m, images):
        return vclip.clip_hba_forward(m, images, tok,
                                      compute_dtype=compute_dtype,
                                      use_pos_embedding=use_pos_embedding)
    eng = InferenceEngine(apply_fn, model, buckets=buckets,
                          param_dtype=param_dtype, device=device, mesh=mesh)
    eng.prompt_tokens = tok
    return eng
