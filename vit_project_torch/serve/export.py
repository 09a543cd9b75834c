"""AOT serving artifacts: the bucketed serving programs exported with
``torch.export`` and served with no model code (counterpart of the JAX
package's serve/export.py, which exports StableHLO).

- ``export_serving(engine, ...)`` writes one ``torch.export`` program per
  batch bucket plus a manifest. The parameters stay an ARGUMENT of every
  program (``torch.func.functional_call`` over the model's named parameters
  and buffers, int8 weights and their scales included), so the weights are
  stored once, in ``params.pth``, not in every bucket's program.
- ``load_serving(dir)`` rebuilds an engine (``AotEngine``) whose bucket
  programs come from the artifact: no model code runs at start-up, and the
  attention forward stays one node, ``vit_project_torch::flash3_fwd``,
  which launches the hand-written kernel on the card (ops/attention.py
  registers it; the loader imports that module first).

An artifact is bound to the device type it was exported on: constants the
forward makes (the q-lane scale of the classifier block, the normalization
constants) are created on that device inside the programs. The loader
refuses another device type, a JAX artifact and a directory that is not an
artifact, before loading anything.
"""
from __future__ import annotations

import itertools
import json
import os

import numpy as np
import torch

from ..core.device import resolve_device
from .engine import InferenceEngine

_FORMAT_PREFIX = "vit_project_torch.aot_serving/"
FORMAT = _FORMAT_PREFIX + "1"
_JAX_FORMAT_PREFIX = "vit_project_tpu.aot_serving/"
_MANIFEST = "manifest.json"
_PARAMS = "params.pth"


def _bucket_file(b: int) -> str:
    return f"bucket_{b:05d}.pt2"


class _Served(torch.nn.Module):
    """forward(images) = apply_fn(model, images), with the model as the one
    submodule, so ``functional_call`` can put the parameters in its place."""

    def __init__(self, apply_fn, model: torch.nn.Module):
        super().__init__()
        self.apply_fn = apply_fn
        self.model = model

    def forward(self, images):
        return self.apply_fn(self.model, images)


class _Program(torch.nn.Module):
    """forward(params, images): the served forward with `params` ({name:
    tensor} of the model's parameters and buffers) in place of the model's
    own. The model is kept out of this module's tree, so export lifts none
    of its tensors into the program."""

    def __init__(self, served: _Served):
        super().__init__()
        self.__dict__["served"] = served

    def forward(self, params, images):
        return torch.func.functional_call(
            self.served, {f"model.{k}": v for k, v in params.items()},
            (images,))


def _params(model: torch.nn.Module) -> dict:
    return {k: v.detach() for k, v in itertools.chain(
        model.named_parameters(), model.named_buffers())}


def export_serving(engine: InferenceEngine, example_shape: tuple,
                   out_dir: str, *, input_dtype=np.float32,
                   extra: dict | None = None) -> dict:
    """Write `engine`'s per-bucket programs, its parameters and a manifest
    to `out_dir`; returns the manifest.

    example_shape is ONE example's shape, e.g. (224, 224, 3); bucket B is
    exported at input [B, *example_shape] of `input_dtype` (the dtype
    requests arrive in: fixed at export, enforced by a cast at serving).

    An engine built over a mesh is refused, as the JAX package refuses it:
    its forward holds this rank's shard of the batch and its collectives;
    serve across ranks with the live engine."""
    if engine.mesh is not None:
        raise ValueError("AOT export supports single-device engines only "
                         "(a meshed export pins the exporting host's device "
                         "assignment into the artifact)")
    os.makedirs(out_dir, exist_ok=True)
    params = _params(engine.model)
    program = _Program(_Served(engine._fn, engine.model))
    dtype = np.dtype(input_dtype)
    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    for b in engine.buckets:
        x = torch.zeros((b,) + tuple(example_shape), dtype=tdtype,
                        device=engine.device)
        with torch.no_grad():
            ep = torch.export.export(program, (params, x), strict=False)
        if getattr(ep, "example_inputs", None) is not None:
            ep.example_inputs = None   # else every bucket keeps the weights
        torch.export.save(ep, os.path.join(out_dir, _bucket_file(b)))
    torch.save({k: v.cpu() for k, v in params.items()},
               os.path.join(out_dir, _PARAMS))
    manifest = {
        "format": FORMAT,
        "buckets": list(engine.buckets),
        "example_shape": list(example_shape),
        "input_dtype": dtype.name,
        "platforms": [engine.device.type],
        "torch_version": torch.__version__,
    }
    manifest.update(extra or {})  # the caller's host-side contract
    # (normalize constants, output mode, model name)
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class AotEngine(InferenceEngine):
    """An InferenceEngine whose bucket programs are loaded from an artifact.
    Every serving surface (__call__, map_stream, warmup) is the live
    engine's; only the program source differs."""

    def __init__(self, programs: dict, params: dict, manifest: dict,
                 device: torch.device):
        # deliberately NOT super().__init__: there is no model and no
        # apply_fn, that is the point of the artifact
        self.buckets = tuple(sorted(programs))
        self.device = device
        self.mesh = None
        self.params = params
        self.manifest = dict(manifest)
        self._programs = programs
        self._dtype = np.dtype(manifest["input_dtype"])
        self._example_shape = tuple(manifest["example_shape"])

    def _place(self, chunk: np.ndarray) -> torch.Tensor:
        if chunk.shape[1:] != self._example_shape:
            raise ValueError(f"request shape {chunk.shape[1:]} != exported "
                             f"example shape {self._example_shape}")
        return super()._place(np.ascontiguousarray(chunk, self._dtype))

    def _dispatch(self, chunk: np.ndarray) -> torch.Tensor:
        with torch.inference_mode():
            return self._programs[chunk.shape[0]](self.params,
                                                  self._place(chunk))


def load_serving(out_dir: str, device=None) -> AotEngine:
    """An ``export_serving`` artifact as a serving engine on `device`
    (default CUDA)."""
    from ..ops import attention  # noqa: F401  registers the programs' op
    path = os.path.join(out_dir, _MANIFEST)
    if not os.path.isfile(path):
        raise ValueError(f"{out_dir}: not an AOT serving artifact (no "
                         f"{_MANIFEST})")
    with open(path) as f:
        manifest = json.load(f)
    fmt = manifest.get("format", "")
    if fmt.startswith(_JAX_FORMAT_PREFIX):
        raise ValueError(f"{out_dir}: a JAX package artifact ({fmt!r}, "
                         f"StableHLO); export it with vit_project_torch")
    if not fmt.startswith(_FORMAT_PREFIX):
        raise ValueError(f"{out_dir}: not an AOT serving artifact ({fmt!r})")
    dev = resolve_device(device)
    plats = [p.lower() for p in manifest["platforms"]]
    if dev.type not in plats:
        raise ValueError(
            f"artifact was exported for platform(s) {plats}, but this "
            f"process serves on {dev.type!r}: re-export on the serving "
            f"platform (the programs create their constants on the "
            f"exporting device)")
    programs = {int(b): torch.export.load(
        os.path.join(out_dir, _bucket_file(int(b)))).module()
        for b in manifest["buckets"]}
    params = torch.load(os.path.join(out_dir, _PARAMS), map_location=dev,
                        weights_only=True)
    return AotEngine(programs, params, manifest, dev)
