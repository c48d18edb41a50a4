"""Serving artifacts: deploy the port's model with no model code
(counterpart of istvt_tpu/serve_export.py).

`save_artifact` exports the serving forward with `torch.export`: the input
cast, the model's eval forward and the logit column, as one program whose
batch dimension is dynamic from 1 to the largest bucket, so that one
program serves every bucket and holds the weights once (JAX writes one
program per bucket beside one weights file). The kernels are dispatcher
ops (kernels/ops.py), so the program carries them as `istvt::` calls,
as JAX's exported StableHLO carries its Pallas kernels as tpu_custom_call;
a loaded program launches them (and counts them in _lib.LAUNCHES) as the
live model does. `load_artifact` rebuilds a `serve.Predictor`-compatible
scorer from the directory alone: it needs torch, kernels/ops.py (which
registers the ops) and serve.py, and not the model zoo
(istvt_tpu_torch.models), so the serving process is immune to model-code
drift between training and serving.

Artifact layout (directory):

    manifest.json   JAX's keys: format_version, model_name, model_config,
                    batch_sizes, input_shape, input_dtype, platforms (the
                    device type the program was exported on), tree_spec
                    (the program's input and output pytree specs), extra;
                    torch_version in place of jax_version, and custom_ops
                    (each istvt:: op in the program with its calls) in
                    place of waived_custom_calls
    program.pt2     `torch.export.save` of the ExportedProgram: the graph
                    and every parameter and buffer bit for bit (bf16, int8,
                    f8), the non-persistent K-major and packed weight
                    copies as program constants

Quantized serving: quantize (models/istvt.quantize_params) or pack
(pack_params) the model first; its copies are stored as they are, so a
loaded int8 program builds no K-major copy (_lib.KMAJOR_BUILDS stays 0).

A program is pinned to the device type it was exported on: torch.export
bakes the devices of tensor factories into the graph, so `load_artifact`
refuses another device type rather than moving the program. A program is
also pinned to the torch generation that wrote it (redeploy = re-export),
as JAX's Pallas artifacts are to their jaxlib.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree

from istvt_tpu_torch.kernels import ops
from istvt_tpu_torch.serve import Predictor

FORMAT_VERSION = 1
_MANIFEST = "manifest.json"
_PROGRAM = "program.pt2"


class _ServingForward(nn.Module):
    """The exported function (JAX's `fwd`): the input cast, the model's
    eval forward, logits.reshape(B, -1)[:, 0] in f32."""

    def __init__(self, model: nn.Module, cast: Optional[torch.dtype]):
        super().__init__()
        self.model = model
        self.cast = cast

    def forward(self, x):
        if self.cast is not None:
            x = x.to(self.cast)
        logits = self.model(x)
        return logits.reshape(x.shape[0], -1)[:, 0].float()


def _dtype_name(dtype: Optional[torch.dtype]) -> Optional[str]:
    return None if dtype is None else str(dtype).split(".", 1)[1]


def export_program(model: nn.Module, *, input_shape: Sequence[int],
                   max_batch: int, input_dtype=None, device=None):
    """torch.export of the serving forward of `model` (put in eval mode for
    the trace, then given back in its own mode) on f32 clips of
    `input_shape`, the batch dynamic from 1 to max_batch (fixed where
    max_batch is 1), traced on `device` (default: the parameters')."""
    if device is None:
        device = next(model.parameters()).device
    example = torch.zeros((min(2, max_batch),) + tuple(input_shape),
                          dtype=torch.float32, device=device)
    dynamic = None
    if max_batch > 1:
        dynamic = ({0: torch.export.Dim("batch", min=1, max=max_batch)},)
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            return torch.export.export(_ServingForward(model, input_dtype),
                                       (example,), dynamic_shapes=dynamic,
                                       strict=False)
    finally:
        model.train(was)


def save_artifact(path: str, model: nn.Module, *,
                  input_shape: Sequence[int],
                  batch_sizes: Sequence[int] = (1, 16),
                  input_dtype=None, device=None,
                  extra_meta: Optional[Dict[str, Any]] = None) -> Dict:
    """Write a self-contained serving artifact for `model` into `path`.

    input_shape: per-clip shape WITHOUT the batch dim, e.g. (6, 300, 300,
        3); callers feed f32 and any cast happens inside the program.
    input_dtype: the cast applied to the inputs inside the program (as
        Predictor(input_dtype=...) or its compute_dtype: bf16 for the int8
        path and the bf16 float path, whose parameters already carry their
        deployed dtypes).
    device: where the program is traced, and so the device type it runs on
        (default: the model's).

    Returns the manifest dict (also written to manifest.json)."""
    os.makedirs(path, exist_ok=True)
    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    program = export_program(model, input_shape=input_shape,
                             max_batch=batch_sizes[-1],
                             input_dtype=input_dtype, device=device)
    torch.export.save(program, os.path.join(path, _PROGRAM))
    spec = program.call_spec
    cfg = getattr(model, "cfg", None)
    platform = (torch.device(device) if device is not None
                else next(model.parameters()).device).type
    manifest = {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "model_name": getattr(model, "name", "unknown"),
        "model_config": dataclasses.asdict(cfg)
        if dataclasses.is_dataclass(cfg) else None,
        "batch_sizes": batch_sizes,
        "input_shape": list(input_shape),
        "input_dtype": _dtype_name(input_dtype),
        "platforms": [platform],
        "custom_ops": {f"istvt::{n}": k for n, k in
                       ops.op_counts(program.graph).items() if k},
        "tree_spec": {"in": _pytree.treespec_dumps(spec.in_spec),
                      "out": _pytree.treespec_dumps(spec.out_spec)},
        "extra": extra_meta or {},
    }
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ExportedPredictor(Predictor):
    """Predictor over a loaded program: serve.Predictor's bucketing,
    padding and output contract (it inherits predict and _bucket), no
    model object. The input cast is the program's own."""

    def __init__(self, program, manifest: Dict, device: torch.device):
        self.model = None
        self.program = program
        self.manifest = manifest
        self.device = torch.device(device)
        self.batch_sizes = sorted(int(b) for b in manifest["batch_sizes"])
        self.compute_dtype = self.input_dtype = None    # in the program
        self.n_forwards = 0
        self._fn = program.module()

    def _forward(self, x: torch.Tensor) -> np.ndarray:
        with torch.inference_mode():
            logits = self._fn(x.to(self.device, torch.float32))
        self.n_forwards += 1
        return logits.cpu().numpy()


def load_artifact(path: str, device=None) -> ExportedPredictor:
    """Rebuild a scorer from a `save_artifact` directory, on the device
    type its manifest names (device=None: that type's default device); a
    device of another type raises ValueError, as does a format newer than
    this reader's. Requires torch and this package's kernel ops only; the
    model zoo is not imported."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["format_version"] > FORMAT_VERSION:
        raise ValueError(
            f"artifact format {manifest['format_version']} is newer "
            f"than this reader ({FORMAT_VERSION})")
    platform = manifest["platforms"][0]
    dev = torch.device(platform if device is None else device)
    if dev.type != platform:
        raise ValueError(
            f"the artifact was exported on {platform!r} and cannot run on "
            f"{dev.type!r}: torch.export bakes the devices of its tensor "
            f"factories into the program; export it again on that device")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the artifact {path} runs on the card and no "
                           f"CUDA device is present")
    program = torch.export.load(os.path.join(path, _PROGRAM))
    return ExportedPredictor(program, manifest, dev)
