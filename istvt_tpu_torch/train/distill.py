"""Knowledge distillation: train a cheaper student against a teacher
(counterpart of istvt_tpu/train/distill.py).

The teacher's logits, and with attention transfer its LRP cams, are
computed per batch by `make_teacher_fn` and added to the batch by the
hook `augment_with_teacher`; the student trains through the standard
train/step.make_train_step with train/losses.make_distill_loss. Riding in
the batch, the teacher signal composes with every step feature: bf16
compute and grad_accum (the step splits the teacher's entries with the
clips).

`resize_bilinear` is jax.image.resize(..., 'bilinear') over the spatial
axes: a triangle filter widened by the scale when it downscales
(antialias), which F.interpolate(antialias=True) computes; without
antialias a 300 -> 224 resize is off by up to 2.2 on N(0, 1) data.

Not ported: a device mesh (raises, naming ROADMAP.md queue 1
'Parallelism').
"""
from __future__ import annotations

import copy
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from istvt_tpu_torch.core import tree
from istvt_tpu_torch.interpret.lrp import generate_lrp
from istvt_tpu_torch.models import istvt

_ROADMAP = "ROADMAP.md queue 1"


def resize_bilinear(x: torch.Tensor, size: int,
                    channels_last: bool = True) -> torch.Tensor:
    """jax.image.resize(x, ..., 'bilinear') of the two spatial axes to
    (size, size): NHWC clips (..., H, W, C) with channels_last, else maps
    (..., H, W). Computed in f32, returned in x's dtype."""
    if channels_last:
        lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
        y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    else:
        lead, (h, w) = x.shape[:-2], x.shape[-2:]
        y = x.reshape(-1, 1, h, w)
    y = F.interpolate(y.float(), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True).to(x.dtype)
    if channels_last:
        return y.permute(0, 2, 3, 1).reshape(*lead, size, size, c)
    return y.reshape(*lead, size, size)


def chunk_slices(n: int, chunk: Optional[int]):
    """Row slices of at most `chunk` (all rows without one); a ragged
    last slice is one more slice."""
    step = chunk if chunk and chunk < n else n
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def make_teacher_fn(teacher, compute_dtype: Optional[torch.dtype] = None,
                    mesh=None, cam_cfg=None,
                    cam_chunk: Optional[int] = None) -> Callable:
    """Returns batch -> the teacher's logits, or (logits, cam_s, cam_t)
    with cam_cfg (JAX distill.py:27-97).

    teacher: the port's ISTVT with its weights loaded; it runs in eval
    mode on its own device, whatever mode a student is put in. Its
    (in, out) weight copies are packed here (models/istvt.pack_params),
    so its fused forward runs where its cfg has use_pallas. Logits are
    computed without autograd; compute_dtype casts a copy of the
    teacher's parameters and the clips for them (the logits come back as
    produced).

    cam_cfg: the teacher's ISTVTConfig (teacher.cfg; another raises);
    when set, the teacher's own LRP maps (interpret/lrp.generate_lrp,
    transformer_attribution of logit 0), (B, T, hw) each, the supervision
    of attention-transfer distillation. cam_chunk computes them in slices of
    that many clips (the maps and their gradients of a 300^2 / depth-12
    clip take ~700 MB); a ragged last slice is one more slice."""
    if mesh is not None:
        raise NotImplementedError(f"a device mesh is not ported yet "
                                  f"({_ROADMAP}, 'Parallelism')")
    if cam_cfg is not None and cam_cfg != teacher.cfg:
        raise ValueError(f"cam_cfg {cam_cfg} is not the teacher's cfg "
                         f"{teacher.cfg}")
    teacher.eval()
    istvt.pack_params(teacher)
    scorer = teacher
    if compute_dtype is not None:
        scorer = istvt.pack_params(tree.cast(copy.deepcopy(teacher),
                                             compute_dtype))
    dev = next(teacher.parameters()).device
    in_dtype = next(scorer.parameters()).dtype

    def cams(x):
        parts = [generate_lrp(teacher, x[sl], index=0)
                 for sl in chunk_slices(x.shape[0], cam_chunk)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    def teacher_fn(batch):
        x = torch.as_tensor(batch.get("clips", batch.get("images"))).to(dev)
        scorer.eval()
        with torch.no_grad():
            logits = scorer(x.to(in_dtype))
        if cam_cfg is None:
            return logits
        return (logits, *cams(x))

    return teacher_fn


def regrid(cam_s, cam_t, student_feat_hw: Optional[int] = None):
    """(teacher_cam_s (B, T, hs^2), teacher_cam_t (B, T)) from the
    teacher's cams (JAX distill.py:117-128): cam_s bilinearly regridded
    from the teacher's feature grid to the student's (default: the
    teacher's own), clipped at 0 and normalised over the cells; cam_t
    summed over the cells, clipped and normalised over the frames."""
    b, t, hw = cam_s.shape
    ht = int(round(hw ** 0.5))
    hs = student_feat_hw or ht
    g = cam_s.reshape(b, t, ht, ht)
    if hs != ht:
        g = resize_bilinear(g, hs, channels_last=False)
    g = g.reshape(b, t, hs * hs).clamp_min(0.0)
    g = g / (g.sum(dim=-1, keepdim=True) + 1e-9)
    ft = cam_t.sum(dim=-1).clamp_min(0.0)
    ft = ft / (ft.sum(dim=-1, keepdim=True) + 1e-9)
    return g, ft


def augment_with_teacher(teacher_fn: Callable,
                         student_size: Optional[int] = None,
                         student_feat_hw: Optional[int] = None) -> Callable:
    """batch_hook for train/trainer.Trainer (JAX distill.py:100-146):
    adds 'teacher_logits' to each batch, and with a cam teacher_fn
    'teacher_cam_s' / 'teacher_cam_t' (regrid to student_feat_hw).
    student_size: cross-geometry distillation: the teacher scores the
    clips as they come, then the student gets them resized to
    (student_size, student_size) (resize_bilinear)."""
    def hook(batch):
        out = dict(batch)
        res = teacher_fn(batch)
        if isinstance(res, tuple):
            out["teacher_logits"], cam_s, cam_t = res
            out["teacher_cam_s"], out["teacher_cam_t"] = regrid(
                cam_s, cam_t, student_feat_hw)
        else:
            out["teacher_logits"] = res
        if student_size is not None:
            key = "clips" if "clips" in batch else "images"
            out[key] = resize_bilinear(torch.as_tensor(batch[key]),
                                       student_size)
        return out
    return hook
