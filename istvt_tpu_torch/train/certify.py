"""Accuracy certification of the composed serving recipe (teacher ->
distilled reduced-geometry student -> int8), end to end (counterpart of
istvt_tpu/train/certify.py).

The recipe serves a reduced-geometry shallow student (224^2 / depth 6,
int8) in place of the paper model (300^2 / depth 12). `certify_recipe`
trains the teacher at full geometry on the held-out synthetic capability
task (static artifact patches, graded amplitudes), distills the student
cross-geometry with attention transfer (train/distill.py,
losses.make_distill_loss), quantizes a copy, and scores every link on a
disjoint val split:

  1. teacher generalization - val AUC of the teacher;
  2. student generalization - val AUC >= auc_frac of the teacher's;
  3. int8 serving parity    - the same student through the W8A8 path
                              (use_pallas, quantize='int8', its kernels):
                              AUC, rank fidelity to its float logits, max
                              |logit delta|; with export_dir, that exact
                              int8 student exported as a serving artifact
                              (serve_export), reloaded, and its val logits
                              held to the ones certified
                              (artifact_matches);
  4. teacher-logit fidelity - Spearman rank correlation of student and
                              teacher val logits;
  5. interpretability       - the student's LRP maps put more cam_s mass
                              on the artifact cells than the uniform share,
                              and cam_t mass on the manipulated frames of
                              subset-frame fakes.

The two training loops and the LRP calls run the XLA-math path (cfg
use_pallas=False, as JAX builds its teacher and student); only the int8
leg runs kernels. Result keys and criteria names are JAX's.

Departures from JAX, its advisor's findings (ADVICE.md r5) not carried
over: a cam_chunk that does not divide a batch computes a ragged last
slice (JAX's _lrp_eval silently ran the whole batch); teacher_ckpt keeps
a meta record (seed, patch, train_amp_range, geometry, seq_len) beside
the teacher's state_dict, and a restore under other settings raises;
export_dir without the int8 leg raises (JAX exported nothing then,
silently).

Drivers: `python -m istvt_tpu_torch.cli.certify`;
tests/test_torch_certify.py runs the chain at a CPU-scaled geometry.
"""
from __future__ import annotations

import contextlib
import copy
import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from istvt_tpu_torch.core.checkpoint import load_pytree, save_pytree
from istvt_tpu_torch.core.config import ISTVTConfig, TrainConfig
from istvt_tpu_torch.core.device import require_cuda
from istvt_tpu_torch.data import SyntheticVideoDataset
from istvt_tpu_torch.interpret.lrp import eval_mode, generate_lrp
from istvt_tpu_torch.models import istvt
from istvt_tpu_torch.models.istvt import infer_feat_hw
from istvt_tpu_torch.models.registry import model_selection
from istvt_tpu_torch.train import distill as D
from istvt_tpu_torch.train import losses as L
from istvt_tpu_torch.train import step as S
from istvt_tpu_torch.train.metrics import auc
from istvt_tpu_torch.train.schedule import cosine_schedule


def _batches(ds, batch_size: int, device=None):
    """(items, full batches of batch_size as tensors on device): the clips
    move to the device once, and every epoch reuses them."""
    items = [ds[i] for i in range(len(ds))]
    out = []
    for i in range(0, len(items), batch_size):
        chunk = items[i:i + batch_size]
        if len(chunk) < batch_size:
            break
        out.append({
            "clips": torch.as_tensor(
                np.stack([it["clips"] for it in chunk])).to(device),
            "labels": torch.as_tensor(
                np.stack([it["labels"] for it in chunk])).to(device),
        })
    return items, out


def spearman(a, b) -> float:
    """Spearman rank correlation (average ranks for ties)."""
    from scipy.stats import rankdata
    ra, rb = rankdata(np.asarray(a)), rankdata(np.asarray(b))
    ra, rb = ra - ra.mean(), rb - rb.mean()
    denom = float(np.sqrt((ra * ra).sum() * (rb * rb).sum()))
    return float((ra * rb).sum() / denom) if denom else 0.0


def _train(model, batches, *, epochs: int, lr: float, loss_fn=None,
           compute_dtype=None, log: Callable = print, tag: str = "model"):
    """AdamW on a cosine schedule for `epochs` passes over `batches`,
    then recalibrate_bn over them; trains `model` in place and drops its
    gradients."""
    opt = S.make_optimizer(TrainConfig(optimizer="adamw"),
                           cosine_schedule(lr, 10_000))
    ts = S.create_train_state(model, opt)
    step = S.make_train_step(compute_dtype=compute_dtype, loss_fn=loss_fn)
    for e in range(epochs):
        t0, ls, accs = time.time(), [], []
        for b in batches:
            m = step(ts, b)
            ls.append(float(m["loss"]))
            accs.append(float(m["accuracy"]))
        log(f"[certify] {tag} epoch {e + 1}/{epochs}: "
            f"loss {np.mean(ls):.4f} acc {np.mean(accs):.3f} "
            f"({time.time() - t0:.1f}s)")
    S.recalibrate_bn(model, batches)
    model.zero_grad(set_to_none=True)
    return model


def _eval_logits(model, batch) -> np.ndarray:
    out = S.make_eval_step()(model, batch)
    return out["logits"].cpu().numpy().reshape(-1)


@torch.no_grad()
def _fwd_logits(model, clips):
    """The eval forward's logits, the model given back in its mode."""
    with eval_mode(model):
        istvt.pack_params(model)
        return model(clips)


def _patch_cells(y: float, x: float, ps: float, size: int,
                 feat_hw: int) -> list:
    """Feature-grid cells (row-major) that the patch at (y, x) of side ps
    overlaps, on a size^2 clip read as a feat_hw^2 grid."""
    cell = size / feat_hw

    def span(v):
        return range(int(v // cell),
                     min(int((v + ps - 1) // cell), feat_hw - 1) + 1)
    return [r * feat_hw + c for r in span(y) for c in span(x)]


def _lrp_eval(model, clips, chunk: Optional[int] = None):
    """(logits, cam_s, cam_t) as numpy, the eval forward's logits and
    generate_lrp's cams, in slices of `chunk` clips (a ragged last slice
    is one more slice; none: the whole batch)."""
    parts = []
    for sl in D.chunk_slices(clips.shape[0], chunk):
        c = clips[sl]
        parts.append((_fwd_logits(model, c), *generate_lrp(model, c,
                                                           index=0)))
    return tuple(torch.cat([p[k] for p in parts]).cpu().numpy()
                 for k in range(3))


def _spatial_ratios(cam_s, fakes, scale: float, size: int, feat_hw: int,
                    ps: float) -> list:
    """Per-fake ratio of cam_s mass on the artifact cells vs the uniform
    share (ratio 1.0 = no localization)."""
    ratios = []
    for j, f in enumerate(fakes):
        y, x = f["patch_yx"]
        cells = _patch_cells(y * scale, x * scale, ps * scale, size,
                             feat_hw)
        sm = cam_s[j] / (cam_s[j].sum(axis=-1, keepdims=True) + 1e-9)
        share = sm[:, cells].sum(axis=-1).mean()
        ratios.append(float(share / (len(cells) / feat_hw ** 2)))
    return ratios


def _subset_frame_fakes(n: int, seq_len: int, size: int, patch: int,
                        frames: Sequence[int], seed: int) -> np.ndarray:
    """Fakes whose artifact lives only in a subset of frames, ground truth
    for the temporal saliency check; frames=() yields reals."""
    clips = []
    for k in range(n):
        rng = np.random.default_rng((seed, k))
        base = rng.normal(0, 0.3, (size, size, 3)).astype(np.float32)
        clip = np.stack([np.roll(base, t, axis=1) for t in range(seq_len)])
        y = int(rng.integers(0, size - patch))
        x = int(rng.integers(0, size - patch))
        for t in frames:
            clip[t, y:y + patch, x:x + patch] += rng.normal(
                0, 1.0, (patch, patch, 3)).astype(np.float32)
        clips.append(clip)
    return np.stack(clips)


def _temporal_aug_batches(n_batches: int, batch_size: int, seq_len: int,
                          size: int, patch: int, seed: int,
                          device=None) -> list:
    """Distillation batches of half subset-frame fakes (single frames
    cycling from the last, suffix runs of varying onset) and half reals,
    with cam_s_mask 0: their spatial cam targets are noise on the
    artifact-free frames, so they train the logit and temporal terms
    only. Seeds are disjoint from the held-out temporal probe (4242)."""
    out = []
    for bi in range(n_batches):
        half = batch_size // 2
        clips, labels = [], []
        for k in range(half):
            if k % 2 == 0:          # single frames, cycling from the last
                frames = (seq_len - 1 - (k // 2) % seq_len,)
            else:                   # suffix runs of varying onset
                start = 1 + (k // 2) % max(seq_len - 1, 1)
                frames = tuple(range(start, seq_len))
            clips.append(_subset_frame_fakes(
                1, seq_len, size, patch, frames,
                seed=777 + 1000 * bi + k)[0])
            labels.append(1)
        for k in range(batch_size - half):
            clips.append(_subset_frame_fakes(
                1, seq_len, size, patch, (),
                seed=888 + 1000 * bi + k)[0])
            labels.append(0)
        out.append({"clips": torch.as_tensor(np.stack(clips)).to(device),
                    "labels": torch.as_tensor(
                        np.array(labels, np.float32)).to(device),
                    "cam_s_mask": torch.zeros(batch_size, device=device)})
    return out


@contextlib.contextmanager
def _leg(legs: Optional[Dict], name: str, device):
    """Record the block's wall time and, on the card, its peak device
    memory under legs[name]."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    yield
    if cuda:
        torch.cuda.synchronize(device)
    if legs is not None:
        legs[name] = {
            "wall_s": time.perf_counter() - t0,
            "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                         if cuda else None)}


def _teacher_meta(seed, ps, train_amp_range, teacher_size, teacher_depth,
                  seq_len) -> Dict:
    return {"seed": int(seed), "patch": int(ps),
            "train_amp_range": (None if train_amp_range is None
                                else [float(v) for v in train_amp_range]),
            "geometry": f"{teacher_size}^2/d{teacher_depth}",
            "seq_len": int(seq_len)}


def certify_recipe(
    *,
    teacher_size: int = 300,
    teacher_depth: int = 12,
    student_size: int = 224,
    student_depth: int = 6,
    seq_len: int = 6,
    train_clips: int = 48,
    val_clips: int = 32,
    batch_size: int = 8,
    patch_size: Optional[int] = None,
    teacher_epochs: int = 15,
    distill_epochs: int = 15,
    lr: float = 3e-4,
    alpha: float = 0.5,
    temperature: float = 2.0,
    attn_weight: float = 1.0,
    seed: int = 0,
    train_amp_range: Optional[Tuple[float, float]] = None,
    compute_dtype=None,
    auc_frac: float = 0.95,
    int8_delta_max: float = 1.0,
    int8_spearman_min: float = 0.98,
    fidelity_min: float = 0.8,
    lrp_ratio_min: float = 1.2,
    lrp_ratio_mean: float = 1.4,
    lrp_fakes: int = 6,
    val_amp_range: Optional[Tuple[float, float]] = (0.5, 1.5),
    temporal_checks: Optional[Sequence[Tuple[Sequence[int], float]]] = None,
    temporal_aug: int = 1,
    cam_chunk: Optional[int] = None,
    run_int8: bool = True,
    run_lrp: bool = True,
    export_dir: Optional[str] = None,
    diag_teacher_lrp: bool = True,
    teacher_ckpt: Optional[str] = None,
    teacher_bundle=None,
    log: Callable = print,
    device=None,
    legs: Optional[Dict] = None,
) -> dict:
    """Run the whole chain; returns {metrics..., 'criteria': {...},
    'pass': bool} with JAX's keys (train/certify.py:227-549). Defaults
    are the production recipe's geometry; the arguments are JAX's, with
    these port-side ones:

    teacher_bundle: an already-trained port ISTVT at (teacher_size,
    teacher_depth, seq_len) on the same static-patch task, its weights
    loaded; skips the teacher leg (JAX's (model, params, state) bundle).
    teacher_ckpt: a file the teacher is restored from if it exists
    (its meta record must match this call's, else ValueError), and saved
    to after training otherwise.
    device: where everything runs (default: the card; the tests pass
    the CPU, where the int8 leg runs its kernels' plain versions).
    legs: a dict filled with each leg's {'wall_s', 'peak_gib'} (peak
    device memory on the card, None on the CPU): data, teacher, hook,
    student, int8, lrp.
    compute_dtype: torch.bfloat16 trains both loops in bf16 over f32
    masters."""
    if export_dir and not run_int8:
        raise ValueError("export_dir exports the certified int8 student: "
                         "it needs the int8 leg (run_int8=True)")
    if train_amp_range is not None and len(train_amp_range) != 2:
        raise ValueError(f"train_amp_range={train_amp_range!r}: want "
                         f"(lo, hi)")
    dev = require_cuda() if device is None else torch.device(device)
    t_start = time.time()
    ps = patch_size or teacher_size // 3
    scale = student_size / teacher_size

    # -- data: train and a disjoint val, the artifact pinned per clip ----
    with _leg(legs, "data", dev):
        train_ds = SyntheticVideoDataset(
            num_clips=train_clips, seq_len=seq_len, size=teacher_size,
            seed=seed, static_patch=True, patch_size=ps,
            amp_range=train_amp_range)
        val_ds = SyntheticVideoDataset(
            num_clips=val_clips, seq_len=seq_len, size=teacher_size,
            seed=999 + seed, static_patch=True, patch_size=ps,
            amp_range=val_amp_range)
        _, batches = _batches(train_ds, batch_size, dev)
        val_items = [val_ds[i] for i in range(len(val_ds))]
        vb = {"clips": torch.as_tensor(
                  np.stack([it["clips"] for it in val_items])).to(dev),
              "labels": torch.as_tensor(
                  np.stack([it["labels"] for it in val_items])).to(dev)}
    log(f"[certify] data on device: {len(batches)} train batches of "
        f"{batch_size} + {val_clips} val clips at {teacher_size}^2 T="
        f"{seq_len} ({time.time() - t_start:.0f}s)")

    # -- teacher at full geometry ---------------------------------------
    with _leg(legs, "teacher", dev):
        if teacher_bundle is not None:
            teacher = teacher_bundle
        else:
            t_cfg = ISTVTConfig(num_frames=seq_len, image_size=teacher_size,
                                feat_hw=infer_feat_hw(teacher_size),
                                depth=teacher_depth)
            teacher = model_selection("istvt", num_out_classes=1, cfg=t_cfg,
                                      device=dev, seed=seed)
            meta = _teacher_meta(seed, ps, train_amp_range, teacher_size,
                                 teacher_depth, seq_len)
            if teacher_ckpt and os.path.exists(teacher_ckpt):
                blob = load_pytree(teacher_ckpt, map_location="cpu")
                if blob.get("meta") != meta:
                    raise ValueError(
                        f"teacher_ckpt {teacher_ckpt} was trained under "
                        f"{blob.get('meta')}, this run asks for {meta}")
                teacher.load_state_dict(blob["state_dict"])
                log(f"[certify] teacher restored from {teacher_ckpt}")
            else:
                _train(teacher, batches, epochs=teacher_epochs, lr=lr,
                       compute_dtype=compute_dtype, log=log,
                       tag=f"teacher {teacher_size}^2/d{teacher_depth}")
                if teacher_ckpt:
                    save_pytree(teacher_ckpt,
                                {"state_dict": teacher.state_dict(),
                                 "meta": meta})
                    log(f"[certify] teacher saved to {teacher_ckpt}")
        t_logits = _eval_logits(teacher, vb)
    labels = vb["labels"].cpu().reshape(-1)
    teacher_auc = float(auc(torch.as_tensor(t_logits), labels))
    log(f"[certify] teacher val AUC {teacher_auc:.4f}")

    # -- cross-geometry distillation ------------------------------------
    t_cfg_eff = teacher.cfg
    s_cfg = ISTVTConfig(num_frames=seq_len, image_size=student_size,
                        feat_hw=infer_feat_hw(student_size),
                        depth=student_depth)
    with _leg(legs, "hook", dev):
        hook = D.augment_with_teacher(
            D.make_teacher_fn(teacher,
                              cam_cfg=t_cfg_eff if attn_weight else None,
                              cam_chunk=cam_chunk),
            student_size=student_size, student_feat_hw=s_cfg.feat_hw)
        distill_batches = [
            dict(b, cam_s_mask=torch.ones(batch_size, device=dev))
            for b in batches
        ] + _temporal_aug_batches(temporal_aug, batch_size, seq_len,
                                  teacher_size, ps, seed, dev)
        small = [hook(b) for b in distill_batches]  # static teacher signals
    with _leg(legs, "student", dev):
        student = model_selection("istvt", num_out_classes=1, cfg=s_cfg,
                                  device=dev, seed=seed + 7)
        _train(student, small, epochs=distill_epochs, lr=lr,
               loss_fn=L.make_distill_loss(alpha=alpha,
                                           temperature=temperature,
                                           attn_weight=attn_weight),
               compute_dtype=compute_dtype, log=log,
               tag=f"student {student_size}^2/d{student_depth}")
        vb_s = {"clips": D.resize_bilinear(vb["clips"], student_size),
                "labels": vb["labels"]}
        s_logits = _eval_logits(student, vb_s)
    student_auc = float(auc(torch.as_tensor(s_logits), labels))
    fidelity = spearman(s_logits, t_logits)
    log(f"[certify] student val AUC {student_auc:.4f} "
        f"(teacher {teacher_auc:.4f}), teacher-logit spearman "
        f"{fidelity:.4f}")

    result = {
        "geometry": {"teacher": f"{teacher_size}^2/d{teacher_depth}",
                     "student": f"{student_size}^2/d{student_depth}",
                     "seq_len": seq_len, "patch": ps},
        "budget": {"train_clips": train_clips, "val_clips": val_clips,
                   "teacher_epochs": teacher_epochs,
                   "distill_epochs": distill_epochs,
                   "steps_per_epoch": len(batches),
                   "train_amp_range": train_amp_range,
                   "attn_weight": attn_weight},
        "teacher_auc": teacher_auc,
        "student_auc": student_auc,
        "teacher_fidelity_spearman": fidelity,
    }
    criteria = {
        "student_auc": student_auc >= auc_frac * teacher_auc,
        "teacher_fidelity": fidelity >= fidelity_min,
    }

    # -- int8 serving path of the same student --------------------------
    if run_int8:
        with _leg(legs, "int8", dev):
            student_q = copy.deepcopy(student)
            student_q.cfg = ISTVTConfig(
                num_frames=seq_len, image_size=student_size,
                feat_hw=s_cfg.feat_hw, depth=student_depth, use_pallas=True,
                quantize="int8")
            istvt.quantize_params(student_q)
            q_logits = _eval_logits(student_q, vb_s)
            if export_dir:
                art_delta, batches_ = _export_certified(
                    student_q, export_dir, vb_s["clips"], q_logits,
                    seq_len=seq_len, student_size=student_size,
                    batch_size=batch_size, geometry=result["geometry"],
                    device=dev)
                log(f"[certify] exported artifact {export_dir} "
                    f"({batches_}): max |logit delta| vs certified int8 "
                    f"logits {art_delta:.3e}")
            del student_q
        int8_auc = float(auc(torch.as_tensor(q_logits), labels))
        int8_delta = float(np.max(np.abs(q_logits - s_logits)))
        int8_sp = spearman(q_logits, s_logits)
        log(f"[certify] int8 val AUC {int8_auc:.4f}, max |delta| "
            f"{int8_delta:.4f}, float-rank spearman {int8_sp:.4f}")
        result.update(int8_auc=int8_auc, int8_max_logit_delta=int8_delta,
                      int8_spearman_vs_float=int8_sp)
        criteria.update(
            int8_auc=int8_auc >= auc_frac * teacher_auc,
            int8_delta=int8_delta <= int8_delta_max,
            int8_rank_fidelity=int8_sp >= int8_spearman_min)
        if export_dir:
            result.update(export_dir=export_dir,
                          artifact_max_logit_delta=art_delta)
            criteria.update(artifact_matches=art_delta <= 1e-3)

    # -- LRP localization on the shipped student ------------------------
    if run_lrp:
        with _leg(legs, "lrp", dev):
            _lrp_checks(result, criteria, teacher, student, val_items,
                        seq_len=seq_len, teacher_size=teacher_size,
                        student_size=student_size, ps=ps, scale=scale,
                        lrp_fakes=lrp_fakes, lrp_ratio_min=lrp_ratio_min,
                        lrp_ratio_mean=lrp_ratio_mean,
                        temporal_checks=temporal_checks,
                        cam_chunk=cam_chunk,
                        diag_teacher_lrp=diag_teacher_lrp, log=log, dev=dev)

    result["criteria"] = criteria
    result["pass"] = all(criteria.values())
    result["wall_s"] = round(time.time() - t_start, 1)
    log(f"[certify] PASS={result['pass']} in {result['wall_s']}s "
        f"({sum(criteria.values())}/{len(criteria)} criteria)")
    return result


def _export_certified(student_q, export_dir, clips, q_logits, *, seq_len,
                      student_size, batch_size, geometry, device):
    """Export the EXACT quantized student just scored
    (serve_export.save_artifact, the input cast to its parameters' dtype as
    the eval step casts it), reload it and score the val clips: (max
    |logit delta| vs the certified int8 logits, the manifest's buckets).
    The artifact a deployer ships is the one the criteria certify, not a
    re-derived cousin (JAX train/certify.py:455-470). Its buckets are
    JAX's 1 and batch_size, and the val split's size, which the one
    program serves too: the val clips then run in one forward, as the
    certified logits did. At another batch size the stem's convolutions
    may sum in another order, and an ulp there can flip an int8 code (a
    toy CPU run on one thread: 2.7e-3 at buckets of 4 against one forward
    of 8)."""
    from istvt_tpu_torch import serve_export as SE

    dtype = next(student_q.parameters()).dtype
    man = SE.save_artifact(
        export_dir, student_q,
        input_shape=(seq_len, student_size, student_size, 3),
        batch_sizes=sorted({1, batch_size, len(clips)}),
        input_dtype=None if dtype == torch.float32 else dtype,
        device=device, extra_meta={"certified": True, "geometry": geometry})
    scorer = SE.load_artifact(export_dir, device)
    a_logits = scorer.predict(clips.float())["logits"].reshape(-1)
    return float(np.max(np.abs(a_logits - q_logits))), man["batch_sizes"]


def _lrp_checks(result, criteria, teacher, student, val_items, *, seq_len,
                teacher_size, student_size, ps, scale, lrp_fakes,
                lrp_ratio_min, lrp_ratio_mean, temporal_checks, cam_chunk,
                diag_teacher_lrp, log, dev):
    """The LRP leg of certify_recipe (JAX :472-542): the student's
    spatial ratios on the strongest val fakes and its temporal shares on
    subset-frame fakes, with the teacher's own as diagnostics."""
    fakes = sorted([it for it in val_items if it["labels"] == 1],
                   key=lambda it: -float(it.get("amp", 1.0)))[:lrp_fakes]
    clips_t = torch.as_tensor(np.stack([f["clips"] for f in fakes])).to(dev)
    s_cfg, t_cfg = student.cfg, teacher.cfg

    if diag_teacher_lrp:
        _, t_cam_s, _ = _lrp_eval(teacher, clips_t, chunk=cam_chunk)
        t_ratios = _spatial_ratios(t_cam_s, fakes, 1.0, teacher_size,
                                   t_cfg.feat_hw, ps)
        log(f"[certify] teacher LRP spatial ratios min "
            f"{min(t_ratios):.2f} mean {np.mean(t_ratios):.2f}")
        result.update(teacher_lrp_spatial_ratio_min=min(t_ratios),
                      teacher_lrp_spatial_ratio_mean=float(np.mean(t_ratios)))

    logits, cam_s, _ = _lrp_eval(student,
                                 D.resize_bilinear(clips_t, student_size))
    pos = bool(np.all(logits > 0))
    ratios = _spatial_ratios(cam_s, fakes, scale, student_size,
                             s_cfg.feat_hw, ps)
    log(f"[certify] LRP spatial ratios min {min(ratios):.2f} mean "
        f"{np.mean(ratios):.2f} (fake logits positive: {pos})")
    result.update(lrp_spatial_ratio_min=min(ratios),
                  lrp_spatial_ratio_mean=float(np.mean(ratios)))
    criteria.update(lrp_fake_logits_positive=pos,
                    lrp_spatial_min=min(ratios) >= lrp_ratio_min,
                    lrp_spatial_mean=float(np.mean(ratios))
                    >= lrp_ratio_mean)

    if temporal_checks is None:
        last = seq_len - 1
        temporal_checks = [
            (tuple(range(seq_len // 2, seq_len)), 0.5 + 0.2),
            ((last,), 1 / seq_len + 0.3),
        ]

    def _t_share(cam_t, frames):
        tm = cam_t.sum(axis=-1)
        tm = tm / (tm.sum(axis=-1, keepdims=True) + 1e-9)
        return float(tm[:, list(frames)].sum(axis=-1).mean())

    result["lrp_temporal"] = []
    for frames, floor in temporal_checks:
        sub = torch.as_tensor(_subset_frame_fakes(
            lrp_fakes, seq_len, teacher_size, ps, frames, seed=4242)).to(dev)
        entry = {"frames": list(frames), "floor": floor}
        if diag_teacher_lrp:
            _, _, t_cam_t = _lrp_eval(teacher, sub, chunk=cam_chunk)
            entry["teacher_share"] = _t_share(t_cam_t, frames)
        lg, _, cam_t = _lrp_eval(student, D.resize_bilinear(sub,
                                                            student_size))
        share = _t_share(cam_t, frames)
        pos_t = bool(np.all(lg > 0))
        log(f"[certify] LRP temporal frames {tuple(frames)}: share "
            f"{share:.3f} (uniform {len(frames) / seq_len:.3f}, "
            f"floor {floor}, teacher "
            f"{entry.get('teacher_share', float('nan')):.3f}, "
            f"logits positive: {pos_t})")
        entry.update(share=share, logits_positive=pos_t)
        result["lrp_temporal"].append(entry)
        criteria[f"lrp_temporal_{'_'.join(map(str, frames))}"] = \
            pos_t and share >= floor
