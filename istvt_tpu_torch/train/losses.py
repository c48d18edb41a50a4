"""The ISTVT criterion and the distillation losses (counterpart of
istvt_tpu/train/losses.py).

Ported: `bce_with_logits`, and the distillation losses that
train/distill.py and train/certify.py train with (`distillation_bce`,
`attention_transfer_ce`, `make_distill_loss`; JAX :37-145). Every loss is
computed in f32, from logits and attention maps cast to f32, also under
bf16 compute. The rest of the JAX loss library serves other models and
training modes (ROADMAP.md queue 1, 'Training').
"""
from __future__ import annotations

import torch


def bce_with_logits(logits, labels):
    """nn.BCEWithLogitsLoss (mean), in f32, in the JAX package's stable
    form max(x, 0) - x y + log1p(exp(-|x|)) (train/losses.py:26-34)."""
    x = logits.reshape(-1).float()
    y = labels.reshape(-1).float()
    per = torch.clamp_min(x, 0) - x * y + torch.log1p(torch.exp(-x.abs()))
    return per.mean()


def distillation_bce(logits, teacher_logits, labels, alpha: float = 0.5,
                     temperature: float = 2.0):
    """Hinton distillation on the single-logit BCE head (JAX :37-61):

        alpha * BCE(z, labels) + (1 - alpha) * T^2 * BCE(z / T, sigmoid(t / T))

    whose soft term's gradient in z is T (sigmoid(z/T) - sigmoid(t/T)):
    zero where the student matches the teacher."""
    z = logits.reshape(-1).float()
    t = teacher_logits.reshape(-1).float()
    T = float(temperature)
    soft_target = torch.sigmoid(t / T)
    zs = z / T
    soft = (torch.clamp_min(zs, 0) - zs * soft_target
            + torch.log1p(torch.exp(-zs.abs()))).mean()
    return alpha * bce_with_logits(z, labels) + (1.0 - alpha) * (T * T) * soft


def _masked_ce(pred, target, mask):
    """Cross-entropy of per-frame distributions (B, T, n), pred
    renormalised, averaged over frames and the mask's rows; 0 when the
    mask is empty."""
    pred = pred / (pred.sum(dim=-1, keepdim=True) + 1e-9)
    ce = -(target * torch.log(pred + 1e-9)).sum(dim=-1)         # (B, T)
    return (ce.mean(dim=-1) * mask).sum() / mask.sum().clamp_min(1.0)


def attention_transfer_ce(attns, cam_s_target, cam_t_target, labels,
                          cam_s_mask=None):
    """(spatial_ce, temporal_ce) between the teacher's LRP saliency and
    the student's layer- and head-averaged CLS-row attention, over the
    fakes (label 1) only (JAX :64-117).

    attns: the model's return_attn maps, {'s': [L x (B, H, T+1, S, S)],
    't': [L x (B, H, S, T+1, T+1)]}. The spatial prediction is the
    spatial-CLS row over the patch tokens of the real frames, (B, T, hw),
    against cam_s_target (B, T, hw); the temporal one the temporal-CLS row
    over the frames at the patch locations, averaged to (B, T), against
    cam_t_target (B, T). cam_s_mask (B,) leaves clips out of the spatial
    term (certify's subset-frame fakes). Either term is 0 when its target
    is None or its mask is empty."""
    m = (labels.reshape(-1) > 0).float()
    dev = m.device
    s_ce = torch.zeros((), device=dev)
    if cam_s_target is not None:
        m_s = m if cam_s_mask is None else m * cam_s_mask.reshape(-1).float()
        per = [a[:, :, 1:, 0, 1:].float().mean(dim=1) for a in attns["s"]]
        s_ce = _masked_ce(sum(per) / len(per), cam_s_target.float(), m_s)
    t_ce = torch.zeros((), device=dev)
    if cam_t_target is not None:
        per = [a[:, :, 1:, 0, 1:].float().mean(dim=(1, 2))
               for a in attns["t"]]
        t_ce = _masked_ce((sum(per) / len(per))[:, None, :],
                          cam_t_target.float()[:, None, :], m)
    return s_ce, t_ce


def make_distill_loss(alpha: float = 0.5, temperature: float = 2.0,
                      attn_weight: float = 0.0):
    """loss_fn(logits, batch, attns=None) for train/step.make_train_step
    (JAX :120-145): distillation_bce against batch['teacher_logits'],
    plus, with attn_weight > 0 and maps given, attn_weight * (spatial +
    temporal) attention_transfer_ce against batch['teacher_cam_s'] /
    ['teacher_cam_t'] (train/distill.augment_with_teacher adds them).
    `loss_fn.needs_attn` (attn_weight > 0) has the step run its forward
    with return_attn=True."""
    def loss_fn(logits, batch, attns=None):
        loss = distillation_bce(logits, batch["teacher_logits"],
                                batch["labels"], alpha, temperature)
        if attn_weight and attns is not None:
            s_ce, t_ce = attention_transfer_ce(
                attns, batch.get("teacher_cam_s"),
                batch.get("teacher_cam_t"), batch["labels"],
                cam_s_mask=batch.get("cam_s_mask"))
            loss = loss + attn_weight * (s_ce + t_ce)
        return loss
    loss_fn.needs_attn = attn_weight > 0
    return loss_fn
