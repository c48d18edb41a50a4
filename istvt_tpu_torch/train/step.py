"""Training and evaluation steps (counterpart of istvt_tpu/train/step.py).

One train step: forward in train mode, the loss (BCE-with-logits, or a
given loss_fn such as train/losses.make_distill_loss's, which reads the
whole batch and, where it needs_attn, the attention maps), backward
through the kernels' backward passes, optimizer update, metrics. With
compute_dtype=torch.bfloat16 the parameters are cast inside the
differentiated function (torch.func.functional_call on the casts), as
JAX's compute_loss casts inside jax.value_and_grad: the forward and
backward run in bf16, and the gradients arrive in f32 on the f32 master
parameters. The optimizers are torch's AdamW and SGD configured as optax's
adamw and sgd (decoupled decay times lr, eps 1e-8, a first momentum buffer
of g), with the lr set from the step-indexed schedule before every update
(optax's count semantics: the first update uses schedule(0)). Dropout
masks come from the generator given to make_train_step (JAX's rng).

recalibrate_bn replaces the BatchNorm running statistics by the fixed
point of their train-mode update on given batches (JAX's recalibrate_bn).
`train_state_dict` / `load_train_state` are a TrainState as the tensors
that core/checkpoint.py saves.

Not ported (raise, naming ROADMAP.md queue 1): a device mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from istvt_tpu_torch.core.config import TrainConfig
from istvt_tpu_torch.models import istvt
from istvt_tpu_torch.train import losses, metrics

_ROADMAP = "ROADMAP.md queue 1"


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """optax.adamw(schedule, weight_decay) or optax.sgd(schedule, momentum)
    as a recipe: `build` makes the torch optimizer over the parameters; the
    train step sets its lr from `schedule` before every update."""

    name: str
    schedule: Callable[[int], float]
    weight_decay: float = 0.01
    momentum: float = 0.9

    def build(self, params) -> torch.optim.Optimizer:
        if self.name == "adamw":
            return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999),
                                     eps=1e-8,
                                     weight_decay=self.weight_decay)
        if self.name == "sgd":
            return torch.optim.SGD(params, lr=0.0, momentum=self.momentum)
        raise ValueError(f"unknown optimizer {self.name}")


def make_optimizer(tc: TrainConfig, schedule) -> Optimizer:
    """AdamW or SGD(+momentum), matching reference train_CNN.py:198-202."""
    if tc.optimizer not in ("adamw", "sgd"):
        raise ValueError(f"unknown optimizer {tc.optimizer}")
    return Optimizer(tc.optimizer, schedule, tc.weight_decay, tc.momentum)


@dataclasses.dataclass
class TrainState:
    """The f32 master parameters and BN running statistics live in `model`
    (JAX's params and model_state); `opt` holds the optimizer state."""

    model: nn.Module
    opt: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0


def create_train_state(model: nn.Module, optimizer: Optimizer) -> TrainState:
    return TrainState(model=model, opt=optimizer.build(model.parameters()),
                      schedule=optimizer.schedule)


def train_state_dict(ts: TrainState) -> Dict:
    """{'model': the model's state_dict (parameters and BN running
    statistics under the port's names), 'opt': the optimizer's
    state_dict, 'step': int}, the tensors still the live ones (JAX's
    TrainState of params, model_state, opt_state and step)."""
    return {"model": ts.model.state_dict(), "opt": ts.opt.state_dict(),
            "step": int(ts.step)}


def load_train_state(ts: TrainState, sd: Dict) -> TrainState:
    """Load train_state_dict's tensors into ts in place (onto the model's
    device) and return it."""
    ts.model.load_state_dict(sd["model"])
    ts.opt.load_state_dict(sd["opt"])
    ts.step = int(sd["step"])
    return ts


def _device(model):
    return next(model.parameters()).device


def _clips(batch, dev):
    x = batch.get("clips", batch.get("images"))
    return torch.as_tensor(x).to(dev)


def _on_device(batch, dev) -> Dict:
    """The batch with every array entry (numpy or tensor) as a tensor on
    dev; other entries as they are."""
    return {k: torch.as_tensor(v).to(dev)
            if isinstance(v, (torch.Tensor, np.ndarray)) else v
            for k, v in batch.items()}


def _microbatch(batch: Dict, b: int, sl: slice) -> Dict:
    """The rows `sl` of every entry with a leading batch axis of b."""
    return {k: v[sl] if isinstance(v, torch.Tensor) and v.dim()
            and v.shape[0] == b else v for k, v in batch.items()}


def make_train_step(compute_dtype: Optional[torch.dtype] = None,
                    grad_accum: int = 1, mesh=None, rng=None,
                    loss_fn: Optional[Callable] = None):
    """Returns step(ts, batch) -> {'loss', 'accuracy', 'grad_norm'} (0-dim
    f32 tensors), updating ts in place.

    batch: {'clips': (B, T, H, W, 3), 'labels': (B,), ...} (numpy or
    tensors). loss_fn(logits, batch) -> loss (default: BCE-with-logits on
    batch['labels']) gets the microbatch's whole dict; a loss_fn with
    `needs_attn` set runs the forward with return_attn=True and is called
    as loss_fn(logits, batch, attns=maps) (JAX step.py:85-110).
    grad_accum=k > 1 splits every batch entry with a leading batch axis
    (the teacher's logits and cams too) into k microbatches run one after
    the other: gradients are averaged into one update, the BN running
    statistics thread through the microbatches in order, and loss and
    accuracy are the microbatch means (JAX's _accumulate).

    rng: the dropout masks' source (JAX's rng), a torch.Generator on the
    model's device or a callable handing out given masks
    (nn/layers.dropout_mask); every call draws from it in a fixed order,
    microbatch by microbatch, layer by layer, each layer's feed-forward
    masks (models/istvt.DSTTr.ff_masks). None: no dropout."""
    if mesh is not None:
        raise NotImplementedError(f"a device mesh is not ported yet "
                                  f"({_ROADMAP}, 'Parallelism')")
    if grad_accum < 1:
        raise ValueError(f"grad_accum={grad_accum}")

    loss_fn = loss_fn or (lambda logits, batch:
                          losses.bce_with_logits(logits, batch["labels"]))
    needs_attn = getattr(loss_fn, "needs_attn", False)

    def compute_loss(model, batch):
        x = batch.get("clips", batch.get("images"))
        kwargs = {"rng": rng, "return_attn": needs_attn}
        if compute_dtype is None:
            out = model(x, **kwargs)
        else:
            cast = {n: p.to(compute_dtype) if p.is_floating_point() else p
                    for n, p in model.named_parameters()}
            out = torch.func.functional_call(model, cast,
                                             (x.to(compute_dtype),), kwargs)
        if needs_attn:
            logits, attns = out
            return loss_fn(logits, batch, attns=attns), logits
        return loss_fn(out, batch), out

    def step(ts: TrainState, batch) -> Dict[str, torch.Tensor]:
        model = ts.model.train()
        dev = _device(model)
        batch = _on_device(batch, dev)
        b = batch.get("clips", batch.get("images")).shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} not divisible by "
                             f"grad_accum={grad_accum}")
        ts.opt.zero_grad(set_to_none=True)
        mb = b // grad_accum
        loss_sum = torch.zeros((), device=dev)
        acc_sum = torch.zeros((), device=dev)
        for i in range(grad_accum):
            part = _microbatch(batch, b, slice(i * mb, (i + 1) * mb))
            loss, logits = compute_loss(model, part)
            loss.backward()
            loss_sum += loss.detach()
            acc_sum += metrics.accuracy(logits.detach(), part["labels"])
        params = list(model.parameters())
        for p in params:
            if p.grad is None:
                # a parameter the forward does not reach (the Xception
                # blocks past the stem) has a zero gradient in JAX, and
                # optax's adamw still decays it
                p.grad = torch.zeros_like(p)
        if grad_accum > 1:
            for p in params:
                p.grad.div_(grad_accum)
        grad_norm = torch.sqrt(sum(p.grad.float().pow(2).sum()
                                   for p in params))
        lr = float(ts.schedule(ts.step))
        for group in ts.opt.param_groups:
            group["lr"] = lr
        ts.opt.step()
        ts.step += 1
        return {"loss": loss_sum / grad_accum,
                "accuracy": acc_sum / grad_accum, "grad_norm": grad_norm}

    return step


_BN_STATS = ("running_mean", "running_var")


@torch.no_grad()
def recalibrate_bn(model: nn.Module, batches) -> Dict[str, torch.Tensor]:
    """Replace the BatchNorm running statistics of `model` by the actual
    activation statistics under its current parameters, averaged over
    `batches` (JAX's recalibrate_bn: short runs leave an O(0.9^steps)
    residual of the init statistics that collapses eval-mode logits).

    In train mode the forward never reads the running statistics, so one
    pass updates each buffer affinely, new = c * old + d. Two probe
    passes per batch through the real train-mode forward, with every
    buffer set to 0 and then to 1, give d and c + d (so the rounding of
    nn/layers.batchnorm_train's update is the one measured); the installed
    value is the fixed point d / (1 - c) where 1 - c > 1e-3, the original
    value where a pass leaves the buffer alone. No dropout runs (no rng),
    and the parameters and any optimizer are untouched. Returns the
    installed statistics by state_dict name; the model comes back in the
    mode it had."""
    was_training = model.training
    dev = _device(model)
    bufs = {n: b for n, b in model.named_buffers()
            if n.rsplit(".", 1)[-1] in _BN_STATS}
    orig = {n: b.clone() for n, b in bufs.items()}
    sums = {n: torch.zeros_like(b) for n, b in bufs.items()}
    count = 0
    model.train()
    try:
        for batch in batches:
            x = _clips(batch, dev).to(next(model.parameters()).dtype)
            probes = []
            for fill in (0.0, 1.0):
                for b in bufs.values():
                    b.fill_(fill)
                model(x)
                probes.append({n: b.clone() for n, b in bufs.items()})
            for n in bufs:
                d, cd = probes[0][n], probes[1][n]
                one_minus_c = 1.0 - (cd - d)
                sums[n] += torch.where(one_minus_c > 1e-3,
                                       d / one_minus_c.clamp_min(1e-3),
                                       orig[n])
            count += 1
    finally:
        for n, b in bufs.items():
            b.copy_(orig[n])
        model.train(was_training)
    if count == 0:
        return {}
    for n, b in bufs.items():
        b.copy_(sums[n] / count)
    return {n: b.clone() for n, b in bufs.items()}


def make_eval_step():
    """Returns eval(model, batch) -> per-batch logits, labels, 'correct'
    and the confusion counts (reference eval loop, threshold at 0). The
    model runs in eval mode in its parameters' dtype, as JAX's eval step
    applies the uncast params; the float path's (in, out) weight copies
    are packed from the current parameters first."""

    @torch.no_grad()
    def step(model, batch):
        model.eval()
        istvt.pack_params(model)
        dev = _device(model)
        logits = model(_clips(batch, dev).to(
            next(model.parameters()).dtype))
        if logits.dim() == 2 and logits.shape[-1] == 2:
            logits = logits[:, 1] - logits[:, 0]
        flat = logits.reshape(-1).float()
        labels = torch.as_tensor(batch["labels"]).to(dev).reshape(-1)
        out = {"logits": flat, "labels": labels,
               "correct": (metrics.binary_predictions(flat)
                           == labels.to(torch.int32)).float()}
        out.update(metrics.confusion_counts(flat, labels))
        return out

    return step
