"""The training loop: epochs + eval (counterpart of
istvt_tpu/train/trainer.py).

Trainer.fit runs the train step over a ClipLoader for num_epochs, logs
the running loss and accuracy, and evaluates after each epoch. Not ported
(each raises, naming ROADMAP.md queue 1 'Training' or 'Parallelism'):
checkpointing and resume, the SIGTERM/SIGINT checkpoint handler, a device
mesh, the metrics logger, BN recalibration, step and batch hooks.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from istvt_tpu_torch.core.config import DataConfig, TrainConfig
from istvt_tpu_torch.train import metrics as M
from istvt_tpu_torch.train import step as S
from istvt_tpu_torch.train.schedule import (cosine_schedule,
                                            reference_epoch_schedule)

_ROADMAP = "ROADMAP.md queue 1"


def evaluate(model, loader) -> Dict[str, float]:
    """Eval pass: accuracy and AUC over the loader (reference
    train_CNN.py:837-984; AUC added as in the JAX package)."""
    eval_fn = S.make_eval_step()
    logits, labels = [], []
    for batch in loader:
        out = eval_fn(model, batch)
        logits.append(out["logits"].cpu())
        labels.append(out["labels"].cpu())
    logits, labels = torch.cat(logits), torch.cat(labels)
    preds = (logits > 0).to(torch.int64)
    return {"accuracy": float((preds == labels).float().mean()),
            "auc": float(M.auc(logits, labels)), "n": int(labels.numel())}


class Trainer:
    """Epoch-driven trainer on one device."""

    def __init__(self, model, tc: TrainConfig, dc: DataConfig,
                 steps_per_epoch: Optional[int] = None,
                 use_reference_schedule: bool = False,
                 log_fn: Callable[[str], None] = print,
                 grad_accum: int = 1, mesh=None, recal_bn_batches: int = 0):
        if mesh is not None:
            raise NotImplementedError(f"a device mesh is not ported yet "
                                      f"({_ROADMAP}, 'Parallelism')")
        if tc.checkpoint_dir:
            raise NotImplementedError(
                f"checkpointing (checkpoint_dir={tc.checkpoint_dir!r}) and "
                f"its metrics logger are not ported yet ({_ROADMAP}, "
                f"'Training'); pass checkpoint_dir=''")
        if recal_bn_batches:
            S.recalibrate_bn()
        if tc.debug_nans:
            raise NotImplementedError(f"debug_nans is not ported yet "
                                      f"({_ROADMAP}, 'Tooling')")
        self.model, self.tc, self.dc = model, tc, dc
        self.log = log_fn
        spe = steps_per_epoch or 1000
        if use_reference_schedule:
            sched = reference_epoch_schedule(tc.base_lr, tc.warmup_epochs,
                                             spe)
        else:
            sched = cosine_schedule(tc.base_lr, spe * tc.num_epochs,
                                    warmup_steps=spe * min(tc.warmup_epochs,
                                                           1))
        self.optimizer = S.make_optimizer(tc, sched)
        compute_dtype = torch.bfloat16 if tc.compute_dtype == "bfloat16" \
            else None
        self.step_fn = S.make_train_step(compute_dtype=compute_dtype,
                                         grad_accum=grad_accum)

    def init_state(self) -> S.TrainState:
        return S.create_train_state(self.model, self.optimizer)

    def fit(self, train_loader, val_loader=None) -> S.TrainState:
        ts = self.init_state()
        for epoch in range(self.tc.num_epochs):
            train_loader.set_epoch(epoch)
            t0 = time.time()
            run_loss, run_acc, seen = M.Welford(), M.Welford(), 0
            for batch in train_loader:
                m = self.step_fn(ts, batch)
                bs = len(batch["labels"])
                run_loss.update(float(m["loss"]), bs)
                run_acc.update(float(m["accuracy"]), bs)
                seen += bs
                if seen % (self.tc.log_every * bs) < bs:
                    self.log(f"epoch {epoch} seen {seen}: loss "
                             f"{run_loss.mean:.4f} acc {run_acc.mean:.4f}")
            dt = time.time() - t0
            self.log(f"epoch {epoch}: train loss {run_loss.mean:.4f} "
                     f"acc {run_acc.mean:.4f} "
                     f"({seen / max(dt, 1e-9):.1f} clips/s)")
            if val_loader is not None:
                ev = evaluate(self.model, val_loader)
                self.log(f"epoch {epoch}: val {ev}")
        return ts
