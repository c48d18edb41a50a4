"""The training loop: epochs + eval + checkpointing (counterpart of
istvt_tpu/train/trainer.py).

Trainer.fit runs the train step over a ClipLoader's batches, fed to the
model's device by data/loader.device_feed (on the card: pinned copies on
a side stream, one batch ahead), for num_epochs, logs
the running loss and accuracy, and evaluates after each epoch. With a
checkpoint_dir it saves the whole train state after each epoch on a
background thread (core/checkpoint.py), with the epoch's metric (val
accuracy, else train accuracy), and logs metrics.jsonl
(train/logging.py); `restore` resumes the latest state. A run resumes at
its step's place in the epoch order (epoch step // steps_per_epoch, that
epoch's later batches), with the dropout generator's state, so a resumed
run takes the steps an uninterrupted one would have. SIGTERM or SIGINT
during fit saves the whole state at the next step boundary and exits
with 128 + signum. recal_bn_batches > 0 recalibrates the BatchNorm
running statistics after the last epoch (train/step.recalibrate_bn).
loss_fn replaces the step's BCE (train/step.make_train_step; distillation
passes train/losses.make_distill_loss's), and batch_hook transforms every
train batch after the device feed and before the step, the recalibration
batches too, so that calibration sees what the step saw (distillation
passes train/distill.augment_with_teacher's hook). TrainConfig.debug_nans
runs fit (its steps, evaluations and recalibration) inside
utils/debug.debug_nans, JAX's jax_debug_nans: an operator that makes a
NaN raises FloatingPointError naming it; without the flag no check is
entered.

Not ported (raises, naming ROADMAP.md queue 1 'Parallelism'): a device
mesh; a step hook is not a parameter yet.
"""
from __future__ import annotations

import contextlib
import signal
import time
from typing import Callable, Dict, Optional

import torch

from istvt_tpu_torch.core.checkpoint import CheckpointManager
from istvt_tpu_torch.core.config import DataConfig, TrainConfig
from istvt_tpu_torch.data.loader import device_feed
from istvt_tpu_torch.train import metrics as M
from istvt_tpu_torch.train import step as S
from istvt_tpu_torch.train.logging import MetricsLogger
from istvt_tpu_torch.train.schedule import (cosine_schedule,
                                            reference_epoch_schedule)
from istvt_tpu_torch.utils.debug import debug_nans

_ROADMAP = "ROADMAP.md queue 1"


def evaluate(model, loader, compute_acer: bool = False,
             num_fake_types: int = 5) -> Dict[str, float]:
    """Eval pass over the loader's batches, fed to the model's device by
    data/loader.device_feed: accuracy, AUC (added as in the JAX package),
    APCER / BPCER / ACER with compute_acer, and `acc_type_{i}` for each
    manipulation type present when the batches carry 'fake_types'
    (reference train_CNN.py:837-984)."""
    eval_fn = S.make_eval_step()
    logits, labels, ftypes = [], [], []
    dev = next(model.parameters()).device
    with contextlib.closing(device_feed(loader, dev)) as feed:
        for batch in feed:
            out = eval_fn(model, batch)
            logits.append(out["logits"].cpu())
            labels.append(out["labels"].cpu())
            if "fake_types" in batch:
                ftypes.append(torch.as_tensor(batch["fake_types"]).cpu()
                              .reshape(-1))
    logits, labels = torch.cat(logits), torch.cat(labels)
    preds = (logits > 0).to(torch.int64)
    result = {"accuracy": float((preds == labels).float().mean()),
              "auc": float(M.auc(logits, labels)), "n": int(labels.numel())}
    if compute_acer:
        c = M.confusion_counts(logits, labels)
        result.update({k: float(v) for k, v in M.acer(c).items()})
    if ftypes:
        acc_t, cnt = M.per_type_accuracy(logits, labels, torch.cat(ftypes),
                                         num_types=num_fake_types)
        for i in range(num_fake_types):
            if float(cnt[i]) > 0:
                result[f"acc_type_{i}"] = float(acc_t[i])
    return result


class Trainer:
    """Epoch-driven trainer on one device."""

    def __init__(self, model, tc: TrainConfig, dc: DataConfig,
                 steps_per_epoch: Optional[int] = None,
                 use_reference_schedule: bool = False,
                 log_fn: Callable[[str], None] = print,
                 grad_accum: int = 1, mesh=None, recal_bn_batches: int = 0,
                 loss_fn: Optional[Callable] = None,
                 batch_hook: Optional[Callable[[Dict], Dict]] = None):
        if mesh is not None:
            raise NotImplementedError(f"a device mesh is not ported yet "
                                      f"({_ROADMAP}, 'Parallelism')")
        self.model, self.tc, self.dc = model, tc, dc
        self.log = log_fn
        if tc.debug_nans:
            self.log("debug_nans: enabled")
        self.recal_bn_batches = recal_bn_batches
        self.batch_hook = batch_hook
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
        # the dropout masks' source, as JAX's PRNGKey(seed + 1); its state
        # is saved and restored with the train state
        self.dev = next(model.parameters()).device
        self.rng = torch.Generator(device=self.dev).manual_seed(tc.seed + 1)
        self.step_fn = S.make_train_step(compute_dtype=compute_dtype,
                                         grad_accum=grad_accum, rng=self.rng,
                                         loss_fn=loss_fn)
        self.ckpt = CheckpointManager(tc.checkpoint_dir, async_save=True) \
            if tc.checkpoint_dir else None
        self.metrics = MetricsLogger(tc.checkpoint_dir) \
            if tc.checkpoint_dir else None
        self.best_metric = -float("inf")

    def init_state(self) -> S.TrainState:
        return S.create_train_state(self.model, self.optimizer)

    def state_dict(self, ts: S.TrainState) -> Dict:
        """What a checkpoint holds: train_state_dict(ts) and the dropout
        generator's state."""
        return {**S.train_state_dict(ts), "rng": self.rng.get_state()}

    def restore(self, ts: S.TrainState) -> S.TrainState:
        """ts with the latest checkpoint loaded into it (onto the model's
        device), or ts as it is if there is none."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return ts
        step = self.ckpt.latest_step()
        dev = next(ts.model.parameters()).device
        sd = self.ckpt.restore(step, map_location=dev)
        S.load_train_state(ts, sd)
        if "rng" in sd:
            self.rng.set_state(sd["rng"].cpu())
        self.log(f"resumed from step {step}")
        return ts

    def _hooked(self, batch: Dict) -> Dict:
        return batch if self.batch_hook is None else self.batch_hook(batch)

    def _snapshot_and_exit(self, ts: S.TrainState, signum: int):
        """Save the whole state at this step boundary (after any async
        save has been written) and exit with 128 + signum."""
        if self.ckpt is not None:
            self.log(f"signal {signum}: checkpointing step {ts.step} "
                     f"before exit")
            self.ckpt.wait()
            if self.ckpt.latest_step() != ts.step:
                self.ckpt.save(ts.step, self.state_dict(ts), wait=True)
        raise SystemExit(128 + signum)

    def fit(self, train_loader, val_loader=None,
            ts: Optional[S.TrainState] = None) -> S.TrainState:
        ts = ts if ts is not None else self.restore(self.init_state())
        # preemption: the handler only records the signal; the loop saves
        # at the next step boundary, never from inside a step that is
        # mutating the parameters or the optimizer in place
        pending = []
        prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(
                    sig, lambda signum, frame: pending.append(signum))
            except ValueError:  # not the main thread
                pass
        with debug_nans(self.tc.debug_nans):
            try:
                self._epochs(train_loader, val_loader, ts, pending)
            finally:
                for sig, handler in prev_handlers.items():
                    signal.signal(sig, handler)
            if self.recal_bn_batches > 0:
                self._recalibrate(train_loader, ts)
        if self.ckpt:
            self.ckpt.wait()
        return ts

    def _recalibrate(self, train_loader, ts):
        batches = []
        train_loader.set_epoch(self.tc.num_epochs)  # a fresh order
        with contextlib.closing(device_feed(train_loader, self.dev)) as feed:
            for batch in feed:
                batches.append(self._hooked(batch))
                if len(batches) >= self.recal_bn_batches:
                    break
        S.recalibrate_bn(self.model, batches)
        self.log(f"recalibrated BN stats over {len(batches)} batches")
        if self.ckpt:
            # step + 1 marks the calibration pass, as in JAX
            self.ckpt.save(ts.step + 1, self.state_dict(ts),
                           metric=self.best_metric, wait=True)

    def _epochs(self, train_loader, val_loader, ts, pending):
        spe = max(len(train_loader), 1)
        start_epoch, skip = divmod(ts.step, spe)
        for epoch in range(start_epoch, self.tc.num_epochs):
            train_loader.set_epoch(epoch)
            t0 = time.time()
            run_loss, run_acc, seen = M.Welford(), M.Welford(), 0
            batches = (train_loader.iter_from(skip)
                       if epoch == start_epoch else iter(train_loader))
            # the feed (and with it the loader's producer) is closed when
            # the loop ends, a snapshot's SystemExit included
            with contextlib.closing(device_feed(batches, self.dev)) as feed:
                for batch in feed:
                    if pending:
                        self._snapshot_and_exit(ts, pending[0])
                    batch = self._hooked(batch)
                    m = self.step_fn(ts, batch)
                    bs = len(batch["labels"])
                    run_loss.update(float(m["loss"]), bs)
                    run_acc.update(float(m["accuracy"]), bs)
                    seen += bs
                    if seen % (self.tc.log_every * bs) < bs:
                        self.log(f"epoch {epoch} seen {seen}: loss "
                                 f"{run_loss.mean:.4f} acc "
                                 f"{run_acc.mean:.4f}")
            if pending:
                self._snapshot_and_exit(ts, pending[0])
            dt = time.time() - t0
            self.log(f"epoch {epoch}: train loss {run_loss.mean:.4f} "
                     f"acc {run_acc.mean:.4f} "
                     f"({seen / max(dt, 1e-9):.1f} clips/s)")
            metric = run_acc.mean
            if self.metrics:
                self.metrics.log(ts.step, {"loss": run_loss.mean,
                                           "accuracy": run_acc.mean,
                                           "clips_per_sec":
                                               seen / max(dt, 1e-9)},
                                 prefix="train/")
            if val_loader is not None:
                ev = evaluate(self.model, val_loader)
                self.log(f"epoch {epoch}: val {ev}")
                metric = ev["accuracy"]
                if self.metrics:
                    self.metrics.log(ts.step, {k: v for k, v in ev.items()
                                               if isinstance(v, float)},
                                     prefix="val/")
            if self.ckpt:
                self.ckpt.save(ts.step, self.state_dict(ts), metric=metric)
            if metric > self.best_metric:
                self.best_metric = metric
