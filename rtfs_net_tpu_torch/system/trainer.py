"""Trainer: the epoch orchestration the reference delegates to
pytorch-lightning (``pl.Trainer.fit``, train.py:135-148); the counterpart
of ``rtfs_net_tpu/system/trainer.py``.

One process drives a ``System`` on one device. Host-side bookkeeping
(schedulers, early stop, checkpoints, TensorBoard scalars) runs between
epochs like the reference's callbacks:

  * grad clip 5.0 (inside the step), AdamW from config
  * ReduceLROnPlateau(factor, patience) on val_loss when ``half_lr``
  * manual staircase when ``divide_lr_by`` is set
  * EarlyStopping(patience=15) when ``early_stop``
  * ModelCheckpoint(top_k=5 on val_loss) + last + resume
  * train_loss/val_loss/lr scalars with the epoch averages
  * SIGTERM/SIGUSR1: a 'preempt' checkpoint at the next step boundary

Each step's loss stays on the device; the host reads the losses only
every ``log_every`` steps and at the epoch's end, so the loop adds no
synchronisation per step.
"""
from __future__ import annotations

import json
import os
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..models import resolve_device
from .checkpoint import CheckpointManager
from .core import System
from .optimizers import get_lr, set_lr
from .schedulers import EarlyStopping, ReduceLROnPlateau, StaircaseLR
from .tb_writer import TensorBoardLogger


class Trainer:
    def __init__(
        self,
        system: System,
        exp_dir: str,
        epochs: int = 200,
        config: Optional[Dict] = None,
        half_lr: bool = True,
        sche_patience: int = 10,
        sche_factor: float = 0.5,
        divide_lr_by: Optional[float] = None,
        early_stop: bool = True,
        early_stop_patience: int = 15,
        save_top_k: int = 5,
        n_devices: Optional[int] = None,
        log_every: int = 50,
        device="cuda",
    ):
        if n_devices is not None and n_devices > 1:
            raise NotImplementedError("data-parallel training is not ported yet")
        self.system = system
        self.exp_dir = exp_dir
        self.epochs = epochs
        self.config = config or {}
        self.device = resolve_device(device)
        os.makedirs(exp_dir, exist_ok=True)

        self.ckpt = CheckpointManager(exp_dir, top_k=save_top_k, config=self.config)
        self.logger = TensorBoardLogger(os.path.join(exp_dir, "tb"))
        self.log_every = log_every

        self.plateau = ReduceLROnPlateau(sche_factor, sche_patience) if half_lr else None
        lr0 = (self.config.get("optim") or {}).get("lr", 1e-3)
        self.staircase = (
            StaircaseLR(lr0, divide_lr_by, sche_patience) if divide_lr_by else None
        )
        self.early = EarlyStopping(early_stop_patience) if early_stop else None
        self.start_epoch = 0
        self._preempted = False
        # per epoch: losses, lr, wall seconds and seconds spent waiting on
        # the loaders (host clock)
        self.history = []

    # ------------------------------------------------------------------
    def _prep_batch(self, batch):
        """(mix, sources, [mouths], key, ...) numpy -> (mix, targets,
        mouths-or-None) on the device; pinned and copied asynchronously
        when the device is a card."""
        arrays = [batch[0], batch[1]]
        if len(batch) > 2 and isinstance(batch[2], np.ndarray):
            arrays.append(batch[2])
        tensors = []
        for a in arrays:
            t = torch.from_numpy(a)
            if self.device.type == "cuda":
                t = t.pin_memory()
            tensors.append(t.to(self.device, non_blocking=True))
        return tensors[0], tensors[1], tensors[2] if len(tensors) > 2 else None

    def _batches(self, loader):
        """``loader``'s batches on the device; the host time spent waiting
        for each one is added to ``self._waited``."""
        it = iter(loader)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            self._waited += time.perf_counter() - t0
            if batch is None:
                return
            yield self._prep_batch(batch)

    def resume(self, checkpoint: Optional[str] = None):
        """Resume the system from 'last' (or a named checkpoint). The state
        is read to the host: loading it moves the parameters' and the
        optimizer's tensors to the parameters' device, and leaves each
        optimizer ``step`` count on the host, where ``torch.optim`` keeps it
        (on the card, reading it would cost a synchronisation per
        parameter and step)."""
        if checkpoint:
            name = os.path.basename(checkpoint)
            name = name[:-3] if name.endswith(".pt") else name
            self.system.load_state_dict(self.ckpt.restore(name, map_location="cpu"))
            meta_path = os.path.join(self.ckpt.ckpt_dir, name + ".meta.json")
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    self.start_epoch = json.load(f).get("epoch", -1) + 1
            return
        try:
            state, last = self.ckpt.restore_last(map_location="cpu")
        except FileNotFoundError:
            return
        self.system.load_state_dict(state)
        self.start_epoch = last.get("epoch", -1) + 1
        sched = last.get("schedulers", {})
        if self.plateau and "plateau" in sched:
            self.plateau.load_state_dict(sched["plateau"])
        if self.early and "early" in sched:
            self.early.load_state_dict(sched["early"])
        print(f"resumed from epoch {self.start_epoch}")

    # ------------------------------------------------------------------
    def _install_preempt_handlers(self):
        """SIGTERM/SIGUSR1 -> finish the current step, checkpoint, stop.

        The handler only sets a flag; the fit loop checkpoints at the next
        step boundary. Returns the previous handlers for restoration.
        """
        previous = {}

        def _flag(signum, frame):
            self._preempted = True
            print(f"signal {signum}: checkpointing and stopping after the "
                  "current step", flush=True)

        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                previous[sig] = signal.signal(sig, _flag)
            except (ValueError, OSError):
                pass  # not the main thread / unsupported platform
        return previous

    def fit(self, train_loader, val_loader, generator: Optional[torch.Generator] = None):
        """Train from ``start_epoch`` to ``epochs``. Dropout masks come from
        ``generator`` (default: one on the device, seeded with 0)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.logger.log_hyperparams(self.config)
        self._preempted = False
        prev_handlers = self._install_preempt_handlers()
        try:
            self._fit_loop(train_loader, val_loader, generator)
        finally:
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)

    def _sched_state(self) -> Dict:
        sched_state = {}
        if self.plateau:
            sched_state["plateau"] = self.plateau.state_dict()
        if self.early:
            sched_state["early"] = self.early.state_dict()
        return sched_state

    def _fit_loop(self, train_loader, val_loader, generator):
        system = self.system
        for epoch in range(self.start_epoch, self.epochs):
            epoch_t0 = time.perf_counter()
            self._waited = 0.0
            train_loader.set_epoch(epoch)
            losses = []
            for batch in self._batches(train_loader):
                loss = system.train_step(batch, generator)["loss"]
                if system.step % self.log_every == 0:
                    self.logger.add_scalar("train_loss_step", float(loss), system.step)
                losses.append(loss)
                if self._preempted:
                    break
            if self._preempted:
                self.ckpt.save_preempt(system.state_dict(), epoch - 1,
                                       extra={"schedulers": self._sched_state()})
                print(f"preempted during epoch {epoch}: saved 'preempt' "
                      f"checkpoint; resume restarts epoch {epoch}", flush=True)
                break
            train_loss = _mean(losses)

            val_losses = []
            for batch in self._batches(val_loader):
                val_losses.append(system.val_step(batch)["val_loss"])
                if self._preempted:
                    break
            if self._preempted:
                # training of this epoch IS complete — checkpoint now
                # (bounded by one val step) rather than after the whole
                # val sweep + epoch save, which could outlast the
                # preemption grace window on a large val set
                self.ckpt.save_preempt(system.state_dict(), epoch,
                                       extra={"schedulers": self._sched_state()})
                print(f"preempted during validation of epoch {epoch}: "
                      f"saved 'preempt' checkpoint; resume starts epoch "
                      f"{epoch + 1}", flush=True)
                break
            val_loss = _mean(val_losses)

            lr = get_lr(system.optimizer)
            self.logger.add_scalar("train_loss", train_loss, epoch)
            self.logger.add_scalar("val_loss", val_loss, epoch)
            self.logger.add_scalar("train_sisnr", -train_loss, epoch)
            self.logger.add_scalar("val_sisnr", -val_loss, epoch)
            self.logger.add_scalar("learning_rate", lr, epoch)

            # schedulers (reference: ReduceLROnPlateau on val_loss OR
            # manual staircase, core.py:203-211)
            new_lr = lr
            if self.staircase is not None:
                new_lr = self.staircase.step(epoch, new_lr)
            elif self.plateau is not None:
                new_lr = self.plateau.step(val_loss, new_lr)
            if new_lr != lr:
                set_lr(system.optimizer, new_lr)
                print(f"  lr -> {new_lr:.2e}")

            self.ckpt.save(system.state_dict(), epoch, val_loss,
                           extra={"schedulers": self._sched_state()})
            wall = time.perf_counter() - epoch_t0
            self.history.append({"epoch": epoch, "train_loss": train_loss,
                                 "val_loss": val_loss, "lr": lr, "wall_s": wall,
                                 "loader_wait_s": self._waited})
            print(f"epoch {epoch}: train_loss={train_loss:.3f} "
                  f"val_loss={val_loss:.3f} lr={lr:.2e} ({wall:.1f}s)")

            if self.early is not None and self.early.step(val_loss):
                print(f"early stopping at epoch {epoch}")
                break
            if self._preempted:
                # arrived during validation: the epoch checkpoint above
                # already captured the completed epoch — just stop.
                print(f"preempted after epoch {epoch}: stopping", flush=True)
                break

        self.logger.finalize()

    # ------------------------------------------------------------------
    def export_best(self, model_name: str, model_args: Dict) -> str:
        """Export the best checkpoint's model as ``best_model.pth``
        (reference train.py:151-160).

        Degrades gracefully when no scored checkpoint exists (e.g. a
        preemption signal arrived before the first epoch completed):
        falls back to the 'last' checkpoint (preempt/crash state), and
        failing that exports the live model — a partial artifact beats
        crashing after the preemption save already succeeded. It never
        reloads freshly initialised weights.
        """
        from ..models import serialization

        try:
            state = self.ckpt.restore(map_location="cpu")["model"]
        except FileNotFoundError:
            try:
                state = self.ckpt.restore_last(map_location="cpu")[0]["model"]
                print("export_best: no scored checkpoint; "
                      "exporting the 'last' (preempt/crash) state", flush=True)
            except FileNotFoundError:
                state = self.system.model.state_dict()
                print("export_best: no checkpoints on disk; "
                      "exporting the in-memory state", flush=True)
        path = os.path.join(self.exp_dir, "best_model.pth")
        serialization.save_model(path, model_name, model_args, state)
        return path


def _mean(losses) -> float:
    """Mean of a list of 0-d device tensors, in float64 on the host: one
    transfer for the whole list."""
    if not losses:
        return float("nan")
    return float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))
