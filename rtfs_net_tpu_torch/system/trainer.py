"""Trainer: the epoch orchestration the reference delegates to
pytorch-lightning (``pl.Trainer.fit``, train.py:135-148); the counterpart
of ``rtfs_net_tpu/system/trainer.py``.

Each process drives a ``System`` on one device; under a process group
(``parallel.initialize``) the ranks of the mesh (``parallel.make_mesh``:
by default every rank, clamped so that they divide the global
``batch_size``) train data-parallel, each on its shard of the global batch
(``parallel.make_parallel_train_step``), and a rank outside the mesh sits
the run out. Host-side bookkeeping (schedulers, early stop, checkpoints,
TensorBoard scalars) runs between epochs like the reference's callbacks,
the writes and prints on rank 0 only:

  * grad clip 5.0 (inside the step), AdamW from config
  * ReduceLROnPlateau(factor, patience) on val_loss when ``half_lr``
  * manual staircase when ``divide_lr_by`` is set
  * EarlyStopping(patience=15) when ``early_stop``
  * ModelCheckpoint(top_k=5 on val_loss) + last + resume
  * train_loss/val_loss/lr scalars with the epoch averages
  * SIGTERM/SIGUSR1: a 'preempt' checkpoint at the next step boundary

Each step's loss stays on the device; the host reads the losses only
every ``log_every`` steps and at the epoch's end, so the loop adds no
synchronisation per step. Under a process group a signal to any rank
stops every rank at the same step boundary (``_Agreement``).
"""
from __future__ import annotations

import json
import os
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models import resolve_device
from ..parallel import make_mesh, make_parallel_train_step, make_parallel_val_step, process_info
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
        batch_size: Optional[int] = None,
        log_every: int = 50,
        device="cuda",
    ):
        self.system = system
        self.exp_dir = exp_dir
        self.epochs = epochs
        self.config = config or {}
        self.device = resolve_device(device)
        os.makedirs(exp_dir, exist_ok=True)

        # the global batch, which the mesh's ranks must divide
        if batch_size is None:
            batch_size = (self.config.get("training") or {}).get("batch_size")
        self.mesh = make_mesh(n_devices, batch_size=batch_size)
        self.train_step = make_parallel_train_step(system, self.mesh)
        self.val_step = make_parallel_val_step(system, self.mesh)
        self.rank0 = process_info()[0] == 0

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
            yield upload_batch(batch, self.device)

    def _print(self, msg: str):
        if self.rank0:
            print(msg, flush=True)

    def resume(self, checkpoint: Optional[str] = None):
        """Resume the system from 'last' (or a named checkpoint); every rank
        reads the same file. The state
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
        self._print(f"resumed from epoch {self.start_epoch}")

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
                  "current step", flush=True)  # on the rank that got it

        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                previous[sig] = signal.signal(sig, _flag)
            except (ValueError, OSError):
                pass  # not the main thread / unsupported platform
        return previous

    def fit(self, train_loader, val_loader, generator: Optional[torch.Generator] = None):
        """Train from ``start_epoch`` to ``epochs``. Dropout masks come from
        ``generator`` (default: one on the device, seeded with 0; every rank
        must hold the same one). A rank outside the mesh returns at once;
        the mesh's ranks take their loaders' shards of each global batch."""
        if not self.mesh.member:
            return
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if self.rank0:
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
        stop = _Agreement(self.mesh, self.device)
        for epoch in range(self.start_epoch, self.epochs):
            epoch_t0 = time.perf_counter()
            self._waited = 0.0
            train_loader.set_epoch(epoch)
            losses = []
            preempted = False
            for batch in self._batches(train_loader):
                loss = self.train_step(batch, generator)["loss"]
                if self.rank0 and system.step % self.log_every == 0:
                    self.logger.add_scalar("train_loss_step", float(loss), system.step)
                losses.append(loss)
                preempted = stop.lagged(self._preempted)
                if preempted:
                    break
            if preempted:
                if self.rank0:
                    self.ckpt.save_preempt(system.state_dict(), epoch - 1,
                                           extra={"schedulers": self._sched_state()})
                self._print(f"preempted during epoch {epoch}: saved 'preempt' "
                            f"checkpoint; resume restarts epoch {epoch}")
                break
            train_loss = _mean(losses)

            val_losses = []
            for batch in self._batches(val_loader):
                val_losses.append(self.val_step(batch)["val_loss"])
                preempted = stop.lagged(self._preempted)
                if preempted:
                    break
            if preempted:
                # training of this epoch IS complete — checkpoint now
                # (bounded by one val step) rather than after the whole
                # val sweep + epoch save, which could outlast the
                # preemption grace window on a large val set
                if self.rank0:
                    self.ckpt.save_preempt(system.state_dict(), epoch,
                                           extra={"schedulers": self._sched_state()})
                self._print(f"preempted during validation of epoch {epoch}: "
                            f"saved 'preempt' checkpoint; resume starts epoch "
                            f"{epoch + 1}")
                break
            val_loss = _mean(val_losses)

            lr = get_lr(system.optimizer)
            if self.rank0:
                self.logger.add_scalar("train_loss", train_loss, epoch)
                self.logger.add_scalar("val_loss", val_loss, epoch)
                self.logger.add_scalar("train_sisnr", -train_loss, epoch)
                self.logger.add_scalar("val_sisnr", -val_loss, epoch)
                self.logger.add_scalar("learning_rate", lr, epoch)

            # schedulers (reference: ReduceLROnPlateau on val_loss OR
            # manual staircase, core.py:203-211); the val loss is the mesh's
            # mean, so every rank steps them alike
            new_lr = lr
            if self.staircase is not None:
                new_lr = self.staircase.step(epoch, new_lr)
            elif self.plateau is not None:
                new_lr = self.plateau.step(val_loss, new_lr)
            if new_lr != lr:
                set_lr(system.optimizer, new_lr)
                self._print(f"  lr -> {new_lr:.2e}")

            if self.rank0:
                self.ckpt.save(system.state_dict(), epoch, val_loss,
                               extra={"schedulers": self._sched_state()})
            wall = time.perf_counter() - epoch_t0
            self.history.append({"epoch": epoch, "train_loss": train_loss,
                                 "val_loss": val_loss, "lr": lr, "wall_s": wall,
                                 "loader_wait_s": self._waited})
            self._print(f"epoch {epoch}: train_loss={train_loss:.3f} "
                        f"val_loss={val_loss:.3f} lr={lr:.2e} ({wall:.1f}s)")

            if self.early is not None and self.early.step(val_loss):
                self._print(f"early stopping at epoch {epoch}")
                break
            if stop.now(self._preempted):
                # arrived during validation: the epoch checkpoint above
                # already captured the completed epoch — just stop.
                self._print(f"preempted after epoch {epoch}: stopping")
                break

        if self.rank0:
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


class _Agreement:
    """Whether any rank of ``mesh`` has been signalled. Without a process
    group it is this process's flag. With one, ``lagged`` puts this
    process's flag into an all-reduce (max) over the mesh and returns the
    result of the call before, copied to the host behind an event: the host
    waits for the previous step and its collective, never for the step it
    has just queued. ``now`` waits for a fresh result. Every rank makes the
    same calls in the same order, so all read the same values and stop at
    the same step boundary."""

    def __init__(self, mesh, device):
        self.mesh, self.device, self.pending = mesh, device, None

    def _put(self, flag: bool):
        value = torch.full((1,), float(flag), device=self.device)
        dist.all_reduce(value, op=dist.ReduceOp.MAX, group=self.mesh.group)
        if value.device.type != "cuda":
            return value, None
        host = torch.empty(1, pin_memory=True)
        host.copy_(value, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _read(pending) -> bool:
        value, done = pending
        if done is not None:
            done.synchronize()
        return bool(value.item())

    def lagged(self, flag: bool) -> bool:
        if not self.mesh.distributed:
            return flag
        pending, self.pending = self.pending, self._put(flag)
        return pending is not None and self._read(pending)

    def now(self, flag: bool) -> bool:
        if not self.mesh.distributed:
            return flag
        pending, self.pending = self.pending, None
        earlier = pending is not None and self._read(pending)
        return self._read(self._put(flag)) or earlier


def upload_batch(batch, device):
    """(mix, sources, [mouths], key, ...) numpy -> (mix, targets,
    mouths-or-None) on ``device``; pinned and copied asynchronously when
    the device is a card."""
    arrays = [batch[0], batch[1]]
    if len(batch) > 2 and isinstance(batch[2], np.ndarray):
        arrays.append(batch[2])
    tensors = []
    for a in arrays:
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory()
        tensors.append(t.to(device, non_blocking=True))
    return tensors[0], tensors[1], tensors[2] if len(tensors) > 2 else None


def _mean(losses) -> float:
    """Mean of a list of 0-d device tensors, in float64 on the host: one
    transfer for the whole list."""
    if not losses:
        return float("nan")
    return float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))
