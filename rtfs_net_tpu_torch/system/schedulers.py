"""Host-side epoch schedulers (``rtfs_net_tpu/system/schedulers.py``, copied;
reference semantics):

* ReduceLROnPlateau on val_loss, factor 0.5, patience from config
  (train.py:103 wiring, ``sche:`` block of every config).
* Manual staircase: lr = lr0 / divide_lr_by**(epoch // patience) when
  ``training.divide_lr_by`` is set (reference core.py:203-211).
* EarlyStopping(monitor=val_loss, patience=15) (train.py:129).

These run between epochs on the host; the trainer writes the new lr into
every parameter group of the ``torch.optim`` optimizer (``set_lr``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics (mode='min',
    threshold 1e-4 rel)."""

    factor: float = 0.5
    patience: int = 10
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = math.inf
    num_bad_epochs: int = 0

    def step(self, metric: float, lr: float) -> float:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            return max(lr * self.factor, self.min_lr)
        return lr

    def state_dict(self):
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, d):
        self.best = d["best"]
        self.num_bad_epochs = d["num_bad_epochs"]


@dataclass
class StaircaseLR:
    """lr0 / divide_by**(epoch // every) when epoch % every == 0, epoch>0."""

    lr0: float
    divide_by: float
    every: int

    def step(self, epoch: int, lr: float) -> float:
        if self.every > 0 and self.divide_by is not None:
            if epoch != 0 and epoch % self.every == 0:
                return self.lr0 / (self.divide_by ** (epoch // self.every))
        return lr


@dataclass
class EarlyStopping:
    """monitor=min val_loss, stop after ``patience`` epochs without
    improvement."""

    patience: int = 15
    min_delta: float = 0.0
    best: float = math.inf
    wait: int = 0
    stopped: bool = False

    def step(self, metric: float) -> bool:
        if metric < self.best - self.min_delta:
            self.best = metric
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped = True
        return self.stopped

    def state_dict(self):
        return {"best": self.best, "wait": self.wait, "stopped": self.stopped}

    def load_state_dict(self, d):
        self.best, self.wait, self.stopped = d["best"], d["wait"], d["stopped"]
