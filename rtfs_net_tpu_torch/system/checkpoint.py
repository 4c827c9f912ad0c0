"""Checkpointing (``rtfs_net_tpu/system/checkpoint.py``; reference semantics:
Lightning ``ModelCheckpoint(monitor=val_loss, save_top_k=5, save_last=True)``
+ ``best_k_models.json`` score ledger + full training-config embed —
``train.py:118-126,151-153``, ``core.py:178-181``).

A checkpoint is one ``torch.save`` of the training state
(``System.state_dict()``: tensors and plain containers only, so
``torch.load(..., weights_only=True)`` restores it) at
``checkpoints/<name>.pt``. The host-side bookkeeping (top-k pruning, the
score ledger, ``<name>.meta.json`` with the epoch, score, config and
scheduler states, and the ``last.json`` marker) is JSON beside it, with
the same names and contents as the JAX package's.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch


class CheckpointManager:
    def __init__(self, exp_dir: str, top_k: int = 5, monitor: str = "val_loss",
                 config: Optional[Dict] = None):
        self.exp_dir = os.path.abspath(exp_dir)
        self.ckpt_dir = os.path.join(self.exp_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.top_k = top_k
        self.monitor = monitor
        self.config = config or {}
        self.best_k: Dict[str, float] = {}
        self._ledger_path = os.path.join(self.exp_dir, "best_k_models.json")
        if os.path.exists(self._ledger_path):
            with open(self._ledger_path) as f:
                self.best_k = json.load(f)

    # ------------------------------------------------------------------
    def _path(self, name: str) -> str:
        return os.path.join(self.ckpt_dir, name)

    def _write(self, name: str, state: Dict, meta: Dict):
        """The payload goes to a temporary file first and is renamed into
        place, so a save cut short (a preemption's grace window running
        out) never leaves a truncated checkpoint under the name."""
        path = self._path(name) + ".pt"
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        with open(self._path(name) + ".meta.json", "w") as f:
            json.dump(meta, f, indent=2, default=str)

    def _remove(self, name: str):
        for suffix in (".pt", ".meta.json"):
            try:
                os.remove(self._path(name) + suffix)
            except OSError:
                pass

    def save(self, state: Dict, epoch: int, score: float, extra: Optional[Dict] = None):
        """Save an epoch checkpoint; keep top-k by monitor + 'last'."""
        name = f"epoch{epoch}"
        self._write(name, state, {"epoch": epoch, self.monitor: score,
                                  "training_config": self.config, **(extra or {})})

        self.best_k[name] = float(score)
        # prune beyond top_k (min is best: val_loss)
        while len(self.best_k) > self.top_k:
            worst = max(self.best_k, key=self.best_k.get)
            self.best_k.pop(worst)
            if worst == name:
                break
            self._remove(worst)
        with open(self._ledger_path, "w") as f:
            json.dump(self.best_k, f, indent=2)

        with open(self._path("last.json"), "w") as f:
            json.dump({"name": name, "epoch": epoch, **(extra or {})}, f, default=str)

    def save_preempt(self, state: Dict, completed_epoch: int, extra: Optional[Dict] = None):
        """Preemption save: mid-epoch state, outside the top-k ledger.

        Points ``last.json`` at it with ``epoch=completed_epoch`` so
        :meth:`restore_last` resumes by restarting the interrupted epoch
        from the saved (mid-epoch) parameters — the same
        epoch-granularity contract as crash-resume, but without losing
        the partial epoch's optimization progress.
        """
        self._write("preempt", state, {"epoch": completed_epoch, "preempted": True,
                                       "training_config": self.config, **(extra or {})})
        with open(self._path("last.json"), "w") as f:
            json.dump({"name": "preempt", "epoch": completed_epoch,
                       "preempted": True, **(extra or {})}, f, default=str)

    # ------------------------------------------------------------------
    def best_name(self) -> Optional[str]:
        if not self.best_k:
            return None
        return min(self.best_k, key=self.best_k.get)

    def restore(self, name: Optional[str] = None, map_location=None) -> Dict:
        """The saved training state (by name, or the best one), its tensors
        on ``map_location``."""
        name = name or self.best_name()
        if name is None:
            raise FileNotFoundError("no checkpoints saved")
        return torch.load(self._path(name) + ".pt", map_location=map_location,
                          weights_only=True)

    def restore_last(self, map_location=None):
        """-> (state, the ``last.json`` record)."""
        last_path = self._path("last.json")
        if not os.path.exists(last_path):
            raise FileNotFoundError("no 'last' checkpoint")
        with open(last_path) as f:
            last = json.load(f)
        return self.restore(last["name"], map_location), last
