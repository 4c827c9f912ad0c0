"""Permutation-invariant training wrapper (``rtfs_net_tpu/losses/pit.py``,
reference ``src/losses/pit_wrapper.py``).

For n_src <= 3 every permutation is scored on the device with a one-hot
einsum over the pairwise loss matrix; for n_src > 3 the best permutation
comes from SciPy's ``linear_sum_assignment`` on the host, and the loss is
then gathered on the device, so it stays differentiable.
"""
from __future__ import annotations

from itertools import permutations
from typing import Callable, Optional

import numpy as np
import torch


class PITLossWrapper:
    """Callable: (ests, targets) -> mean best-permutation loss.

    pit_from:
      * ``pw_mtx``  - loss_func returns the (B, est, tgt) pairwise matrix
      * ``pw_pt``   - loss_func maps (B,T),(B,T) -> (B,); matrix built here
      * ``perm_avg``- loss_func maps (B,n,T),(B,n,T) -> (B,); evaluated per
        permutation
    """

    def __init__(self, loss_func: Callable, pit_from: str = "pw_mtx",
                 perm_reduce: Optional[Callable] = None):
        if pit_from not in ("pw_mtx", "pw_pt", "perm_avg"):
            raise ValueError(
                f"Unsupported loss function type {pit_from}: expected one of "
                "[pw_mtx, pw_pt, perm_avg]")
        self.loss_func = loss_func
        self.pit_from = pit_from
        self.perm_reduce = perm_reduce

    def __call__(self, ests, targets, return_ests: bool = False, **kwargs):
        if self.pit_from == "perm_avg":
            min_loss, batch_indices = self.best_perm_from_perm_avg_loss(
                self.loss_func, ests, targets, **kwargs)
        else:
            if self.pit_from == "pw_mtx":
                pw_loss = self.loss_func(ests, targets, **kwargs)
            else:
                pw_loss = self.get_pw_losses(self.loss_func, ests, targets, **kwargs)
            assert pw_loss.dim() == 3, "pairwise loss must be (batch, est, tgt)"
            min_loss, batch_indices = self.find_best_perm(pw_loss)
        mean_loss = min_loss.mean()
        if not return_ests:
            return mean_loss
        return mean_loss, self.reorder_source(ests, batch_indices)

    @staticmethod
    def get_pw_losses(loss_func, ests, targets, **kwargs):
        n_src = targets.shape[1]
        rows = [torch.stack([loss_func(ests[:, i], targets[:, j], **kwargs)
                             for j in range(n_src)], dim=-1) for i in range(n_src)]
        return torch.stack(rows, dim=1)  # (B, est, tgt)

    @staticmethod
    def best_perm_from_perm_avg_loss(loss_func, ests, targets, **kwargs):
        n_src = targets.shape[1]
        perms = torch.tensor(list(permutations(range(n_src))), device=ests.device)
        loss_set = torch.stack([loss_func(ests[:, p], targets, **kwargs) for p in perms],
                               dim=1)
        min_loss, idx = loss_set.min(dim=1)
        return min_loss, perms[idx]

    def find_best_perm(self, pair_wise_losses):
        n_src = pair_wise_losses.shape[-1]
        if self.perm_reduce is not None or n_src <= 3:
            return self.find_best_perm_factorial(pair_wise_losses)
        return self.find_best_perm_hungarian(pair_wise_losses)

    def find_best_perm_factorial(self, pair_wise_losses):
        n_src = pair_wise_losses.shape[-1]
        pwl = pair_wise_losses.transpose(-1, -2)  # (B, tgt, est)
        perms = torch.tensor(list(permutations(range(n_src))), device=pwl.device)
        if self.perm_reduce is None:
            one_hot = torch.zeros((len(perms), n_src, n_src), dtype=pwl.dtype,
                                  device=pwl.device)
            one_hot[torch.arange(len(perms))[:, None], torch.arange(n_src), perms] = 1.0
            loss_set = torch.einsum("bij,pij->bp", pwl, one_hot) / n_src
        else:
            loss_set = self.perm_reduce(
                torch.stack([pwl[:, torch.arange(n_src), p] for p in perms], dim=1))
        min_loss, idx = loss_set.min(dim=1)
        return min_loss, perms[idx]

    def find_best_perm_hungarian(self, pair_wise_losses):
        from scipy import optimize  # host assignment, n_src > 3 only

        pwl = pair_wise_losses.transpose(-1, -2)  # (B, tgt, est)
        host = pwl.detach().float().cpu().numpy()
        batch_indices = torch.from_numpy(np.stack(
            [optimize.linear_sum_assignment(m)[1] for m in host])).to(pwl.device)
        min_loss = torch.gather(pwl, 2, batch_indices[..., None]).mean(dim=(-1, -2))
        return min_loss, batch_indices

    @staticmethod
    def reorder_source(source, batch_indices):
        idx = batch_indices.long().view(*batch_indices.shape, *([1] * (source.dim() - 2)))
        return torch.gather(source, 1, idx.expand(-1, -1, *source.shape[2:]))
