"""SDR-family losses (reference: ``src/losses/matrix.py``).

A copy of ``rtfs_net_tpu/losses/sdr.py`` in PyTorch: pure functions over
(B, n_src, T) tensors, differentiable. EPS and the zero-mean/log
semantics match the reference exactly (train loss = pairwise neg-SNR,
val/test = pairwise neg-SI-SDR).
"""
from __future__ import annotations

import functools

import torch

EPS = 1e-8


def pairwise_neg_sdr(ests, targets, sdr_type: str = "sisdr",
                     zero_mean: bool = True, take_log: bool = True):
    """(B, n_src, T) x (B, n_src, T) -> (B, est_src, target_src) loss matrix."""
    assert ests.dim() == 3 and ests.shape == targets.shape
    if zero_mean:
        targets = targets - targets.mean(dim=2, keepdim=True)
        ests = ests - ests.mean(dim=2, keepdim=True)
    s_target = targets[:, None, :, :]  # (B, 1, n_src, T)
    s_est = ests[:, :, None, :]  # (B, n_src, 1, T)
    if sdr_type in ("sisdr", "sdsdr"):
        dot = torch.sum(s_est * s_target, dim=3, keepdim=True)
        energy = torch.sum(s_target ** 2, dim=3, keepdim=True) + EPS
        proj = dot * s_target / energy
    else:
        B, n_src, T = ests.shape
        proj = s_target.expand(B, n_src, n_src, T)
    if sdr_type in ("sdsdr", "snr"):
        e_noise = s_est - s_target
    else:
        e_noise = s_est - proj
    ratio = torch.sum(proj ** 2, dim=3) / (torch.sum(e_noise ** 2, dim=3) + EPS)
    if take_log:
        ratio = 10 * torch.log10(ratio + EPS)
    return -ratio


def singlesrc_neg_sdr(ests, targets, sdr_type: str = "sisdr",
                      zero_mean: bool = True, take_log: bool = True):
    """(B, T) x (B, T) -> (B,) losses."""
    assert ests.dim() == 2 and ests.shape == targets.shape
    if zero_mean:
        targets = targets - targets.mean(dim=1, keepdim=True)
        ests = ests - ests.mean(dim=1, keepdim=True)
    if sdr_type in ("sisdr", "sdsdr"):
        dot = torch.sum(ests * targets, dim=1, keepdim=True)
        energy = torch.sum(targets ** 2, dim=1, keepdim=True) + EPS
        scaled = dot * targets / energy
    else:
        scaled = targets
    e_noise = ests - targets if sdr_type in ("sdsdr", "snr") else ests - scaled
    ratio = torch.sum(scaled ** 2, dim=1) / (torch.sum(e_noise ** 2, dim=1) + EPS)
    if take_log:
        ratio = 10 * torch.log10(ratio + EPS)
    return -ratio


def multisrc_neg_sdr(ests, targets, sdr_type: str = "sisdr",
                     zero_mean: bool = True, take_log: bool = True):
    """(B, n_src, T) -> (B,) per-batch mean over aligned sources."""
    assert ests.dim() == 3 and ests.shape == targets.shape
    if zero_mean:
        targets = targets - targets.mean(dim=2, keepdim=True)
        ests = ests - ests.mean(dim=2, keepdim=True)
    if sdr_type in ("sisdr", "sdsdr"):
        dot = torch.sum(ests * targets, dim=2, keepdim=True)
        energy = torch.sum(targets ** 2, dim=2, keepdim=True) + EPS
        scaled = dot * targets / energy
    else:
        scaled = targets
    e_noise = ests - targets if sdr_type in ("sdsdr", "snr") else ests - scaled
    ratio = torch.sum(scaled ** 2, dim=2) / (torch.sum(e_noise ** 2, dim=2) + EPS)
    if take_log:
        ratio = 10 * torch.log10(ratio + EPS)
    return -ratio.mean(dim=-1)


# aliases mirroring the reference's module-level loss instances
pairwise_neg_sisdr = functools.partial(pairwise_neg_sdr, sdr_type="sisdr")
pairwise_neg_sdsdr = functools.partial(pairwise_neg_sdr, sdr_type="sdsdr")
pairwise_neg_snr = functools.partial(pairwise_neg_sdr, sdr_type="snr")
singlesrc_neg_sisdr = functools.partial(singlesrc_neg_sdr, sdr_type="sisdr")
singlesrc_neg_sdsdr = functools.partial(singlesrc_neg_sdr, sdr_type="sdsdr")
singlesrc_neg_snr = functools.partial(singlesrc_neg_sdr, sdr_type="snr")
multisrc_neg_sisdr = functools.partial(multisrc_neg_sdr, sdr_type="sisdr")
multisrc_neg_sdsdr = functools.partial(multisrc_neg_sdr, sdr_type="sdsdr")
multisrc_neg_snr = functools.partial(multisrc_neg_sdr, sdr_type="snr")
