"""The reference training step: the train loss (permutation-invariant
negative SNR, which for one target is the negative SNR itself), the
gradients' global-norm clip and decoupled-weight-decay Adam (AdamW), each
written out plainly."""
from __future__ import annotations

from typing import Dict, List

import torch

from . import precision

EPS = 1e-8


def neg_snr(est: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of -10·log10(|t|² / |e - t|²), both zero-mean."""
    est = est - est.mean(-1, keepdim=True)
    target = target - target.mean(-1, keepdim=True)
    ratio = target.pow(2).sum(-1) / ((est - target).pow(2).sum(-1) + EPS)
    return (-10 * torch.log10(ratio + EPS)).mean()


def clip_(grads: List[torch.Tensor], max_norm: float) -> None:
    """Scale every gradient by min(1, max_norm / (global norm + 1e-6))."""
    total = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef)


class AdamW:
    """p <- p - lr·wd·p; then Adam's bias-corrected step."""

    def __init__(self, params, lr, weight_decay, betas=(0.9, 0.999), eps=1e-8):
        self.params = list(params)
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, tuple(betas), eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - self.lr * self.wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr / c1 * m / ((v / c2).sqrt() + self.eps))


def forward(module, *args):
    """``module(*args)`` in the current precision: float32 as it is, a lower
    precision through a cast of every parameter and buffer (the casts are
    differentiable, so the float32 parameters get the gradients)."""
    dtype = precision.dtype()
    if dtype == torch.float32:
        return module(*args)
    state = {n: t.to(dtype) if t.is_floating_point() else t
             for n, t in [*module.named_parameters(), *module.named_buffers()]}
    with precision.layer_outputs(module):
        return torch.func.functional_call(module, state, tuple(
            a.to(dtype) if torch.is_tensor(a) and a.is_floating_point() else a for a in args))


def train_steps(model, video, batches, generator, optim: Dict, grad_clip: float):
    """Run the reference's training steps on ``batches`` of (mix, target,
    frames); dropout masks come from ``generator``. Returns each step's
    loss, the clipped gradients of the first step and the parameters'
    change after the last, by parameter name."""
    from .model import use_generator

    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    opt = AdamW(params, optim["lr"], optim.get("weight_decay", 0.0),
                optim.get("betas", (0.9, 0.999)), optim.get("eps", 1e-8))
    losses, first = [], None
    model.train()
    for mix, target, frames in batches:
        with torch.no_grad():
            emb = forward(video, frames)
        with use_generator(generator):
            loss = neg_snr(forward(model, mix, emb).float(), target.float())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.float() for p, g in zip(params, grads)]
        if grad_clip:
            clip_(grads, grad_clip)
        if first is None:
            first = {n: g.clone() for n, g in zip(names, grads)}
        opt.step(grads)
        losses.append(float(loss.detach()))
    change = {n: (p.detach() - s).float() for n, p, s in zip(names, params, start)}
    return losses, first, change
