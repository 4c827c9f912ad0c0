"""Training system core (``rtfs_net_tpu/system/core.py``; reference
``src/system/core.py``, the Lightning ``System``).

``System`` owns the model, a ``torch.optim`` optimizer and the losses and
runs one step at a time on the model's device:

* ``train_step``: forward in training mode (dropout, DropPath, BatchNorm
  batch statistics, checkpointed TDANet blocks) with the activations in
  ``compute_dtype``, the train loss in float32, the gradients (averaged
  over ``accum_steps`` sequential microbatches), a global-norm clip, and
  the optimizer's update;
* ``val_step``: the eval-mode forward and the val loss, without autograd.

Without ``video_model`` the batch's third entry is the precomputed lip
embedding; with one it is the raw mouth-ROI frames, and the embedding is
computed from them without autograd (its BatchNorm statistics frozen)
unless ``train_video_model``, which also joins the video model's
parameters to the optimizer's, the clip and the update. ``online_mix``
replaces an audio-only batch's mixture by an energy-matched remix of its
sources (``online_mixing_collate``). ``step`` counts the optimizer steps;
``state_dict``/``load_state_dict`` carry it with the model's, the
optimizer's and (when it trains) the video model's state.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..ops.dropout import use_generator


class System:
    """loss_func routing matches the reference (``train.py:98-101``):
    ``{"train": PIT neg-SNR, "val": PIT neg-SI-SDR}``."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 loss_func: Dict[str, Callable], grad_clip: Optional[float] = 5.0,
                 compute_dtype: Optional[torch.dtype] = None, accum_steps: int = 1,
                 video_model=None, train_video_model: bool = False,
                 online_mix: bool = False):
        self.model = model
        self.optimizer = optimizer
        self.video_model = video_model
        self.train_video_model = bool(train_video_model and video_model is not None)
        if video_model is not None:
            video_model.requires_grad_(self.train_video_model)
            if self.train_video_model:
                optimizer.add_param_group({"params": list(video_model.parameters())})
        self.loss_func = loss_func
        self.grad_clip = grad_clip
        # mixed precision: parameters, gradients and the loss stay float32;
        # the modules follow the input's dtype
        self.compute_dtype = compute_dtype
        self.accum_steps = int(accum_steps)
        # energy-matched within-batch remix on the audio-only train path
        # (reference core.py:96-98, when there is no video model)
        self.online_mix = bool(online_mix)
        self.step = 0

    def _parameters(self):
        """Every parameter the optimizer updates."""
        params = list(self.model.parameters())
        if self.train_video_model:
            params += list(self.video_model.parameters())
        return params

    def _forward(self, mix, mouths):
        if self.compute_dtype is not None:
            mix = mix.to(self.compute_dtype)
            mouths = None if mouths is None else mouths.to(self.compute_dtype)
        if self.video_model is not None and mouths is not None:
            with torch.set_grad_enabled(self.train_video_model and torch.is_grad_enabled()):
                mouths = self.video_model(mouths)
        return self.model(mix, mouths).float()

    @staticmethod
    def _targets(targets):
        return targets[:, None, :] if targets.dim() == 2 else targets

    def backward(self, batch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Training-mode forward and backward of ``batch = (mix, targets,
        mouths)``: leaves the gradient of the mean train loss in each
        parameter's ``.grad`` (zeros for a parameter the loss does not
        reach, as JAX's grads have) and returns that loss, detached.

        With ``accum_steps`` = A the batch runs as A sequential
        microbatches of B/A and the loss and gradients are their means
        (BatchNorm statistics move once per microbatch). Dropout masks, and
        ``online_mix``'s permutations, are drawn from ``generator``, which
        must lie on the model's device."""
        mix, targets, mouths = batch
        targets = self._targets(targets)
        if self.online_mix and mouths is None:
            # the mixture is REPLACED by a fresh sum of energy-matched,
            # batch-permuted sources
            mix, targets = online_mixing_collate(targets, generator)
        A = self.accum_steps
        B = mix.shape[0]
        if B % A:
            raise ValueError(f"batch {B} not divisible by accum_steps {A}")
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        total = torch.zeros((), device=mix.device)
        with use_generator(generator):
            for m, t, mo in zip(mix.chunk(A), targets.chunk(A),
                                (None,) * A if mouths is None else mouths.chunk(A)):
                loss = self.loss_func["train"](self._forward(m, mo), t)
                (loss / A).backward()
                total += loss.detach()
        for p in self._parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return total / A

    def train_step(self, batch, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns ``{"loss", "grad_norm"}`` with the
        gradients' global norm before the clip. The clip scales every
        gradient by min(1, grad_clip / (norm + 1e-6))."""
        loss = self.backward(batch, generator)
        params = self._parameters()
        if self.grad_clip:
            gnorm = torch.nn.utils.clip_grad_norm_(params, self.grad_clip)
        else:
            gnorm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(p.grad) for p in params]))
        self.optimizer.step()
        self.step += 1
        return {"loss": loss, "grad_norm": gnorm.detach()}

    @torch.no_grad()
    def val_step(self, batch) -> Dict[str, torch.Tensor]:
        mix, targets, mouths = batch
        self.model.eval()
        loss = self.loss_func["val"](self._forward(mix, mouths), self._targets(targets))
        return {"val_loss": loss}

    def state_dict(self) -> Dict:
        """The training state: tensors and plain containers only."""
        state = {"step": self.step, "model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict()}
        if self.train_video_model:
            state["video_model"] = self.video_model.state_dict()
        return state

    def load_state_dict(self, state: Dict):
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.train_video_model:
            self.video_model.load_state_dict(state["video_model"])


def remix_sources(targets: torch.Tensor, perms: Sequence[torch.Tensor]):
    """(B, n_src, T) sources -> (mixture, remixed sources): source i of
    remixed utterance b is source i of utterance ``perms[i][b]``, rescaled
    to the energy source i of utterance b had (reference core.py:185-201)."""
    energies = targets.pow(2).sum(-1, keepdim=True)
    new_src = []
    for i, perm in enumerate(perms):
        s = targets[perm, i]
        s = s * torch.sqrt(energies[:, i] / (s.pow(2).sum(-1, keepdim=True) + 1e-8))
        new_src.append(s)
    targets = torch.stack(new_src, 1)
    return targets.sum(1), targets


def online_mixing_collate(targets: torch.Tensor, generator: Optional[torch.Generator] = None):
    """Energy-matched within-batch source remix augmentation: one batch
    permutation per source, drawn from ``generator``. targets: (B, n_src,
    T) -> (mix, targets)."""
    B, n_src, _ = targets.shape
    perms = [torch.randperm(B, generator=generator, device=targets.device)
             for _ in range(n_src)]
    return remix_sources(targets, perms)
