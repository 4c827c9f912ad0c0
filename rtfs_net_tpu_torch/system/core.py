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

``distribute(mesh)`` (``parallel.make_parallel_train_step``) makes each
step the one-device step on the global batch of which this rank holds a
shard: the forward runs in ``DistributedDataParallel``, BatchNorms become
``SyncBatchNorm``, dropout masks are drawn for the global batch, the
remix permutes it, and the losses are averaged over the mesh. The state
dict keeps the plain module names.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..ops.dropout import use_generator


class _Forward(nn.Module):
    """The step's forward as one module (what ``DistributedDataParallel``
    wraps): the lip embedding from the video model (with autograd only when
    it trains), then the model, activations in ``compute_dtype``, output in
    float32."""

    def __init__(self, model, video_model, train_video_model, compute_dtype):
        super().__init__()
        self.model, self.video_model = model, video_model
        self.train_video_model, self.compute_dtype = train_video_model, compute_dtype

    def forward(self, mix, mouths):
        if self.compute_dtype is not None:
            mix = mix.to(self.compute_dtype)
            mouths = None if mouths is None else mouths.to(self.compute_dtype)
        if self.video_model is not None and mouths is not None:
            with torch.set_grad_enabled(self.train_video_model and torch.is_grad_enabled()):
                mouths = self.video_model(mouths)
        return self.model(mix, mouths).float()


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
        self.net = _Forward(model, video_model, self.train_video_model, compute_dtype)
        # set by ``distribute``: the mesh and the forward in DDP
        self.mesh = None
        self.replica = None

    def _parameters(self):
        """Every parameter the optimizer updates."""
        params = list(self.model.parameters())
        if self.train_video_model:
            params += list(self.video_model.parameters())
        return params

    def distribute(self, mesh):
        """Train data-parallel over ``mesh`` (a ``parallel.Mesh`` this rank
        belongs to); a second call changes nothing. The trained modules'
        BatchNorms become ``SyncBatchNorm`` over the mesh's group (same
        tensors, same keys) and the forward runs in
        ``DistributedDataParallel``: gradients averaged over the mesh, no
        parameter left unused (``find_unused_parameters=False``)."""
        if self.replica is not None:
            return
        from torch.nn.parallel import DistributedDataParallel

        from ..parallel.sync_batchnorm import convert_sync_batchnorm

        convert_sync_batchnorm(self.model, mesh.group)
        if self.train_video_model:
            convert_sync_batchnorm(self.video_model, mesh.group)
        device = next(self.model.parameters()).device
        self.replica = DistributedDataParallel(
            self.net, device_ids=[device] if device.type == "cuda" else None,
            process_group=mesh.group, find_unused_parameters=False)
        self.mesh = mesh

    def _shard(self):
        """(index, count) of this rank's rows in the global batch."""
        return (0, 1) if self.mesh is None else (self.mesh.index, self.mesh.size)

    def _mean_over_mesh(self, loss):
        if self.mesh is not None:
            dist.all_reduce(loss, group=self.mesh.group)
            loss = loss / self.mesh.size
        return loss

    def _remix(self, targets, generator):
        """``online_mixing_collate`` of the global batch (gathered from the
        mesh), this rank's rows of it."""
        if self.mesh is None:
            return online_mixing_collate(targets, generator)
        parts = [torch.empty_like(targets) for _ in range(self.mesh.size)]
        dist.all_gather(parts, targets.contiguous(), group=self.mesh.group)
        mix, targets = online_mixing_collate(torch.cat(parts), generator)
        rows = slice(self.mesh.index * len(parts[0]), (self.mesh.index + 1) * len(parts[0]))
        return mix[rows], targets[rows]

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
            mix, targets = self._remix(targets, generator)
        A = self.accum_steps
        B = mix.shape[0]
        if B % A:
            raise ValueError(f"batch {B} not divisible by accum_steps {A}")
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        total = torch.zeros((), device=mix.device)
        forward = self.net if self.replica is None else self.replica
        with use_generator(generator, self._shard()):
            for i, (m, t, mo) in enumerate(zip(
                    mix.chunk(A), targets.chunk(A),
                    (None,) * A if mouths is None else mouths.chunk(A))):
                # DDP averages the gradients once, in the last microbatch's backward
                last = self.replica is None or i == A - 1
                with contextlib.nullcontext() if last else self.replica.no_sync():
                    loss = self.loss_func["train"](forward(m, mo), t)
                    (loss / A).backward()
                total += loss.detach()
        for p in self._parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return self._mean_over_mesh(total / A)

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
        loss = self.loss_func["val"](self.net(mix, mouths), self._targets(targets))
        return {"val_loss": self._mean_over_mesh(loss)}

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
