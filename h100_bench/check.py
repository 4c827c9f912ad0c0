"""What decides ``correct``: the program's results against the plain
reference, which is given the same seeded weights and inputs and computes
in float32 with TF32 off.

* Serving: a sample of the window's requests, drawn from the seed
  (``check_calls`` of them); the reference separates each whole request in
  blocks of ``check_block`` rows and rescales the batch's energy as
  ``separate`` does. The number compared is the widest relative error of
  an utterance, ‖program − reference‖ / ‖reference‖.
* Training: the first ``check_steps`` steps of the very ``System`` that the
  window then drives, through the window's own call and feed. The numbers
  are the widest gap of a step's loss (dB), and by the worst parameter
  tensor the gap between the program's and the reference's norms of the
  first step's gradient (as AdamW got it: its first moment after one step
  over 1 − β1) and of the parameters' change over the steps, each over the
  larger of that tensor's reference norm and the median tensor's. Tensors
  whose reference gradient is under a thousandth of the median tensor's
  move by round-off alone and are left out of both.

A control puts the reference itself, one precision lower, in the
program's place (``reference/precision.py``).
"""
from __future__ import annotations

import contextlib
import math
import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from . import inputs, spec, weights
from .reference import precision
from .reference.train import forward, train_steps

ROUND_OFF = 1e-3  # a tensor's gradient under this share of the median's moves by round-off
# the training fault planted in the reference put in the program's place:
# half of the batch left out, the loss the mean over the rest
HALF_BATCH = "half_batch"


@contextlib.contextmanager
def exact_float32():
    """float32 matmuls and convolutions without TF32, for the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def reference_models(reference: str, conf: Dict, seed: int, device):
    """The AVNet and video model of ``conf`` in the plain reference module
    at ``reference``, with the seed's weights: the state dicts that the
    program is given too."""
    module = spec.reference(reference)
    with torch.device("meta"):
        model, video = module.build(conf)
    ms, vs = weights.make_state(model, video, inputs.torch_seed(seed, 0), device, module.INIT)
    model.load_state_dict(ms, assign=True)
    video.load_state_dict(vs, assign=True)
    model.requires_grad_(True)
    video.requires_grad_(False).eval()
    return model.eval(), video


@torch.no_grad()
def reference_separate(model, video, requests: List[tuple], block: int, device) -> List:
    """Each request's (mixture, frames) separated by the reference, the rows
    of all requests run in blocks of ``block``, then each request's energy
    rescaled to its mixture's over its whole batch, as ``separate`` does."""
    mix = torch.from_numpy(np.concatenate([m for m, _ in requests])).to(device)
    frames = np.concatenate([f for _, f in requests])
    raw = torch.cat([forward(model, mix[lo:lo + block],
                             forward(video, torch.from_numpy(frames[lo:lo + block]).to(device)))
                     .float() for lo in range(0, mix.shape[0], block)])
    outs, lo = [], 0
    for m, _ in requests:
        x, out = mix[lo:lo + len(m)], raw[lo:lo + len(m)]
        outs.append((out * (x.abs().sum() / (out.abs().sum() + 1e-8))).cpu().numpy())
        lo += len(m)
    return outs


def _sample(indices: List[int], k: int, seed: int) -> List[int]:
    rng = inputs.stream(seed, 3)
    return sorted(int(i) for i in rng.choice(sorted(indices), size=min(k, len(indices)),
                                             replace=False))


def serve_numbers(cell, seed: int, device, pool: inputs.Pool,
                  outputs: Optional[Dict[int, np.ndarray]] = None,
                  control: Optional[str] = None) -> Dict[str, float]:
    """The serving number of the sampled requests: the program's
    ``outputs`` (request index -> (B, 1, L) numpy), or the reference at
    ``control`` precision in the program's place."""
    t = cell.traffic
    indices = _sample(list(outputs) if outputs is not None else range(t["check_calls"] * 4),
                      t["check_calls"], seed)
    model, video = reference_models(cell.reference, cell.conf, seed, device)
    requests = [(mix.copy(), frames) for mix, _, frames in map(pool.call, indices)]
    with exact_float32():
        want = reference_separate(model, video, requests, t["check_block"], device)
        if control is None:
            got = [outputs[i].reshape(w.shape) for i, w in zip(indices, want)]
        else:
            with precision.mode(control):
                got = reference_separate(model, video, requests, t["check_block"], device)
    err = np.concatenate([np.linalg.norm(g - w, axis=-1) / np.linalg.norm(w, axis=-1)
                          for g, w in zip(got, want)])
    worst = float(np.max(err)) if np.all(np.isfinite(err)) else math.inf
    return {"max_rel_err": worst}


def program_train_readings(driver, steps: int) -> Dict:
    """The program's first ``steps`` steps, through the window's own call:
    each loss, the first gradient as AdamW got it, the change of every
    parameter."""
    system = driver.system
    named = list(system.model.named_parameters())
    start = {n: p.detach().clone() for n, p in named}
    losses, first = [], None
    for i in range(steps):
        losses.append(driver.call(i)["loss"])
        if i == 0:
            beta1 = system.optimizer.param_groups[0]["betas"][0]
            first = {n: system.optimizer.state[p]["exp_avg"].detach().float() / (1 - beta1)
                     for n, p in named}
    change = {n: (p.detach() - start[n]).float() for n, p in named}
    return {"losses": [float(x) for x in losses], "first": first, "change": change}


def _leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
               keep: List[str]):
    """(worst, median) over the tensors in ``keep`` of |‖got‖ − ‖want‖| over
    the larger of ‖want‖ and the median tensor's ‖want‖."""
    norms = {n: float(torch.linalg.vector_norm(want[n])) for n in keep}
    median = statistics.median(norms.values())
    gaps = [abs(float(torch.linalg.vector_norm(got[n])) - norms[n]) / max(norms[n], median)
            for n in keep]
    if not all(math.isfinite(g) for g in gaps):
        return math.inf, math.inf, None
    return max(gaps), statistics.median(gaps), keep[gaps.index(max(gaps))]


def train_numbers(cell, seed: int, device, pool: inputs.Pool, readings: Optional[Dict],
                  control: Optional[str] = None) -> Dict[str, float]:
    """The training numbers: the program's ``readings`` (or the reference at
    ``control`` precision in the program's place) against the reference."""
    t = cell.traffic
    steps = t["check_steps"]

    def run(rows=None):
        model, video = reference_models(cell.reference, cell.conf, seed, device)
        gen = torch.Generator(device=device).manual_seed(inputs.torch_seed(seed, 2))
        batches = [tuple(torch.tensor(a[:rows], device=device) for a in pool.call(i))
                   for i in range(steps)]
        return train_steps(model, video, batches, gen, cell.conf["optim"], t["grad_clip"])

    with exact_float32():
        losses, first, change = run()
        if control == HALF_BATCH:
            got = run(t["batch"] // 2)
        elif control is not None:
            with precision.mode(control):
                got = run()
        if control is not None:
            readings = {"losses": got[0], "first": got[1], "change": got[2]}
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in first.items()}
    median = statistics.median(norms.values())
    keep = [n for n, v in norms.items() if v >= ROUND_OFF * median]
    gaps = [abs(a - b) for a, b in zip(readings["losses"], losses)]
    gaps = gaps if all(map(math.isfinite, gaps)) else [math.inf] * len(gaps)
    grad, change_ = (_leaf_gaps(readings[k], want, keep)
                     for k, want in (("first", first), ("change", change)))
    return {"loss_gap_first_db": gaps[0], "loss_gap_db": max(gaps),
            "grad_gap": grad[0], "grad_gap_median": grad[1], "grad_worst": grad[2],
            "change_gap": change_[0], "change_gap_median": change_[1],
            "change_worst": change_[2], "left_out": sorted(set(first) - set(keep))}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when every number with a limit is finite and within it."""
    return all(name in numbers and math.isfinite(numbers[name]) and numbers[name] <= limit
               for name, limit in limits.items())
