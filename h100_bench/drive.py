"""The one general driver of a cell's traffic, read from its traffic file:

* ``"kind": "serve"``: one caller, a closed loop: each request is a call of
  the port's ``separate`` with numpy mixture and frames in and the
  separated waveform out as numpy, sent when the previous one has
  returned. A request's latency runs from the call to its numpy result.
* ``"kind": "train"``: the port's ``System.train_step``, step after step,
  each batch uploaded from pinned host memory without blocking, as the
  port's ``Trainer`` does, the mixture stamped for step i on the device
  as ``inputs.Pool.call`` stamps it.

The window runs requests or steps until ``--seconds`` have passed and
closes on a synchronise. Set-up warms up the shapes first; a traced run
adds two profiled stretches of ``trace_units`` requests or steps after the
window.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import inputs, program, trace

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """What the window (or the traced stretch) did."""

    def __init__(self):
        self.units = 0                     # requests or steps completed
        self.utterances = 0
        self.latencies: List[float] = []  # seconds, per request
        self.outputs: Dict[int, np.ndarray] = {}
        self.seconds = 0.0
        self.launches: Dict[str, int] = {}
        self.light: Optional[trace.Trace] = None   # the device-only stretch
        self.stretch: Optional[trace.Trace] = None  # the stretch with host ops
        self.stretch_utterances = 0                 # in each of the two


class Serve:
    def __init__(self, cell, seed: int, device, model, video, pool: inputs.Pool):
        self.traffic, self.device = cell.traffic, device
        self.model, self.video, self.pool = model, video, pool
        self.dtype = DTYPES[cell.traffic["dtype"]]
        self.batch = cell.traffic["batch"]

    def call(self, i: int) -> np.ndarray:
        mix, _, frames = self.pool.call(i)
        return program.separate(self.model, self.video, mix, frames, self.device, self.dtype)

    def run(self, first: int, w: Window, done: Callable[[int], bool], keep: bool) -> int:
        i = first
        while not done(i - first):
            start = time.perf_counter()
            out = self.call(i)
            w.latencies.append(time.perf_counter() - start)
            if keep:
                w.outputs[i] = out
            w.units += 1
            w.utterances += self.batch
            i += 1
        return i


class Train:
    def __init__(self, cell, seed: int, device, model, video, pool: inputs.Pool):
        self.traffic, self.device = cell.traffic, device
        self.system = program.system(cell.conf, model, video, cell.traffic["grad_clip"],
                                     DTYPES[cell.traffic["dtype"]])
        self.generator = torch.Generator(device=device).manual_seed(inputs.torch_seed(seed, 2))
        pin = torch.device(device).type == "cuda"
        # copies of the pool as set-up left it, before any call stamped it
        self.host = [tuple(torch.from_numpy(a).pin_memory() if pin else torch.from_numpy(a).clone()
                           for a in (pool.mixes[p], pool.targets[p], pool.frames[p]))
                     for p in range(len(pool.mixes))]
        self.batch = cell.traffic["batch"]

    def call(self, i: int) -> Dict[str, torch.Tensor]:
        mix, target, frames = (t.to(self.device, non_blocking=True, copy=True)
                               for t in self.host[i % len(self.host)])
        mix[:, 0] += inputs.Pool.stamp(i).item()
        return self.system.train_step((mix, target, frames), self.generator)

    def run(self, first: int, w: Window, done: Callable[[int], bool], keep: bool) -> int:
        i = first
        while not done(i - first):
            self.call(i)
            w.units += 1
            w.utterances += self.batch
            i += 1
        return i


def make(cell, seed, device, model, video, pool):
    return {"serve": Serve, "train": Train}[cell.traffic["kind"]](cell, seed, device, model,
                                                                   video, pool)


def window(driver, seconds: float, first: int) -> Window:
    """The measured window: requests or steps from ``first`` until
    ``seconds`` have passed, every output kept for the check."""
    w = Window()
    before = program.kernel_launches()
    synchronize(driver.device)
    t0 = time.perf_counter()
    driver.run(first, w, lambda n: n > 0 and time.perf_counter() - t0 >= seconds, True)
    synchronize(driver.device)
    w.seconds = time.perf_counter() - t0
    w.launches = {k: n - before[k] for k, n in program.kernel_launches().items()}
    return w


def stretch(driver, units: int, first: int, install: Callable[[], Callable], w: Window):
    """Two traced stretches of ``units`` requests or steps each, after the
    window: the first with the profiler on the device alone (busy time,
    idle share, launch calls: little overhead), the second with the host's
    operators and ranges too (what ran under which op or range);
    ``install()`` puts the readers' hooks in place for the second and
    returns their undo."""
    for host in (False, True):
        undo = install() if host else (lambda: None)
        holder: Dict = {}
        side = Window()
        try:
            with trace.profiled(holder, host):
                first = driver.run(first, side, lambda n: n >= units, False)
        finally:
            undo()
        t = trace.Trace(holder["events"], side.units, None if host else holder["wall_s"])
        if host:
            w.stretch = t
        else:
            w.light = t
            w.stretch_utterances = side.utterances
