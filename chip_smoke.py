#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rtfs_net_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card and nvcc

Phases (any failure exits non-zero before the final line):

1. preconditions: a CUDA card; prints ``nvidia-smi``'s name and power limit.
2. build: both kernel sources (``csrc/sru_stack_layer.cu``, the inference
   SRU kernel K1, and ``csrc/sru_train.cu``, the training SRU kernels K2)
   with one ``nvcc`` each, started together, into
   ``rtfs_net_tpu_torch/csrc/build/``, timed.
3. kernel K1: against its plain PyTorch version on the card, at the
   shapes the B=16 serving forward gives it, with times and the bound.
4. serving: RTFS-Net-4 at full width (random weights from seed 0) answers
   requests of 2 s mixtures plus (B, 512, 50) lip embeddings at B = 1, 4,
   16 through ``separate()``; K1 must launch exactly 32 times per forward
   and K2 never; B=1 in float32 is held against the same model on the CPU;
   ms per forward and per utterance in float32 and bfloat16.
5. profile: ``torch.profiler`` over a few forwards of the same model and
   requests per (dtype, B): wall and device busy time, idle share, kernel
   launches, device time by kernel category and the top kernels.
6. kernel K2: its forward and backward against their plain versions at
   the four shapes the B=4 and B=16 train steps give them, k = 3 and 4,
   float32 and bfloat16, with times and bounds.
7. training: ``System.train_step`` of RTFS-Net-4 at full width (AdamW lr
   1e-3, wd 0.1, clip 5.0, PIT neg-SNR; the target is the mixture) at
   B = 4 and 16, in float32 and with ``compute_dtype=bfloat16``: each step
   launches K2's forward exactly 64 times (32 layers, and again in the
   checkpointed blocks' recompute), its backward 32 times and K1 never;
   loss and grad norm finite; median ms per step and peak memory.
8. train parity: one float32 B=1 step (dropout off) on the card against
   the same step on the CPU: the loss and every gradient.
9. train profile: ``torch.profiler`` over one B=16 bfloat16 step.
10. K3's library call: ``F.conv2d(groups=C)`` at the shapes of the
   stride-1 depthwise convs of a B=16 forward (K3 is not ported), and the
   bounds of K3 and K4.
11. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` last.

Every comparison on the card runs with TF32 off (cuDNN convolutions and
matmuls in full float32), and so do the float32 timings.
"""
import collections
import concurrent.futures
import copy
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "rtfs_net_tpu_torch", "configs", "lrs2_RTFSNet_4_layer.yaml")

# H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per SRU output element: two gates (3 + sigmoid's 4
# each), the carry update (4), the highway mix (4)
SRU_OPS_PER_ELEMENT = 22
# and per element of the backward sweep (sru_train.cu): the two gates
# again (14), dm (5), dct (2), da (5), du0 and dskip (4), the four gate
# sums (6), the carry (5)
SRU_BWD_OPS_PER_ELEMENT = 41
H = 32
SRU_SHAPES = [(57, 125 * 16), (118, 64 * 16)]  # (L, rows): F pass, T pass at B=16
TRAIN_BATCHES = (4, 16)
# (L, rows) of the F and T passes at each train batch
TRAIN_SHAPES = [(L, per_utt * B) for B in TRAIN_BATCHES for L, per_utt in ((57, 125), (118, 64))]
TRAIN_STEPS = 10  # timed steps per (dtype, B), after one counted step
SRU_LAYERS = {4: 1, 3: 3}  # layers per 4-layer stack with k=4 and k=3 chunks
REPEATS = 4                # TDANet repeats per forward (1 fused + 3 audio-only)
SERVE_BATCHES = (1, 4, 16)
SERVE_REPS = 11  # timed forwards per (dtype, B); small batches are host-bound and noisy
PROFILE_ITERS, PROFILE_TOP = 3, 6  # profiled forwards per (dtype, B); kernels listed
PROFILE_CATEGORIES = [  # kernel name regexes, first match wins
    ("sru_kernel", r"sru_stack_layer"),
    ("sru_train_kernel", r"sru_train"),
    ("fft", r"fft"),
    ("softmax", r"softmax"),
    ("norm_reduce", r"norm|reduce|welford|moments"),
    ("matmul", r"gemm|cutlass|xmma_gemm|sm90_xmma|cublas"),
    ("conv", r"conv|cudnn|implicit|winograd|dgrad|wgrad|xmma|depthwise"),
    ("copy_layout", r"copy|cat|transpose|permute|pad|upsample|index|gather|scatter"),
    ("elementwise", r"elementwise|vectorized|unrolled|prelu|sigmoid|relu|add|mul"),
]
SAMPLES, LIP_CHANNELS, LIP_FRAMES = 32000, 512, 50
# bf16 kernel vs the plain version on the same bf16 inputs: both carry and
# compute in float32 and round once, so they differ by one bf16 ulp where
# the float32 results straddle a rounding boundary. One ulp is 2^-8 to
# 2^-7 of the value, so the limit 2^-7*|ref| + 1e-5 admits one to two ulps.
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5


def fail(msg):
    raise RuntimeError(msg)


def event_ms(fn, reps, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sru_inputs(L, rows, k, dtype, gen, copies):
    import torch

    O = 2 * H
    sets = []
    for _ in range(copies):
        u = torch.randn((L, k * O, rows), generator=gen, device="cuda").to(dtype)
        skip = torch.randn((L, O, rows), generator=gen, device="cuda").to(dtype) if k == 3 else None
        sets.append((u, skip))
    v = 0.5 * torch.randn(2 * O, generator=gen, device="cuda")
    b = 0.5 * torch.randn(2 * O, generator=gen, device="cuda")
    return sets, v, b


def check_sru_kernel():
    """The SRU layer kernel against its plain version at the serving shapes."""
    import torch

    from rtfs_net_tpu_torch.ops.kernels import sru as ksru

    gen = torch.Generator(device="cuda").manual_seed(0)
    per_forward = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
                   "ops_ms": 0.0}
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for L, rows in SRU_SHAPES:
        for k in (4, 3):
            for dtype in (torch.float32, torch.bfloat16):
                item = torch.tensor([], dtype=dtype).element_size()
                O = 2 * H
                nbytes = (k * O + O + (O if k == 3 else 0)) * L * rows * item
                # rotate through input copies totalling > 100 MB so each
                # launch reads from HBM, not from the 50 MB L2
                copies = 1 + int(100e6 // (nbytes - O * L * rows * item))
                sets, v, b = sru_inputs(L, rows, k, dtype, gen, copies)
                u, skip = sets[0]
                got = ksru.sru_stack_layer(u, skip, v, b, H=H, k=k, ndir=2)
                torch.cuda.synchronize()
                want = ksru.sru_stack_layer_ref(u, skip, v, b, H=H, k=k, ndir=2)
                err = (got.float() - want.float()).abs()
                max_abs = float(err.max())
                if dtype == torch.float32:
                    ok = max_abs <= 1e-5
                else:
                    ok = bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
                if not ok or not bool(torch.isfinite(got).all()):
                    fail(f"sru_stack_layer L={L} rows={rows} k={k} {dtype}: "
                         f"max_abs_err {max_abs} out of tolerance")
                max_err[dtype] = max(max_err[dtype], max_abs)
                it = itertools.count()

                def kernel():
                    uu, ss = sets[next(it) % copies]
                    ksru.sru_stack_layer(uu, ss, v, b, H=H, k=k, ndir=2)

                ms = event_ms(kernel, reps=20)
                plain_ms = event_ms(
                    lambda: ksru.sru_stack_layer_ref(u, skip, v, b, H=H, k=k, ndir=2),
                    reps=2, warmup=1)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = SRU_OPS_PER_ELEMENT * L * O * rows / FP32_OPS_PER_S * 1e3
                bound_ms = max(bytes_ms, ops_ms)
                row = {"L": L, "rows": rows, "k": k, "dtype": str(dtype).split(".")[-1],
                       "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms,
                       "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                       "GB_per_s": nbytes / ms / 1e6}
                print("sru_stack_layer " + json.dumps(row))
                if dtype == torch.float32:
                    n = REPEATS * SRU_LAYERS[k]
                    per_forward["ms"] += n * ms
                    per_forward["plain_ms"] += n * plain_ms
                    per_forward["bound_ms"] += n * bound_ms
                    per_forward["bytes_ms"] += n * bytes_ms
                    per_forward["ops_ms"] += n * ops_ms
                del sets, u, skip, got, want, err
    print(f"sru_stack_layer: max_abs_err float32 {max_err[torch.float32]} "
          f"(tol 1e-5), bfloat16 {max_err[torch.bfloat16]} "
          f"(tol {BF16_ATOL} + {BF16_RTOL}*|ref|)")
    print("sru_stack_layer per B=16 float32 forward (32 launches): " + json.dumps(per_forward))
    bound_by = "bytes" if per_forward.pop("bytes_ms") >= per_forward.pop("ops_ms") else "operations"
    return {"max_abs_err": max_err[torch.float32], "bound_by": bound_by, **per_forward}


def serving_setup():
    """RTFS-Net-4 at full width on the card, and one request per batch size."""
    import torch
    import yaml

    from rtfs_net_tpu_torch.models import build_model

    with open(CONFIG) as f:
        conf = yaml.safe_load(f)
    model = build_model(conf, device="cuda", generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    requests = [(torch.randn((B, SAMPLES), generator=gen, device="cuda"),
                 0.1 * torch.randn((B, LIP_CHANNELS, LIP_FRAMES), generator=gen, device="cuda"))
                for B in SERVE_BATCHES]
    return model, requests


def check_serving(model, requests):
    """The main path: one float32 forward per request, SRU launches counted;
    then B=1 against the CPU, then timings. Returns the main path's launches."""
    import torch

    from rtfs_net_tpu_torch.ops.kernels import sru as ksru
    from rtfs_net_tpu_torch.ops.kernels import sru_train as ktrain
    from rtfs_net_tpu_torch.utils.separator import separate

    ksru.launches = ktrain.forward_launches = ktrain.backward_launches = 0
    outs = []
    for B, (mix, mouth) in zip(SERVE_BATCHES, requests):
        before = ksru.launches
        outs.append(separate(model, mix, mouth))
        torch.cuda.synchronize()
        n = ksru.launches - before
        if n != 32:
            fail(f"B={B}: sru_stack_layer launched {n} times in one forward, want 32")
    launches = ksru.launches
    if ktrain.forward_launches or ktrain.backward_launches:
        fail("the serving forward launched the training kernels")
    print(f"main path launches (serving): sru_stack_layer {launches}")
    for B, out in zip(SERVE_BATCHES, outs):
        if tuple(out.shape) != (B, 1, SAMPLES) or not bool(torch.isfinite(out).all()):
            fail(f"B={B}: output {tuple(out.shape)}, finite={bool(torch.isfinite(out).all())}")
    print("serving: outputs " + ", ".join(str(tuple(o.shape)) for o in outs) + ", all finite")

    # B=1 float32 against the same model on the CPU (plain SRU path)
    cpu_model = copy.deepcopy(model).cpu()
    mix, mouth = requests[0]
    ref = separate(cpu_model, mix.cpu(), mouth.cpu(), device="cpu")
    err = float((outs[0].cpu() - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"serving B=1 float32 vs CPU: max_abs_err {err}, max|ref| {scale}, "
          f"tol 5e-4*max|ref| = {5e-4 * scale}")
    if not err <= 5e-4 * scale:
        fail("B=1 float32 output disagrees with the CPU forward")
    del cpu_model

    for dtype in (torch.float32, torch.bfloat16):
        for B, (mix, mouth) in zip(SERVE_BATCHES, requests):
            out = separate(model, mix, mouth, dtype=dtype)  # warm-up
            if not bool(torch.isfinite(out).all()):
                fail(f"B={B} {dtype}: non-finite output")
            times = []
            for _ in range(SERVE_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                separate(model, mix, mouth, dtype=dtype)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            times.sort()
            median = times[len(times) // 2]
            print("serving " + json.dumps({
                "dtype": str(dtype).split(".")[-1], "B": B, "ms_per_forward_median": median,
                "ms_per_forward_min": times[0], "ms_per_utt_median": median / B}))
    return launches


def category(name):
    low = name.lower()
    return next((cat for cat, pattern in PROFILE_CATEGORIES if re.search(pattern, low)),
                "other")


def profile_line(label, fn, iters):
    """``torch.profiler`` over ``iters`` calls of ``fn`` (after one warm-up
    call); prints one ``profile`` line. Device busy time is the sum of
    kernel times (the port runs on one stream)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = collections.Counter()
    n_launches = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] += e.device_time_total / 1e3 / iters
            n_launches += 1
    if not kernels:
        fail(f"profile {label}: the profiler saw no device time")
    busy = sum(kernels.values())
    by_cat = collections.Counter()
    for name, ms in kernels.items():
        by_cat[category(name)] += ms
    print("profile " + json.dumps({
        **label, "wall_ms": wall_ms,
        "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
        "kernel_launches": n_launches / iters,
        "by_category_ms": dict(by_cat.most_common()),
        "top_kernels_ms": [[n[:80], ms] for n, ms in kernels.most_common(PROFILE_TOP)],
    }))


def profile_serving(model, requests):
    """Where a forward's time goes, per (dtype, B), from ``torch.profiler``."""
    import torch

    from rtfs_net_tpu_torch.utils.separator import separate

    for dtype in (torch.float32, torch.bfloat16):
        for B, (mix, mouth) in zip(SERVE_BATCHES, requests):
            profile_line({"dtype": str(dtype).split(".")[-1], "B": B},
                         lambda: separate(model, mix, mouth, dtype=dtype), PROFILE_ITERS)


def tolerance_ok(got, want, dtype):
    """Elementwise: float32 1e-5 + 1e-5*|ref|; bfloat16 K1's 1e-5 + 2^-7*|ref|."""
    import torch

    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (BF16_RTOL, BF16_ATOL)
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all()) and bool(torch.isfinite(got).all())
    return ok, float(err.max())


def check_sru_train_kernel():
    """K2's forward and backward against their plain versions at the train
    shapes, with times and bounds; returns the per-step sums of a B=16
    float32 step for the kernels line."""
    import torch

    from rtfs_net_tpu_torch.ops.kernels import sru_train as ktrain

    gen = torch.Generator(device="cuda").manual_seed(2)
    O = 2 * H
    per_step = {"forward": collections.Counter(), "backward": collections.Counter()}
    max_err = {"forward": 0.0, "backward": 0.0}
    for L, rows in TRAIN_SHAPES:
        for k in (4, 3):
            for dtype in (torch.float32, torch.bfloat16):
                item = torch.tensor([], dtype=dtype).element_size()
                skip_ch = O if k == 3 else 0
                fwd_bytes = (k * O + skip_ch + 2 * O) * L * rows * item
                bwd_bytes = ((k * O + 2 * O + skip_ch) + (k * O + skip_ch)) * L * rows * item \
                    + 4 * O * rows * 4
                # rotate through input copies totalling > 100 MB so each
                # launch reads from HBM, not from the 50 MB L2
                copies = 1 + int(100e6 // ((k * O + 2 * O + skip_ch) * L * rows * item))
                sets, v, b = sru_inputs(L, rows, k, dtype, gen, copies)
                sets = [(u, sk, torch.randn((L, O, rows), generator=gen, device="cuda").to(dtype))
                        for u, sk in sets]
                u, skip, dh = sets[0]
                kw = dict(H=H, k=k, ndir=2)
                h, c = ktrain.sru_train_forward(u, skip, v, b, **kw)
                got_b = ktrain.sru_train_backward(u, skip, c, v, b, dh, **kw)
                torch.cuda.synchronize()
                want_h, want_c = ktrain.sru_train_forward_ref(u, skip, v, b, **kw)
                want_b = ktrain.sru_train_backward_ref(u, skip, c, v, b, dh, **kw)
                name = f"L={L} rows={rows} k={k} {dtype}"
                errs = {}
                for part, g, w in (("h", h, want_h), ("c", c, want_c), ("du", got_b[0], want_b[0]),
                                   ("dskip", got_b[1], want_b[1])):
                    if w is None:
                        continue
                    ok, errs[part] = tolerance_ok(g, w, dtype)
                    if not ok:
                        fail(f"sru_train {part} {name}: max_abs_err {errs[part]} out of tolerance")
                gate_rtol = 1e-4 if dtype == torch.float32 else 1e-3
                for part, g, w in (("dv", got_b[2], want_b[2]), ("db", got_b[3], want_b[3])):
                    errs[part] = float((g - w).abs().max())
                    if not errs[part] <= gate_rtol * float(w.abs().max()):
                        fail(f"sru_train {part} {name}: max_abs_err {errs[part]} > "
                             f"{gate_rtol}*max|ref| = {gate_rtol * float(w.abs().max())}")
                cs = [ktrain.sru_train_forward(uu, ss, v, b, **kw)[1] for uu, ss, _ in sets]
                it = itertools.count()

                def fwd():
                    uu, ss, _ = sets[next(it) % copies]
                    ktrain.sru_train_forward(uu, ss, v, b, **kw)

                def bwd():
                    i = next(it) % copies
                    uu, ss, gg = sets[i]
                    ktrain.sru_train_backward(uu, ss, cs[i], v, b, gg, **kw)

                times = {
                    "forward": (event_ms(fwd, reps=20), event_ms(
                        lambda: ktrain.sru_train_forward_ref(u, skip, v, b, **kw),
                        reps=2, warmup=1), fwd_bytes, SRU_OPS_PER_ELEMENT),
                    "backward": (event_ms(bwd, reps=20), event_ms(
                        lambda: ktrain.sru_train_backward_ref(u, skip, c, v, b, dh, **kw),
                        reps=2, warmup=1), bwd_bytes, SRU_BWD_OPS_PER_ELEMENT),
                }
                for which, (ms, plain_ms, nbytes, ops) in times.items():
                    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                    ops_ms = ops * L * O * rows / FP32_OPS_PER_S * 1e3
                    parts = ("h", "c") if which == "forward" else ("du", "dskip", "dv", "db")
                    err = max(errs[p] for p in parts if p in errs)
                    print(f"sru_train_{which} " + json.dumps({
                        "L": L, "rows": rows, "k": k, "dtype": str(dtype).split(".")[-1],
                        "max_abs_err": err, "errors": {p: errs[p] for p in parts if p in errs},
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                        "GB_per_s": nbytes / ms / 1e6}))
                    if dtype == torch.float32:
                        max_err[which] = max(max_err[which], err)
                    if dtype == torch.float32 and rows in (125 * 16, 64 * 16):
                        # a step runs each layer's forward twice (the
                        # checkpointed recompute) and its backward once
                        n = REPEATS * SRU_LAYERS[k] * (2 if which == "forward" else 1)
                        acc = per_step[which]
                        acc["ms"] += n * ms
                        acc["plain_ms"] += n * plain_ms
                        acc["bytes_ms"] += n * bytes_ms
                        acc["ops_ms"] += n * ops_ms
                del sets, cs, u, skip, dh, h, c, got_b, want_b
    out = {}
    for which, acc in per_step.items():
        row = {"max_abs_err": max_err[which], "ms": acc["ms"], "plain_ms": acc["plain_ms"],
               "bound_ms": max(acc["bytes_ms"], acc["ops_ms"]),
               "bound_by": "bytes" if acc["bytes_ms"] >= acc["ops_ms"] else "operations"}
        print(f"sru_train_{which} per B=16 float32 step: " + json.dumps(row))
        out[which] = row
    return out


def rtfs4_conf(dropout=None):
    import yaml

    with open(CONFIG) as f:
        conf = yaml.safe_load(f)["audionet"]
    if dropout is not None:
        conf["video_params"]["layers"]["layer_1"]["dropout"] = dropout
    return conf


def make_system(model, dtype):
    import torch

    from rtfs_net_tpu_torch.losses import PITLossWrapper, pairwise_neg_sisdr, pairwise_neg_snr
    from rtfs_net_tpu_torch.system import System, make_optimizer

    import yaml

    with open(CONFIG) as f:
        optim = yaml.safe_load(f)["optim"]
    return System(model, make_optimizer(model.parameters(), **optim),
                  {"train": PITLossWrapper(pairwise_neg_snr),
                   "val": PITLossWrapper(pairwise_neg_sisdr)},
                  compute_dtype=None if dtype == torch.float32 else dtype)


def train_batch(B, gen):
    """A (mix, target, mouths) batch; the target is the mixture, as the JAX
    package's train benchmark has it."""
    import torch

    mix = torch.randn((B, SAMPLES), generator=gen, device="cuda")
    mouth = 0.1 * torch.randn((B, LIP_CHANNELS, LIP_FRAMES), generator=gen, device="cuda")
    return mix, mix[:, None], mouth


def check_training():
    """The training path: per (dtype, B), one counted step (K2 forward 64,
    backward 32, K1 0), then timed steps and peak memory. Returns the
    path's launch counts."""
    import torch

    from rtfs_net_tpu_torch.models import build_model
    from rtfs_net_tpu_torch.ops.kernels import sru as ksru
    from rtfs_net_tpu_torch.ops.kernels import sru_train as ktrain

    base = build_model(rtfs4_conf(), device="cuda", generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(3)
    batches = {B: train_batch(B, gen) for B in TRAIN_BATCHES}
    runs = [(dtype, B) for dtype in (torch.float32, torch.bfloat16) for B in TRAIN_BATCHES]
    systems = {run: make_system(copy.deepcopy(base), run[0]) for run in runs}

    def step(run):
        out = systems[run].train_step(batches[run[1]],
                                      generator=torch.Generator(device="cuda").manual_seed(4))
        loss, gnorm = float(out["loss"]), float(out["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"train {run}: loss {loss}, grad_norm {gnorm}")
        return loss, gnorm

    ksru.launches = ktrain.forward_launches = ktrain.backward_launches = 0
    for run in runs:
        before = (ktrain.forward_launches, ktrain.backward_launches, ksru.launches)
        step(run)
        torch.cuda.synchronize()
        n = [a - b for a, b in zip((ktrain.forward_launches, ktrain.backward_launches,
                                    ksru.launches), before)]
        if n != [64, 32, 0]:
            fail(f"train {run}: launches (K2 forward, K2 backward, K1) = {n}, want [64, 32, 0]")
    launches = {"forward": ktrain.forward_launches, "backward": ktrain.backward_launches,
                "sru_stack_layer": ksru.launches}
    print("main path launches (training): " + json.dumps(launches))

    for run in runs:
        dtype, B = run
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(run)[0])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        print("train " + json.dumps({
            "dtype": str(dtype).split(".")[-1], "B": B,
            "ms_per_step_median": times[len(times) // 2], "ms_per_step_min": times[0],
            "utt_per_s": B / times[len(times) // 2] * 1e3,
            "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
            "loss_first_last": [losses[0], losses[-1]]}))
    del systems
    return base, launches


def check_train_parity():
    """One float32 B=1 step, dropout off: the card against the CPU."""
    import torch

    from rtfs_net_tpu_torch.models import build_model

    cpu_model = build_model(rtfs4_conf(dropout=0.0), device="cpu",
                            generator=torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).cuda()
    batch = train_batch(1, torch.Generator(device="cuda").manual_seed(5))
    loss_gpu = float(make_system(gpu_model, torch.float32).backward(batch))
    loss_cpu = float(make_system(cpu_model, torch.float32).backward(
        tuple(t.cpu() for t in batch)))
    grads = {n: p.grad for n, p in cpu_model.named_parameters()}
    scale = max(float(g.abs().max()) for g in grads.values())
    worst, worst_name = 0.0, None
    for n, p in gpu_model.named_parameters():
        err = float((p.grad.cpu() - grads[n]).abs().max())
        if err > worst:
            worst, worst_name = err, n
    print("train B=1 float32 vs CPU: " + json.dumps({
        "loss_gpu": loss_gpu, "loss_cpu": loss_cpu, "loss_tol": 1e-4 * abs(loss_cpu),
        "grad_max_abs_err": worst, "worst_param": worst_name, "max_abs_grad": scale,
        "grad_tol": 1e-3 * scale}))
    if not abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu):
        fail("B=1 float32 train loss disagrees with the CPU")
    if not worst <= 1e-3 * scale:
        fail(f"B=1 float32 gradient of {worst_name} disagrees with the CPU")


def profile_training(base):
    """torch.profiler over one B=16 bfloat16 train step."""
    import torch

    system = make_system(copy.deepcopy(base), torch.bfloat16)
    batch = train_batch(16, torch.Generator(device="cuda").manual_seed(6))
    gen = torch.Generator(device="cuda").manual_seed(7)
    profile_line({"train": True, "dtype": "bfloat16", "B": 16},
                 lambda: system.train_step(batch, generator=gen), 1)


def check_k3_library(model):
    """K3 (the stride-1 depthwise k x k conv, not ported) at the shapes a
    B=16 float32 forward gives it: the time of ``F.conv2d(groups=C)``, and
    its bound; and K4's bound (one SRU direction, inference) at K1's
    main-path shapes."""
    import torch
    import torch.nn.functional as F

    from rtfs_net_tpu_torch.ops.conv import Conv
    from rtfs_net_tpu_torch.utils.separator import separate

    calls = collections.Counter()

    def hook(mod, args):
        x = args[0]
        if mod.pad is not None:
            x = F.pad(x, mod.pad)
        calls[(tuple(x.shape), tuple(mod.weight.shape), str(x.dtype))] += 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, Conv) and m.ndim == 2 and m.groups > 1
               and m.weight.shape[1] == 1 and m.stride == (1, 1) and m.weight.shape[2] > 1]
    gen = torch.Generator(device="cuda").manual_seed(8)
    separate(model, torch.randn((16, SAMPLES), generator=gen, device="cuda"),
             torch.randn((16, LIP_CHANNELS, LIP_FRAMES), generator=gen, device="cuda"))
    for h in handles:
        h.remove()
    total = collections.Counter()
    for (xs, ws, _), n in sorted(calls.items()):
        B, C, Tp, Fp = xs
        kt, kf = ws[2], ws[3]
        To, Fo = Tp - kt + 1, Fp - kf + 1
        x = torch.randn(xs, generator=gen, device="cuda")
        w = torch.randn(ws, generator=gen, device="cuda")
        ms = event_ms(lambda: F.conv2d(x, w, groups=C), reps=20)
        nbytes = (x.numel() + B * C * To * Fo + w.numel()) * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * kt * kf * B * C * To * Fo / FP32_OPS_PER_S * 1e3
        print("k3_library " + json.dumps({
            "x_padded": xs, "w": ws, "calls_per_forward": n, "library_ms": ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}))
        total["calls"] += n
        total["library_ms"] += n * ms
        total["bytes_ms"] += n * bytes_ms
        total["ops_ms"] += n * ops_ms
    if not total["calls"]:
        fail("k3: no stride-1 depthwise conv ran in the forward")
    print("k3_library per B=16 float32 forward: " + json.dumps({
        "calls": total["calls"], "library_ms": total["library_ms"],
        "bound_ms": max(total["bytes_ms"], total["ops_ms"]),
        "bound_by": "bytes" if total["bytes_ms"] >= total["ops_ms"] else "operations"}))
    # K4 reads u0, u1, u2, skip and writes h, each (L, B, H), per direction
    k4_bytes = sum(5 * L * rows * H * 4 * 2 * REPEATS * sum(SRU_LAYERS.values())
                   for L, rows in SRU_SHAPES)
    print("k4_bound per B=16 float32 forward (64 directions): " + json.dumps({
        "bound_ms": k4_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from rtfs_net_tpu_torch.ops.kernels import build
    from rtfs_net_tpu_torch.ops.kernels import sru as ksru
    from rtfs_net_tpu_torch.ops.kernels import sru_train as ktrain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    sources = (ksru.SOURCE, ktrain.SOURCE)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(lambda src: build.build(build.CSRC / src), sources))
    for src in sources:
        build.load(src)
    print(f"build: {', '.join(sources)} built and loaded in {time.perf_counter() - t0:.3f} s")
    sru = check_sru_kernel()
    model, requests = serving_setup()
    launches = check_serving(model, requests)
    profile_serving(model, requests)
    sru_train = check_sru_train_kernel()
    base, train_launches = check_training()
    check_train_parity()
    profile_training(base)
    check_k3_library(model)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    # no single PyTorch call computes an SRU layer's recurrence or its backward
    summary = [{"name": "sru_stack_layer", "route": "cuda",
                "source": "rtfs_net_tpu_torch/csrc/sru_stack_layer.cu",
                "replaces": "rtfs_net_tpu/ops/pallas/sru_kernel_v3.py:234",
                "launches": launches, **{key: sru[key] for key in keys},
                "library_ms": None}]
    for which, line in (("forward", 154), ("backward", 177)):
        summary.append({"name": f"sru_train_{which}", "route": "cuda",
                        "source": "rtfs_net_tpu_torch/csrc/sru_train.cu",
                        "replaces": f"rtfs_net_tpu/ops/pallas/sru_train.py:{line}",
                        "launches": train_launches[which],
                        **{key: sru_train[which][key] for key in keys},
                        "library_ms": None})
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # any failed phase: report it and exit non-zero
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}", file=sys.stderr)
        sys.exit(1)
