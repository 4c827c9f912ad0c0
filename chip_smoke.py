#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rtfs_net_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card and nvcc

Phases (any failure exits non-zero before the final line):

1. preconditions: a CUDA card; prints ``nvidia-smi``'s name and power limit.
2. build: the SRU kernel's source with ``nvcc`` into
   ``rtfs_net_tpu_torch/csrc/build/``, timed.
3. kernel: the SRU kernel against its plain PyTorch version on the card,
   at the shapes the B=16 serving forward gives it, with times and the bound.
4. serving: RTFS-Net-4 at full width (random weights from seed 0) answers
   requests of 2 s mixtures plus (B, 512, 50) lip embeddings at B = 1, 4,
   16 through ``separate()``; the SRU kernel must launch exactly 32 times
   per forward; B=1 in float32 is held against the same model on the CPU;
   ms per forward and per utterance in float32 and bfloat16.
5. profile: ``torch.profiler`` over a few forwards of the same model and
   requests per (dtype, B): wall and device busy time, idle share, kernel
   launches, device time by kernel category and the top kernels.
6. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` last.

Every comparison on the card runs with TF32 off (cuDNN convolutions and
matmuls in full float32), and so do the float32 timings.
"""
import collections
import copy
import itertools
import json
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
H = 32
SRU_SHAPES = [(57, 125 * 16), (118, 64 * 16)]  # (L, rows): F pass, T pass at B=16
SRU_LAYERS = {4: 1, 3: 3}  # layers per 4-layer stack with k=4 and k=3 chunks
REPEATS = 4                # TDANet repeats per forward (1 fused + 3 audio-only)
SERVE_BATCHES = (1, 4, 16)
SERVE_REPS = 11  # timed forwards per (dtype, B); small batches are host-bound and noisy
PROFILE_ITERS, PROFILE_TOP = 3, 6  # profiled forwards per (dtype, B); kernels listed
PROFILE_CATEGORIES = [  # kernel name regexes, first match wins
    ("sru_kernel", r"sru_stack_layer"),
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
    from rtfs_net_tpu_torch.utils.separator import separate

    ksru.launches = 0
    outs = []
    for B, (mix, mouth) in zip(SERVE_BATCHES, requests):
        before = ksru.launches
        outs.append(separate(model, mix, mouth))
        torch.cuda.synchronize()
        n = ksru.launches - before
        if n != 32:
            fail(f"B={B}: sru_stack_layer launched {n} times in one forward, want 32")
    launches = ksru.launches
    print(f"main path launches: sru_stack_layer {launches}")
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


def profile_serving(model, requests):
    """Where a forward's time goes, per (dtype, B), from ``torch.profiler``.
    Device busy time is the sum of kernel times (the port runs on one stream)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rtfs_net_tpu_torch.utils.separator import separate

    def category(name):
        low = name.lower()
        return next((cat for cat, pattern in PROFILE_CATEGORIES if re.search(pattern, low)),
                    "other")

    for dtype in (torch.float32, torch.bfloat16):
        for B, (mix, mouth) in zip(SERVE_BATCHES, requests):
            separate(model, mix, mouth, dtype=dtype)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(PROFILE_ITERS):
                    separate(model, mix, mouth, dtype=dtype)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_ITERS
            kernels = collections.Counter()
            n_launches = 0
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    kernels[e.name] += e.device_time_total / 1e3 / PROFILE_ITERS
                    n_launches += 1
            if not kernels:
                fail(f"profile B={B} {dtype}: the profiler saw no device time")
            busy = sum(kernels.values())
            by_cat = collections.Counter()
            for name, ms in kernels.items():
                by_cat[category(name)] += ms
            print("profile " + json.dumps({
                "dtype": str(dtype).split(".")[-1], "B": B, "wall_ms": wall_ms,
                "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
                "kernel_launches": n_launches / PROFILE_ITERS,
                "by_category_ms": dict(by_cat.most_common()),
                "top_kernels_ms": [[n[:80], ms] for n, ms in kernels.most_common(PROFILE_TOP)],
            }))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from rtfs_net_tpu_torch.ops.kernels import build
    from rtfs_net_tpu_torch.ops.kernels import sru as ksru

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build.load(ksru.SOURCE)
    print(f"build: {ksru.SOURCE} built and loaded in {time.perf_counter() - t0:.3f} s")
    sru = check_sru_kernel()
    model, requests = serving_setup()
    launches = check_serving(model, requests)
    profile_serving(model, requests)

    summary = [{"name": "sru_stack_layer", "route": "cuda",
                "source": "rtfs_net_tpu_torch/csrc/sru_stack_layer.cu",
                "replaces": "rtfs_net_tpu/ops/pallas/sru_kernel_v3.py:234",
                "launches": launches,
                **{key: sru[key] for key in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
                # no single PyTorch call computes an SRU layer's recurrence
                "library_ms": None}]
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
