#!/usr/bin/env python3
"""Device time of each hand-written kernel of the PyTorch port alone, at
the shapes its path gives it, beside its plain version and its bound, on
one CUDA card (PERF.md §6's "B=128 / train shapes" column).

    python3 scripts/torch_kernel_times.py       # needs one CUDA card and nvcc

For each row of ``ops.kernels.KERNELS``: its output is first held against
its plain version (``tolerance_ok``), then its launches are timed by
``event_ms`` (CUDA events around 20 launches queued behind a sleep kernel,
inputs rotated past the 50 MB L2) and summed over the launches of one call
of its path; the plain version is timed the same way, once. The shapes:

* ``sru_stack_layer`` (K1): the 32 launches of a B=128 bfloat16 serving
  forward (4 TDANet repeats, 2 DualPathRNNs, k = 4 once and k = 3 three
  times a stack, (L, rows) = (57, 125·B) and (118, 64·B));
* ``sru_train_forward``, ``sru_train_backward`` (K2): the 64 and 32
  launches of a float32 train step at B = 16 and at B = 4;
* ``dw_conv2d_same`` (K3): the 40 launches of a B=128 bfloat16 forward
  ((B, 64, 251, 129) three times and (B, 64, 125, 64) seven times a
  repeat, 4x4, pads (1, 2)), beside ``F.pad`` + ``F.conv2d(groups=C)``;
* ``sru_direction`` (K4): the 64 launches of a B=16 float32 forward on the
  ``"pallas"`` route;
* ``dual_path_norm_in``, ``dual_path_out``: one launch along F and one
  along T at RTFS-Net-4's B=128 bfloat16 block (128, 64, 126, 65);
* ``dual_path_windows_in``: one launch along T and one along F at
  TF-GridNet's B=128 bfloat16 block (128, 128, 251, 129), k = 4, beside
  the general route's norm, permute, unfold and copy.

Each summed row names the call it sums over (``path``) and how many
launches it summed; the tool counts that call's launches in one real call
of it (``path_launches``) and fails unless they agree, so a route change
that alters the counts stops it instead of skewing the sums. An op of the
table with no shapes here (``TIMES``) stops it too.

Prints one JSON line per kernel and shape: ``ms`` (device), ``plain_ms``,
``library_ms`` where one PyTorch call computes the same, ``bound_ms`` (the
bytes at ``HBM_BYTES_PER_S`` or the operations at ``FP32_OPS_PER_S``,
whichever is longer), ``bound_by`` and ``share`` (bound over ms); then the
card's name and power limit. To compare two trees, run it on each in
turns (parent, change, change, parent) in one call.
"""
import itertools
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

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
SRU_PASSES = [(57, 125), (118, 64)]  # (L, rows per utterance): the F pass, the T pass
SRU_LAYERS = {4: 1, 3: 3}  # layers per 4-layer stack with k=4 and k=3 chunks
REPEATS = 4                # TDANet repeats per forward
BIG_BATCH = 128
TRAIN_BATCHES = (16, 4)
PALLAS_BATCH = 16
GRID_BATCH = 2  # TF-GridNet's forward whose launches are counted
DW_PLANES = {(251, 129): 3, (125, 64): 7}  # K3 launches per TDANet block, by (T, F)
DW_KERNEL, DW_PADS = (4, 4), ((1, 2), (1, 2))
DUAL_PATH_BLOCK = (BIG_BATCH, 64, 126, 65)
GRID_BLOCK, GRID_K = (BIG_BATCH, 128, 251, 129), 4
# cycles of the sleep kernel that timed launches queue behind: ~6 ms, more
# than the host takes to launch 20 wrapper calls
QUEUE_CYCLES = 10_000_000
# bf16 kernel vs the plain version on the same bf16 inputs: one to two ulps
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5


def event_ms(fn, reps=20, warmup=2):
    """Device ms per call of ``fn``: CUDA events around ``reps`` calls that
    queue behind a sleep kernel, so the card runs them back to back and the
    host's time to launch them (tens of us per wrapper call, more than a
    small kernel takes) is not counted."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tolerance_ok(got, want, dtype):
    """Elementwise: float32 1e-5 + 1e-5*|ref|; bfloat16 1e-5 + 2^-7*|ref|;
    and finite. Returns (ok, max abs error)."""
    import torch

    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (BF16_RTOL, BF16_ATOL)
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all()) and bool(torch.isfinite(got).all())
    return ok, float(err.max())


def dtype_name(dtype):
    return str(dtype).split(".")[-1]


def sru_inputs(L, rows, k, dtype, gen, copies):
    """``copies`` (u, skip) sets of one SRU layer (skip only at k = 3) and
    its gate vectors v, b."""
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


def copies_for(nbytes):
    """Input copies totalling > 100 MB, so each launch reads from HBM, not
    from the 50 MB L2."""
    return 1 + int(100e6 // nbytes)


def check(name, got, want, dtype):
    ok, err = tolerance_ok(got, want, dtype)
    if not ok:
        raise RuntimeError(f"{name}: max_abs_err {err} out of tolerance")
    return err


def bound(nbytes, ops=0.0):
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def row(kernel, shape, ms, plain_ms, bound_ms, bound_by, **extra):
    return {"kernel": kernel, **shape, "ms": ms, "plain_ms": plain_ms, **extra,
            "bound_ms": bound_ms, "bound_by": bound_by, "share": bound_ms / ms}


def k1(gen):
    """K1 over a B=128 bfloat16 serving forward."""
    import torch

    from rtfs_net_tpu_torch.ops.kernels import sru

    dtype, O = torch.bfloat16, 2 * H
    sums = {"launches": 0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0}
    for (L, per_utt), k in itertools.product(SRU_PASSES, (4, 3)):
        rows, item = per_utt * BIG_BATCH, 2
        nbytes = (k * O + O + (O if k == 3 else 0)) * L * rows * item
        sets, v, b = sru_inputs(L, rows, k, dtype, gen, copies_for(nbytes - O * L * rows * item))
        u, skip = sets[0]
        with torch.no_grad():
            check(f"sru_stack_layer L={L} k={k}", sru.sru_stack_layer(u, skip, v, b, H=H, k=k,
                                                                      ndir=2),
                  sru.sru_stack_layer_ref(u, skip, v, b, H=H, k=k, ndir=2), dtype)
            it = itertools.count()
            ms = event_ms(lambda: sru.sru_stack_layer(*sets[next(it) % len(sets)], v, b, H=H,
                                                      k=k, ndir=2))
            plain_ms = event_ms(lambda: sru.sru_stack_layer_ref(u, skip, v, b, H=H, k=k, ndir=2),
                                reps=1, warmup=1)
        n = REPEATS * SRU_LAYERS[k]  # per forward, in the DualPathRNN of this pass
        for key, value in (("launches", 1), ("ms", ms), ("plain_ms", plain_ms), ("bytes", nbytes),
                           ("ops", SRU_OPS_PER_ELEMENT * L * O * rows)):
            sums[key] += n * value
        del sets, u, skip
    return [row("sru_stack_layer", {"B": BIG_BATCH, "dtype": "bfloat16",
                                    "path": f"serving_b{BIG_BATCH}", "launches": sums["launches"]},
                sums["ms"], sums["plain_ms"], *bound(sums["bytes"], sums["ops"]))]


def k2(gen):
    """K2's forward and backward over a float32 train step at B = 16 and 4:
    each layer's forward twice (the checkpointed recompute), its backward
    once."""
    import torch

    from rtfs_net_tpu_torch.ops.kernels import sru_train

    dtype, O, item, rows_out = torch.float32, 2 * H, 4, []
    for B in TRAIN_BATCHES:
        sums = {w: {"launches": 0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0}
                for w in ("forward", "backward")}
        for (L, per_utt), k in itertools.product(SRU_PASSES, (4, 3)):
            rows, skip_ch = per_utt * B, O if k == 3 else 0
            copies = copies_for((k * O + 2 * O + skip_ch) * L * rows * item)
            sets, v, b = sru_inputs(L, rows, k, dtype, gen, copies)
            sets = [(u, sk, torch.randn((L, O, rows), generator=gen, device="cuda"))
                    for u, sk in sets]
            kw = dict(H=H, k=k, ndir=2)
            u, skip, dh = sets[0]
            h, c = sru_train.sru_train_forward(u, skip, v, b, **kw)
            check(f"sru_train_forward L={L} B={B} k={k}", h,
                  sru_train.sru_train_forward_ref(u, skip, v, b, **kw)[0], dtype)
            check(f"sru_train_backward L={L} B={B} k={k}",
                  sru_train.sru_train_backward(u, skip, c, v, b, dh, **kw)[0],
                  sru_train.sru_train_backward_ref(u, skip, c, v, b, dh, **kw)[0], dtype)
            cs = [sru_train.sru_train_forward(uu, ss, v, b, **kw)[1] for uu, ss, _ in sets]
            it = itertools.count()

            def fwd():
                uu, ss, _ = sets[next(it) % copies]
                sru_train.sru_train_forward(uu, ss, v, b, **kw)

            def bwd():
                i = next(it) % copies
                uu, ss, gg = sets[i]
                sru_train.sru_train_backward(uu, ss, cs[i], v, b, gg, **kw)

            runs = {"forward": (fwd, lambda: sru_train.sru_train_forward_ref(u, skip, v, b, **kw),
                                (k * O + skip_ch + 2 * O) * L * rows * item,
                                SRU_OPS_PER_ELEMENT, 2),
                    "backward": (bwd, lambda: sru_train.sru_train_backward_ref(
                        u, skip, c, v, b, dh, **kw),
                        ((k * O + 2 * O + skip_ch) + (k * O + skip_ch)) * L * rows * item
                        + 4 * O * rows * 4, SRU_BWD_OPS_PER_ELEMENT, 1)}
            for which, (kernel, plain, nbytes, ops, per_layer) in runs.items():
                n = REPEATS * SRU_LAYERS[k] * per_layer
                acc = sums[which]
                acc["launches"] += n
                acc["ms"] += n * event_ms(kernel)
                acc["plain_ms"] += n * event_ms(plain, reps=1, warmup=1)
                acc["bytes"] += n * nbytes
                acc["ops"] += n * ops * L * O * rows
            del sets, cs, u, skip, dh, h, c
        for which, acc in sums.items():
            rows_out.append(row(f"sru_train_{which}", {"B": B, "dtype": "float32",
                                                       "path": f"train_b{B}",
                                                       "launches": acc["launches"]},
                                acc["ms"], acc["plain_ms"], *bound(acc["bytes"], acc["ops"])))
    return rows_out


def k3(gen):
    """K3 over a B=128 bfloat16 forward, beside F.pad + F.conv2d(groups=C)."""
    import torch
    import torch.nn.functional as F

    from rtfs_net_tpu_torch.ops.kernels import dw_conv

    dtype, item = torch.bfloat16, 2
    sums = {"launches": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "ops": 0.0}
    (lo_t, hi_t), (lo_f, hi_f) = DW_PADS
    for (T, Fq), calls in DW_PLANES.items():
        shape = (BIG_BATCH, 64, T, Fq)
        n = math.prod(shape)
        xs = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
              for _ in range(copies_for(n * item))]
        w = torch.randn((64, 1, *DW_KERNEL), generator=gen, device="cuda")
        w_lib = w.to(dtype)
        with torch.no_grad():
            check(f"dw_conv2d_same {shape}", dw_conv.dw_conv2d_same(xs[0], w, DW_PADS),
                  dw_conv.dw_conv2d_same_ref(xs[0], w, DW_PADS), dtype)
            it = itertools.count()
            ms = event_ms(lambda: dw_conv.dw_conv2d_same(xs[next(it) % len(xs)], w, DW_PADS))
            library_ms = event_ms(lambda: F.conv2d(F.pad(xs[next(it) % len(xs)],
                                                         (lo_f, hi_f, lo_t, hi_t)),
                                                   w_lib, groups=64))
            plain_ms = event_ms(lambda: dw_conv.dw_conv2d_same_ref(xs[0], w, DW_PADS), reps=2,
                                warmup=1)
        per_forward = REPEATS * calls
        for key, value in (("launches", 1), ("ms", ms), ("plain_ms", plain_ms),
                           ("library_ms", library_ms),
                           ("bytes", 2 * n * item + w.numel() * 4),
                           ("ops", 2 * math.prod(DW_KERNEL) * n)):
            sums[key] += per_forward * value
        del xs
    return [row("dw_conv2d_same", {"B": BIG_BATCH, "dtype": "bfloat16",
                                   "path": f"serving_b{BIG_BATCH}", "launches": sums["launches"]},
                sums["ms"], sums["plain_ms"], *bound(sums["bytes"], sums["ops"]),
                library_ms=sums["library_ms"])]


def k4(gen):
    """K4 over a B=16 float32 forward on the "pallas" route: both
    directions of each layer, on slices of one (L, rows, 4, 2H) projection."""
    import torch

    from rtfs_net_tpu_torch.ops.kernels import sru_direction

    dtype, O, item, B = torch.float32, 2 * H, 4, PALLAS_BATCH
    sums = {"launches": 0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0}
    for (L, per_utt), reverse in itertools.product(SRU_PASSES, (False, True)):
        rows = per_utt * B
        us = [torch.randn((L, rows, 4, O), generator=gen, device="cuda")
              for _ in range(copies_for(4 * L * rows * H * item))]
        gates = [0.5 * torch.randn(H, generator=gen, device="cuda") for _ in range(4)]
        sl = slice(H, O) if reverse else slice(0, H)

        def operands(u):
            return [u[:, :, c, sl] for c in range(4)]

        check(f"sru_direction L={L} reverse={reverse}",
              sru_direction.sru_direction(*operands(us[0]), *gates, reverse=reverse),
              sru_direction.sru_direction_ref(*operands(us[0]), *gates, reverse=reverse), dtype)
        it = itertools.count()
        ms = event_ms(lambda: sru_direction.sru_direction(*operands(us[next(it) % len(us)]),
                                                          *gates, reverse=reverse))
        plain_ms = event_ms(lambda: sru_direction.sru_direction_ref(
            *operands(us[0]), *gates, reverse=reverse), reps=1, warmup=1)
        n = REPEATS * sum(SRU_LAYERS.values())  # per direction and pass
        for key, value in (("launches", 1), ("ms", ms), ("plain_ms", plain_ms),
                           ("bytes", 5 * L * rows * H * item),
                           ("ops", SRU_OPS_PER_ELEMENT * L * rows * H)):
            sums[key] += n * value
        del us
    return [row("sru_direction", {"B": B, "dtype": "float32", "path": f"pallas_b{B}",
                                  "launches": sums["launches"]},
                sums["ms"], sums["plain_ms"], *bound(sums["bytes"], sums["ops"]))]


def dual_path_layout(gen):
    """The SRU DualPathRNN's passes into and out of K1's layout, one launch
    each along F and T at the B=128 bfloat16 block."""
    import torch

    from rtfs_net_tpu_torch.ops.kernels import dual_path

    dtype, item, rows_out = torch.bfloat16, 2, []
    B, C, T, F = DUAL_PATH_BLOCK
    numel = B * C * T * F
    for seq_dim in (3, 2):
        S, rows = dual_path.seq_shape(DUAL_PATH_BLOCK, seq_dim)
        x = (3 * torch.randn(DUAL_PATH_BLOCK, generator=gen, device="cuda") + 1).to(dtype)
        gamma = 1 + 0.1 * torch.randn(C, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(C, generator=gen, device="cuda")
        z = torch.randn((S, C, rows), generator=gen, device="cuda").to(dtype)
        bias = torch.randn(C, generator=gen, device="cuda")
        residual = torch.randn(DUAL_PATH_BLOCK, generator=gen, device="cuda").to(dtype)
        # bytes per launch: norm_in reads x and writes y; out reads z and the
        # residual and writes out
        calls = {"dual_path_norm_in": (
            lambda: dual_path.dual_path_norm_in(x, gamma, beta, seq_dim=seq_dim, eps=1e-5),
            lambda: dual_path.dual_path_norm_in_ref(x, gamma, beta, seq_dim, 1e-5), 2),
            "dual_path_out": (lambda: dual_path.dual_path_out(z, bias, residual, seq_dim=seq_dim),
                              lambda: dual_path.dual_path_out_ref(z, bias, residual, seq_dim),
                              3)}
        for name, (kernel, plain, passes) in calls.items():
            check(f"{name} seq_dim={seq_dim}", kernel(), plain(), dtype)
            rows_out.append(row(name, {"x": list(DUAL_PATH_BLOCK),
                                       "along": "T" if seq_dim == 2 else "F", "dtype": "bfloat16"},
                                event_ms(kernel), event_ms(plain, reps=3, warmup=1),
                                *bound(passes * numel * item)))
        del x, z, residual
    return rows_out


def dual_path_windows(gen):
    """The LSTM or GRU DualPathRNN's window pass, one launch along T and F
    at TF-GridNet's B=128 bfloat16 block, beside the general route's norm,
    permute, unfold and the copy cuDNN made of the permuted windows."""
    import torch

    from rtfs_net_tpu_torch.ops.conv import unfold_1d
    from rtfs_net_tpu_torch.ops.kernels import dual_path
    from rtfs_net_tpu_torch.ops.normalizations import LayerNormalization4D

    dtype, item, k, rows_out = torch.bfloat16, 2, GRID_K, []
    C = GRID_BLOCK[1]
    norm = LayerNormalization4D(C).cuda()
    for seq_dim in (2, 3):
        x = (3 * torch.randn(GRID_BLOCK, generator=gen, device="cuda") + 1).to(dtype)
        gamma = 1 + 0.1 * torch.randn(C, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(C, generator=gen, device="cuda")
        with torch.no_grad():
            norm.gamma.copy_(gamma.view(norm.gamma.shape))
            norm.beta.copy_(beta.view(norm.beta.shape))

        def library():
            xx = x.transpose(-2, -1) if seq_dim == 3 else x
            B, C_, S, O = xx.shape
            y = norm(xx).permute(0, 3, 1, 2).reshape(B * O, C_, S)
            return unfold_1d(y, k).permute(2, 0, 1).contiguous()

        def kernel():
            return dual_path.dual_path_windows_in(x, gamma, beta, seq_dim=seq_dim, k=k, eps=1e-5)

        def plain():
            return dual_path.dual_path_windows_in_ref(x, gamma, beta, seq_dim, k, 1e-5)

        with torch.no_grad():
            check(f"dual_path_windows_in seq_dim={seq_dim}", kernel(), plain(), dtype)
            moved = (x.numel() + math.prod(dual_path.window_shape(GRID_BLOCK, seq_dim, k))) * item
            rows_out.append(row("dual_path_windows_in", {"x": list(GRID_BLOCK), "k": k,
                                                         "along": "T" if seq_dim == 2 else "F",
                                                         "dtype": "bfloat16"},
                                event_ms(kernel), event_ms(plain, reps=3, warmup=1),
                                *bound(moved), library_ms=event_ms(library, reps=3, warmup=1)))
        del x
        torch.cuda.empty_cache()
    return rows_out


# op -> its timing at its path's shapes
TIMES = {"sru_stack_layer": k1, "sru_train_forward": k2, "dw_conv2d_same": k3,
         "sru_direction": k4, "dual_path_norm_in": dual_path_layout,
         "dual_path_windows_in": dual_path_windows}
# ops timed with another one: K2's backward with its forward, the layout
# pass out of K1's layout with the pass into it
TIMED_WITH = {"sru_train_backward": "sru_train_forward", "dual_path_out": "dual_path_norm_in"}


def path_launches():
    """Each kernel's launches, by label, in one call of each path the rows
    sum over, counted by ``bench.launched`` from just before the call to
    just after it, with seed-0 weights: RTFS-Net-4's B=128 bfloat16
    serving forward from lip embeddings, its float32 train steps at
    ``TRAIN_BATCHES`` and its B=16 float32 forward on the ``"pallas"``
    route; and TF-GridNet's B=2 bfloat16 forward (the window pass)."""
    import torch

    from rtfs_net_tpu_torch.bench import launched
    from rtfs_net_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from rtfs_net_tpu_torch.models import build_model
    from rtfs_net_tpu_torch.ops import rnn
    from rtfs_net_tpu_torch.scripts import load_config
    from rtfs_net_tpu_torch.system import System, make_optimizer
    from rtfs_net_tpu_torch.utils.separator import separate

    gen = torch.Generator(device="cuda").manual_seed(1)

    def batch(B, conf):
        mix = torch.randn((B, 32000), generator=gen, device="cuda")
        emb = torch.randn((B, conf["audionet"]["pretrained_vout_chan"], 50), generator=gen,
                          device="cuda")
        return mix, mix[:, None], 0.1 * emb

    def serve(model, conf, B, dtype):
        mix, _, emb = batch(B, conf)
        with torch.no_grad():
            return launched(lambda: separate(model, mix, emb, dtype=dtype))[1]

    rtfs4, grid = load_config("lrs2_RTFSNet_4_layer"), load_config("lrs2_TFGridNet_6_layer")
    model = build_model(rtfs4, device="cuda")
    paths = {f"serving_b{BIG_BATCH}": serve(model, rtfs4, BIG_BATCH, torch.bfloat16)}
    backend, rnn.DEFAULT_SRU_BACKEND = rnn.DEFAULT_SRU_BACKEND, "pallas"
    try:
        paths[f"pallas_b{PALLAS_BATCH}"] = serve(model, rtfs4, PALLAS_BATCH, torch.float32)
    finally:
        rnn.DEFAULT_SRU_BACKEND = backend
    system = System(model, make_optimizer(model.parameters(), **rtfs4["optim"]),
                    {"train": PITLossWrapper(pairwise_neg_snr)})
    for B in TRAIN_BATCHES:
        step = batch(B, rtfs4)
        paths[f"train_b{B}"] = launched(lambda: system.train_step(step))[1]
    del system, model
    torch.cuda.empty_cache()
    paths[f"tfgridnet_b{GRID_BATCH}"] = serve(build_model(grid, device="cuda"), grid, GRID_BATCH,
                                              torch.bfloat16)
    torch.cuda.empty_cache()
    return paths


def kernel_rows(gen):
    """Every row of ``ops.kernels.KERNELS`` timed at its path's shapes
    (``TIMES``; an op of ``TIMED_WITH`` with the op it names)."""
    import torch

    from rtfs_net_tpu_torch.ops.kernels import KERNELS

    rows = []
    for kernel in KERNELS:
        timed = TIMED_WITH.get(kernel.op, kernel.op)
        if timed not in TIMES:
            raise KeyError(f"{kernel.op}: no shapes in torch_kernel_times.TIMES")
        if timed == kernel.op:
            rows += TIMES[kernel.op](gen)
            torch.cuda.empty_cache()
    return rows


def check_launches(rows, paths):
    """Fails unless every row summed over a path's launches (``path``)
    counted as many as that path's call made."""
    from rtfs_net_tpu_torch.ops.kernels import KERNELS

    label = {k.op: k.label for k in KERNELS}
    for r in rows:
        if "path" in r and r["launches"] != paths[r["path"]][label[r["kernel"]]]:
            raise RuntimeError(f"{r['kernel']}: summed {r['launches']} launches, "
                               f"{r['path']} makes {paths[r['path']][label[r['kernel']]]}")


def card_name():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rows = kernel_rows(torch.Generator(device="cuda").manual_seed(0))
    check_launches(rows, path_launches())
    for r in rows:
        print(json.dumps(r))
    print(card_name())
    return 0


if __name__ == "__main__":
    sys.exit(main())
