#!/usr/bin/env python3
"""Per-launch device times of the port's kernels beside another tree's, on
one CUDA card, at every main-path shape and dtype.

    python3 scripts/torch_kernel_ab.py --parent DIR [--kernels k1,k4] [--rounds 3]

``--kernels`` names the kernels to compare (default ``k2,k3``). DIR is a
checkout of the port whose sources of those kernels have the C interface of
their first CUDA versions, the parent of their redesign: no band or ring
arguments in ``csrc/dw_conv.cu`` (K3) and ``sru_train.cu`` (K2), no ring
depth in ``sru_stack_layer.cu`` (K1) and ``sru_direction.cu`` (K4). Both
trees' sources are built with the same ``nvcc`` flags and loaded into one
process. At each shape the two kernels get the same inputs, rotated past the
50 MB L2 so every launch reads HBM, and are timed in turns (parent, change,
change, parent) for ``--rounds`` rounds; each turn is ``chip_smoke.event_ms``
over 20 launches, device time only. Shapes:

- K1 ``sru_stack_layer``: (L, rows) = (57, 125 B) and (118, 64 B), k = 3
  and 4, two directions of H = 32, for B = 1, 4, 16 in float32 and
  bfloat16 and B = 128 in bfloat16;
- K2 ``sru_train`` forward and backward: the same (L, rows) for B = 4 and
  16, k = 3 and 4;
- K3 ``dw_conv2d_same``: (B, 64, 251, 129) and (B, 64, 125, 64) for B = 16
  and 128, 4x4 kernel, pads (1, 2);
- K4 ``sru_direction``: the (L, rows) of K1 for B = 1, 4, 16, H = 32, both
  directions, on slices of one (L, rows, 4, 64) projection.

Prints one JSON line per (kernel, shape, dtype) with both medians and
spreads, the bytes bound at 3.35 TB/s and each median's share of it, then
the sums over a forward's 32 K1, 40 K3 (12 + 28) and 64 K4 launches and a
train step's K2 launches (64 forward, 32 backward), and the card's name
and power limit.
"""
import argparse
import ctypes
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

REPS = 20


SOURCES = {"k1": "sru_stack_layer", "k2": "sru_train", "k3": "dw_conv", "k4": "sru_direction"}


def parent_kernels(parent_dir, build_dir, kernels):
    """The parent tree's entry points of ``kernels``, built in parallel with
    this tree's flags: {"k1": fn, "k2": (forward, backward), "k3": fn, "k4": fn}."""
    from rtfs_net_tpu_torch.ops.kernels import build

    procs = {}
    for kernel in kernels:
        name = SOURCES[kernel]
        out = os.path.join(build_dir, f"parent_{name}.so")
        src = os.path.join(parent_dir, "rtfs_net_tpu_torch", "csrc", f"{name}.cu")
        procs[kernel] = (out, subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o", out, src]))
    libs = {}
    for kernel, (out, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed on the parent's {SOURCES[kernel]}.cu")
        libs[kernel] = ctypes.CDLL(out)
    fns, void, i32 = {}, ctypes.c_void_p, ctypes.c_int
    if "k1" in libs:
        fns["k1"] = libs["k1"].rtfs_sru_stack_layer
        fns["k1"].argtypes = [void] * 5 + [i32] * 6 + [void]
    if "k2" in libs:
        fwd, bwd = libs["k2"].rtfs_sru_train_forward, libs["k2"].rtfs_sru_train_backward
        fwd.argtypes = [void] * 6 + [i32] * 6 + [void]
        bwd.argtypes = [void] * 9 + [i32] * 6 + [void]
        fns["k2"] = (fwd, bwd)
    if "k3" in libs:
        fns["k3"] = libs["k3"].rtfs_dw_conv2d_same
        fns["k3"].argtypes = [void] * 3 + [i32] * 9 + [void]
    if "k4" in libs:
        fns["k4"] = libs["k4"].rtfs_sru_direction
        fns["k4"].argtypes = ([void] * 4 + [ctypes.POINTER(ctypes.c_int64)] + [void] * 5
                              + [i32] * 5 + [void])
    for fn in fns.values():
        for f in fn if isinstance(fn, tuple) else (fn,):
            f.restype = ctypes.c_int
    return fns


def turns(fns, rounds):
    """Times of (parent, change) in the order P, C, C, P per round."""
    times = {"parent": [], "change": []}
    for _ in range(rounds):
        for who in ("parent", "change", "change", "parent"):
            times[who].append(cs.event_ms(fns[who], reps=REPS))
    return times


def row(kind, shape, dtype, times, nbytes):
    """One ``ab`` line: each side's median, its spread ((max - min) / median
    over its turns), the bound and each median's share of it."""
    bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
    med = {who: statistics.median(t) for who, t in times.items()}
    line = {"kernel": kind, "shape": shape, "dtype": cs.dtype_name(dtype),
            "parent_ms": med["parent"], "change_ms": med["change"], "bound_ms": bound,
            "parent_share": bound / med["parent"], "change_share": bound / med["change"],
            **{f"{who}_spread": (max(t) - min(t)) / med[who] for who, t in times.items()}}
    print("ab " + json.dumps(line))
    return line


def ab_sru_stack_layer(parent_fn, rounds, gen):
    import torch

    from rtfs_net_tpu_torch.ops.kernels import sru as ksru

    stream = torch.cuda.current_stream().cuda_stream
    O = 2 * cs.H
    out = []
    for B in cs.SERVE_BATCHES + (cs.BIG_BATCH,):
        for (L, per_utt), k in itertools.product(cs.SRU_PASSES, (4, 3)):
            rows = per_utt * B
            for dtype in ((torch.bfloat16,) if B == cs.BIG_BATCH
                          else (torch.float32, torch.bfloat16)):
                item = torch.tensor([], dtype=dtype).element_size()
                in_bytes = (k * O + (O if k == 3 else 0)) * L * rows * item
                copies = 1 + int(100e6 // in_bytes)
                sets, v, b = cs.sru_inputs(L, rows, k, dtype, gen, copies)
                h = torch.empty((L, O, rows), dtype=dtype, device="cuda")
                it = itertools.count()

                def parent(i):
                    u, sk = sets[i]
                    err = parent_fn(u.data_ptr(), None if sk is None else sk.data_ptr(),
                                    v.data_ptr(), b.data_ptr(), h.data_ptr(), L, rows, cs.H, k,
                                    2, 0 if dtype == torch.float32 else 1, stream)
                    if err:
                        cs.fail(f"parent sru_stack_layer: CUDA error {err}")

                def change(i):
                    u, sk = sets[i]
                    return ksru.sru_stack_layer(u, sk, v, b, H=cs.H, k=k, ndir=2)

                parent(0)
                torch.cuda.synchronize()
                ok, err = cs.tolerance_ok(h, change(0), dtype)
                if not ok:
                    cs.fail(f"sru_stack_layer L={L} rows={rows} k={k} {dtype}: parent and "
                            f"change differ by {err}")
                out.append(row("sru_stack_layer", (B, L, rows, k), dtype,
                               turns({"parent": lambda: parent(next(it) % copies),
                                      "change": lambda: change(next(it) % copies)}, rounds),
                               in_bytes + O * L * rows * item))
                del sets, h
    return out


def ab_sru_direction(parent_fn, rounds, gen):
    import torch

    from rtfs_net_tpu_torch.ops.kernels import sru_direction as kdir

    stream = torch.cuda.current_stream().cuda_stream
    O = 2 * cs.H
    out = []
    for B, (L, per_utt) in itertools.product(cs.SERVE_BATCHES, cs.SRU_PASSES):
        rows = per_utt * B
        for dtype, reverse in itertools.product((torch.float32, torch.bfloat16), (False, True)):
            item = torch.tensor([], dtype=dtype).element_size()
            copies = 1 + int(100e6 // (4 * L * rows * cs.H * item))
            sl = slice(cs.H, O) if reverse else slice(0, cs.H)
            ops = [[u[:, :, c, sl] for c in range(4)] for u in (
                torch.randn((L, rows, 4, O), generator=gen, device="cuda").to(dtype)
                for _ in range(copies))]
            gates = [0.5 * torch.randn(cs.H, generator=gen, device="cuda") for _ in range(4)]
            strides = (ctypes.c_int64 * 8)(*(st for t in ops[0] for st in t.stride()[:2]))
            h = torch.empty((L, rows, cs.H), dtype=dtype, device="cuda")
            it = itertools.count()

            def parent(i):
                err = parent_fn(*(t.data_ptr() for t in ops[i]), strides,
                                *(g.data_ptr() for g in gates), h.data_ptr(), L, rows, cs.H,
                                int(reverse), 0 if dtype == torch.float32 else 1, stream)
                if err:
                    cs.fail(f"parent sru_direction: CUDA error {err}")

            def change(i):
                return kdir.sru_direction(*ops[i], *gates, reverse=reverse)

            parent(0)
            torch.cuda.synchronize()
            ok, err = cs.tolerance_ok(h, change(0), dtype)
            if not ok:
                cs.fail(f"sru_direction L={L} rows={rows} reverse={reverse} {dtype}: parent "
                        f"and change differ by {err}")
            out.append(row("sru_direction", (B, L, rows, int(reverse)), dtype,
                           turns({"parent": lambda: parent(next(it) % copies),
                                  "change": lambda: change(next(it) % copies)}, rounds),
                           5 * L * rows * cs.H * item))
            del ops, h
    return out


def ab_dw_conv(dw_parent, rounds, gen):
    import torch

    from rtfs_net_tpu_torch.ops.kernels import dw_conv as kdw

    stream = torch.cuda.current_stream().cuda_stream
    out = []
    for B in (16, cs.BIG_BATCH):
        for T, Fq in cs.DW_PLANES:
            for dtype in (torch.float32, torch.bfloat16):
                shape = (B, cs.CHANNELS, T, Fq)
                item = torch.tensor([], dtype=dtype).element_size()
                n = math.prod(shape)
                copies = 1 + int(100e6 // (n * item))
                xs = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                      for _ in range(copies)]
                w = torch.randn((cs.CHANNELS, 1, *cs.DW_KERNEL), generator=gen, device="cuda")
                wf = w.reshape(cs.CHANNELS, -1).contiguous()
                ys = torch.empty_like(xs[0])
                it = itertools.count()

                def parent():
                    x = xs[next(it) % copies]
                    err = dw_parent(x.data_ptr(), wf.data_ptr(), ys.data_ptr(), B * cs.CHANNELS,
                                    cs.CHANNELS, T, Fq, *cs.DW_KERNEL, cs.DW_PADS[0][0],
                                    cs.DW_PADS[1][0], 0 if dtype == torch.float32 else 1, stream)
                    if err:
                        cs.fail(f"parent dw_conv: CUDA error {err}")

                def change():
                    kdw.dw_conv2d_same(xs[next(it) % copies], w, cs.DW_PADS)

                parent()
                torch.cuda.synchronize()
                ok, err = cs.tolerance_ok(ys, kdw.dw_conv2d_same(xs[0], w, cs.DW_PADS), dtype)
                if not ok:
                    cs.fail(f"dw_conv {shape} {dtype}: parent and change differ by {err}")
                out.append(row("dw_conv2d_same", shape, dtype,
                               turns({"parent": parent, "change": change}, rounds),
                               2 * n * item))
                del xs, ys
    return out


def ab_sru_train(fwd_parent, bwd_parent, rounds, gen):
    import torch

    from rtfs_net_tpu_torch.ops.kernels import sru_train as ktrain

    stream = torch.cuda.current_stream().cuda_stream
    O = 2 * cs.H
    out = []
    for L, rows in cs.TRAIN_SHAPES:
        for k in (4, 3):
            for dtype in (torch.float32, torch.bfloat16):
                item = torch.tensor([], dtype=dtype).element_size()
                skip_ch = O if k == 3 else 0
                fwd_bytes = (k * O + skip_ch + 2 * O) * L * rows * item
                bwd_bytes = ((k * O + 2 * O + skip_ch) + (k * O + skip_ch)) * L * rows * item \
                    + 4 * O * rows * 4
                copies = 1 + int(100e6 // ((k * O + 2 * O + skip_ch) * L * rows * item))
                sets, v, b = cs.sru_inputs(L, rows, k, dtype, gen, copies)
                kw = dict(H=cs.H, k=k, ndir=2)
                sets = [(u, sk, torch.randn((L, O, rows), generator=gen, device="cuda").to(dtype),
                         ktrain.sru_train_forward(u, sk, v, b, **kw)[1]) for u, sk in sets]
                h = torch.empty((L, O, rows), dtype=dtype, device="cuda")
                c_out, du = torch.empty_like(h), torch.empty_like(sets[0][0])
                dskip = torch.empty_like(h) if k == 3 else None
                part = torch.empty((4, O, rows), device="cuda")
                code = 0 if dtype == torch.float32 else 1
                it = itertools.count()

                def ptr(t):
                    return None if t is None else t.data_ptr()

                def parent_fwd(i):
                    u, sk, _, _ = sets[i]
                    err = fwd_parent(u.data_ptr(), ptr(sk), v.data_ptr(), b.data_ptr(),
                                     h.data_ptr(), c_out.data_ptr(), L, rows, cs.H, k, 2, code,
                                     stream)
                    if err:
                        cs.fail(f"parent sru_train forward: CUDA error {err}")

                def parent_bwd(i):
                    u, sk, dh, c = sets[i]
                    err = bwd_parent(u.data_ptr(), ptr(sk), c.data_ptr(), v.data_ptr(),
                                     b.data_ptr(), dh.data_ptr(), du.data_ptr(), ptr(dskip),
                                     part.data_ptr(), L, rows, cs.H, k, 2, code, stream)
                    if err:
                        cs.fail(f"parent sru_train backward: CUDA error {err}")

                def change_fwd(i):
                    u, sk, _, _ = sets[i]
                    return ktrain.sru_train_forward(u, sk, v, b, **kw)

                def change_bwd(i):
                    u, sk, dh, c = sets[i]
                    return ktrain.sru_train_backward(u, sk, c, v, b, dh, **kw)

                parent_fwd(0)
                parent_bwd(0)
                torch.cuda.synchronize()
                for name, a, z in (("h", h, change_fwd(0)[0]), ("du", du, change_bwd(0)[0])):
                    ok, err = cs.tolerance_ok(a, z, dtype)
                    if not ok:
                        cs.fail(f"sru_train {name} L={L} rows={rows} k={k} {dtype}: "
                                f"parent and change differ by {err}")

                def rotating(fn):
                    return lambda: fn(next(it) % copies)

                shape = (L, rows, k)
                out.append(row("sru_train_forward", shape, dtype,
                               turns({"parent": rotating(parent_fwd),
                                      "change": rotating(change_fwd)}, rounds),
                               fwd_bytes))
                out.append(row("sru_train_backward", shape, dtype,
                               turns({"parent": rotating(parent_bwd),
                                      "change": rotating(change_bwd)}, rounds),
                               bwd_bytes))
                del sets
    return out


def sums(lines):
    """Per-forward K1, K3 and K4 and per-step K2 sums of the medians and bounds."""
    calls = {(T, Fq): n * cs.REPEATS for (T, Fq), n in cs.DW_PLANES.items()}
    acc = {}
    for ln in lines:
        dtype = ln["dtype"]
        if ln["kernel"] == "sru_stack_layer":
            B, _, _, k = ln["shape"]
            key, n = f"K1 per forward B={B} {dtype} (32 launches)", cs.REPEATS * cs.SRU_LAYERS[k]
        elif ln["kernel"] == "sru_direction":
            B = ln["shape"][0]
            key = f"K4 per forward B={B} {dtype} (64 launches)"
            n = cs.REPEATS * sum(cs.SRU_LAYERS.values())  # per direction and pass
        elif ln["kernel"] == "dw_conv2d_same":
            B, _, T, Fq = ln["shape"]
            key, n = f"K3 per forward B={B} {dtype} (40 launches)", calls[(T, Fq)]
        else:
            L, rows, k = ln["shape"]
            B = rows // (125 if L == 57 else 64)
            which = ln["kernel"].rsplit("_", 1)[1]
            n = cs.REPEATS * cs.SRU_LAYERS[k] * (2 if which == "forward" else 1)
            key = f"K2 {which} per step B={B} {dtype} ({64 if which == 'forward' else 32} launches)"
        s = acc.setdefault(key, {"parent_ms": 0.0, "change_ms": 0.0, "bound_ms": 0.0})
        for field in s:
            s[field] += n * ln[field]
    for key, s in acc.items():
        print("ab sum " + json.dumps({"what": key, **s,
                                      "parent_share": s["bound_ms"] / s["parent_ms"],
                                      "change_share": s["bound_ms"] / s["change_ms"]}))


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="checkout of the parent tree")
    ap.add_argument("--kernels", default="k2,k3",
                    help="comma-separated kernels to compare: k1, k2, k3, k4")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not kernels or set(kernels) - set(SOURCES):
        ap.error(f"--kernels takes a comma-separated subset of {sorted(SOURCES)}")
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    from rtfs_net_tpu_torch.ops.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        parents = parent_kernels(os.path.abspath(args.parent), tmp, kernels)
        gen = torch.Generator(device="cuda").manual_seed(11)
        lines = []
        for kernel in kernels:
            if kernel == "k1":
                lines += ab_sru_stack_layer(parents["k1"], args.rounds, gen)
            elif kernel == "k2":
                lines += ab_sru_train(*parents["k2"], args.rounds, gen)
            elif kernel == "k3":
                lines += ab_dw_conv(parents["k3"], args.rounds, gen)
            else:
                lines += ab_sru_direction(parents["k4"], args.rounds, gen)
    sums(lines)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
