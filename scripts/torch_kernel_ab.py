#!/usr/bin/env python3
"""Per-launch device times of the port's K2 and K3 kernels beside another
tree's, on one CUDA card, at every main-path shape and dtype.

    python3 scripts/torch_kernel_ab.py --parent DIR [--rounds 3]

DIR is a checkout of the port whose ``rtfs_net_tpu_torch/csrc/dw_conv.cu``
and ``sru_train.cu`` have the C interface of the first CUDA versions of the
two kernels (no band or ring arguments: the parent of their redesign). Both
trees' sources are built with the same ``nvcc`` flags and loaded into one
process. At each shape the two kernels get the same inputs, rotated past the
50 MB L2 so every launch reads HBM, and are timed in turns (parent, change,
change, parent) for ``--rounds`` rounds; each turn is ``chip_smoke.event_ms``
over 20 launches, device time only. Shapes:

- K3 ``dw_conv2d_same``: (B, 64, 251, 129) and (B, 64, 125, 64) for B = 16
  and 128, 4x4 kernel, pads (1, 2);
- K2 ``sru_train`` forward and backward: (L, rows) = (57, 125 B) and
  (118, 64 B) for B = 4 and 16, k = 3 and 4, two directions of H = 32.

Prints one JSON line per (kernel, shape, dtype) with both medians, the bytes
bound at 3.35 TB/s and each one's share of it, then the sums over a
forward's 40 K3 launches (12 + 28) and a train step's K2 launches (64
forward, 32 backward), and the card's name and power limit.
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


def parent_kernels(parent_dir, build_dir):
    """The parent tree's K3 and K2 entry points, built with this tree's flags."""
    from rtfs_net_tpu_torch.ops.kernels import build

    libs = {}
    for name in ("dw_conv", "sru_train"):
        out = os.path.join(build_dir, f"parent_{name}.so")
        src = os.path.join(parent_dir, "rtfs_net_tpu_torch", "csrc", f"{name}.cu")
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", out, src], check=True)
        libs[name] = ctypes.CDLL(out)
    dw = libs["dw_conv"].rtfs_dw_conv2d_same
    dw.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fwd = libs["sru_train"].rtfs_sru_train_forward
    bwd = libs["sru_train"].rtfs_sru_train_backward
    fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    for fn in (dw, fwd, bwd):
        fn.restype = ctypes.c_int
    return dw, fwd, bwd


def turns(fns, rounds):
    """Medians of (parent, change) timed in the order P, C, C, P per round."""
    times = {"parent": [], "change": []}
    for _ in range(rounds):
        for who in ("parent", "change", "change", "parent"):
            times[who].append(cs.event_ms(fns[who], reps=REPS))
    return {who: statistics.median(t) for who, t in times.items()}


def row(kind, shape, dtype, med, nbytes):
    bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
    line = {"kernel": kind, "shape": shape, "dtype": cs.dtype_name(dtype),
            "parent_ms": med["parent"], "change_ms": med["change"], "bound_ms": bound,
            "parent_share": bound / med["parent"], "change_share": bound / med["change"]}
    print("ab " + json.dumps(line))
    return line


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
    """Per-forward K3 and per-step K2 sums of the medians and bounds."""
    calls = {(T, Fq): n * cs.REPEATS for (T, Fq), n in cs.DW_PLANES.items()}
    acc = {}
    for ln in lines:
        dtype = ln["dtype"]
        if ln["kernel"] == "dw_conv2d_same":
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
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
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
        dw, fwd, bwd = parent_kernels(os.path.abspath(args.parent), tmp)
        gen = torch.Generator(device="cuda").manual_seed(11)
        lines = ab_dw_conv(dw, args.rounds, gen) + ab_sru_train(fwd, bwd, args.rounds, gen)
    sums(lines)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
