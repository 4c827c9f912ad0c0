"""Stride-1 depthwise 2-D convolution with an output of the input's size:
the CUDA kernel ``csrc/dw_conv.cu``, its plain PyTorch version, the
``torch.autograd.Function`` around them, and the gate that says which
convs it takes.

Port of ``rtfs_net_tpu/ops/pallas/dw_conv.py:dw_conv2d_same``, same
arguments: x (B, C, T, F); w (C, 1, k_t, k_f); ``pads = ((lo_t, hi_t),
(lo_f, hi_f))`` explicit zero padding with lo + hi = k - 1 on each axis
(torch's "same" for an even kernel is the asymmetric ((k-1)//2, k//2)).
Taps are summed in float32 from float32 weights; the output has x's dtype
and no bias. The kernel handles the edges itself, so no padded copy of x
is made. The kernel is the registered op ``rtfs::dw_conv2d_same``
(``registry.py``), with the pads flat: ``dw_conv2d_same_cuda`` launches it,
``dw_conv2d_same_ref`` is its CPU implementation.

Gradients as the JAX function's ``custom_vjp`` has them: dx is the same
stencil on dy with the flipped kernel under pads (k-1-lo, k-1-hi), so it
runs through the kernel too; dw is the per-channel correlation of x with
dy in float32, through PyTorch's convolution backward.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build, registry

SOURCE = "dw_conv.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
Pads = Tuple[Tuple[int, int], Tuple[int, int]]

# launches of the CUDA kernel since the last reset (set it to 0 to reset):
# forward calls and, under autograd, the dx of each backward
launches = 0

# the band kernel's geometry (csrc/dw_conv.cu)
STRIP = 8             # output rows per thread task
TARGET_THREADS = 256  # threads per block the plan aims at: of 64, 128 and
                      # 256, the one faster than the first K3 at every
                      # main-path shape on an H100
MAX_THREADS = 256
MAX_SMEM = 232448     # an H100 block's dynamic shared memory, bytes


def columns(itemsize: int) -> int:
    """Adjacent output columns per thread task (``cols`` in the source)."""
    return 5 if itemsize == 4 else 6


class BandPlan(NamedTuple):
    rows: int     # R, output rows per band; 0 takes the generic kernel
    threads: int  # per block
    smem: int     # dynamic shared-memory bytes per block


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


@functools.lru_cache(maxsize=None)
def band_plan(T: int, Fq: int, k_t: int, k_f: int, itemsize: int) -> BandPlan:
    """The band kernel's launch geometry for a (.., T, F) plane. A thread
    task is ``columns`` adjacent outputs of ``STRIP`` rows; a band is s
    strips of R = STRIP·s rows, with one thread per task, s as large as
    ``TARGET_THREADS`` threads allow (and no larger than T needs). Shared memory
    holds two buffers of R + k_t - 1 input rows (this band's and the
    next's) and one of R output rows, each with a 16-byte chunk of slack at
    both ends (``in_elems`` and ``out_elems`` in the source); s is halved
    until that fits. k outside 2..5, or a one-strip band that does not fit,
    takes the generic kernel (rows 0)."""
    if not (2 <= k_t <= 5 and 2 <= k_f <= 5):
        return BandPlan(0, 128, 0)
    vec = 16 // itemsize
    groups = -(-Fq // columns(itemsize))
    strips = max(1, min(TARGET_THREADS // groups, -(-T // STRIP)))
    while True:
        R = STRIP * strips
        in_elems = _round_up((R + k_t - 1) * Fq + 2 * vec, vec)
        out_elems = _round_up(R * Fq + 2 * vec, vec)
        smem = (2 * in_elems + out_elems) * itemsize
        if smem <= MAX_SMEM:
            return BandPlan(R, min(MAX_THREADS, _round_up(strips * groups, 32)), smem)
        if strips == 1:
            return BandPlan(0, 128, 0)
        strips //= 2


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load(SOURCE).rtfs_dw_conv2d_same
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dw_conv_supported(x_shape: Sequence[int], kernel, stride, dilation, groups: int,
                      in_chan: int, out_chan: int, ndim: int, pads=None) -> bool:
    """Which convs the kernel takes (``pallas_dw_supported`` without the
    TPU's batch, halo and VMEM limits): 2-D depthwise, stride 1, dilation
    1, every k > 1, padding that keeps the size, T and F at least k."""
    if ndim != 2 or len(x_shape) != 4 or groups != in_chan or out_chan != in_chan:
        return False
    if any(s != 1 for s in stride) or any(d != 1 for d in dilation):
        return False
    if any(k <= 1 for k in kernel):
        return False
    if pads is not None and any(lo < 0 or hi < 0 or lo + hi != k - 1
                                for (lo, hi), k in zip(pads, kernel)):
        return False
    _, _, T, Fq = x_shape
    return T >= max(kernel) and Fq >= max(kernel)


def _check(x, w, pads: Pads):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, T, F), got {tuple(x.shape)}")
    B, C, T, Fq = x.shape
    if w.dim() != 4 or w.shape[0] != C or w.shape[1] != 1:
        raise ValueError(f"w must be ({C}, 1, k_t, k_f), got {tuple(w.shape)}")
    kernel = (int(w.shape[2]), int(w.shape[3]))
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.device != x.device:
        raise ValueError("w must be on x's device")
    pads = tuple((int(lo), int(hi)) for lo, hi in pads)
    if len(pads) != 2 or any(lo < 0 or hi < 0 or lo + hi != k - 1
                             for (lo, hi), k in zip(pads, kernel)):
        raise ValueError(f"pads {pads} do not keep the size under kernel {kernel}")
    if B * C == 0 or T * Fq == 0:
        raise ValueError(f"x is empty: {tuple(x.shape)}")
    return pads


def _stencil(x, w, pads: Pads):
    """The forward on checked inputs, outside autograd: the registered op
    ``rtfs::dw_conv2d_same``, whose pads are the flat (lo_t, hi_t, lo_f,
    hi_f)."""
    return torch.ops.rtfs.dw_conv2d_same(x, w, [p for lo_hi in pads for p in lo_hi])


def dw_conv2d_same_cuda(x, w, pads: Sequence[int]):
    """The op's CUDA implementation: one launch of the kernel."""
    global launches
    fn = _fn()
    B, C, T, Fq = x.shape
    k_t, k_f = w.shape[2], w.shape[3]
    x = x.contiguous()
    wf = w.detach().float().reshape(C, k_t * k_f).contiguous()
    y = torch.empty_like(x)
    plan = band_plan(T, Fq, k_t, k_f, x.element_size())
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), wf.data_ptr(), y.data_ptr(), B * C, C, T, Fq, k_t, k_f,
                 pads[0], pads[2], plan.rows, plan.threads, _DTYPES[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dw_conv2d_same kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def _dw_conv2d_same_cpu(x, w, pads):
    return dw_conv2d_same_ref(x, w, ((pads[0], pads[1]), (pads[2], pads[3])))


def _dw_conv2d_same_fake(x, w, pads):
    return x.new_empty(x.shape)


def dw_conv2d_same_ref(x, w, pads: Pads):
    """Plain PyTorch version: tap by tap, each a shifted slice of the
    zero-padded input times its weight, summed in float32 in the order
    (dt, df); the output has x's dtype."""
    _, _, T, Fq = x.shape
    (lo_t, hi_t), (lo_f, hi_f) = pads
    xp = F.pad(x.float(), (lo_f, hi_f, lo_t, hi_t))
    wf = w.float()
    acc = None
    for dt in range(w.shape[2]):
        for df in range(w.shape[3]):
            term = xp[:, :, dt:dt + T, df:df + Fq] * wf[None, :, 0, dt, df, None, None]
            acc = term if acc is None else acc + term
    return acc.to(x.dtype)


class DwConvFunction(torch.autograd.Function):
    """y = dw_conv2d_same(x, w), differentiable in both."""

    @staticmethod
    def forward(ctx, x, w, pads):
        ctx.save_for_backward(x, w)
        ctx.pads = pads
        return _stencil(x, w, pads)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        (lo_t, hi_t), (lo_f, hi_f) = ctx.pads
        k_t, k_f = w.shape[2], w.shape[3]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # correlate dy with the flipped kernel under the transposed padding
            dx_pads = ((k_t - 1 - lo_t, k_t - 1 - hi_t), (k_f - 1 - lo_f, k_f - 1 - hi_f))
            dx = _stencil(dy.to(x.dtype), w.flip(2, 3), dx_pads)
        if ctx.needs_input_grad[1]:
            # dw[c, 0, dt, df] = sum_{b,t,f} x[b, c, t+dt-lo_t, f+df-lo_f] * dy[b, c, t, f]
            xp = F.pad(x.float(), (lo_f, hi_f, lo_t, hi_t))
            dw = torch.nn.grad.conv2d_weight(xp, w.shape, dy.float(),
                                             groups=x.shape[1]).to(w.dtype)
        return dx, dw, None


def dw_conv2d_same(x, w, pads: Pads):
    """CUDA tensors launch the kernel; CPU tensors take the plain version
    (the dispatcher picks, by the op's registered implementations).
    Under autograd the call goes through ``DwConvFunction``; without, the
    Function is skipped."""
    pads = _check(x, w, pads)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return DwConvFunction.apply(x, w, pads)
    return _stencil(x, w, pads)


registry.define_op("dw_conv2d_same(Tensor x, Tensor w, int[] pads) -> Tensor",
                   dw_conv2d_same_cuda, _dw_conv2d_same_cpu, _dw_conv2d_same_fake)
