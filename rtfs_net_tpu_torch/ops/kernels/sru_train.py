"""One bidirectional SRU layer's recurrence for training: the CUDA kernels
``csrc/sru_train.cu`` (forward and backward), their plain PyTorch
versions, and the ``torch.autograd.Function`` that joins them.

Port of ``rtfs_net_tpu/ops/pallas/sru_train.py:sru_direction_train`` in
the layout of the inference kernel (``sru.py``): u (L, k·O, rows) with
chunk-major columns ``c*O + d*H + h``; skip (L, O, rows) when k == 3
(when k == 4 u's 4th chunk is the highway and its gradient is du's 4th
chunk); v, b the layer's (2·O,) gate vectors. One call covers both
directions. The carry and the math are float32; h, c and the input
gradients are stored in u's dtype, the gate gradients in float32.

The kernels are the registered ops ``rtfs::sru_train_forward`` and
``rtfs::sru_train_backward`` (``registry.py``): ``sru_train_forward_cuda``
and ``sru_train_backward_cuda`` launch them, ``sru_train_forward_ref`` and
``sru_train_backward_ref`` are their CPU implementations.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, registry
from .sru import SMEM_PER_SM, SMS, THREADS, _aligned, _check, _DTYPES, _sms

SOURCE = "sru_train.cu"

# launches of the CUDA kernels since the last reset (set them to 0 to reset)
forward_launches = 0
backward_launches = 0

WARPS = THREADS // 32  # per block; the grid is (ceil(rows / THREADS), O)
# bytes of loads each SM should keep in flight: 3.35 TB/s over 132 SMs is
# ~25 KB per us, and a loaded HBM answers in one to two us
IN_FLIGHT_BYTES = 64 * 1024
DEPTHS = {"forward": (8, 16, 32), "backward": (8, 16)}
OPERANDS = {"forward": 4, "backward": 6}  # copied per step: u0, u1, u2, skip[, dh, c]


@functools.lru_cache(maxsize=None)
def ring_depth(rows: int, O: int, itemsize: int, which: str, aligned: bool = True,
               sms: int = SMS) -> int:
    """D, the steps in each warp's shared-memory ring (csrc/sru_train.cu),
    or 0 for the narrow kernel. A bfloat16 ring copies 4-byte words of two
    rows, so odd rows or an operand that does not start 4-byte aligned
    (``aligned`` False) take the narrow kernel. Otherwise: the depths in
    ``DEPTHS[which]`` at which every block of the launch fits in shared
    memory at once (ceil(blocks / sms) per SM, each D steps of the operands
    of 128 rows), and of those the least that keeps ``IN_FLIGHT_BYTES`` in
    flight per SM, else the deepest; the shallowest if none fits."""
    if itemsize == 2 and (rows % 2 or not aligned):
        return 0
    per_sm = -(-(-(-rows // THREADS) * O) // sms)
    stage = WARPS * OPERANDS[which] * 32 * itemsize  # a block's bytes per step
    depths = DEPTHS[which]
    fits = [d for d in depths if per_sm * (d * stage + 1024) <= SMEM_PER_SM] or [depths[0]]
    return next((d for d in fits if per_sm * d * stage >= IN_FLIGHT_BYTES), fits[-1])


@functools.lru_cache(maxsize=None)
def _fns():
    lib = build.load(SOURCE)
    fwd, bwd = lib.rtfs_sru_train_forward, lib.rtfs_sru_train_backward
    fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _ptr(t):
    return None if t is None else t.data_ptr()


def sru_train_forward(u, skip, v, b, *, H: int, k: int, ndir: int):
    """(h, c), each (L, O, rows) in u's dtype: the registered op
    ``rtfs::sru_train_forward``. CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    _check(u, skip, v, b, H, k, ndir)
    return torch.ops.rtfs.sru_train_forward(u, skip, v, b, H, k, ndir)


def sru_train_backward(u, skip, c, v, b, dh, *, H: int, k: int, ndir: int):
    """(du, dskip, dv, db): du like u, dskip like skip (None when k == 4),
    dv and db (2·O,) float32: the registered op ``rtfs::sru_train_backward``.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    L, O, rows = _check(u, skip, v, b, H, k, ndir)
    for name, t in (("c", c), ("dh", dh)):
        if (tuple(t.shape) != (L, O, rows) or t.dtype != u.dtype or t.device != u.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous ({L}, {O}, {rows}) in u's dtype")
    return tuple(torch.ops.rtfs.sru_train_backward(u, skip, c, v, b, dh, H, k, ndir))


def sru_train_forward_cuda(u, skip, v, b, H: int, k: int, ndir: int):
    """The forward op's CUDA implementation: one launch of the kernel."""
    global forward_launches
    fwd = _fns()[0]
    L, _, rows = u.shape
    O = H * ndir
    h = torch.empty((L, O, rows), dtype=u.dtype, device=u.device)
    c = torch.empty_like(h)
    v = v.float().contiguous()
    b = b.float().contiguous()
    depth = ring_depth(rows, O, u.element_size(), "forward", _aligned(u, skip if k == 3 else None),
                       _sms(u.device.index or 0))
    with torch.cuda.device(u.device):
        err = fwd(u.data_ptr(), _ptr(skip) if k == 3 else None, v.data_ptr(),
                  b.data_ptr(), h.data_ptr(), c.data_ptr(),
                  L, rows, H, k, ndir, depth, _DTYPES[u.dtype],
                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sru_train forward kernel launch failed: CUDA error {err}")
    forward_launches += 1
    return h, c


def sru_train_backward_cuda(u, skip, c, v, b, dh, H: int, k: int, ndir: int):
    """The backward op's CUDA implementation: one launch of the kernel, then
    the gate gradients' sums over rows."""
    global backward_launches
    bwd = _fns()[1]
    L, _, rows = u.shape
    O = H * ndir
    du = torch.empty_like(u)
    dskip = torch.empty_like(skip) if k == 3 else None
    part = torch.empty((4, O, rows), dtype=torch.float32, device=u.device)
    v = v.float().contiguous()
    b = b.float().contiguous()
    depth = ring_depth(rows, O, u.element_size(), "backward",
                       _aligned(u, skip if k == 3 else None, c, dh), _sms(u.device.index or 0))
    with torch.cuda.device(u.device):
        err = bwd(u.data_ptr(), _ptr(skip) if k == 3 else None, c.data_ptr(),
                  v.data_ptr(), b.data_ptr(), dh.data_ptr(), du.data_ptr(),
                  _ptr(dskip), part.data_ptr(), L, rows, H, k, ndir, depth,
                  _DTYPES[u.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sru_train backward kernel launch failed: CUDA error {err}")
    backward_launches += 1
    return (du, dskip) + _gate_grads(part)


def _sru_train_forward_cpu(u, skip, v, b, H, k, ndir):
    return sru_train_forward_ref(u, skip, v, b, H=H, k=k, ndir=ndir)


def _sru_train_backward_cpu(u, skip, c, v, b, dh, H, k, ndir):
    return sru_train_backward_ref(u, skip, c, v, b, dh, H=H, k=k, ndir=ndir)


def _sru_train_forward_fake(u, skip, v, b, H, k, ndir):
    h = u.new_empty((u.shape[0], H * ndir, u.shape[2]))
    return h, torch.empty_like(h)


def _sru_train_backward_fake(u, skip, c, v, b, dh, H, k, ndir):
    gate = v.new_empty(v.shape, dtype=torch.float32)
    return (torch.empty_like(u), torch.empty_like(skip) if k == 3 else None,
            gate, torch.empty_like(gate))


def _gate_grads(part):
    """(4, O, rows) per-row sums -> dv = [dv_f, dv_r], db = [db_f, db_r]."""
    s = part.sum(dim=-1)
    return torch.cat([s[0], s[1]]), torch.cat([s[2], s[3]])


def _split(u, skip, v, b, H, k, ndir):
    L, _, rows = u.shape
    O = H * ndir
    uf = u.float().reshape(L, k, O, rows)
    sk = uf[:, 3] if k == 4 else skip.float()
    return uf, sk, v.float()[:, None], b.float()[:, None]


def _steps(L, d):
    """The direction's time steps in its own order."""
    return range(L - 1, -1, -1) if d == 1 else range(L)


def sru_train_forward_ref(u, skip, v, b, *, H: int, k: int, ndir: int):
    """Plain PyTorch version: a Python loop over L per direction, float32
    carry and math, h and c cast to u's dtype."""
    uf, sk, v, b = _split(u, skip, v, b, H, k, ndir)
    L, _, O, rows = uf.shape
    h = torch.empty((L, O, rows), dtype=torch.float32, device=u.device)
    c_all = torch.empty_like(h)
    for d in range(ndir):
        s = slice(d * H, (d + 1) * H)
        vf, vr, bf, br = v[:O][s], v[O:][s], b[:O][s], b[O:][s]
        c = torch.zeros((H, rows), dtype=torch.float32, device=u.device)
        for t in _steps(L, d):
            f = torch.sigmoid(uf[t, 1, s] + vf * c + bf)
            r = torch.sigmoid(uf[t, 2, s] + vr * c + br)
            c = f * c + (1.0 - f) * uf[t, 0, s]
            h[t, s] = r * c + (1.0 - r) * sk[t, s]
            c_all[t, s] = c
    return h.to(u.dtype), c_all.to(u.dtype)


def sru_train_backward_ref(u, skip, c, v, b, dh, *, H: int, k: int, ndir: int):
    """Plain PyTorch version of the backward sweep, with the kernel's
    arithmetic: gates recomputed from the stored (u-dtype) c, float32 math,
    gate gradients summed per row over L, then over rows."""
    uf, sk, v, b = _split(u, skip, v, b, H, k, ndir)
    L, _, O, rows = uf.shape
    cf, g = c.float(), dh.float()
    du = torch.empty((L, k, O, rows), dtype=torch.float32, device=u.device)
    dsk = du[:, 3] if k == 4 else torch.empty((L, O, rows), dtype=torch.float32,
                                              device=u.device)
    part = torch.zeros((4, O, rows), dtype=torch.float32, device=u.device)
    zero = torch.zeros((H, rows), dtype=torch.float32, device=u.device)
    for d in range(ndir):
        s = slice(d * H, (d + 1) * H)
        vf, vr, bf, br = v[:O][s], v[O:][s], b[:O][s], b[O:][s]
        steps = list(_steps(L, d))
        dc = zero
        for i in range(L - 1, -1, -1):
            t = steps[i]
            c_prev = cf[steps[i - 1], s] if i > 0 else zero
            f = torch.sigmoid(uf[t, 1, s] + vf * c_prev + bf)
            r = torch.sigmoid(uf[t, 2, s] + vr * c_prev + br)
            dm = g[t, s] * (cf[t, s] - sk[t, s]) * r * (1.0 - r)
            dct = g[t, s] * r + dc
            da = dct * (c_prev - uf[t, 0, s]) * f * (1.0 - f)
            du[t, 0, s] = dct * (1.0 - f)
            du[t, 1, s] = da
            du[t, 2, s] = dm
            dsk[t, s] = g[t, s] * (1.0 - r)
            part[0, s] += da * c_prev
            part[1, s] += dm * c_prev
            part[2, s] += da
            part[3, s] += dm
            dc = dct * f + da * vf + dm * vr
    du = du.reshape(L, k * O, rows).to(u.dtype)
    return (du, None if k == 4 else dsk.to(u.dtype)) + _gate_grads(part)


class SRULayerFunction(torch.autograd.Function):
    """h = SRU layer(u, skip, v, b), differentiable in all four."""

    @staticmethod
    def forward(ctx, u, skip, v, b, H, k, ndir):
        h, c = sru_train_forward(u, skip, v, b, H=H, k=k, ndir=ndir)
        ctx.save_for_backward(u, skip, c, v, b)
        ctx.shape = (H, k, ndir)
        return h

    @staticmethod
    def backward(ctx, dh):
        u, skip, c, v, b = ctx.saved_tensors
        H, k, ndir = ctx.shape
        du, dskip, dv, db = sru_train_backward(u, skip, c, v, b,
                                               dh.to(u.dtype).contiguous(),
                                               H=H, k=k, ndir=ndir)
        return du, dskip, dv.to(v.dtype), db.to(b.dtype), None, None, None


def sru_layer_train(u, skip, v, b, *, H: int, k: int, ndir: int):
    """The differentiable SRU layer: ``SRULayerFunction`` on contiguous
    inputs."""
    return SRULayerFunction.apply(u.contiguous(), None if skip is None else skip.contiguous(),
                                  v, b, H, k, ndir)


registry.define_op("sru_train_forward(Tensor u, Tensor? skip, Tensor v, Tensor b, int H, int k, "
                   "int ndir) -> (Tensor, Tensor)", sru_train_forward_cuda,
                   _sru_train_forward_cpu, _sru_train_forward_fake)
registry.define_op("sru_train_backward(Tensor u, Tensor? skip, Tensor c, Tensor v, Tensor b, "
                   "Tensor dh, int H, int k, int ndir) -> (Tensor, Tensor?, Tensor, Tensor)",
                   sru_train_backward_cuda, _sru_train_backward_cpu, _sru_train_backward_fake)
