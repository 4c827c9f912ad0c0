"""One SRU direction's recurrence on the (L, rows, H) layout: the CUDA
kernel ``csrc/sru_direction.cu`` and its plain PyTorch version.

Port of ``rtfs_net_tpu/ops/pallas/sru_kernel.py:sru_direction_pallas``,
same arguments: u0, u1, u2, skip (L, rows, H); v_f, v_r, b_f, b_r (H,);
``reverse`` walks t = L-1 .. 0. Returns (L, rows, H) in u0's dtype; the
carry and the math are float32.

The operands usually arrive as slices ``u[:, :, c, d*H:(d+1)*H]`` of one
(L, rows, k, O) projection. The kernel reads them in place through their
strides along t and rows; only an operand whose stride along h is not 1
is copied first.

The kernel is the registered op ``rtfs::sru_direction`` (``registry.py``):
``sru_direction_cuda`` launches it, ``sru_direction_ref`` is its CPU
implementation.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, registry
from .sru import SMS, THREADS, _sms, ring_plan

SOURCE = "sru_direction.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel since the last reset (set it to 0 to reset)
launches = 0


@functools.lru_cache(maxsize=None)
def launch_plan(rows: int, H: int, itemsize: int, aligned: bool = True, sms: int = SMS) -> int:
    """D of one K4 launch, grid ceil(rows * H / THREADS), or 0 for the
    narrow kernel. A bfloat16 ring copies 4-byte words of two neighbouring
    h, so odd H or an operand whose base or strides break that word
    alignment (``aligned`` False) take the narrow kernel."""
    return ring_plan(-(-rows * H // THREADS), itemsize,
                     itemsize == 2 and (H % 2 == 1 or not aligned), sms)


def _words_aligned(t) -> bool:
    """A bfloat16 operand's 4-byte words stay aligned at every (t, row)."""
    return t.data_ptr() % 4 == 0 and t.stride(0) % 2 == 0 and t.stride(1) % 2 == 0


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load(SOURCE).rtfs_sru_direction
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int64)]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(u0, u1, u2, skip, gates):
    if u0.dim() != 3:
        raise ValueError(f"u0 must be (L, rows, H), got {tuple(u0.shape)}")
    if u0.dtype not in _DTYPES:
        raise TypeError(f"u0 must be float32 or bfloat16, got {u0.dtype}")
    if u0.numel() == 0:
        raise ValueError(f"u0 is empty: {tuple(u0.shape)}")
    for name, t in (("u1", u1), ("u2", u2), ("skip", skip)):
        if t.shape != u0.shape or t.dtype != u0.dtype or t.device != u0.device:
            raise ValueError(f"{name} must be {tuple(u0.shape)} on u0's device, in u0's dtype")
    H = u0.shape[2]
    for name, g in zip(("v_f", "v_r", "b_f", "b_r"), gates):
        if tuple(g.shape) != (H,) or g.device != u0.device:
            raise ValueError(f"{name} must be ({H},) on u0's device")


def sru_direction(u0, u1, u2, skip, v_f, v_r, b_f, b_r, reverse: bool = False):
    """The registered op ``rtfs::sru_direction``: CUDA tensors launch the
    kernel, CPU tensors take the plain version. Inference only: it raises
    when autograd would need its backward (the differentiable recurrence
    is ``sru_train.sru_layer_train``)."""
    gates = (v_f, v_r, b_f, b_r)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (u0, u1, u2, skip) + gates):
        raise RuntimeError("sru_direction has no backward; a grad-enabled call "
                           "goes through sru_train.sru_layer_train")
    _check(u0, u1, u2, skip, gates)
    return torch.ops.rtfs.sru_direction(u0, u1, u2, skip, *gates, bool(reverse))


def sru_direction_cuda(u0, u1, u2, skip, v_f, v_r, b_f, b_r, reverse: bool):
    """The op's CUDA implementation: one launch of the kernel."""
    global launches
    fn = _fn()
    L, rows, H = u0.shape
    operands = [t if t.stride(2) == 1 else t.contiguous() for t in (u0, u1, u2, skip)]
    strides = (ctypes.c_int64 * 8)(*(s for t in operands for s in t.stride()[:2]))
    gates = [g.float().contiguous() for g in (v_f, v_r, b_f, b_r)]
    out = torch.empty((L, rows, H), dtype=u0.dtype, device=u0.device)
    depth = launch_plan(rows, H, u0.element_size(), all(_words_aligned(t) for t in operands),
                        _sms(u0.device.index or 0))
    with torch.cuda.device(u0.device):
        err = fn(*(t.data_ptr() for t in operands), strides,
                 *(g.data_ptr() for g in gates), out.data_ptr(),
                 L, rows, H, int(reverse), depth, _DTYPES[u0.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sru_direction kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _sru_direction_cpu(u0, u1, u2, skip, v_f, v_r, b_f, b_r, reverse):
    return sru_direction_ref(u0, u1, u2, skip, v_f, v_r, b_f, b_r, reverse=reverse)


def _sru_direction_fake(u0, u1, u2, skip, v_f, v_r, b_f, b_r, reverse):
    return u0.new_empty(u0.shape)


def sru_direction_ref(u0, u1, u2, skip, v_f, v_r, b_f, b_r, reverse: bool = False):
    """Plain PyTorch version: a Python loop over L, float32 carry and math,
    output cast to u0's dtype."""
    L, rows, H = u0.shape
    dtype = u0.dtype
    u0, u1, u2, skip = (t.float() for t in (u0, u1, u2, skip))
    v_f, v_r, b_f, b_r = (g.float() for g in (v_f, v_r, b_f, b_r))
    out = torch.empty((L, rows, H), dtype=torch.float32, device=u0.device)
    c = torch.zeros((rows, H), dtype=torch.float32, device=u0.device)
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        f = torch.sigmoid(u1[t] + v_f * c + b_f)
        r = torch.sigmoid(u2[t] + v_r * c + b_r)
        c = f * c + (1.0 - f) * u0[t]
        out[t] = r * c + (1.0 - r) * skip[t]
    return out.to(dtype)


registry.define_op("sru_direction(Tensor u0, Tensor u1, Tensor u2, Tensor skip, Tensor v_f, "
                   "Tensor v_r, Tensor b_f, Tensor b_r, bool reverse) -> Tensor",
                   sru_direction_cuda, _sru_direction_cpu, _sru_direction_fake)
