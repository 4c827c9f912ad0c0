"""The DualPathRNN's passes into and out of its recurrence's layouts: the
CUDA kernels ``csrc/dual_path.cu`` and their plain PyTorch versions.

They replace no TPU kernel (the note in the source says why they exist).
x, the residual and the output are a DualPathRNN's (B, C, T, F) features;
the sequence layout is K1's (S, C, rows), S the recurrent axis ``seq_dim``
of x (2: T, 3: F) and rows the other axis times B, b-major; the window
layout is cuDNN's (L, rows, C·k) input, the L = S - k + 1 stride-1 windows
of k steps with columns ``c*k + j`` (``ops/conv.py:unfold_1d``'s order):

* ``dual_path_norm_in``: LayerNormalization4D over C (float32 statistics,
  biased variance, the (C,) float32 gamma and beta), cast to x's dtype,
  written as (S, C, rows).
* ``dual_path_out``: z (S, C, rows), the overlap-add's output, back to
  (B, C, T, F), plus the (C,) float32 bias and the residual, in float32 with
  one rounding to z's dtype.
* ``dual_path_windows_in``: the same LayerNormalization4D, cast to x's
  dtype, written as the (L, rows, C·k) windows, ``w[l, r, c*k + j] =
  y[l + j, c, r]``: the LSTM or GRU DualPathRNN's input, contiguous, so
  cuDNN takes it without a copy. x may have any strides but F's, which is 1.

The kernels are the registered ops ``rtfs::dual_path_norm_in``,
``rtfs::dual_path_out`` and ``rtfs::dual_path_windows_in``
(``registry.py``): the ``*_cuda`` functions launch them, the ``*_ref``
functions are their CPU implementations.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, registry
from .sru import _DTYPES

SOURCE = "dual_path.cu"

# launches of the CUDA kernels since the last reset (set them to 0 to reset)
norm_in_launches = 0
out_launches = 0
windows_in_launches = 0


@functools.lru_cache(maxsize=None)
def _fns():
    lib = build.load(SOURCE)
    norm_in, out = lib.rtfs_dual_path_norm_in, lib.rtfs_dual_path_out
    windows_in = lib.rtfs_dual_path_windows_in
    norm_in.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int]
                        + [ctypes.c_void_p])
    out.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    windows_in.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
                           + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    norm_in.restype = out.restype = windows_in.restype = ctypes.c_int
    return norm_in, out, windows_in


def seq_shape(shape, seq_dim: int):
    """(S, rows) of the sequence layout of a (B, C, T, F) ``shape``."""
    B, _, T, F = shape
    return (T, B * F) if seq_dim == 2 else (F, B * T)


def window_shape(shape, seq_dim: int, k: int):
    """(L, rows, C·k) of the window layout of a (B, C, T, F) ``shape``."""
    S, rows = seq_shape(shape, seq_dim)
    return (S - k + 1, rows, shape[1] * k)


def _check_x(x, name: str, seq_dim: int, contiguous: bool = True):
    """x a float32 or bfloat16 (B, C, T, F), contiguous, or with
    ``contiguous=False`` only along F."""
    if seq_dim not in (2, 3):
        raise ValueError(f"seq_dim must be 2 (T) or 3 (F), got {seq_dim}")
    if x.dim() != 4:
        raise ValueError(f"{name} must be (B, C, T, F), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {x.dtype}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if not contiguous and x.shape[3] > 1 and x.stride(3) != 1:
        raise ValueError(f"{name} must be contiguous along F")


def _check_vector(v, name: str, C: int, device):
    if tuple(v.shape) != (C,) or v.dtype != torch.float32 or v.device != device:
        raise ValueError(f"{name} must be float32 ({C},) on the input's device")


def dual_path_norm_in(x, gamma, beta, *, seq_dim: int, eps: float):
    """The registered op ``rtfs::dual_path_norm_in``: CUDA tensors launch the
    kernel, CPU tensors take the plain version. Inference only (no
    backward)."""
    _check_x(x, "x", seq_dim)
    for name, v in (("gamma", gamma), ("beta", beta)):
        _check_vector(v, name, x.shape[1], x.device)
    return torch.ops.rtfs.dual_path_norm_in(x, gamma, beta, seq_dim, eps)


def dual_path_out(z, bias, residual, *, seq_dim: int):
    """The registered op ``rtfs::dual_path_out``: CUDA tensors launch the
    kernel, CPU tensors take the plain version. Inference only (no
    backward)."""
    _check_x(residual, "residual", seq_dim)
    C = residual.shape[1]
    S, rows = seq_shape(residual.shape, seq_dim)
    want = (S, C, rows)
    if tuple(z.shape) != want or z.dtype != residual.dtype or z.device != residual.device:
        raise ValueError(f"z must be {want} in the residual's dtype and device, got "
                         f"{tuple(z.shape)} {z.dtype}")
    if not z.is_contiguous():
        raise ValueError("z must be contiguous")
    _check_vector(bias, "bias", C, residual.device)
    return torch.ops.rtfs.dual_path_out(z, bias, residual, seq_dim)


def dual_path_windows_in(x, gamma, beta, *, seq_dim: int, k: int, eps: float):
    """The registered op ``rtfs::dual_path_windows_in``: CUDA tensors launch
    the kernel, CPU tensors take the plain version. Inference only (no
    backward)."""
    _check_x(x, "x", seq_dim, contiguous=False)
    S, _ = seq_shape(x.shape, seq_dim)
    if not 1 <= k <= S:
        raise ValueError(f"k must lie in [1, {S}] (the sequence's steps), got {k}")
    for name, v in (("gamma", gamma), ("beta", beta)):
        _check_vector(v, name, x.shape[1], x.device)
    return torch.ops.rtfs.dual_path_windows_in(x, gamma, beta, seq_dim, k, eps)


def dual_path_norm_in_cuda(x, gamma, beta, seq_dim: int, eps: float):
    """The op's CUDA implementation: one launch of the kernel."""
    global norm_in_launches
    fn = _fns()[0]
    B, C, T, F = x.shape
    S, rows = seq_shape(x.shape, seq_dim)
    y = torch.empty((S, C, rows), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), B, C, T, F,
                 seq_dim - 2, eps, _DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dual_path_norm_in kernel launch failed: CUDA error {err}")
    norm_in_launches += 1
    return y


def dual_path_out_cuda(z, bias, residual, seq_dim: int):
    """The op's CUDA implementation: one launch of the kernel."""
    global out_launches
    fn = _fns()[1]
    B, C, T, F = residual.shape
    out = torch.empty_like(residual)
    with torch.cuda.device(z.device):
        err = fn(z.data_ptr(), bias.data_ptr(), residual.data_ptr(), out.data_ptr(), B, C, T, F,
                 seq_dim - 2, _DTYPES[z.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dual_path_out kernel launch failed: CUDA error {err}")
    out_launches += 1
    return out


def dual_path_windows_in_cuda(x, gamma, beta, seq_dim: int, k: int, eps: float):
    """The op's CUDA implementation: one launch of the kernel."""
    global windows_in_launches
    fn = _fns()[2]
    B, C, T, F = x.shape
    w = torch.empty(window_shape(x.shape, seq_dim, k), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(), B, C, T, F,
                 *x.stride()[:3], seq_dim - 2, k, eps, _DTYPES[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dual_path_windows_in kernel launch failed: CUDA error {err}")
    windows_in_launches += 1
    return w


def _norm(x, gamma, beta, eps: float):
    """LayerNormalization4D over C (``ops/normalizations.py``) with (C,)
    gamma and beta: float32 statistics, one rounding to x's dtype."""
    C = x.shape[1]
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=1, correction=0, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma.view(1, C, 1, 1) + beta.view(1, C, 1, 1)).to(x.dtype)


def dual_path_norm_in_ref(x, gamma, beta, seq_dim: int, eps: float):
    """Plain PyTorch version: LayerNormalization4D's arithmetic, then the
    permute into the sequence layout."""
    C = x.shape[1]
    y = _norm(x, gamma, beta, eps)
    S, rows = seq_shape(x.shape, seq_dim)
    order = (2, 1, 0, 3) if seq_dim == 2 else (3, 1, 0, 2)
    return y.permute(order).reshape(S, C, rows).contiguous()


def dual_path_out_ref(z, bias, residual, seq_dim: int):
    """Plain PyTorch version: z permuted back to (B, C, T, F), plus the bias
    and the residual in float32."""
    B, C, T, F = residual.shape
    if seq_dim == 2:
        zz = z.view(T, C, B, F).permute(2, 1, 0, 3)
    else:
        zz = z.view(F, C, B, T).permute(2, 1, 3, 0)
    out = zz.float() + bias.view(1, C, 1, 1) + residual.float()
    return out.to(z.dtype).contiguous()


def dual_path_windows_in_ref(x, gamma, beta, seq_dim: int, k: int, eps: float):
    """Plain PyTorch version, the general DualPathRNN route's steps:
    LayerNormalization4D, the permute to (rows, C, S), the stride-1 unfold
    into (rows, C·k, L) windows, the permute to (L, rows, C·k), contiguous."""
    C = x.shape[1]
    S, rows = seq_shape(x.shape, seq_dim)
    y = _norm(x, gamma, beta, eps)
    y = y.permute((0, 3, 1, 2) if seq_dim == 2 else (0, 2, 1, 3)).reshape(rows, C, S)
    windows = y.unfold(2, k, 1).permute(0, 1, 3, 2).reshape(rows, C * k, S - k + 1)
    return windows.permute(2, 0, 1).contiguous()


def _dual_path_norm_in_cpu(x, gamma, beta, seq_dim, eps):
    return dual_path_norm_in_ref(x, gamma, beta, seq_dim, eps)


def _dual_path_out_cpu(z, bias, residual, seq_dim):
    return dual_path_out_ref(z, bias, residual, seq_dim)


def _dual_path_windows_in_cpu(x, gamma, beta, seq_dim, k, eps):
    return dual_path_windows_in_ref(x, gamma, beta, seq_dim, k, eps)


def _dual_path_norm_in_fake(x, gamma, beta, seq_dim, eps):
    S, rows = seq_shape(x.shape, seq_dim)
    return x.new_empty((S, x.shape[1], rows))


def _dual_path_out_fake(z, bias, residual, seq_dim):
    return torch.empty_like(residual)


def _dual_path_windows_in_fake(x, gamma, beta, seq_dim, k, eps):
    return x.new_empty(window_shape(x.shape, seq_dim, k))


registry.define_op("dual_path_norm_in(Tensor x, Tensor gamma, Tensor beta, int seq_dim, "
                   "float eps) -> Tensor", dual_path_norm_in_cuda, _dual_path_norm_in_cpu,
                   _dual_path_norm_in_fake)
registry.define_op("dual_path_out(Tensor z, Tensor bias, Tensor residual, int seq_dim) -> Tensor",
                   dual_path_out_cuda, _dual_path_out_cpu, _dual_path_out_fake)
registry.define_op("dual_path_windows_in(Tensor x, Tensor gamma, Tensor beta, int seq_dim, "
                   "int k, float eps) -> Tensor", dual_path_windows_in_cuda,
                   _dual_path_windows_in_cpu, _dual_path_windows_in_fake)
