"""One bidirectional SRU layer's recurrence: the CUDA kernel
``csrc/sru_stack_layer.cu`` and its plain PyTorch version.

Port of ``rtfs_net_tpu/ops/pallas/sru_kernel_v3.py:sru_stack_layer``, same
arguments and layout: u (L, k·O, rows) with chunk-major columns
``c*O + d*H + h``; skip (L, O, rows) when k == 3 (unused when k == 4,
where u's 4th chunk is the highway); v, b the layer's (2·O,) gate vectors.
Returns (L, O, rows) in u's dtype; the carry and the math are float32.
With ``pad`` > 0 the output is (L + 2·pad, O, rows): the layer's steps in
the middle and ``pad`` zero steps at each end, for a caller whose next
step reads zero-padded windows of the output (an overlap-add). The end
steps are zeroed inside the op, so its device time includes that fill.

The kernel is the registered op ``rtfs::sru_stack_layer``
(``registry.py``): ``sru_stack_layer_cuda`` launches it,
``sru_stack_layer_ref`` is its CPU implementation.

``launch_plan`` picks each launch's ring depth, or the narrow kernel;
``sru_direction.py`` plans K4 by the same rule, ``ring_plan``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, registry

SOURCE = "sru_stack_layer.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel since the last reset (set it to 0 to reset)
launches = 0

THREADS = 128             # per block; a launch's grid is ceil(chains / THREADS) blocks
SMS = 132                 # an H100's SMs, for planning where no card is asked
SMEM_PER_SM = 228 * 1024  # shared memory an SM gives its blocks, 1 KB each reserved
BLOCKS_AT_ONCE = 2048 // THREADS  # blocks an SM holds at once by its thread limit
DEEP, SHALLOW = 32, 8     # ring depths the kernels take
OPERANDS = 4              # copied per step: u0, u1, u2, skip


def ring_plan(blocks: int, itemsize: int, narrow: bool, sms: int = SMS) -> int:
    """D, the steps in each warp's shared-memory ring, for a launch of
    ``blocks`` blocks, or 0 for the narrow kernel. ``narrow``: a ring cannot
    take the operands. Where each SM gets at most one block the carry chain
    sets the time, and the deepest ring waits least per step. Up to
    ``BLOCKS_AT_ONCE`` blocks per SM the shallow ring, whose shared memory
    lets every block stay resident. Beyond that the launch runs in waves,
    and the narrow kernel's lighter blocks (fewer registers, no shared
    memory) hide its latency better than the ring (measured on an H100:
    ``scripts/torch_sru_plans.py``)."""
    per_sm = -(-blocks // sms)
    stage = THREADS * OPERANDS * itemsize  # a block's ring bytes per step
    if narrow or per_sm > BLOCKS_AT_ONCE or per_sm * (SHALLOW * stage + 1024) > SMEM_PER_SM:
        return 0
    return DEEP if per_sm <= 1 else SHALLOW


@functools.lru_cache(maxsize=None)
def launch_plan(rows: int, O: int, itemsize: int, aligned: bool = True, sms: int = SMS) -> int:
    """D of one K1 launch, grid (ceil(rows / THREADS), O), or 0 for the
    narrow kernel. A bfloat16 ring copies 4-byte words of two rows, so odd
    rows or an operand that does not start 4-byte aligned (``aligned``
    False) take the narrow kernel."""
    return ring_plan(-(-rows // THREADS) * O, itemsize,
                     itemsize == 2 and (rows % 2 == 1 or not aligned), sms)


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 4 == 0 for t in tensors)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load(SOURCE).rtfs_sru_stack_layer
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(u, skip, v, b, H: int, k: int, ndir: int):
    if k not in (3, 4) or ndir not in (1, 2) or H <= 0:
        raise ValueError(f"unsupported k={k}, ndir={ndir}, H={H}")
    if u.dim() != 3:
        raise ValueError(f"u must be (L, k*O, rows), got {tuple(u.shape)}")
    L, KO, rows = u.shape
    O = H * ndir
    if KO != k * O:
        raise ValueError(f"u has {KO} channels, want k*O = {k * O}")
    if u.dtype not in _DTYPES:
        raise TypeError(f"u must be float32 or bfloat16, got {u.dtype}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")
    if k == 3:
        if skip is None or tuple(skip.shape) != (L, O, rows):
            raise ValueError(f"k == 3 needs skip of shape {(L, O, rows)}")
        if skip.dtype != u.dtype or skip.device != u.device or not skip.is_contiguous():
            raise ValueError("skip must be contiguous, on u's device, in u's dtype")
    for name, g in (("v", v), ("b", b)):
        if tuple(g.shape) != (2 * O,) or g.device != u.device:
            raise ValueError(f"{name} must be ({2 * O},) on u's device")
    return L, O, rows


def sru_stack_layer(u, skip, v, b, *, H: int, k: int, ndir: int, pad: int = 0):
    """The registered op ``rtfs::sru_stack_layer``: CUDA tensors launch the
    kernel, CPU tensors take the plain version. Inference only: it raises
    when autograd would need its backward (the differentiable layer is
    ``sru_train.sru_layer_train``)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (u, skip, v, b)):
        raise RuntimeError("sru_stack_layer has no backward; a grad-enabled call "
                           "goes through sru_train.sru_layer_train")
    _check(u, skip, v, b, H, k, ndir)
    if pad < 0:
        raise ValueError(f"pad must be >= 0, got {pad}")
    return torch.ops.rtfs.sru_stack_layer(u, skip, v, b, H, k, ndir, pad)


def sru_stack_layer_cuda(u, skip, v, b, H: int, k: int, ndir: int, pad: int = 0):
    """The op's CUDA implementation: one launch of the kernel, into the
    middle of the output when ``pad`` > 0, whose end steps are zeroed."""
    global launches
    fn = _fn()
    L, _, rows = u.shape
    padded = torch.empty((L + 2 * pad, H * ndir, rows), dtype=u.dtype, device=u.device)
    if pad:
        padded[:pad].zero_()
        padded[L + pad:].zero_()
    out = padded[pad:L + pad]
    v = v.float().contiguous()
    b = b.float().contiguous()
    skip = skip if k == 3 else None
    depth = launch_plan(rows, H * ndir, u.element_size(), _aligned(u, skip),
                        _sms(u.device.index or 0))
    with torch.cuda.device(u.device):
        err = fn(u.data_ptr(), None if skip is None else skip.data_ptr(),
                 v.data_ptr(), b.data_ptr(), out.data_ptr(),
                 L, rows, H, k, ndir, depth, _DTYPES[u.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sru_stack_layer kernel launch failed: CUDA error {err}")
    launches += 1
    return padded


def _sru_stack_layer_cpu(u, skip, v, b, H, k, ndir, pad=0):
    out = sru_stack_layer_ref(u, skip, v, b, H=H, k=k, ndir=ndir)
    return torch.nn.functional.pad(out, (0, 0, 0, 0, pad, pad)) if pad else out


def _sru_stack_layer_fake(u, skip, v, b, H, k, ndir, pad=0):
    return u.new_empty((u.shape[0] + 2 * pad, H * ndir, u.shape[2]))


def sru_stack_layer_ref(u, skip, v, b, *, H: int, k: int, ndir: int):
    """Plain PyTorch version: a Python loop over L per direction, float32
    carry and math, output cast to u's dtype."""
    L, KO, rows = u.shape
    O = H * ndir
    uf = u.float().reshape(L, k, O, rows)
    u0, u1, u2 = uf[:, 0], uf[:, 1], uf[:, 2]
    sk = uf[:, 3] if k == 4 else skip.float()
    v, b = v.float()[:, None], b.float()[:, None]
    out = torch.empty((L, O, rows), dtype=torch.float32, device=u.device)
    for d in range(ndir):
        s = slice(d * H, (d + 1) * H)
        vf, vr = v[:O][s], v[O:][s]
        bf, br = b[:O][s], b[O:][s]
        c = torch.zeros((H, rows), dtype=torch.float32, device=u.device)
        for t in (range(L - 1, -1, -1) if d == 1 else range(L)):
            f = torch.sigmoid(u1[t, s] + vf * c + bf)
            r = torch.sigmoid(u2[t, s] + vr * c + br)
            c = f * c + (1.0 - f) * u0[t, s]
            out[t, s] = r * c + (1.0 - r) * sk[t, s]
    return out.to(u.dtype)


registry.define_op("sru_stack_layer(Tensor u, Tensor? skip, Tensor v, Tensor b, int H, int k, "
                   "int ndir, int pad=0) -> Tensor", sru_stack_layer_cuda, _sru_stack_layer_cpu,
                   _sru_stack_layer_fake)
