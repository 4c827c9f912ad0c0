"""The kernels as registered operators (``rtfs_net_tpu_torch/ops/kernels``):
``torch.library.opcheck`` on each of the five ``rtfs::`` ops with CPU
inputs, where the dispatcher runs the plain version. It checks the schema,
the fake (shape-only) implementation against the real outputs' metadata,
the autograd registration and tracing through AOT dispatch. Small shapes:
k = 3 and 4, skip None and given, uneven pads, operands sliced out of a
larger tensor. On the card ``chip_smoke.py`` runs the same check against
the CUDA kernels."""
import numpy as np
import pytest
import torch

from rtfs_net_tpu_torch.ops import kernels

from _torch_port import one_torch_thread  # noqa: F401

L, ROWS, H = 3, 5, 2


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _sru_args(rng, k, ndir, with_skip):
    O = H * ndir
    skip = _t(rng, L, O, ROWS) if with_skip else None
    return _t(rng, L, k * O, ROWS), skip, _t(rng, 2 * O), _t(rng, 2 * O)


def _cases():
    rng = np.random.default_rng(0)
    cases = []
    for k, ndir, with_skip in ((3, 2, True), (4, 2, False), (4, 1, True)):
        u, skip, v, b = _sru_args(rng, k, ndir, with_skip)
        cases.append((f"sru_stack_layer-k{k}-ndir{ndir}", "sru_stack_layer",
                      (u, skip, v, b, H, k, ndir)))
        cases.append((f"sru_train_forward-k{k}-ndir{ndir}", "sru_train_forward",
                      (u, skip, v, b, H, k, ndir)))
        c, dh = _t(rng, L, H * ndir, ROWS), _t(rng, L, H * ndir, ROWS)
        cases.append((f"sru_train_backward-k{k}-ndir{ndir}", "sru_train_backward",
                      (u, skip, c, v, b, dh, H, k, ndir)))
    for kernel, pads in (((3, 3), [1, 1, 1, 1]), ((4, 4), [1, 2, 2, 1]), ((2, 3), [0, 1, 2, 0])):
        x, w = _t(rng, 2, 3, 7, 6), _t(rng, 3, 1, *kernel)
        cases.append((f"dw_conv2d_same-{kernel[0]}x{kernel[1]}", "dw_conv2d_same", (x, w, pads)))
    proj = _t(rng, L, ROWS, 4, 2 * H)  # slices of one projection, as the "pallas" route has them
    gates = [_t(rng, H) for _ in range(4)]
    for reverse in (False, True):
        cases.append((f"sru_direction-reverse{int(reverse)}", "sru_direction",
                       (*(proj[:, :, c, H:] for c in range(4)), *gates, reverse)))
    return cases


CASES = _cases()


@pytest.mark.parametrize("op,args", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_opcheck(op, args):
    torch.library.opcheck(getattr(torch.ops.rtfs, op).default, args)


def test_every_op_is_registered_for_each_device():
    assert len(kernels.OPS) == 5 and {c[1] for c in CASES} == set(kernels.OPS)
    for op in kernels.OPS:
        for key in ("CUDA", "CPU", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(f"rtfs::{op}", key), (op, key)


def test_wrappers_call_the_ops():
    """The Python wrappers return exactly what the op's CPU implementation
    (the plain version) gives."""
    rng = np.random.default_rng(1)
    u, skip, v, b = _sru_args(rng, 3, 2, True)
    with torch.no_grad():
        got = kernels.sru.sru_stack_layer(u, skip, v, b, H=H, k=3, ndir=2)
    assert torch.equal(got, kernels.sru.sru_stack_layer_ref(u, skip, v, b, H=H, k=3, ndir=2))
    h, c = kernels.sru_train.sru_train_forward(u, skip, v, b, H=H, k=3, ndir=2)
    want = kernels.sru_train.sru_train_forward_ref(u, skip, v, b, H=H, k=3, ndir=2)
    assert torch.equal(h, want[0]) and torch.equal(c, want[1])
    x, w = _t(rng, 2, 3, 7, 6), _t(rng, 3, 1, 4, 4)
    pads = ((1, 2), (2, 1))
    assert torch.equal(kernels.dw_conv.dw_conv2d_same(x, w, pads),
                       kernels.dw_conv.dw_conv2d_same_ref(x, w, pads))
