"""PyTorch port vs JAX package: the depthwise stencil K3.

* ``dw_conv2d_same`` with CPU tensors (its plain, tap-by-tap version)
  against the JAX Pallas kernel ``dw_conv2d_same`` in interpret mode at the
  cases of tests/test_pallas_dw_conv.py (atol 2e-5), and against
  ``F.conv2d(groups=C)`` on the padded input;
* the ``torch.autograd.Function``'s gradients against the JAX function's
  ``custom_vjp`` and against autograd through ``F.conv2d`` (dx atol 1e-4;
  dw rtol 1e-4, atol 1e-3: a float32 sum over B·T·F terms);
* the gate against ``pallas_dw_supported``'s cases, less the TPU's batch
  rule; ``Conv(groups=C, padding="same")`` with the route on and off.

The CUDA kernel itself runs only on the card
(``tests/test_torch_card_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rtfs_net_tpu.ops.pallas.dw_conv import dw_conv2d_same as jax_dw_conv2d_same
from rtfs_net_tpu_torch.ops import conv
from rtfs_net_tpu_torch.ops.kernels import dw_conv as kdw

from _torch_port import one_torch_thread  # noqa: F401

CASES = [
    # (B, C, T, F, k_t, k_f): tests/test_pallas_dw_conv.py:21-28
    (8, 4, 17, 9, 3, 3),
    (8, 3, 12, 7, 5, 5),
    (16, 2, 9, 13, 4, 4),
    (8, 5, 8, 8, 2, 3),
    (8, 2, 70, 9, 3, 3),
]


def _pads(k_t, k_f):
    return ((k_t - 1) // 2, k_t // 2), ((k_f - 1) // 2, k_f // 2)


def _inputs(rng, B, C, T, Fq, k_t, k_f):
    return (rng.standard_normal((B, C, T, Fq)).astype(np.float32),
            rng.standard_normal((C, 1, k_t, k_f)).astype(np.float32))


def _library(x, w, pads):
    (lo_t, hi_t), (lo_f, hi_f) = pads
    return F.conv2d(F.pad(x, (lo_f, hi_f, lo_t, hi_t)), w, groups=x.shape[1])


# the card's edge cases (DW_EDGE of tests/test_torch_card_kernels.py), small:
# (B, C, T, F, k_t, k_f, pads, offset): B*C = 1 with odd F = 129 and T not
# a multiple of a band, F = 7, uneven pads, the 7x2 kernel; x a slice at an
# odd offset
EDGE_CASES = [
    (1, 1, 13, 129, 4, 4, ((1, 2), (1, 2)), 1),
    (2, 3, 11, 7, 4, 4, ((2, 1), (2, 1)), 0),
    (2, 2, 10, 9, 4, 4, ((0, 3), (0, 3)), 3),
    (2, 2, 9, 10, 7, 2, ((3, 3), (0, 1)), 0),
]


@pytest.mark.parametrize(
    "B,C,T,Fq,k_t,k_f,pads,offset",
    [pytest.param(*case, None, 0, id="-".join(map(str, case))) for case in CASES]
    + [pytest.param(*case, id="edge-{}-{}-{}-{}-{}x{}-{}-off{}".format(
        *case[:6], "".join(str(p) for pad in case[6] for p in pad), case[7]))
       for case in EDGE_CASES])
def test_plain_version_matches_pallas_kernel(rng, B, C, T, Fq, k_t, k_f, pads, offset):
    pads = pads or _pads(k_t, k_f)
    x, w = _inputs(rng, B, C, T, Fq, k_t, k_f)
    want = np.asarray(jax_dw_conv2d_same(jnp.asarray(x), jnp.asarray(w), pads))
    before = kdw.launches
    # x as a contiguous view at ``offset`` elements into a larger buffer
    buf = np.zeros(x.size + offset, np.float32)
    buf[offset:] = x.ravel()
    tx, tw = torch.from_numpy(buf)[offset:].view(x.shape), torch.from_numpy(w)
    got = kdw.dw_conv2d_same(tx, tw, pads)
    assert kdw.launches == before  # CPU tensors never count as a launch
    assert got.shape == tx.shape and got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), _library(tx, tw, pads).numpy(), atol=2e-5)


def test_uneven_explicit_pads(rng):
    """Any lo + hi = k - 1 split, not only torch's "same"."""
    x, w = (torch.from_numpy(a) for a in _inputs(rng, 2, 3, 9, 11, 4, 3))
    for pads in (((0, 3), (2, 0)), ((3, 0), (0, 2)), ((2, 1), (1, 1))):
        torch.testing.assert_close(kdw.dw_conv2d_same(x, w, pads), _library(x, w, pads),
                                   atol=2e-5, rtol=0)


def _torch_grads(fn, x, w):
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = fn(tx, tw)
    assert y.grad_fn is not None
    torch.sin(y).sum().backward()
    return tx.grad.numpy(), tw.grad.numpy()


def test_function_grads_match_jax_custom_vjp(rng):
    B, C, T, Fq, k_t, k_f = 8, 3, 20, 9, 3, 3  # tests/test_pallas_dw_conv.py:46
    pads = _pads(k_t, k_f)
    x, w = _inputs(rng, B, C, T, Fq, k_t, k_f)
    dx_j, dw_j = jax.grad(lambda a, b: jnp.sum(jnp.sin(jax_dw_conv2d_same(a, b, pads))),
                          argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    dx, dw = _torch_grads(lambda a, b: kdw.dw_conv2d_same(a, b, pads), x, w)
    np.testing.assert_allclose(dx, np.asarray(dx_j), atol=1e-4)
    np.testing.assert_allclose(dw, np.asarray(dw_j), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("B,C,T,Fq,k_t,k_f", CASES[:4])
def test_function_grads_match_autograd_through_conv2d(rng, B, C, T, Fq, k_t, k_f):
    """Odd, even and k_t != k_f kernels: the even ones have asymmetric pads,
    which dx's transposed padding must mirror."""
    pads = _pads(k_t, k_f)
    x, w = _inputs(rng, B, C, T, Fq, k_t, k_f)
    dx, dw = _torch_grads(lambda a, b: kdw.dw_conv2d_same(a, b, pads), x, w)
    dx_r, dw_r = _torch_grads(lambda a, b: _library(a, b, pads), x, w)
    np.testing.assert_allclose(dx, dx_r, atol=1e-4)
    np.testing.assert_allclose(dw, dw_r, rtol=1e-4, atol=1e-3)


def test_grad_of_one_argument_only(rng):
    x, w = (torch.from_numpy(a) for a in _inputs(rng, 2, 3, 8, 8, 4, 4))
    pads = _pads(4, 4)
    y = kdw.dw_conv2d_same(x, w.clone().requires_grad_(), pads)
    assert y.grad_fn is not None
    with torch.no_grad():  # no autograd: the Function is skipped
        assert kdw.dw_conv2d_same(x.clone().requires_grad_(), w, pads).grad_fn is None


def test_bf16_sums_in_float32(rng):
    """bf16 in, bf16 out: equal to the float32 result on the same
    (bf16-representable) activations and float32 weights, rounded once."""
    x, w = (torch.from_numpy(a) for a in _inputs(rng, 2, 3, 9, 10, 4, 4))
    pads = _pads(4, 4)
    got = kdw.dw_conv2d_same(x.bfloat16(), w, pads)
    assert got.dtype == torch.bfloat16
    want = kdw.dw_conv2d_same(x.bfloat16().float(), w, pads).bfloat16()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_rejects_bad_inputs(rng):
    x, w = (torch.from_numpy(a) for a in _inputs(rng, 2, 3, 8, 8, 3, 3))
    pads = _pads(3, 3)
    with pytest.raises(ValueError):
        kdw.dw_conv2d_same(x[0], w, pads)  # not 4-D
    with pytest.raises(ValueError):
        kdw.dw_conv2d_same(x, w[:2], pads)  # channels differ
    with pytest.raises(ValueError):
        kdw.dw_conv2d_same(x, w, ((0, 0), (1, 1)))  # would change the size
    with pytest.raises(ValueError):
        kdw.dw_conv2d_same(x, w, ((3, -1), (1, 1)))
    with pytest.raises(TypeError):
        kdw.dw_conv2d_same(x.double(), w.double(), pads)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_band_plan_fits_and_covers_main_path_shapes(itemsize):
    """Every main-path plane (any batch: the plan depends on (T, F) only)
    takes the band kernel with a plan that fits an H100 block's shared
    memory, whose bands cover all T rows, and whose block has a thread for
    every task of a band (strips x column groups) in whole warps."""
    for T, Fq in ((251, 129), (125, 64)):
        plan = kdw.band_plan(T, Fq, 4, 4, itemsize)
        groups = -(-Fq // kdw.columns(itemsize))
        tasks = plan.rows // kdw.STRIP * groups
        assert plan.rows > 0 and plan.rows % kdw.STRIP == 0
        assert 0 < plan.smem <= kdw.MAX_SMEM == 232448
        assert -(-T // plan.rows) * plan.rows >= T
        assert plan.threads % 32 == 0 and tasks <= plan.threads <= kdw.MAX_THREADS
        # two input buffers of R + 3 rows, one output buffer of R rows, each
        # with up to a 16-byte chunk of slack at both ends
        rows_smem = (2 * (plan.rows + 3) + plan.rows) * Fq * itemsize
        assert rows_smem < plan.smem <= rows_smem + 3 * 3 * 16


def test_band_plan_takes_the_generic_kernel_when_no_band_fits():
    assert kdw.band_plan(50, 9, 7, 2, 4).rows == 0  # k outside 2..5
    assert kdw.band_plan(20, 20000, 4, 4, 4).rows == 0  # one strip is > 227 KB
    small = kdw.band_plan(45, 7, 4, 4, 2)  # one warp: two column groups, three strips
    assert small.rows == 48 and small.threads == 32 and small.smem <= kdw.MAX_SMEM


def test_gate_rejects_unsupported():
    """tests/test_pallas_dw_conv.py:test_gate_rejects_unsupported, without
    the batch rule, which is the TPU's."""
    ok = dict(x_shape=(128, 8, 64, 32), kernel=(3, 3), stride=(1, 1),
              dilation=(1, 1), groups=8, in_chan=8, out_chan=8, ndim=2,
              pads=((1, 1), (1, 1)))
    assert kdw.dw_conv_supported(**ok)
    assert kdw.dw_conv_supported(**{**ok, "x_shape": (1, 8, 64, 32)})  # any batch
    assert kdw.dw_conv_supported(**{**ok, "kernel": (4, 4), "pads": ((1, 2), (1, 2))})
    assert not kdw.dw_conv_supported(**{**ok, "ndim": 1})
    assert not kdw.dw_conv_supported(**{**ok, "groups": 1})
    assert not kdw.dw_conv_supported(**{**ok, "out_chan": 16})
    assert not kdw.dw_conv_supported(**{**ok, "stride": (2, 1)})
    assert not kdw.dw_conv_supported(**{**ok, "dilation": (2, 2)})
    assert not kdw.dw_conv_supported(**{**ok, "kernel": (1, 1)})
    assert not kdw.dw_conv_supported(**{**ok, "x_shape": (8, 8, 2, 32)})  # T < k
    # shape-changing padding (valid conv) must not route to the kernel
    assert not kdw.dw_conv_supported(**{**ok, "pads": ((0, 0), (0, 0))})


@pytest.mark.parametrize("kernel,bias", [((3, 3), True), ((4, 4), False), ((2, 5), True)])
def test_conv_module_route(rng, monkeypatch, kernel, bias):
    """``Conv(groups=C, padding="same")`` gives the same output with the
    route on (a CPU tensor is sent to the wrapper, which runs its plain
    version) and off (``F.pad`` + ``F.conv2d``)."""
    x = torch.from_numpy(rng.standard_normal((4, 8, 24, 16)).astype(np.float32))
    m = conv.Conv(8, 8, kernel, ndim=2, padding="same", groups=8, bias=bias)
    m.reset_parameters(torch.Generator().manual_seed(0))
    calls = []
    plain = kdw.dw_conv2d_same_ref
    monkeypatch.setattr(kdw, "dw_conv2d_same_ref",
                        lambda *a: calls.append(1) or plain(*a))
    with torch.no_grad():
        assert not m.takes_dw_kernel(x)  # a CPU tensor stays on F.conv2d
        off = m(x)
        assert not calls
        monkeypatch.setattr(conv, "DW_KERNEL_DEVICES", ("cuda", "cpu"))
        assert m.takes_dw_kernel(x)
        on = m(x)
    assert len(calls) == 1
    torch.testing.assert_close(on, off, atol=2e-5, rtol=0)
    # convs the gate refuses keep their route
    for other in (conv.Conv(8, 8, 4, ndim=2, stride=2, padding=1, groups=8),
                  conv.Conv(8, 8, 1, ndim=2, groups=8),
                  conv.Conv(8, 16, 3, ndim=2, padding="same"),
                  conv.Conv(8, 8, 3, ndim=1, padding="same", groups=8)):
        assert not other.takes_dw_kernel(x if other.ndim == 2 else x[..., 0])


def test_conv_module_route_trains(rng, monkeypatch):
    """With the route on, the module's parameters get the gradients they
    get through ``F.conv2d``."""
    x = torch.from_numpy(rng.standard_normal((4, 6, 10, 9)).astype(np.float32))
    m = conv.Conv(6, 6, 4, ndim=2, padding="same", groups=6)
    grads = {}
    for route in (("cuda",), ("cuda", "cpu")):
        monkeypatch.setattr(conv, "DW_KERNEL_DEVICES", route)
        m.zero_grad()
        xi = x.clone().requires_grad_()
        torch.sin(m(xi)).sum().backward()
        grads[route] = (xi.grad, m.weight.grad.clone(), m.bias.grad.clone())
    for on, off in zip(grads[("cuda", "cpu")], grads[("cuda",)]):
        torch.testing.assert_close(on, off, atol=1e-4, rtol=1e-4)
