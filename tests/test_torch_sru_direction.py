"""PyTorch port vs JAX package: the per-direction SRU kernel K4 and the
``"pallas"`` route of ``SRU``.

* ``sru_direction`` with CPU tensors (its plain version) against the JAX
  Pallas kernel ``sru_direction_pallas`` in interpret mode at the shapes of
  tests/test_pallas_sru.py (atol 1e-6), on strided slices of one projection;
* ``SRU(backend="pallas")`` against ``SRU(backend="scan")`` in the port and
  against the JAX module (atol 1e-5), with and without a window;
* the refusal under autograd, and unknown backends.

The CUDA kernel itself runs only on the card
(``tests/test_torch_card_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtfs_net_tpu.ops.pallas.sru_kernel import sru_direction_pallas
from rtfs_net_tpu.ops.rnn import SRU as JaxSRU
from rtfs_net_tpu_torch.ops import rnn
from rtfs_net_tpu_torch.ops.kernels import sru as ksru
from rtfs_net_tpu_torch.ops.kernels import sru_direction as kdir
from rtfs_net_tpu_torch.utils import convert

from _torch_port import jax_apply, jax_init, load, one_torch_thread, port_apply  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


def _direction_inputs(rng, L, B, H):
    u = rng.standard_normal((L, B, 3, H)).astype(np.float32)
    skip = rng.standard_normal((L, B, H)).astype(np.float32)
    gates = [(0.3 * rng.standard_normal(H)).astype(np.float32) for _ in range(4)]
    return u, skip, gates


# edge shapes (SRU_DIR_EDGE of tests/test_torch_card_kernels.py):
# (L, B, H, offset): L = 1 and 2, odd rows 63 and 125, odd H, and u's
# storage starting at an odd element offset (the bfloat16 ring takes
# neither odd H nor misaligned words)
EDGE_CASES = [(1, 16, 8, 0), (2, 63, 8, 0), (5, 125, 8, 0), (13, 16, 7, 0), (13, 16, 8, 1)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize(
    "L,B,H,offset",
    [pytest.param(L, B, H, 0, id=f"{L}-{B}-{H}")
     for L, B, H in [(13, 16, 8), (57, 40, 32)]]  # tests/test_pallas_sru.py:16
    + [pytest.param(L, B, H, offset, id=f"edge-L{L}-rows{B}-H{H}-offset{offset}")
       for L, B, H, offset in EDGE_CASES])
def test_plain_version_matches_pallas_kernel(rng, reverse, L, B, H, offset):
    u, skip, gates = _direction_inputs(rng, L, B, H)
    ju = jnp.asarray(u)
    want = np.asarray(sru_direction_pallas(
        ju[:, :, 0], ju[:, :, 1], ju[:, :, 2], jnp.asarray(skip),
        *(jnp.asarray(g) for g in gates), reverse=reverse, interpret=True))
    flat = torch.from_numpy(np.concatenate([np.zeros(offset, np.float32), u.ravel()]))
    tu = flat[offset:].view(u.shape)
    before = kdir.launches
    got = kdir.sru_direction(tu[:, :, 0], tu[:, :, 1], tu[:, :, 2], torch.from_numpy(skip),
                             *(torch.from_numpy(g) for g in gates), reverse=reverse)
    assert kdir.launches == before  # CPU tensors never count as a launch
    assert got.shape == (L, B, H) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_launch_plan_fits_main_path_launches():
    """At the main path's shapes (rows 125·B and 64·B for B = 1, 4, 16, 128,
    H = 32) a ring launch keeps every block resident at once, in both
    dtypes: the deep ring where an SM gets one block, the shallow one up to
    a full card; launches of several waves take the narrow kernel."""
    H = 32
    for B in (1, 4, 16, 128):
        for rows in (125 * B, 64 * B):
            for itemsize in (4, 2):
                depth = kdir.launch_plan(rows, H, itemsize)
                per_sm = -(-(-(-rows * H // ksru.THREADS)) // ksru.SMS)
                if per_sm > ksru.BLOCKS_AT_ONCE or depth == 0:
                    assert depth == 0 and B == 128
                    continue
                assert depth == (ksru.DEEP if per_sm == 1 else ksru.SHALLOW)
                stage = ksru.THREADS * ksru.OPERANDS * itemsize
                assert per_sm * (depth * stage + 1024) <= ksru.SMEM_PER_SM


def test_launch_plan_takes_the_narrow_kernel_when_misaligned():
    """A bfloat16 ring copies 4-byte words of two neighbouring h: odd H, or
    an operand whose base or strides break the word alignment, take the
    narrow kernel; float32 takes the ring whatever its layout."""
    assert kdir.launch_plan(500, 33, 2) == 0
    assert kdir.launch_plan(500, 32, 2, aligned=False) == 0
    assert kdir.launch_plan(500, 32, 2) > 0
    assert kdir.launch_plan(500, 33, 4, aligned=False) > 0
    u = torch.zeros((3, 5, 4, 66), dtype=torch.bfloat16)
    assert kdir._words_aligned(u[:, :, 1, 32:64])
    assert not kdir._words_aligned(u[:, :, 1, 33:65])       # odd base
    odd_strides = torch.zeros((3, 5, 33), dtype=torch.bfloat16)[:, :, :32]
    assert not kdir._words_aligned(odd_strides)


def test_bf16_keeps_float32_carry(rng):
    u, skip, gates = _direction_inputs(rng, 12, 6, 8)
    tu, ts = torch.from_numpy(u).bfloat16(), torch.from_numpy(skip).bfloat16()
    gates = [torch.from_numpy(g) for g in gates]
    got = kdir.sru_direction(tu[:, :, 0], tu[:, :, 1], tu[:, :, 2], ts, *gates, reverse=True)
    assert got.dtype == torch.bfloat16
    tf = tu.float()
    want = kdir.sru_direction_ref(tf[:, :, 0], tf[:, :, 1], tf[:, :, 2], ts.float(), *gates,
                                  reverse=True)
    torch.testing.assert_close(got, want.bfloat16(), atol=0, rtol=0)


def test_rejects_bad_inputs_and_autograd(rng):
    u, skip, gates = _direction_inputs(rng, 5, 4, 8)
    tu, ts = torch.from_numpy(u), torch.from_numpy(skip)
    gates = [torch.from_numpy(g) for g in gates]
    ops = (tu[:, :, 0], tu[:, :, 1], tu[:, :, 2], ts)
    with pytest.raises(ValueError):
        kdir.sru_direction(ops[0][0], *ops[1:], *gates)  # not 3-D
    with pytest.raises(ValueError):
        kdir.sru_direction(*ops[:3], ts[:, :3], *gates)  # skip's rows differ
    with pytest.raises(ValueError):
        kdir.sru_direction(*ops, gates[0][:-1], *gates[1:])
    with pytest.raises(TypeError):
        kdir.sru_direction(*(t.double() for t in ops), *gates)
    # no backward: a call autograd would have to differentiate is refused
    with pytest.raises(RuntimeError, match="no backward"):
        kdir.sru_direction(ops[0].clone().requires_grad_(), *ops[1:], *gates)
    with pytest.raises(RuntimeError, match="no backward"):
        kdir.sru_direction(*ops, gates[0].clone().requires_grad_(), *gates[1:])
    with torch.no_grad():
        kdir.sru_direction(ops[0].clone().requires_grad_(), *ops[1:], *gates)


def _pair(jax_variables, d_in, H, num_layers, bidirectional):
    """The port's SRU with the same weights on both routes."""
    return [load(rnn.SRU(d_in, H, num_layers, bidirectional, backend=backend),
                 convert.sru, jax_variables, H, bidirectional)
            for backend in ("scan", "pallas")]


@pytest.mark.parametrize("num_layers,bidirectional", [(2, True), (3, False)])
def test_sru_pallas_backend_matches_scan_and_jax(rng, num_layers, bidirectional):
    L, B, d_in, H = 11, 6, 24, 8  # tests/test_pallas_sru.py:35
    x = rng.standard_normal((L, B, d_in)).astype(np.float32)
    jm = JaxSRU(d_in, H, num_layers, bidirectional)
    v = jax_init(jm, rng, x)  # gate vectors perturbed off zero
    scan, pallas = _pair(v, d_in, H, num_layers, bidirectional)
    calls = kdir.launches
    got = port_apply(pallas, x)
    assert kdir.launches == calls
    np.testing.assert_allclose(got, port_apply(scan, x), **TOL)
    np.testing.assert_allclose(got, jax_apply(jm, v, x), **TOL)


@pytest.mark.parametrize("C,k_w,s_w", [
    (6, 4, 1),  # layer 0 has k=4: the highway comes from the projection
    (4, 2, 2),  # C*k == out: k=3 at layer 0, highway from the unfolded windows
])
def test_sru_pallas_backend_windowed(rng, C, k_w, s_w):
    H, rows, T = 4, 6, 13
    x = rng.standard_normal((rows, C, T)).astype(np.float32)
    jm = JaxSRU(C * k_w, H, 2, True)
    v = jax_init(jm, rng, x, window=(k_w, s_w))
    scan, pallas = _pair(v, C * k_w, H, 2, True)
    with torch.no_grad():
        got = pallas(torch.from_numpy(x), window=(k_w, s_w)).numpy()
        want = scan(torch.from_numpy(x), window=(k_w, s_w)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, jax_apply(jm, v, x, window=(k_w, s_w)), **TOL)


def test_default_backend_is_read_at_each_call(rng, monkeypatch):
    """An SRU built without ``backend`` follows ``DEFAULT_SRU_BACKEND``: one
    ``sru_direction`` call per layer and direction on the ``"pallas"``
    route, none on ``"scan"``."""
    assert rnn.DEFAULT_SRU_BACKEND == "scan"
    m = rnn.SRU(12, 4, num_layers=3, bidirectional=True).eval()
    x = torch.from_numpy(rng.standard_normal((7, 5, 12)).astype(np.float32))
    calls = []
    real = rnn.sru_direction
    monkeypatch.setattr(rnn, "sru_direction", lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        want = m(x)
        assert not calls
        monkeypatch.setattr(rnn, "DEFAULT_SRU_BACKEND", "pallas")
        got = m(x)
    assert len(calls) == 6
    torch.testing.assert_close(got, want, **TOL)


def test_pallas_backend_refuses_autograd_and_unknown_backends(rng, monkeypatch):
    x = torch.from_numpy(rng.standard_normal((7, 5, 12)).astype(np.float32))
    m = rnn.SRU(12, 4, bidirectional=True, backend="pallas")
    with pytest.raises(RuntimeError, match="no backward"):
        m(x)  # grad mode on, parameters require grad
    with torch.no_grad():
        assert m(x).shape == (7, 5, 8)
    with pytest.raises(ValueError, match="backend"):
        rnn.SRU(12, 4, backend="cuda")
    monkeypatch.setattr(rnn, "DEFAULT_SRU_BACKEND", "lanes")
    with pytest.raises(ValueError, match="backend"), torch.no_grad():
        rnn.SRU(12, 4)(x)
