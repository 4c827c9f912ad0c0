"""PyTorch port vs JAX package: the SRU training kernel's plain versions,
the differentiable SRU, and the routing between the two SRU kernels.

* ``sru_train_forward_ref`` and ``sru_train_backward_ref`` (reached
  through the wrappers with CPU tensors) against the JAX Pallas kernel
  ``sru_direction_train`` in interpret mode, direction by direction: h and
  c within 1e-5, the input and gate gradients of ``jax.vjp`` within
  2e-4·max(1, |ref|), the tolerance of tests/test_pallas_sru_v3.py:139-165;
* the plain backward against torch autograd through the plain forward
  (float32, 1e-5·max(1, |ref|));
* the port ``SRU``'s parameter and input grads, windowed layer 0
  included, against ``jax.grad`` through the JAX ``SRU`` (its scan path),
  within 2e-4·max(1, |ref|);
* ``sru_stack_layer`` refuses autograd, and ``SRUCell.recur`` sends a
  grad-enabled call to the training kernel and a no-grad call to the
  inference kernel.

The CUDA kernels themselves run only on the card (``python3 chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtfs_net_tpu.ops.pallas import sru_train as jax_sru_train
from rtfs_net_tpu.ops.rnn import SRU as JaxSRU
from rtfs_net_tpu_torch.ops import rnn
from rtfs_net_tpu_torch.ops.kernels import sru as ksru
from rtfs_net_tpu_torch.ops.kernels import sru_train as ktrain
from rtfs_net_tpu_torch.utils import convert

from _torch_port import jax_init, load, one_torch_thread  # noqa: F401

H, L, ROWS = 8, 9, 16


def _inputs(rng, k, ndir, L=L, rows=ROWS):
    O = H * ndir
    arrays = dict(u=rng.standard_normal((L, k * O, rows)),
                  skip=rng.standard_normal((L, O, rows)) if k == 3 else None,
                  v=0.5 * rng.standard_normal(2 * O), b=0.5 * rng.standard_normal(2 * O),
                  dh=rng.standard_normal((L, O, rows)))
    return {n: None if a is None else a.astype(np.float32) for n, a in arrays.items()}


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


@jax.jit
def _jax_direction(u0, u1, u2, sk, vf, vr, bf, br, dh, reverse):
    """h, c and the vjp of one direction, through the Pallas kernel in
    interpret mode."""
    gates = jax_sru_train._gates(vf, vr, bf, br)
    h, c = jax.lax.cond(
        reverse,
        lambda: jax_sru_train._fwd_call(u0, u1, u2, sk, gates, True, True),
        lambda: jax_sru_train._fwd_call(u0, u1, u2, sk, gates, False, True))

    def grads(rev):
        _, vjp = jax.vjp(lambda *a: jax_sru_train.sru_direction_train(*a, rev, True),
                         u0, u1, u2, sk, vf, vr, bf, br)
        return vjp(dh)

    return h, c, jax.lax.cond(reverse, lambda: grads(True), lambda: grads(False))


# the card's edge shapes (chip_smoke.py's SRU_EDGE): (L, rows, k, ndir):
# L = 1 and 2, rows 125 and 63 (odd) and 500
EDGE_CASES = [(1, 125, 3, 1), (2, 63, 4, 2), (2, 500, 3, 2)]


@pytest.mark.parametrize(
    "k,ndir,L,ROWS",
    [pytest.param(k, ndir, L, ROWS, id=f"{ndir}-{k}") for k in (3, 4) for ndir in (1, 2)]
    + [pytest.param(k, ndir, L_, rows, id=f"edge-L{L_}-rows{rows}-k{k}-ndir{ndir}")
       for L_, rows, k, ndir in EDGE_CASES])
def test_plain_versions_match_pallas_kernel(rng, k, ndir, L, ROWS):
    a = _inputs(rng, k, ndir, L, ROWS)
    O = H * ndir
    t = {n: None if x is None else torch.from_numpy(x) for n, x in a.items()}
    launches = (ktrain.forward_launches, ktrain.backward_launches)
    h, c = ktrain.sru_train_forward(t["u"], t["skip"], t["v"], t["b"], H=H, k=k, ndir=ndir)
    du, dskip, dv, db = ktrain.sru_train_backward(t["u"], t["skip"], c, t["v"], t["b"],
                                                  t["dh"], H=H, k=k, ndir=ndir)
    assert (ktrain.forward_launches, ktrain.backward_launches) == launches  # CPU: no launch
    assert dskip is None if k == 4 else dskip.shape == (L, O, ROWS)
    u = a["u"].reshape(L, k, O, ROWS)
    du = du.numpy().reshape(L, k, O, ROWS)
    for d in range(ndir):
        s = slice(d * H, (d + 1) * H)
        sk = u[:, 3, s] if k == 4 else a["skip"][:, s]
        gv, gb = (a["v"][:O][s], a["v"][O:][s]), (a["b"][:O][s], a["b"][O:][s])
        jh, jc, g = _jax_direction(u[:, 0, s], u[:, 1, s], u[:, 2, s], sk, gv[0], gv[1],
                                   gb[0], gb[1], a["dh"][:, s], d == 1)
        np.testing.assert_allclose(h.numpy()[:, s], jh, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(c.numpy()[:, s], jc, atol=1e-5, rtol=1e-5)
        for chunk in range(3):
            _close(du[:, chunk, s], g[chunk], 2e-4)
        _close(du[:, 3, s] if k == 4 else dskip.numpy()[:, s], g[3], 2e-4)
        for got, want in ((dv[:O][s], g[4]), (dv[O:][s], g[5]), (db[:O][s], g[6]),
                          (db[O:][s], g[7])):
            _close(got.numpy(), want, 2e-4)


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("ndir", [1, 2])
def test_plain_backward_matches_autograd(rng, k, ndir):
    a = _inputs(rng, k, ndir)
    leaves = {n: torch.from_numpy(x).requires_grad_() for n, x in a.items()
              if x is not None and n != "dh"}
    dh = torch.from_numpy(a["dh"])
    skip = leaves.get("skip")
    h, _ = ktrain.sru_train_forward_ref(leaves["u"], skip, leaves["v"], leaves["b"],
                                        H=H, k=k, ndir=ndir)
    want = torch.autograd.grad(h, list(leaves.values()), dh)
    with torch.no_grad():
        _, c = ktrain.sru_train_forward_ref(leaves["u"], skip, leaves["v"], leaves["b"],
                                            H=H, k=k, ndir=ndir)
        du, dskip, dv, db = ktrain.sru_train_backward_ref(
            leaves["u"], skip, c, leaves["v"], leaves["b"], dh, H=H, k=k, ndir=ndir)
    got = [du] + ([dskip] if k == 3 else []) + [dv, db]
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy(), 1e-5)


def test_bf16_plain_versions_round_once(rng):
    """bf16 in and out, float32 math on the stored (bf16) c: equal to the
    float32 computation on the same bf16-representable values, rounded."""
    k, ndir = 3, 2
    t = {n: None if x is None else torch.from_numpy(x).bfloat16()
         for n, x in _inputs(rng, k, ndir).items()}
    t["v"], t["b"] = t["v"].float(), t["b"].float()
    h, c = ktrain.sru_train_forward(t["u"], t["skip"], t["v"], t["b"], H=H, k=k, ndir=ndir)
    h32, c32 = ktrain.sru_train_forward_ref(t["u"].float(), t["skip"].float(), t["v"], t["b"],
                                            H=H, k=k, ndir=ndir)
    assert h.dtype == c.dtype == torch.bfloat16
    torch.testing.assert_close(h, h32.bfloat16(), atol=0, rtol=0)
    torch.testing.assert_close(c, c32.bfloat16(), atol=0, rtol=0)
    got = ktrain.sru_train_backward(t["u"], t["skip"], c, t["v"], t["b"], t["dh"],
                                    H=H, k=k, ndir=ndir)
    want = ktrain.sru_train_backward_ref(t["u"].float(), t["skip"].float(), c.float(), t["v"],
                                         t["b"], t["dh"].float(), H=H, k=k, ndir=ndir)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g, w.bfloat16(), atol=0, rtol=0)
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_ring_depth_fits_main_path_launches():
    """At the main path's shapes (rows 125·B and 64·B for B = 1, 4, 16, 64
    channels) the ring takes a depth of ``DEPTHS`` at which all the
    launch's blocks fit an SM's shared memory at once, in both dtypes; only
    odd rows in bfloat16 take the narrow kernel."""
    O = 64
    for B in (1, 4, 16):
        for rows in (125 * B, 64 * B):
            for itemsize in (4, 2):
                for which in ("forward", "backward"):
                    depth = ktrain.ring_depth(rows, O, itemsize, which)
                    if itemsize == 2 and rows % 2:
                        assert depth == 0
                        continue
                    assert depth in ktrain.DEPTHS[which]
                    per_sm = -(-(-(-rows // 128) * O) // ktrain.SMS)
                    stage = 4 * ktrain.OPERANDS[which] * 32 * itemsize
                    assert per_sm * (depth * stage + 1024) <= ktrain.SMEM_PER_SM


def test_ring_depth_takes_the_narrow_kernel_when_misaligned():
    """A bfloat16 ring copies 4-byte words of two rows: odd rows or an
    operand that starts off a 4-byte boundary take the narrow kernel;
    float32 rows are always aligned."""
    assert ktrain.ring_depth(500, 64, 2, "forward", aligned=False) == 0
    assert ktrain.ring_depth(63, 64, 2, "backward") == 0
    assert ktrain.ring_depth(63, 64, 4, "backward") > 0
    assert ktrain.ring_depth(500, 64, 2, "forward") > 0
    t = torch.zeros(9, dtype=torch.bfloat16)
    assert ktrain._aligned(t, None) and not ktrain._aligned(t[1:])


def test_backward_rejects_bad_inputs(rng):
    t = {n: torch.from_numpy(x) for n, x in _inputs(rng, 3, 2).items()}
    _, c = ktrain.sru_train_forward(t["u"], t["skip"], t["v"], t["b"], H=H, k=3, ndir=2)
    with pytest.raises(ValueError):  # dh of the wrong shape
        ktrain.sru_train_backward(t["u"], t["skip"], c, t["v"], t["b"], t["dh"][:-1],
                                  H=H, k=3, ndir=2)
    with pytest.raises(ValueError):  # c in another dtype
        ktrain.sru_train_backward(t["u"], t["skip"], c.bfloat16(), t["v"], t["b"], t["dh"],
                                  H=H, k=3, ndir=2)


@pytest.mark.parametrize("window", [None, (6, 4, 1), (4, 2, 2)],
                         ids=["plain", "window-k4", "window-k3"])
def test_sru_grads_match_jax(rng, window):
    """Grads of sum(SRU(x) * w) for every parameter and for x. Layer 0 of
    the (6, 4, 1) window has k=4 (C·k != out); of (4, 2, 2), k=3."""
    Hs, layers = 4, 2
    if window is None:
        d_in, x = 12, rng.standard_normal((11, 5, 12)).astype(np.float32)
        kw = {}
    else:
        C, k_w, s_w = window
        d_in, x = C * k_w, rng.standard_normal((6, C, 13)).astype(np.float32)
        kw = {"window": (k_w, s_w)}
    jm = JaxSRU(d_in, Hs, layers, True)
    v = jax_init(jm, rng, x, **kw)
    out_shape = jax.eval_shape(lambda: jm.apply(v, x, **kw)).shape
    w = rng.standard_normal(out_shape).astype(np.float32)

    def loss(params, x):
        return jnp.sum(jm.apply({"params": params}, x, **kw) * w)

    jg_params, jg_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], x)
    want = convert.module_state_dict(convert.sru, {"params": jg_params}, Hs, True)

    pm = load(rnn.SRU(d_in, Hs, layers, True), convert.sru, v, Hs, True)
    xt = torch.from_numpy(x).requires_grad_()
    (pm(xt, **kw) * torch.from_numpy(w)).sum().backward()
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        _close(got[n].numpy(), want[n].numpy(), 2e-4)
    _close(xt.grad.numpy(), jg_x, 2e-4)


def test_stack_layer_refuses_autograd(rng):
    t = {n: None if x is None else torch.from_numpy(x) for n, x in _inputs(rng, 3, 2).items()}
    v = t["v"].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ksru.sru_stack_layer(t["u"], t["skip"], v, t["b"], H=H, k=3, ndir=2)
    with torch.no_grad():
        ksru.sru_stack_layer(t["u"], t["skip"], v, t["b"], H=H, k=3, ndir=2)


def test_recur_routes_by_grad_mode(rng, monkeypatch):
    calls = []
    for name in ("sru_layer_train", "sru_stack_layer"):
        real = getattr(rnn, name)
        monkeypatch.setattr(rnn, name, lambda *a, _real=real, _name=name, **kw: (
            calls.append(_name), _real(*a, **kw))[1])
    sru = rnn.SRU(12, 4, 2, True)
    x = torch.from_numpy(rng.standard_normal((7, 3, 12)).astype(np.float32))
    with torch.no_grad():
        want = sru(x)
    assert calls == ["sru_stack_layer"] * 2
    calls.clear()
    got = sru(x)
    assert calls == ["sru_layer_train"] * 2
    got.sum().backward()
    assert all(bool(p.grad.abs().sum() > 0) for p in sru.parameters())
    torch.testing.assert_close(got.detach(), want, atol=0, rtol=0)
