"""PyTorch port vs JAX package: the SRU recurrence kernel's plain version,
the SRU module, and the kernel wrapper's dispatch and input checks.

* ``sru_stack_layer_ref`` (reached through the wrapper with CPU tensors)
  against the JAX Pallas kernel ``sru_stack_layer`` in interpret mode,
  within 1e-5 as tests/test_pallas_sru_v3.py holds the kernel to scan;
* the port ``SRU`` against the JAX ``SRU`` (its scan path), within 1e-5.

The CUDA kernel itself runs only on the card (``python3 chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtfs_net_tpu.ops.pallas.sru_kernel_v3 import sru_stack_layer as jax_sru_stack_layer
from rtfs_net_tpu.ops.rnn import SRU as JaxSRU
from rtfs_net_tpu_torch.models import build_model
from rtfs_net_tpu_torch.ops import rnn
from rtfs_net_tpu_torch.ops.kernels import sru as ksru
from rtfs_net_tpu_torch.utils import convert
from rtfs_net_tpu_torch.utils.separator import separate

from _torch_port import jax_apply, jax_init, load, one_torch_thread, port_apply  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


def _layer_inputs(rng, L, k, H, ndir, B):
    O = H * ndir
    u = rng.standard_normal((L, k * O, B)).astype(np.float32)
    skip = rng.standard_normal((L, O, B)).astype(np.float32)
    v = (0.5 * rng.standard_normal(2 * O)).astype(np.float32)
    b = (0.5 * rng.standard_normal(2 * O)).astype(np.float32)
    return u, skip, v, b


# edge shapes (chip_smoke.py's SRU_EDGE): (L, rows, k, ndir): L = 1 and 2,
# odd rows 63 and 125 (the bfloat16 ring takes no odd rows)
EDGE_CASES = [(1, 16, 3, 2), (2, 16, 4, 1), (2, 63, 4, 2), (3, 125, 3, 1)]


@pytest.mark.parametrize(
    "k,ndir,L,B",
    [pytest.param(k, ndir, 9, 16, id=f"{ndir}-{k}") for k in (3, 4) for ndir in (1, 2)]
    + [pytest.param(k, ndir, L, B, id=f"edge-L{L}-rows{B}-k{k}-ndir{ndir}")
       for L, B, k, ndir in EDGE_CASES])
def test_stack_layer_ref_matches_pallas_kernel(rng, k, ndir, L, B):
    H = 8
    u, skip, v, b = _layer_inputs(rng, L, k, H, ndir, B)
    want = np.asarray(jax_sru_stack_layer(
        jnp.asarray(u), jnp.asarray(skip), jnp.asarray(v), jnp.asarray(b),
        H=H, k=k, ndir=ndir, interpret=True))
    before = ksru.launches
    got = ksru.sru_stack_layer(*(torch.from_numpy(a) for a in (u, skip, v, b)),
                               H=H, k=k, ndir=ndir)
    assert ksru.launches == before  # CPU tensors never count as a launch
    assert got.shape == (L, H * ndir, B)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_stack_layer_bf16_keeps_float32_carry(rng):
    """bf16 in, bf16 out, float32 carry: the plain version on bf16 inputs
    equals the float32 computation on the same (bf16-representable)
    inputs, rounded once at the end."""
    H, L, B, k, ndir = 8, 12, 16, 3, 2
    args = [torch.from_numpy(a).bfloat16() for a in _layer_inputs(rng, L, k, H, ndir, B)]
    got = ksru.sru_stack_layer(*args, H=H, k=k, ndir=ndir)
    assert got.dtype == torch.bfloat16
    want = ksru.sru_stack_layer_ref(*(a.float() for a in args), H=H, k=k, ndir=ndir)
    torch.testing.assert_close(got, want.bfloat16(), atol=0, rtol=0)


def test_launch_plan_fits_main_path_launches():
    """At the main path's shapes (rows 125·B and 64·B for B = 1, 4, 16, 128,
    64 channels) a ring launch keeps every block of the launch resident at
    once: no more blocks per SM than its thread limit, and their rings in
    its shared memory. The deep ring goes where an SM gets one block, the
    shallow one up to a full card, the narrow kernel to the B=128 launches
    (several waves) and to odd bfloat16 rows."""
    O = 64
    for B in (1, 4, 16, 128):
        for rows in (125 * B, 64 * B):
            for itemsize in (4, 2):
                depth = ksru.launch_plan(rows, O, itemsize)
                per_sm = -(-(-(-rows // ksru.THREADS) * O) // ksru.SMS)
                if B == 128 or (itemsize == 2 and rows % 2):
                    assert depth == 0
                    continue
                assert depth == (ksru.DEEP if per_sm == 1 else ksru.SHALLOW)
                stage = ksru.THREADS * ksru.OPERANDS * itemsize
                assert per_sm <= ksru.BLOCKS_AT_ONCE
                assert per_sm * (depth * stage + 1024) <= ksru.SMEM_PER_SM


def test_launch_plan_takes_the_narrow_kernel_when_misaligned():
    """A bfloat16 ring copies 4-byte words of two rows: odd rows or an
    operand that starts off a 4-byte boundary take the narrow kernel;
    float32 rows are always aligned."""
    assert ksru.launch_plan(500, 64, 2, aligned=False) == 0
    assert ksru.launch_plan(63, 64, 2) == 0
    assert ksru.launch_plan(63, 64, 4) > 0
    assert ksru.launch_plan(500, 64, 4, aligned=False) > 0
    assert ksru.launch_plan(500, 64, 2) > 0
    t = torch.zeros(9, dtype=torch.bfloat16)
    assert ksru._aligned(t, None) and not ksru._aligned(t, t[1:])


def test_stack_layer_rejects_bad_inputs(rng):
    u, skip, v, b = (torch.from_numpy(a) for a in _layer_inputs(rng, 5, 3, 4, 2, 8))
    with pytest.raises(ValueError):
        ksru.sru_stack_layer(u.transpose(0, 2).contiguous().transpose(0, 2),
                             skip, v, b, H=4, k=3, ndir=2)  # not contiguous
    with pytest.raises(ValueError):
        ksru.sru_stack_layer(u, None, v, b, H=4, k=3, ndir=2)  # k=3 without skip
    with pytest.raises(ValueError):
        ksru.sru_stack_layer(u, skip, v, b, H=4, k=4, ndir=2)  # channels != k*O
    with pytest.raises(TypeError):
        ksru.sru_stack_layer(u.double(), skip.double(), v, b, H=4, k=3, ndir=2)
    with pytest.raises(ValueError):
        ksru.sru_stack_layer(u, skip, v[:-1], b, H=4, k=3, ndir=2)


@pytest.mark.parametrize("num_layers", [1, 3])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_sru_matches_jax_scan(rng, num_layers, bidirectional):
    L, B, d_in, H = 11, 5, 12, 4
    x = rng.standard_normal((L, B, d_in)).astype(np.float32)
    jm = JaxSRU(d_in, H, num_layers, bidirectional)
    v = jax_init(jm, rng, x)
    pm = load(rnn.SRU(d_in, H, num_layers, bidirectional), convert.sru, v, H, bidirectional)
    np.testing.assert_allclose(port_apply(pm, x), jax_apply(jm, v, x), **TOL)


@pytest.mark.parametrize("C,k_w,s_w", [
    (6, 4, 1),  # layer 0 has k=4 (C·k != out), as in every RTFS config
    (4, 2, 2),  # C·k == out: k=3 at layer 0, highway from the unfolded windows
])
def test_sru_windowed_matches_jax(rng, C, k_w, s_w):
    """``window=(k, s)``: layer 0 projects the pre-unfold (rows, C, T)
    tensor with one k-wide conv (rows of the weight ordered c*k + tap)."""
    H, rows, T = 4, 6, 13
    x = rng.standard_normal((rows, C, T)).astype(np.float32)
    jm = JaxSRU(C * k_w, H, 2, True)
    v = jax_init(jm, rng, x, window=(k_w, s_w))
    pm = load(rnn.SRU(C * k_w, H, 2, True), convert.sru, v, H, True)
    want = jax_apply(jm, v, x, window=(k_w, s_w))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), window=(k_w, s_w)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_entry_points_refuse_cpu_without_device(monkeypatch):
    """On a box without CUDA the entry points raise instead of quietly
    running on the CPU; ``device="cpu"`` is the explicit way there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = {"n_src": 1,
            "enc_dec_params": {"encoder_type": "STFTEncoder",
                               "decoder_type": "STFTDecoder", "win": 16,
                               "hop_length": 8, "out_chan": 4, "kernel_size": 3},
            "audio_bn_params": {"out_chan": 4, "kernel_size": 1, "is2d": True},
            "audio_params": {"audio_net": None, "repeats": 1},
            "mask_generation_params": {"RI_split": True, "is2d": True}}
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(conf)
    model = build_model(conf, device="cpu")
    wav = np.zeros((1, 64), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        separate(model, wav)
    assert separate(model, wav, device="cpu").shape == (1, 1, 64)
