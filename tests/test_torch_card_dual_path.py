"""The DualPathRNN's layout kernels on an NVIDIA card
(``rtfs_net_tpu_torch/csrc/dual_path.cu``), against their plain versions,
and the routes they serve.

Marked ``card``; each test skips without a card (``tests/_torch_card.py``).
Neither this file nor what it imports loads JAX, so it runs on a machine
without it (``--noconftest`` keeps the suite's JAX-importing
``conftest.py`` out)::

    python3 -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_card_dual_path.py

* ``dual_path_norm_in`` and ``dual_path_out`` along T and F, float32 and
  bfloat16, at the RTFS-Net-4 block's plane (C = 64, T = 126, F = 65) and at
  small odd sizes (a dimension of 1, sizes not a multiple of the 32-wide
  tile), and at the B = 128 bfloat16 block of the benchmark's serving call
  and the B = 16 float32 one of RTFS-Net-4's (125, 64) plane: float32
  within 1e-5 + 1e-5·|ref| (Welford's statistics and the card's rsqrtf
  against torch's), bfloat16 within 1e-5 + 2^-7·|ref| (one rounding that
  may land on the neighbouring value);
* K1 with zero end steps (``pad``) against its plain version, zero padded;
* the DualPathRNN's sequence-layout route against its autograd route on
  the same weights, at RTFS-Net-4's widths, both axes and both dtypes;
* ``dual_path_windows_in`` along T and F, both dtypes, at TF-GridNet's
  block (C = 128, T = 251, F = 129) with B = 2 and k = 4 (and B = 128 in
  bfloat16, the benchmark's serving call), and at small
  sizes: L = 1, k = 3 (the kernel for any k), C·k not a multiple of a
  16-byte vector (scalar stores), x permuted as a DualPathRNN along F
  hands it on; the tolerances above;
* the LSTM DualPathRNN's window-layout route against its autograd route at
  TF-GridNet's widths, both axes and both dtypes.
"""
import pytest
import torch

from rtfs_net_tpu_torch.models.layers import rnn_blocks
from rtfs_net_tpu_torch.ops.kernels import dual_path, sru

from _torch_card import DTYPE_IDS, DTYPES, assert_close, assert_launches, card, randn  # noqa: F401

pytestmark = pytest.mark.card

# (B, C, T, F), each in both dtypes; then the B = 128 bfloat16 block and the
# B = 16 float32 one of RTFS-Net-4's global features
SHAPES = [(2, 64, 126, 65), (3, 5, 37, 33), (1, 1, 1, 1), (2, 7, 1, 40), (1, 3, 70, 9)]
CASES = [(shape, dtype) for shape in SHAPES for dtype in DTYPES] + [
    ((128, 64, 126, 65), torch.bfloat16), ((16, 64, 125, 64), torch.float32)]
CASE_IDS = ["x".join(map(str, shape)) + "-" + str(dtype)[6:] for shape, dtype in CASES]


@pytest.mark.parametrize("seq_dim", [2, 3], ids=["T", "F"])
@pytest.mark.parametrize("shape,dtype", CASES, ids=CASE_IDS)
def test_norm_in_kernel(card, shape, seq_dim, dtype):
    gen = torch.Generator(device=card).manual_seed(sum(shape) + seq_dim)
    C = shape[1]
    x = (randn(gen, *shape) * 3 + 1).to(dtype)
    gamma = 1 + 0.1 * randn(gen, C)
    beta = 0.1 * randn(gen, C)
    got = assert_launches(
        lambda: dual_path.dual_path_norm_in(x, gamma, beta, seq_dim=seq_dim, eps=1e-5),
        {"dual_path_norm_in": 1})
    want = dual_path.dual_path_norm_in_ref(x, gamma, beta, seq_dim, 1e-5)
    assert got.dtype == dtype and got.is_contiguous()
    assert_close(got, want, dtype)


@pytest.mark.parametrize("seq_dim", [2, 3], ids=["T", "F"])
@pytest.mark.parametrize("shape,dtype", CASES, ids=CASE_IDS)
def test_out_kernel(card, shape, seq_dim, dtype):
    gen = torch.Generator(device=card).manual_seed(sum(shape) + 10 * seq_dim)
    C = shape[1]
    S, rows = dual_path.seq_shape(shape, seq_dim)
    z = randn(gen, S, C, rows, dtype=dtype)
    residual = randn(gen, *shape, dtype=dtype)
    bias = randn(gen, C)
    got = assert_launches(lambda: dual_path.dual_path_out(z, bias, residual, seq_dim=seq_dim),
                          {"dual_path_out": 1})
    want = dual_path.dual_path_out_ref(z, bias, residual, seq_dim)
    assert got.dtype == dtype and got.is_contiguous()
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("L,rows,k", [(58, 64, 4), (3, 63, 3), (1, 16, 4)])
def test_k1_with_zero_end_steps(card, L, rows, k, dtype):
    gen = torch.Generator(device=card).manual_seed(L + rows)
    H, ndir, pad = 4, 2, 7
    O = H * ndir
    u = randn(gen, L, k * O, rows, dtype=dtype)
    skip = randn(gen, L, O, rows, dtype=dtype) if k == 3 else None
    v, b = 0.5 * randn(gen, 2 * O), 0.5 * randn(gen, 2 * O)
    with torch.no_grad():
        got = sru.sru_stack_layer(u, skip, v, b, H=H, k=k, ndir=ndir, pad=pad)
    want = sru.sru_stack_layer_ref(u, skip, v, b, H=H, k=k, ndir=ndir)
    assert got.shape == (L + 2 * pad, O, rows)
    assert not got[:pad].any() and not got[L + pad:].any()
    assert_close(got[pad:L + pad], want, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("dim", [3, 4])
def test_seq_layout_route_at_rtfs4_widths(card, dim, dtype):
    """RTFS-Net-4's DualPathRNN (C = 64, hid 32, kernel 8, 4 SRU layers) on a
    (2, 64, 126, 65) block, against the same module with gradients on.
    float32 within 1e-4·max|out| (the two routes sum in other orders through
    four recurrences); bfloat16 within 2^-5·max|out| (they round at other
    places)."""
    torch.manual_seed(0)
    m = rnn_blocks.DualPathRNN(64, 32, dim, kernel_size=8, rnn_type="SRU", num_layers=4)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.1 * torch.randn_like(p))
    m = m.to(card).eval()
    x = torch.randn((2, 64, 126, 65), device=card).to(dtype)
    calls, launches = rnn_blocks.seq_layout_calls, sru.launches
    with torch.no_grad():
        got = m(x)
    torch.cuda.synchronize()
    assert rnn_blocks.seq_layout_calls == calls + 1 and sru.launches == launches + 4
    want = m(x).detach()
    scale = want.float().abs().max().item()
    atol = (1e-4 if dtype == torch.float32 else 2 ** -5) * scale
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


# (B, C, T, F, k, permuted): TF-GridNet's block at B = 2; L = 1 along T; k = 3;
# C·k = 15 (no 16-byte vectors); x laid out (B, T, C, F); each in both
# dtypes, then TF-GridNet's B = 128 block in bfloat16
WINDOW_CASES = [(2, 128, 251, 129, 4, False), (2, 7, 4, 40, 4, False), (3, 5, 37, 33, 3, False),
                (1, 3, 70, 9, 4, True), (2, 128, 21, 129, 4, True)]
WINDOW_DTYPES = [(c, dtype) for c in WINDOW_CASES for dtype in DTYPES] + [
    ((128, 128, 251, 129, 4, False), torch.bfloat16)]


@pytest.mark.parametrize("seq_dim", [2, 3], ids=["T", "F"])
@pytest.mark.parametrize("case,dtype", WINDOW_DTYPES,
                         ids=["x".join(map(str, c)) + "-" + str(d)[6:] for c, d in WINDOW_DTYPES])
def test_windows_in_kernel(card, case, seq_dim, dtype):
    *shape, k, permuted = case
    gen = torch.Generator(device=card).manual_seed(sum(shape) + seq_dim)
    C = shape[1]
    if permuted:
        B, _, T, F = shape
        x = (randn(gen, B, T, C, F) * 3 + 1).to(dtype).permute(0, 2, 1, 3)
    else:
        x = (randn(gen, *shape) * 3 + 1).to(dtype)
    gamma = 1 + 0.1 * randn(gen, C)
    beta = 0.1 * randn(gen, C)
    got = assert_launches(
        lambda: dual_path.dual_path_windows_in(x, gamma, beta, seq_dim=seq_dim, k=k, eps=1e-5),
        {"dual_path_windows_in": 1})
    want = dual_path.dual_path_windows_in_ref(x, gamma, beta, seq_dim, k, 1e-5)
    assert got.dtype == dtype and got.is_contiguous()
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("dim", [3, 4])
def test_window_layout_route_at_tfgridnet_widths(card, dim, dtype):
    """TF-GridNet's DualPathRNN (C = 128, BLSTM of 192, kernel 4) on a
    (2, 128, 251, 129) block, against the same module with gradients on
    (cuDNN's training form on the unfolded windows); the tolerances of the
    sequence-layout route's test."""
    torch.manual_seed(1)
    m = rnn_blocks.DualPathRNN(128, 192, dim, kernel_size=4, rnn_type="LSTM")
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.1 * torch.randn_like(p))
    m = m.to(card).eval()
    x = torch.randn((2, 128, 251, 129), device=card).to(dtype)
    calls, launches = rnn_blocks.window_layout_calls, dual_path.windows_in_launches
    with torch.no_grad():
        got = m(x)
    torch.cuda.synchronize()
    assert rnn_blocks.window_layout_calls == calls + 1
    assert dual_path.windows_in_launches == launches + 1
    want = m(x).detach()
    scale = want.float().abs().max().item()
    atol = (1e-4 if dtype == torch.float32 else 2 ** -5) * scale
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
