"""The DualPathRNN's layout kernels on an NVIDIA card
(``rtfs_net_tpu_torch/csrc/dual_path.cu``), against their plain versions,
and the routes they serve.

Marked ``card``; each test skips without a card. Neither this file nor what
it imports loads JAX, so it runs on a machine without it (``--noconftest``
keeps the suite's JAX-importing ``conftest.py`` out)::

    python3 -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_card_dual_path.py

* ``dual_path_norm_in`` and ``dual_path_out`` along T and F, float32 and
  bfloat16, at the RTFS-Net-4 block's plane (C = 64, T = 126, F = 65) and at
  small odd sizes (a dimension of 1, sizes not a multiple of the 32-wide
  tile): float32 within 1e-5 + 1e-5·|ref| (Welford's statistics and the
  card's rsqrtf against torch's), bfloat16 within 1e-5 + 2^-7·|ref| (one
  rounding that may land on the neighbouring value);
* K1 with zero end steps (``pad``) against its plain version, zero padded;
* the DualPathRNN's sequence-layout route against its autograd route on
  the same weights, at RTFS-Net-4's widths, both axes and both dtypes;
* ``dual_path_windows_in`` along T and F, both dtypes, at TF-GridNet's
  block (C = 128, T = 251, F = 129) with B = 2 and k = 4, and at small
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

pytestmark = pytest.mark.card

# (B, C, T, F)
SHAPES = [(2, 64, 126, 65), (3, 5, 37, 33), (1, 1, 1, 1), (2, 7, 1, 40), (1, 3, 70, 9)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return dict(atol=1e-5, rtol=1e-5 if dtype == torch.float32 else 2 ** -7)


def _randn(gen, *shape, dtype=torch.float32, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("seq_dim", [2, 3], ids=["T", "F"])
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_norm_in_kernel(card, shape, seq_dim, dtype):
    gen = torch.Generator(device=card).manual_seed(sum(shape) + seq_dim)
    C = shape[1]
    x = (_randn(gen, *shape, device=card) * 3 + 1).to(dtype)
    gamma = 1 + 0.1 * _randn(gen, C, device=card)
    beta = 0.1 * _randn(gen, C, device=card)
    before = dual_path.norm_in_launches
    got = dual_path.dual_path_norm_in(x, gamma, beta, seq_dim=seq_dim, eps=1e-5)
    torch.cuda.synchronize()
    assert dual_path.norm_in_launches == before + 1
    want = dual_path.dual_path_norm_in_ref(x, gamma, beta, seq_dim, 1e-5)
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("seq_dim", [2, 3], ids=["T", "F"])
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_out_kernel(card, shape, seq_dim, dtype):
    gen = torch.Generator(device=card).manual_seed(sum(shape) + 10 * seq_dim)
    C = shape[1]
    S, rows = dual_path.seq_shape(shape, seq_dim)
    z = _randn(gen, S, C, rows, dtype=dtype, device=card)
    residual = _randn(gen, *shape, dtype=dtype, device=card)
    bias = _randn(gen, C, device=card)
    before = dual_path.out_launches
    got = dual_path.dual_path_out(z, bias, residual, seq_dim=seq_dim)
    torch.cuda.synchronize()
    assert dual_path.out_launches == before + 1
    want = dual_path.dual_path_out_ref(z, bias, residual, seq_dim)
    assert got.shape == want.shape and got.dtype == dtype and got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("L,rows,k", [(58, 64, 4), (3, 63, 3), (1, 16, 4)])
def test_k1_with_zero_end_steps(card, L, rows, k, dtype):
    gen = torch.Generator(device=card).manual_seed(L + rows)
    H, ndir, pad = 4, 2, 7
    O = H * ndir
    u = _randn(gen, L, k * O, rows, dtype=dtype, device=card)
    skip = _randn(gen, L, O, rows, dtype=dtype, device=card) if k == 3 else None
    v, b = 0.5 * _randn(gen, 2 * O, device=card), 0.5 * _randn(gen, 2 * O, device=card)
    with torch.no_grad():
        got = sru.sru_stack_layer(u, skip, v, b, H=H, k=k, ndir=ndir, pad=pad)
    want = sru.sru_stack_layer_ref(u, skip, v, b, H=H, k=k, ndir=ndir)
    assert got.shape == (L + 2 * pad, O, rows)
    assert not got[:pad].any() and not got[L + pad:].any()
    torch.testing.assert_close(got[pad:L + pad].float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
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
# C·k = 15 (no 16-byte vectors); x laid out (B, T, C, F)
WINDOW_CASES = [(2, 128, 251, 129, 4, False), (2, 7, 4, 40, 4, False), (3, 5, 37, 33, 3, False),
                (1, 3, 70, 9, 4, True), (2, 128, 21, 129, 4, True)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("seq_dim", [2, 3], ids=["T", "F"])
@pytest.mark.parametrize("case", WINDOW_CASES, ids=["x".join(map(str, c)) for c in WINDOW_CASES])
def test_windows_in_kernel(card, case, seq_dim, dtype):
    *shape, k, permuted = case
    gen = torch.Generator(device=card).manual_seed(sum(shape) + seq_dim)
    C = shape[1]
    if permuted:
        B, _, T, F = shape
        x = (_randn(gen, B, T, C, F, device=card) * 3 + 1).to(dtype).permute(0, 2, 1, 3)
    else:
        x = (_randn(gen, *shape, device=card) * 3 + 1).to(dtype)
    gamma = 1 + 0.1 * _randn(gen, C, device=card)
    beta = 0.1 * _randn(gen, C, device=card)
    before = dual_path.windows_in_launches
    got = dual_path.dual_path_windows_in(x, gamma, beta, seq_dim=seq_dim, k=k, eps=1e-5)
    torch.cuda.synchronize()
    assert dual_path.windows_in_launches == before + 1
    want = dual_path.dual_path_windows_in_ref(x, gamma, beta, seq_dim, k, 1e-5)
    assert got.shape == want.shape and got.dtype == dtype and got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
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
