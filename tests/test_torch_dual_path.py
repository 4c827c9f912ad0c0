"""The DualPathRNN's layout routes
(``rtfs_net_tpu_torch/models/layers/rnn_blocks.py:DualPathRNN``), on the CPU
(``tests/test_torch_layers.py:test_dual_path_rnn`` holds the SRU's
sequence-layout route to the JAX package and to the autograd route on the
same weights):

* the sequence-layout route's counter on a tiny RTFS-Net forward: 2·repeats
  without gradients, none with them, none for an LSTM DualPathRNN;
* the plain versions of the SRU route's two kernels
  (``ops/kernels/dual_path.py``) against the compositions they replace:
  LayerNormalization4D and the permutes into K1's layout, and the
  overlap-add's permute back, its bias and the residual;
* the window-layout route of an LSTM or GRU DualPathRNN: its kernel's
  plain version against the general route's norm, permute, unfold and
  permute, bit for bit; the route against the general route on the same
  weights; the calls that keep their routes; its counter on a tiny
  TF-GridNet forward (2·repeats) and a tiny RTFS-Net one (0).

The kernels themselves run on the card (``tests/test_torch_card_dual_path.py``).
"""
import pytest
import torch
import yaml

from h100_bench import spec
from rtfs_net_tpu_torch.models import build_model
from rtfs_net_tpu_torch.models.layers import rnn_blocks
from rtfs_net_tpu_torch.ops.conv import unfold_1d
from rtfs_net_tpu_torch.ops.kernels import dual_path
from rtfs_net_tpu_torch.ops.normalizations import LayerNormalization4D

from _torch_port import one_torch_thread  # noqa: F401
from test_torch_avnet import TINY, TV, L


def _perturbed(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return module.eval()


def test_seq_layout_counts_its_calls():
    """The tiny RTFS-Net of ``test_torch_avnet`` has 2 DualPathRNNs a
    repeat."""
    model = build_model(TINY, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator().manual_seed(3)
    mix, mouth = torch.randn((1, L), generator=gen), torch.randn((1, 16, TV), generator=gen)
    before = rnn_blocks.seq_layout_calls
    with torch.no_grad():
        model(mix, mouth)
    assert rnn_blocks.seq_layout_calls - before == 2 * TINY["audio_params"]["repeats"]
    before = rnn_blocks.seq_layout_calls
    model(mix, mouth)
    assert rnn_blocks.seq_layout_calls == before
    lstm = rnn_blocks.DualPathRNN(4, 3, 3, kernel_size=4, rnn_type="LSTM").eval()
    with torch.no_grad():
        assert not lstm.takes_seq_layout(torch.zeros(1, 4, 6, 5))
        lstm(torch.randn(1, 4, 6, 5))
    assert rnn_blocks.seq_layout_calls == before


@pytest.mark.parametrize("dim", [3, 4])
def test_norm_in_plain_version_is_the_norm_and_permutes(dim):
    """Against LayerNormalization4D, then the route's old permutes:
    (B·F, C, T) for K1's rows, (S, C, rows) for K1's layout."""
    B, C, T, F = 2, 5, 7, 6
    norm = _perturbed(LayerNormalization4D(C), 4)
    x = torch.randn((B, C, T, F), generator=torch.Generator().manual_seed(5))
    xx = x.transpose(-2, -1) if dim == 4 else x
    b, c, s, o = xx.shape
    want = norm(xx).permute(0, 3, 1, 2).reshape(b * o, c, s).permute(2, 1, 0)
    got = dual_path.dual_path_norm_in(x, norm.gamma.view(C), norm.beta.view(C),
                                      seq_dim=dim - 1, eps=norm.eps)
    assert got.is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dim", [3, 4])
def test_out_plain_version_is_the_overlap_adds_exit(dim):
    """Against the route's old exit: the (B·F, C, T) ConvTranspose1d output
    (here z in K1's layout plus the bias) permuted back to (B, C, T, F),
    plus the residual."""
    B, C, T, F = 2, 5, 7, 6
    gen = torch.Generator().manual_seed(6)
    residual = torch.randn((B, C, T, F), generator=gen)
    bias = torch.randn((C,), generator=gen)
    res = residual.transpose(-2, -1) if dim == 4 else residual
    _, _, s, o = res.shape
    z = torch.randn((s, C, B * o), generator=gen)
    y = (z.permute(2, 1, 0) + bias[:, None])                   # (B·F, C, T)
    want = y.reshape(B, o, C, s).permute(0, 2, 3, 1) + res
    if dim == 4:
        want = want.transpose(-2, -1)
    got = dual_path.dual_path_out(z, bias, residual, seq_dim=dim - 1)
    assert got.is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


# (B, C, T, F): odd C; T and F of 4 give L = 1 at k = 4 along either axis
WINDOW_SHAPES = [(2, 5, 7, 6), (1, 3, 4, 4), (3, 2, 9, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("dim", [3, 4])
@pytest.mark.parametrize("shape", WINDOW_SHAPES, ids=["x".join(map(str, s)) for s in WINDOW_SHAPES])
def test_windows_in_plain_version_is_the_unfold(shape, dim, dtype):
    """Bit for bit the general route's steps: LayerNormalization4D, the
    permute to (B·F, C, T), ``unfold_1d`` and the permute to (L, B·F, C·k)."""
    B, C, T, F = shape
    k = 4
    norm = _perturbed(LayerNormalization4D(C), 7)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(sum(shape) + dim)).to(dtype)
    xx = x.transpose(-2, -1) if dim == 4 else x
    b, c, s, o = xx.shape
    want = unfold_1d(norm(xx).permute(0, 3, 1, 2).reshape(b * o, c, s), k).permute(2, 0, 1)
    got = dual_path.dual_path_windows_in(x, norm.gamma.view(C), norm.beta.view(C),
                                         seq_dim=dim - 1, k=k, eps=norm.eps)
    assert got.is_contiguous() and got.dtype == dtype
    assert got.shape == dual_path.window_shape(shape, dim - 1, k) == (s - k + 1, b * o, C * k)
    assert torch.equal(got, want)


def _block(rnn_type, dim, bidirectional=True, hid=5, **kw):
    torch.manual_seed(dim + 10 * bidirectional)
    m = rnn_blocks.DualPathRNN(6, hid, dim, kernel_size=4, rnn_type=rnn_type,
                               bidirectional=bidirectional, **kw)
    return _perturbed(m, 8)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bidirectional", "forward"])
@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
@pytest.mark.parametrize("dim", [3, 4])
def test_window_layout_route_is_the_general_route(dim, rnn_type, bidirectional):
    """Without gradients the window-layout route, with them the general
    route, on the same weights and input (x permuted, as the previous
    DualPathRNN hands it on)."""
    m = _block(rnn_type, dim, bidirectional)
    x = torch.randn((2, 9, 6, 7), generator=torch.Generator().manual_seed(9)).permute(0, 2, 1, 3)
    calls, library = rnn_blocks.window_layout_calls, rnn_blocks.library_route_calls
    with torch.no_grad():
        assert m.takes_window_layout(x) and not m.takes_seq_layout(x)
        got = m(x)
    assert rnn_blocks.window_layout_calls == calls + 1
    assert rnn_blocks.library_route_calls == library + 1
    assert not m.takes_window_layout(x)
    want = m(x)
    assert rnn_blocks.window_layout_calls == calls + 1
    assert got.shape == want.shape == x.shape
    torch.testing.assert_close(got, want.detach(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", ["SRU", "Attn", "stride2", "ffn", "gLN", "autograd"])
def test_other_calls_keep_their_routes(case):
    # the FFN runs on C·k channels, so the BLSTM's output has as many
    kw = {"stride": 2} if case == "stride2" else {"apply_ffn": True, "hid": 12} if (
        case == "ffn") else {"norm_type": "gLN"} if case == "gLN" else {}
    rnn_type = case if case in ("SRU", "Attn") else "LSTM"
    m = _block(rnn_type, 3, **kw)
    x = torch.randn((1, 6, 9, 5), generator=torch.Generator().manual_seed(10))
    calls = rnn_blocks.window_layout_calls
    with torch.set_grad_enabled(case == "autograd"):
        assert not m.takes_window_layout(x)
        assert m.takes_seq_layout(x) == (case == "SRU")
        m(x)
    assert rnn_blocks.window_layout_calls == calls


def test_window_layout_counts_its_calls():
    """Two BLSTM DualPathRNNs a block of the tiny TF-GridNet
    (``h100_bench/tests/tiny_tfgridnet.yaml``); none in the tiny RTFS-Net
    of ``test_torch_avnet``, whose DualPathRNNs are SRUs."""
    files = spec.reference_files("tfgridnet6-av-lrs2")
    grid = yaml.safe_load((spec.ROOT / files["tiny"]).read_text())
    gen = torch.Generator().manual_seed(11)
    mix, emb = torch.randn((1, 4000), generator=gen), torch.randn((1, 512, 6), generator=gen)
    model = build_model(grid, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    calls = rnn_blocks.window_layout_calls
    with torch.no_grad():
        model(mix.bfloat16(), emb.bfloat16())
    assert rnn_blocks.window_layout_calls - calls == 2 * grid["audionet"]["audio_params"]["repeats"]
    rtfs = build_model(TINY, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    calls = rnn_blocks.window_layout_calls
    with torch.no_grad():
        rtfs(torch.randn((1, L), generator=gen), torch.randn((1, 16, TV), generator=gen))
    assert rnn_blocks.window_layout_calls == calls
