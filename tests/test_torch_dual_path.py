"""The SRU DualPathRNN's sequence-layout route
(``rtfs_net_tpu_torch/models/layers/rnn_blocks.py:DualPathRNN``), on the CPU
(``tests/test_torch_layers.py:test_dual_path_rnn`` holds the route to the
JAX package and to the autograd route on the same weights):

* the route's counter on a tiny RTFS-Net forward: 2·repeats without
  gradients, none with them, none for an LSTM DualPathRNN;
* the plain versions of the two new kernels
  (``ops/kernels/dual_path.py``) against the compositions they replace:
  LayerNormalization4D and the permutes into K1's layout, and the
  overlap-add's permute back, its bias and the residual.

The kernels themselves run on the card (``tests/test_torch_card_dual_path.py``).
"""
import pytest
import torch

from rtfs_net_tpu_torch.models import build_model
from rtfs_net_tpu_torch.models.layers import rnn_blocks
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
