"""PyTorch port vs JAX package: the layers of the RTFS-Net serving path,
each built tiny, with the JAX init weights (perturbed) carried into the
port by ``rtfs_net_tpu_torch.utils.convert``.

Tolerances: 2e-5 (abs and rel) for single layers, whose float32 results
differ only by summation order; 1e-4·max|out| for whole TDANet blocks,
where those differences pass through a few normalizations and the SRU
recurrences.
"""
import functools

import numpy as np
import pytest
import torch

from rtfs_net_tpu.models.layers import attention_blocks as jatt
from rtfs_net_tpu.models.layers import fusion_cells as jfus
from rtfs_net_tpu.models.layers import rnn_blocks as jrnn
from rtfs_net_tpu.models.separators import tdanet as jtda
from rtfs_net_tpu_torch.models.layers import attention_blocks, fusion_cells, rnn_blocks
from rtfs_net_tpu_torch.models.separators import tdanet
from rtfs_net_tpu_torch.utils import convert

from _torch_port import (jax_apply, jax_init, jax_random, load, one_torch_thread,  # noqa: F401
                         port_apply)

TOL = dict(atol=2e-5, rtol=2e-5)


def _check(jm, pm, mapper, rng, inputs, *mapper_args, tol=TOL):
    v = jax_init(jm, rng, *inputs)
    pm = load(pm, mapper, v, *mapper_args)
    want = jax_apply(jm, v, *inputs)
    got = port_apply(pm, *inputs)
    assert got.shape == want.shape
    if tol is None:
        tol = dict(atol=1e-4 * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(got, want, **tol)


@functools.lru_cache(maxsize=None)
def _dual_path_rnn_case(dim, stride, in_chan, hid_chan):
    """(kwargs, input, JAX variables, JAX output) of one configuration, the
    variables drawn from their ``eval_shape`` shapes (``jax_random``: no init
    compile); kept, so that its bfloat16 case compiles no JAX of its own."""
    rng = np.random.default_rng(0)
    kw = dict(in_chan=in_chan, hid_chan=hid_chan, dim=dim, kernel_size=4, stride=stride,
              rnn_type="SRU", num_layers=2, bidirectional=True)
    x = rng.standard_normal((2, in_chan, 11, 9)).astype(np.float32)
    jm = jrnn.DualPathRNN(**kw)
    v = jax_random(jm, rng, x)
    return kw, x, v, jax_apply(jm, v, x)


@pytest.mark.parametrize("dim,stride,dtype,in_chan,hid_chan", [
    pytest.param(4, 1, "float32", 8, 4, id="4-1"),
    pytest.param(3, 1, "float32", 8, 4, id="3-1"),
    pytest.param(3, 2, "float32", 8, 4, id="3-2"),
    pytest.param(4, 1, "bfloat16", 8, 4, id="4-1-bfloat16"),
    pytest.param(3, 1, "bfloat16", 8, 4, id="3-1-bfloat16"),
    pytest.param(3, 1, "float32", 4, 8, id="3-1-first-layer-k3"),
    pytest.param(3, 1, "bfloat16", 4, 8, id="3-1-first-layer-k3-bfloat16"),
    pytest.param(4, 1, "float32", 4, 8, id="4-1-first-layer-k3"),
    pytest.param(4, 1, "bfloat16", 4, 8, id="4-1-first-layer-k3-bfloat16"),
])
def test_dual_path_rnn(dim, stride, dtype, in_chan, hid_chan):
    """Two SRU layers: layer 0 has k == 4 chunks (in_chan·kernel_size !=
    2·hid_chan), or k == 3 with the unfolded windows as its highway (==);
    layer 1 has k == 3. Without gradients, so each stride-1 call takes the
    sequence-layout route (the counter says so) and the stride-2 one the
    route of ``SRU.forward``. bfloat16 is held to the float32 JAX output
    within 2^-5·max|out|, a few roundings of a bfloat16 value. The same
    module called with gradients on takes the autograd route (the route of
    training), held to the call without them on the same weights: float32
    within 1e-5·max|out| (the routes sum in other orders), bfloat16 within
    2^-6·max|out| (they round at other places)."""
    kw, x, v, want = _dual_path_rnn_case(dim, stride, in_chan, hid_chan)
    pm = load(rnn_blocks.DualPathRNN(**kw), convert.dual_path_rnn, v, hid_chan, True)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    before = rnn_blocks.seq_layout_calls
    with torch.no_grad():
        out = pm(xt)
    assert rnn_blocks.seq_layout_calls - before == (stride == 1)
    got = out.float().numpy()
    assert got.shape == want.shape
    tol = TOL if dtype == "float32" else dict(atol=2 ** -5 * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(got, want, **tol)
    assert not pm.takes_seq_layout(xt)  # gradients on, the parameters require them
    autograd = pm(xt).detach()
    assert out.dtype == autograd.dtype == xt.dtype and (stride > 1 or out.is_contiguous())
    scale = autograd.float().abs().max().item()
    atol = (1e-5 if dtype == "float32" else 2 ** -6) * scale
    torch.testing.assert_close(out.float(), autograd.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dim", [3, 4])
def test_mhsa2d(rng, dim):
    T, F = 7, 5
    kw = dict(in_chan=8, n_freqs=F if dim == 3 else T, n_head=2, hid_chan=2, dim=dim)
    x = rng.standard_normal((2, 8, T, F)).astype(np.float32)
    _check(jatt.MultiHeadSelfAttention2D(**kw), attention_blocks.MultiHeadSelfAttention2D(**kw),
           convert.mhsa2d, rng, [x])


def test_global_attention(rng):
    kw = dict(in_chan=8, kernel_size=3, n_head=2)
    x = rng.standard_normal((2, 8, 10)).astype(np.float32)
    _check(jatt.GlobalAttention(**kw), attention_blocks.GlobalAttention(**kw),
           convert.global_attention, rng, [x])


@pytest.mark.parametrize("is2d,norm,local,glob", [
    (True, "gLN", (9, 7), (5, 4)),   # global side smaller: embed, then upsample
    (True, "gLN", (5, 4), (9, 7)),   # global side larger: downsample, then embed
    (False, "BatchNorm1d", (10,), (5,)),  # the video TDANet's cells
])
def test_injection_multi_sum(rng, is2d, norm, local, glob):
    kw = dict(in_chan=6, kernel_size=4 if is2d else 3, norm_type=norm, is2d=is2d)
    xl = rng.standard_normal((2, 6, *local)).astype(np.float32)
    xg = rng.standard_normal((2, 6, *glob)).astype(np.float32)
    _check(jfus.InjectionMultiSum(**kw), fusion_cells.InjectionMultiSum(**kw),
           convert.injection_multi_sum, rng, [xl, xg])


def test_attn_fusion_cell(rng):
    kw = dict(in_chan_a=8, in_chan_b=16, kernel_size=4, is2d=True)
    a = rng.standard_normal((2, 8, 9, 5)).astype(np.float32)
    b = rng.standard_normal((2, 16, 4)).astype(np.float32)
    _check(jfus.ATTNFusionCell(**kw), fusion_cells.ATTNFusionCell(**kw),
           convert.attn_fusion_cell, rng, [a, b])


AUDIO_LAYERS = {
    "layer_1": {"layer_type": "DualPathRNN", "hid_chan": 4, "dim": 4, "kernel_size": 4,
                "stride": 1, "rnn_type": "SRU", "num_layers": 2, "bidirectional": True},
    "layer_2": {"layer_type": "DualPathRNN", "hid_chan": 4, "dim": 3, "kernel_size": 4,
                "stride": 1, "rnn_type": "SRU", "num_layers": 2, "bidirectional": True},
    "layer_3": {"layer_type": "MultiHeadSelfAttention2D", "dim": 3, "n_freqs": 4,
                "n_head": 2, "hid_chan": 2, "act_type": "PReLU",
                "norm_type": "LayerNormalization4D"},
}
VIDEO_LAYERS = {
    "layer_1": {"layer_type": "GlobalAttention", "ffn_name": "FeedForwardNetwork",
                "kernel_size": 3, "n_head": 2, "dropout": 0.1},
}


@pytest.mark.parametrize("kind", ["audio", "video"])
def test_tdanet_block(rng, kind):
    if kind == "audio":  # the RTFS-Net 2-D block: SRU DualPathRNNs + MHSA2D
        conf = dict(in_chan=8, hid_chan=4, kernel_size=4, stride=2, norm_type="gLN",
                    act_type="PReLU", upsampling_depth=2, layers=AUDIO_LAYERS, is2d=True)
        x = rng.standard_normal((2, 8, 13, 9)).astype(np.float32)
    else:  # the 1-D video block: BatchNorm1d + GlobalAttention
        conf = dict(in_chan=8, hid_chan=4, kernel_size=3, stride=2, norm_type="BatchNorm1d",
                    act_type="PReLU", upsampling_depth=3, layers=VIDEO_LAYERS, is2d=False)
        x = rng.standard_normal((2, 8, 12)).astype(np.float32)
    _check(jtda.TDANetBlock(**conf), tdanet.TDANetBlock(**conf), convert.tdanet_block,
           rng, [x], conf, tol=None)
