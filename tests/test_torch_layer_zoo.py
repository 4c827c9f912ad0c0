"""PyTorch port vs JAX package: the layer zoo that no shipped config uses
(the legacy configs' layers), each built tiny, with JAX weights drawn by
``_torch_port.jax_random`` and carried into the port by
``rtfs_net_tpu_torch.utils.convert``.

Tolerances: 2e-5 (abs and rel) for single layers, whose float32 results
differ only by summation order; 1e-4·max|out| for recurrences over more
than ~20 steps and for blocks of several layers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtfs_net_tpu.models import layers as jlayers
from rtfs_net_tpu.models.layers import attention_blocks as jatt
from rtfs_net_tpu.models.layers import conv_blocks as jconv
from rtfs_net_tpu.models.layers import mixer_blocks as jmix
from rtfs_net_tpu.models.layers import rnn_blocks as jrnn
from rtfs_net_tpu.ops import activations as jact
from rtfs_net_tpu.ops import rnn as jops_rnn
from rtfs_net_tpu_torch.models import layers
from rtfs_net_tpu_torch.models.layers import (attention_blocks, conv_blocks, mixer_blocks,
                                              rnn_blocks)
from rtfs_net_tpu_torch.ops import activations, normalizations
from rtfs_net_tpu_torch.ops import rnn as ops_rnn
from rtfs_net_tpu_torch.utils import convert

from _torch_port import jax_apply, jax_random, load, one_torch_thread, port_apply  # noqa: F401

TOL = dict(atol=2e-5, rtol=2e-5)
LONG = None  # 1e-4·max|out|


def _check(jm, pm, mapper, rng, inputs, *mapper_args, tol=TOL):
    v = jax_random(jm, rng, *inputs)
    pm = load(pm, mapper, v, *mapper_args)
    want = jax_apply(jm, v, *inputs)
    got = port_apply(pm, *inputs)
    assert got.shape == want.shape
    if tol is None:
        tol = dict(atol=1e-4 * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(got, want, **tol)
    return pm


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------- registries
@pytest.mark.parametrize("name", ["GELU", "SiLU", "LeakyReLU", "ELU", "Softplus"])
def test_activation(rng, name):
    x = 8.0 * _x(rng, 64)
    want = np.asarray(getattr(jact, name)().apply({}, jnp.asarray(x)))
    got = activations.get(name)()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_norm_and_layer_registries():
    assert normalizations.gLN is normalizations.GlobalLayerNorm
    assert normalizations.LN4d is normalizations.LayerNormalization4D
    assert normalizations.get("BatchNorm2d") is normalizations.BatchNorm2d
    assert normalizations.get(None) is normalizations.Identity
    bn = normalizations.BatchNorm(3).eval()
    x = torch.randn(2, 3, 4, 5, 6)
    assert torch.allclose(bn(x), x / (1 + 1e-5) ** 0.5)
    assert layers.get(None) is activations.Identity
    assert layers.get_ffn("ConvolutionalRNN") is conv_blocks.ConvolutionalRNN
    assert set(layers._REGISTRY) == set(jlayers._REGISTRY)
    assert attention_blocks.TorchMultiheadAttention is attention_blocks.MultiheadAttention


# ---------------------------------------------------------------- ops/rnn
@pytest.mark.parametrize("kind,bidirectional,num_layers,batch_first", [
    ("LSTM", True, 2, False), ("LSTM", False, 1, True),
    ("GRU", True, 2, True), ("GRU", False, 2, False)])
def test_lstm_gru(rng, kind, bidirectional, num_layers, batch_first):
    kw = dict(input_size=6, hidden_size=5, num_layers=num_layers,
              bidirectional=bidirectional, batch_first=batch_first)
    x = _x(rng, *((3, 25, 6) if batch_first else (25, 3, 6)))
    pm = _check(getattr(jops_rnn, kind)(**kw), getattr(ops_rnn, kind)(**kw),
                convert.library_rnn, rng, [x], tol=LONG)
    ref = getattr(torch.nn, kind)(**kw)  # torch's own module with the same state
    ref.load_state_dict(pm.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(pm(torch.from_numpy(x)), ref(torch.from_numpy(x))[0])


def test_windowed_projection_and_sru_v1(rng):
    x, w = _x(rng, 3, 4, 17), _x(rng, 4 * 5, 7)
    want = np.asarray(jops_rnn.windowed_projection(jnp.asarray(x), jnp.asarray(w), 5, 2))
    got = ops_rnn.windowed_projection(torch.from_numpy(x), torch.from_numpy(w), 5, 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ins = [_x(rng, 30, 2, 5) for _ in range(4)]
    want = np.asarray(jops_rnn.sru_v1_layer(*map(jnp.asarray, ins)))
    got = ops_rnn.sru_v1_layer(*map(torch.from_numpy, ins)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)
    assert ops_rnn.get_rnn("GRU") is ops_rnn.GRU and ops_rnn.get_rnn("SRU") is ops_rnn.SRU


# ---------------------------------------------------------- DualPathRNN
@pytest.mark.parametrize("rnn_type,dim,stride,apply_ffn", [
    ("LSTM", 3, 1, False), ("LSTM", 3, 2, False), ("LSTM", 4, 1, False),
    ("LSTM", 4, 2, False), ("GRU", 3, 1, False), ("GRU", 4, 2, False),
    ("Attn", 3, 2, False), ("Attn", 4, 1, True)])
def test_dual_path_rnn(rng, rnn_type, dim, stride, apply_ffn):
    kw = dict(in_chan=4, hid_chan=3, dim=dim, kernel_size=4, stride=stride,
              rnn_type=rnn_type, num_layers=2, bidirectional=True, apply_ffn=apply_ffn)
    x = _x(rng, 2, 4, 23, 21)
    _check(jrnn.DualPathRNN(**kw), rnn_blocks.DualPathRNN(**kw), convert.dual_path_rnn,
           rng, [x], 3, True, tol=LONG)


def test_dual_path_rnn_default_is_lstm():
    m = rnn_blocks.DualPathRNN(in_chan=4, hid_chan=3, dim=3)
    assert isinstance(m.rnn, ops_rnn.LSTM) and "rnn.weight_ih_l0" in m.state_dict()


def test_library_rnn_backward_in_eval_mode():
    """An LSTM in eval mode still differentiates (``find_unused_params``
    takes its backward so; cuDNN's backward needs the training form)."""
    m = ops_rnn.LSTM(6, 5, 1, True).eval()
    m(torch.randn(9, 2, 6)).sum().backward()
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0) for p in m.parameters())


# ------------------------------------------------------------ conv blocks
@pytest.mark.parametrize("is2d", [False, True])
def test_depthwise_separable(rng, is2d):
    kw = dict(in_chan=6, out_chan=5, kernel_size=3, norm_type="gLN", act_type="PReLU",
              is2d=is2d)
    x = _x(rng, 2, 6, 11, 7) if is2d else _x(rng, 2, 6, 13)
    _check(jconv.DepthwiseSeparableConvolution(**kw),
           conv_blocks.DepthwiseSeparableConvolution(**kw), convert.depthwise_separable,
           rng, [x])


@pytest.mark.parametrize("is2d", [False, True])
def test_convolutional_rnn(rng, is2d):
    kw = dict(in_chan=6, hid_chan=8, kernel_size=3, is2d=is2d)
    x = _x(rng, 2, 6, 11, 7) if is2d else _x(rng, 2, 6, 13)
    _check(jconv.ConvolutionalRNN(**kw), conv_blocks.ConvolutionalRNN(**kw), convert.ffn,
           rng, [x])


# ------------------------------------------------------- attention blocks
def test_global_attention_with_convolutional_rnn(rng):
    kw = dict(in_chan=8, kernel_size=3, n_head=2, ffn_name="ConvolutionalRNN")
    _check(jatt.GlobalAttention(**kw), attention_blocks.GlobalAttention(**kw),
           convert.global_attention, rng, [_x(rng, 2, 8, 10)])


@pytest.mark.parametrize("group_ffn,single_ffn", [(True, True), (False, False)])
def test_global_attention_2d(rng, group_ffn, single_ffn):
    kw = dict(in_chan=8, kernel_size=3, n_head=2, group_ffn=group_ffn,
              single_ffn=single_ffn)
    _check(jatt.GlobalAttention2D(**kw), attention_blocks.GlobalAttention2D(**kw),
           convert.global_attention_2d, rng, [_x(rng, 2, 8, 9, 7)], tol=LONG)


def test_cbam(rng):
    kw = dict(in_chan=16, reduction=4, kernel_size=7)
    _check(jatt.CBAMBlock(**kw), attention_blocks.CBAMBlock(**kw), convert.cbam, rng,
           [_x(rng, 2, 16, 9, 7)])


def test_shuffle_attention(rng):
    kw = dict(in_chan=32, G=4)
    _check(jatt.ShuffleAttention(**kw), attention_blocks.ShuffleAttention(**kw),
           convert.shuffle_attention, rng, [_x(rng, 2, 32, 9, 7)])


def test_cot_attention(rng):
    kw = dict(in_chan=16, kernel_size=3)
    _check(jatt.CoTAttention(**kw), attention_blocks.CoTAttention(**kw),
           convert.cot_attention, rng, [_x(rng, 2, 16, 9, 7)])


# ------------------------------------------------------------ rnn blocks
@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_rnn_projection(rng, rnn_type):
    kw = dict(input_size=8, hidden_size=5, rnn_type=rnn_type)
    _check(jrnn.RNNProjection(**kw), rnn_blocks.RNNProjection(**kw), convert.rnn_projection,
           rng, [_x(rng, 2, 8, 25)], tol=LONG)


def test_global_attention_rnn(rng):
    kw = dict(in_chan=8, hid_chan=5, rnn_type="GRU", bidirectional=False)
    _check(jrnn.GlobalAttentionRNN(**kw), rnn_blocks.GlobalAttentionRNN(**kw),
           convert.global_attention_rnn, rng, [_x(rng, 2, 8, 25)], tol=LONG)


@pytest.mark.parametrize("group_ffn", [False, True])
def test_global_galr(rng, group_ffn):
    kw = dict(in_chan=8, kernel_size=3, n_head=2, group_ffn=group_ffn)
    _check(jrnn.GlobalGALR(**kw), rnn_blocks.GlobalGALR(**kw), convert.global_galr, rng,
           [_x(rng, 2, 8, 22, 7)], tol=LONG)


@pytest.mark.parametrize("dim,bidirectional", [(3, True), (4, False)])
def test_bilstm2d(rng, dim, bidirectional):
    kw = dict(in_chan=4, hid_chan=4, dim=dim, kernel_size=3, window=4, stride=1,
              bidirectional=bidirectional)
    _check(jrnn.BiLSTM2D(**kw), rnn_blocks.BiLSTM2D(**kw), convert.bilstm2d, rng,
           [_x(rng, 2, 4, 10, 9)], tol=LONG)


# ---------------------------------------------------------- mixer blocks
def test_mlp(rng):
    kw = dict(in_chan=4, image_size=(9, 7), patch_size=2, dim=16, depth=2)
    _check(jmix.MLP(**kw), mixer_blocks.MLP(**kw), convert.mixer, rng, [_x(rng, 2, 4, 9, 7)],
           tol=LONG)


def test_permutator(rng):
    kw = dict(in_chan=4, image_size=(9, 7), patch_size=2, dim=16, depth=2, segments=4)
    _check(jmix.Permutator(**kw), mixer_blocks.Permutator(**kw), convert.mixer, rng,
           [_x(rng, 2, 4, 9, 7)], tol=LONG)
