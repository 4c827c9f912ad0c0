"""PyTorch port vs JAX package: primitive ops (norms, activations, convs,
interpolation, pooling, STFT) on the same numpy inputs and weights.

Nearest interpolation's index map: the port's is the exact
``dst*in // out``; it equals the JAX package's at every size of a 2 s
forward of RTFS-Net-4 and of CTCNet-16 but one, where (as at the sizes of
``JAX_OFF_BY_ONE``) the JAX map is one source index short.

Tolerance 1e-5 (abs and rel) for everything but the STFT, which holds
the JAX DFT-as-matmul against torch.stft's FFT at the tolerances of
tests/test_stft.py (2e-4·max|spec| forward, 5e-5 inverse).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtfs_net_tpu.ops import activations as jact
from rtfs_net_tpu.ops import conv as jconv
from rtfs_net_tpu.ops import normalizations as jnorm
from rtfs_net_tpu.ops import stft as jstft
from rtfs_net_tpu_torch.ops import activations, conv, normalizations, stft
from rtfs_net_tpu_torch.utils import convert

from _torch_port import (jax_apply, jax_init, jax_nearest_index, load,  # noqa: F401
                         one_torch_thread, port_apply)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 6, 11), (2, 6, 7, 5)])
def test_global_layer_norm(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    jm = jnorm.GlobalLayerNorm(6)
    v = jax_init(jm, rng, x)
    pm = load(normalizations.GlobalLayerNorm(6), convert.norm, v)
    np.testing.assert_allclose(port_apply(pm, x), jax_apply(jm, v, x), **TOL)


@pytest.mark.parametrize("param_freq", [1, 5])
def test_layer_norm_4d(rng, param_freq):
    x = rng.standard_normal((2, 6, 7, 5)).astype(np.float32)
    jm = jnorm.LayerNormalization4D(6, param_freq)
    v = jax_init(jm, rng, x)
    pm = load(normalizations.LayerNormalization4D(6, param_freq), convert.norm, v)
    np.testing.assert_allclose(port_apply(pm, x), jax_apply(jm, v, x), **TOL)


@pytest.mark.parametrize("name,shape", [("BatchNorm1d", (3, 6, 9)),
                                        ("BatchNorm2d", (3, 6, 4, 5))])
def test_batch_norm_eval(rng, name, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    jm = getattr(jnorm, name)(6, use_running_average=True)
    v = jax_init(jm, rng, x)
    assert "batch_stats" in v
    pm = load(normalizations.get(name)(6), convert.norm, v)
    np.testing.assert_allclose(port_apply(pm, x), jax_apply(jm, v, x), **TOL)


def test_layer_norm(rng):
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    jm = jnorm.LayerNorm(6)
    v = jax_init(jm, rng, x)
    pm = normalizations.LayerNorm(6)
    pm.load_state_dict({"weight": torch.from_numpy(v["params"]["scale"]),
                        "bias": torch.from_numpy(v["params"]["bias"])})
    np.testing.assert_allclose(port_apply(pm, x), jax_apply(jm, v, x), **TOL)


@pytest.mark.parametrize("name", ["PReLU", "ReLU", "Sigmoid", None])
def test_activations(rng, name):
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    jm = jact.get(name)()
    v = jax_init(jm, rng, x) if name == "PReLU" else {}
    pm = activations.get(name)()
    if name == "PReLU":
        pm.load_state_dict({"weight": torch.from_numpy(v["params"]["alpha"])})
    np.testing.assert_allclose(port_apply(pm, x), jax_apply(jm, v, x), **TOL)


@pytest.mark.parametrize("ndim,k,stride,padding,groups", [
    (2, 4, 1, "same", 1),   # even kernel: asymmetric torch "same"
    (2, 4, 1, "same", 6),   # depthwise, as the TDANet pyramid's level 0
    (2, 4, 2, 1, 6),        # strided depthwise downsample
    (2, 3, 1, "same", 2),
    (1, 4, 1, "same", 1),
    (1, 3, 2, 1, 3),
])
def test_conv(rng, ndim, k, stride, padding, groups):
    shape = (2, 6, 13, 9) if ndim == 2 else (2, 6, 13)
    x = rng.standard_normal(shape).astype(np.float32)
    jm = jconv.Conv(6, 12, k, ndim=ndim, stride=stride, padding=padding, groups=groups)
    v = jax_init(jm, rng, x)
    pm = conv.Conv(6, 12, k, ndim=ndim, stride=stride, padding=padding, groups=groups)
    pm = load(pm, convert._leaf, v)
    np.testing.assert_allclose(port_apply(pm, x), jax_apply(jm, v, x), **TOL)


@pytest.mark.parametrize("ndim,k,stride,padding", [
    (1, 8, 1, 0),   # the DualPathRNN overlap-add
    (1, 4, 2, 1),
    (2, 3, 1, 1),   # the STFT decoder
])
def test_conv_transpose(rng, ndim, k, stride, padding):
    shape = (2, 6, 11, 7) if ndim == 2 else (2, 6, 11)
    x = rng.standard_normal(shape).astype(np.float32)
    jm = jconv.ConvTranspose(6, 4, k, ndim=ndim, stride=stride, padding=padding)
    v = jax_init(jm, rng, x)
    pm = conv.ConvTranspose(6, 4, k, ndim=ndim, stride=stride, padding=padding)
    pm = load(pm, convert._leaf, v)
    np.testing.assert_allclose(port_apply(pm, x), jax_apply(jm, v, x), **TOL)


@pytest.mark.parametrize("src,dst", [
    ((125, 64), (251, 129)),  # the RTFS-4 pyramid's upsample
    ((63, 33), (31, 16)),
    ((10,), (63,)),           # video time axis onto audio frames
    ((50,), (251,)),
])
def test_interpolate_nearest(rng, src, dst):
    x = rng.standard_normal((2, 3, *src)).astype(np.float32)
    want = np.asarray(jconv.interpolate_nearest(jnp.asarray(x), dst))
    got = conv.interpolate_nearest(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# (in, out) of every nearest interpolation of a 2 s forward (32000 samples,
# 50 video frames), recorded from the port's forward at those lengths
NEAREST_2S = {
    "RTFSNet_4": [(7, 13), (7, 25), (7, 50), (13, 25), (25, 50), (50, 251), (64, 129),
                  (125, 251)],
    "CTCNet_16": [(7, 13), (7, 50), (13, 25), (13, 50), (25, 50), (50, 3280), (205, 410),
                  (205, 3280), (410, 820), (410, 3280), (820, 1640), (820, 3280),
                  (1640, 3280)],  # and (3280, 50): JAX_OFF_BY_ONE
}
# (in, out, the dst where the JAX package's float64 floor(dst * (in/out))
# lands one below the exact dst*in // out): RTFS-Net's video TDANet in
# `separate` on 3.75 s (12, 24 -> 94) and 6.25 s (20 -> 156) inputs, a
# 56-frame request, CTCNet's audio pyramid on 4 s (1640 -> 6558), and
# CTCNet-16's ConcatFusion at 2 s, its audio frames onto the video's
JAX_OFF_BY_ONE = [(12, 94, [47]), (24, 94, [47]), (20, 156, [117]), (3694, 56, [28]),
                  (1640, 6558, [3279]), (3280, 50, [15, 25, 30, 45])]


def _port_nearest_index(n_in, n_out):
    x = torch.arange(n_in, dtype=torch.float64).reshape(1, 1, n_in)
    return conv.interpolate_nearest(x, (n_out,)).reshape(-1).long().numpy()


@pytest.mark.parametrize("n_in,n_out", sorted(
    {(i, o) for pairs in NEAREST_2S.values() for i, o in pairs}
    | {(i, o) for i, o, _ in JAX_OFF_BY_ONE}))
def test_interpolate_nearest_follows_the_exact_rule(n_in, n_out):
    np.testing.assert_array_equal(_port_nearest_index(n_in, n_out),
                                  np.arange(n_out) * n_in // n_out)


@pytest.mark.parametrize("config", sorted(NEAREST_2S))
def test_interpolate_nearest_matches_jax_at_2s_sizes(config):
    for n_in, n_out in NEAREST_2S[config]:
        np.testing.assert_array_equal(_port_nearest_index(n_in, n_out),
                                      jax_nearest_index(n_in, n_out),
                                      err_msg=f"{config}: {n_in} -> {n_out}")


@pytest.mark.parametrize("n_in,n_out,wrong", JAX_OFF_BY_ONE)
def test_jax_interpolate_nearest_is_off_by_one(n_in, n_out, wrong):
    """The JAX package's fault (ROADMAP Queue 3), pinned: its map is one
    source index short at exactly these positions and exact elsewhere.
    Once the JAX package is fixed this fails; then the fault leaves the
    queue and this test goes."""
    exact = np.arange(n_out) * n_in // n_out
    got = jax_nearest_index(n_in, n_out)
    assert list(np.nonzero(got != exact)[0]) == wrong, (
        f"{n_in} -> {n_out}: the JAX map differs from the exact one at "
        f"{list(np.nonzero(got != exact)[0])}, not {wrong}; fixed in the JAX package?")
    np.testing.assert_array_equal(got[wrong], exact[wrong] - 1)


@pytest.mark.parametrize("src,dst", [((251, 129), (125, 64)), ((63, 33), (31, 16)),
                                     ((10,), (5,))])
def test_adaptive_avg_pool(rng, src, dst):
    x = rng.standard_normal((2, 3, *src)).astype(np.float32)
    want = np.asarray(jconv.adaptive_avg_pool(jnp.asarray(x), dst))
    got = conv.adaptive_avg_pool(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_unfold_1d(rng):
    x = rng.standard_normal((2, 3, 12)).astype(np.float32)
    want = np.asarray(jconv.unfold_1d(jnp.asarray(x), 4, 2))
    np.testing.assert_array_equal(conv.unfold_1d(torch.from_numpy(x), 4, 2).numpy(), want)


@pytest.mark.parametrize("L,n_fft,hop", [(2000, 64, 32), (32000, 256, 128)])
def test_stft_istft(rng, L, n_fft, hop):
    x = rng.standard_normal((2, L)).astype(np.float32)
    jre, jim = (np.asarray(a) for a in jstft.stft(jnp.asarray(x), n_fft, hop))
    re, im = (a.numpy() for a in stft.stft(torch.from_numpy(x), n_fft, hop))
    scale = np.abs(np.stack([jre, jim])).max()
    np.testing.assert_allclose(re, jre, atol=2e-4 * scale)
    np.testing.assert_allclose(im, jim, atol=2e-4 * scale)
    # the inverse, on a spectrum that is not an exact STFT (a masked one)
    mre = (jre * rng.random(jre.shape)).astype(np.float32)
    mim = (jim * rng.random(jim.shape)).astype(np.float32)
    want = np.asarray(jstft.istft(jnp.asarray(mre), jnp.asarray(mim), n_fft, hop, L))
    got = stft.istft(torch.from_numpy(mre), torch.from_numpy(mim), n_fft, hop, L).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)
