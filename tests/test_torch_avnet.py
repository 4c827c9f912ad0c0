"""PyTorch port vs JAX package: the whole AVNet.

* A tiny RTFS-style audio-visual config (SRU DualPathRNNs and MHSA2D in a
  weight-shared 2-D TDANet, a 1-D BatchNorm video TDANet with
  GlobalAttention, ATTNFusion; 2 repeats, 1 of them fused): the forward
  and ``separate()`` match JAX at L=2000 within 5e-4·max|out|, the
  tolerance of tests/test_avnet_convert.py:324-325.
* ``state_dict_from_jax`` inverts ``convert_avnet`` exactly.
* Each of the ten shipped configs with a JAX counterpart
  (``rtfs_net_tpu_torch/configs/``) builds at full width with exactly the
  parameters the JAX model has (names mapped, shapes equal); no forward at
  that size. TF-GridNet, the port's own, is held against the benchmark's
  plain reference instead (``tests/test_torch_tfgridnet.py``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rtfs_net_tpu.models import AVNet as JaxAVNet
from rtfs_net_tpu.utils.avnet_convert import convert_avnet
from rtfs_net_tpu.utils.separator import separate as jax_separate
from rtfs_net_tpu_torch.models import build_model
from rtfs_net_tpu_torch.utils.convert import state_dict_from_jax
from rtfs_net_tpu_torch.utils.separator import separate

from _torch_port import jax_apply, jax_init, one_torch_thread  # noqa: F401

TINY = {
    "n_src": 1,
    "pretrained_vout_chan": 16,
    "video_bn_params": {"kernel_size": -1},
    "audio_bn_params": {"pre_norm_type": "gLN", "pre_act_type": "ReLU", "out_chan": 16,
                        "kernel_size": 1, "is2d": True},
    "enc_dec_params": {"encoder_type": "STFTEncoder", "decoder_type": "STFTDecoder",
                       "win": 64, "hop_length": 32, "out_chan": 16, "kernel_size": 3,
                       "stride": 1, "bias": False, "act_type": None, "norm_type": None},
    "audio_params": {
        "audio_net": "TDANet", "hid_chan": 8, "kernel_size": 4, "stride": 2,
        "norm_type": "gLN", "act_type": "PReLU", "upsampling_depth": 2, "repeats": 2,
        "shared": True, "is2d": True,
        "layers": {
            "layer_1": {"layer_type": "DualPathRNN", "hid_chan": 4, "dim": 4,
                        "kernel_size": 4, "stride": 1, "rnn_type": "SRU",
                        "num_layers": 2, "bidirectional": True},
            "layer_2": {"layer_type": "DualPathRNN", "hid_chan": 4, "dim": 3,
                        "kernel_size": 4, "stride": 1, "rnn_type": "SRU",
                        "num_layers": 2, "bidirectional": True},
            # F = 33 bins -> 16 after the stride-2 level
            "layer_3": {"layer_type": "MultiHeadSelfAttention2D", "dim": 3, "n_freqs": 16,
                        "n_head": 2, "hid_chan": 2, "act_type": "PReLU",
                        "norm_type": "LayerNormalization4D"}}},
    "video_params": {
        "video_net": "TDANet", "hid_chan": 8, "kernel_size": 3, "stride": 2,
        "norm_type": "BatchNorm1d", "act_type": "PReLU", "upsampling_depth": 2,
        "repeats": 1, "shared": True, "is2d": False,
        "layers": {"layer_1": {"layer_type": "GlobalAttention",
                               "ffn_name": "FeedForwardNetwork", "kernel_size": 3,
                               "n_head": 2, "dropout": 0.1}}},
    "fusion_params": {"fusion_type": "ATTNFusion", "fusion_shared": True, "kernel_size": 4,
                      "is2d": True},
    "mask_generation_params": {"mask_generator_type": "MaskGenerator", "mask_act": "ReLU",
                               "RI_split": True, "is2d": True},
}
L, TV = 2000, 10


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((2, L)).astype(np.float32)
    mouth = rng.standard_normal((2, 16, TV)).astype(np.float32)
    jm = JaxAVNet(**TINY)
    return jm, jax_init(jm, rng, mix, mouth), mix, mouth


def test_forward_and_separate_match_jax(tiny):
    jm, v, mix, mouth = tiny
    want = jax_apply(jm, v, mix, mouth)
    model = build_model(TINY, device="cpu")
    model.load_state_dict(state_dict_from_jax(v, TINY))
    with torch.no_grad():
        got = model(torch.from_numpy(mix), torch.from_numpy(mouth)).numpy()
    assert got.shape == want.shape == (2, 1, L)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=5e-4 * scale)

    want_sep = np.asarray(jax_separate(lambda m, e: jnp.asarray(want), mix, mouth))
    got_sep = separate(model, mix, mouth, device="cpu")
    assert isinstance(got_sep, np.ndarray) and got_sep.shape == (2, 1, L)
    np.testing.assert_allclose(got_sep, want_sep, atol=5e-4 * np.abs(want_sep).max())


def test_state_dict_round_trip_through_convert_avnet(tiny):
    """port state_dict -> convert_avnet -> state_dict_from_jax is exact."""
    jm, v, _, _ = tiny
    gen = torch.Generator().manual_seed(1)
    model = build_model(TINY, device="cpu", generator=gen)
    sd = {k: (torch.rand(t.shape, generator=gen) + 0.5 if k.endswith("running_var") else
              torch.randn(t.shape, generator=gen)) if t.is_floating_point() else t
          for k, t in model.state_dict().items()}
    model.load_state_dict(sd)
    converted = convert_avnet({k: t.numpy() for k, t in sd.items()}, v, TINY)
    back = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, converted), TINY)
    assert set(back) == set(sd)
    for k, t in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), t.numpy(), err_msg=k)


CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "rtfs_net_tpu_torch", "configs")
CONFIGS = sorted(name[:-len(".yaml")] for name in os.listdir(CONFIG_DIR)
                 if name.endswith(".yaml"))
# configs of the port alone: the JAX package has no TF-GridNet
PORT_ONLY = ["lrs2_TFGridNet_6_layer"]
JAX_CONFIGS = [name for name in CONFIGS if name not in PORT_ONLY]


def _builds_the_jax_parameter_set(name):
    """The port's model of a shipped config has exactly the JAX model's
    parameters (names mapped, shapes equal); returns their count."""
    with open(os.path.join(CONFIG_DIR, f"{name}.yaml")) as f:
        conf = yaml.safe_load(f)["audionet"]
    shapes = jax.eval_shape(JaxAVNet(**conf).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32000)), jnp.zeros((1, 512, 50)))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = {k: tuple(t.shape) for k, t in state_dict_from_jax(template, conf).items()}
    model = build_model(conf, device="cpu")
    assert {k: tuple(t.shape) for k, t in model.state_dict().items()} == want
    n = sum(t.numel() for t in model.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    return n


def test_rtfs4_config_builds_the_jax_parameter_set():
    _builds_the_jax_parameter_set("lrs2_RTFSNet_4_layer")


def test_all_ten_configs_ship():
    assert len(JAX_CONFIGS) == 10 and "lrs2_CTCNet_16_layer" in JAX_CONFIGS
    assert set(PORT_ONLY) <= set(CONFIGS)


@pytest.mark.parametrize("name", JAX_CONFIGS)
def test_shipped_config_builds_the_jax_parameter_set(name):
    """Each YAML of ``rtfs_net_tpu_torch/configs/``; CTCNet-16 has the
    paper's 7.0 M parameters within the bounds of tests/test_models.py."""
    n = _builds_the_jax_parameter_set(name)
    if "CTCNet" in name:
        assert 6.5e6 < n < 7.5e6, n
