"""PyTorch port vs JAX package: the DPTNet separator.

* ``DPTNet`` alone (2-D, an SRU DualPathRNN and a GlobalAttention2D with
  its shared group FFN), shared and one block per repeat, and without
  channels (every repeat the identity): within 1e-4·max|out| of JAX.
* A tiny AVNet with DPTNet in both branches (the audio one adds a GRU
  DualPathRNN at stride 2; the video one is 1-D, with a
  GlobalAttentionRNN and a GlobalAttention whose FFN is a
  ConvolutionalRNN): the forward within 5e-4·max|out| (the AVNet
  tolerance of tests/test_torch_avnet.py); the port's state dict through
  the JAX package's ``convert_avnet`` and back is exact, so every name is
  one the reference's converter reads; ``load_model`` of that state dict
  saved as a reference ``best_model.pth`` and as a Lightning checkpoint.
* One float32 train step of that AVNet, dropout off, against
  ``jax.value_and_grad``: the loss within 1e-4·|loss|, every gradient
  within 1e-3·max|g|.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtfs_net_tpu import losses as jlosses
from rtfs_net_tpu.models import AVNet as JaxAVNet
from rtfs_net_tpu.models.separators import dpt as jdpt
from rtfs_net_tpu.utils.avnet_convert import convert_avnet
from rtfs_net_tpu_torch import losses
from rtfs_net_tpu_torch.models import build_model, separators, serialization
from rtfs_net_tpu_torch.models.separators import dpt
from rtfs_net_tpu_torch.system import System, make_optimizer
from rtfs_net_tpu_torch.utils import convert

from _torch_port import jax_apply, jax_random, load, one_torch_thread, port_apply  # noqa: F401
from test_torch_avnet import TINY

AUDIO_LAYERS = {
    "layer_1": {"layer_type": "DualPathRNN", "hid_chan": 4, "dim": 4, "kernel_size": 4,
                "stride": 1, "rnn_type": "SRU", "num_layers": 2, "bidirectional": True},
    "layer_2": {"layer_type": "DualPathRNN", "hid_chan": 4, "dim": 3, "kernel_size": 4,
                "stride": 2, "rnn_type": "GRU", "num_layers": 1, "bidirectional": True},
    "layer_3": {"layer_type": "GlobalAttention2D", "n_head": 2, "kernel_size": 3,
                "dropout": 0.0, "group_ffn": True},
}
VIDEO_LAYERS = {
    "layer_1": {"layer_type": "GlobalAttentionRNN", "dropout": 0.0},
    "layer_2": {"layer_type": "GlobalAttention", "ffn_name": "ConvolutionalRNN",
                "kernel_size": 3, "n_head": 2, "dropout": 0.0},
}
CONF = copy.deepcopy(TINY)
CONF["audio_params"] = {"audio_net": "DPTNet", "hid_chan": 8, "repeats": 2, "shared": True,
                        "is2d": True, "layers": AUDIO_LAYERS}
CONF["video_params"] = {"video_net": "DPTNet", "hid_chan": 8, "repeats": 1, "shared": False,
                        "is2d": False, "layers": VIDEO_LAYERS}
L, TV, B = 1000, 8, 2


@pytest.mark.parametrize("shared,in_chan", [(True, 6), (False, 6), (True, -1)])
def test_dptnet(rng, shared, in_chan):
    layers = {k: AUDIO_LAYERS[k] for k in ("layer_1", "layer_3")}  # the GRU: in the AVNet
    conf = dict(in_chan=in_chan, hid_chan=8, layers=layers, repeats=2, shared=shared,
                is2d=True)
    x = rng.standard_normal((2, 6, 11, 9)).astype(np.float32)
    jm = jdpt.DPTNet(**conf, remat=False)
    v = jax_random(jm, rng, x)
    pm = load(dpt.DPTNet(**conf), convert.separator, v, {**conf, "audio_net": "DPTNet"},
              "audio")
    want, got = jax_apply(jm, v, x), port_apply(pm, x)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)
    assert separators.get("DPTNet") is dpt.DPTNet
    if in_chan <= 0:
        np.testing.assert_array_equal(got, 2 * x)


@pytest.fixture(scope="module")
def dpt_avnet():
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((B, L)).astype(np.float32)
    tgt = (0.5 * mix + 0.3 * rng.standard_normal((B, L))).astype(np.float32)[:, None]
    mouth = rng.standard_normal((B, 16, TV)).astype(np.float32)
    jconf = copy.deepcopy(CONF)
    jconf["audio_params"]["remat"] = jconf["video_params"]["remat"] = False
    jm = JaxAVNet(**jconf)
    v = jax_random(jm, rng, mix, mouth)
    model = build_model(CONF, device="cpu")
    model.load_state_dict(convert.state_dict_from_jax(v, CONF))
    return dict(jm=jm, v=v, mix=mix, tgt=tgt, mouth=mouth, model=model,
                want=jax_apply(jm, v, mix, mouth))


def _assert_forward(model, d):
    with torch.no_grad():
        got = model(torch.from_numpy(d["mix"]), torch.from_numpy(d["mouth"])).numpy()
    assert got.shape == d["want"].shape == (B, 1, L)
    np.testing.assert_allclose(got, d["want"], atol=5e-4 * np.abs(d["want"]).max(), rtol=0)


def test_avnet_with_dptnet_matches_jax(dpt_avnet):
    _assert_forward(dpt_avnet["model"], dpt_avnet)


def test_state_dict_round_trip_through_convert_avnet(dpt_avnet):
    sd = {k: t.numpy() for k, t in dpt_avnet["model"].state_dict().items()}
    template = jax.tree_util.tree_map(np.zeros_like, dpt_avnet["v"])
    back = convert.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, convert_avnet(sd, template, CONF)), CONF)
    assert set(back) == set(sd)
    for k, t in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), t, err_msg=k)


@pytest.mark.parametrize("form", ["reference", "lightning"])
def test_load_model_of_a_reference_state_dict(dpt_avnet, tmp_path, form):
    """A reference ``best_model.pth`` (``model_args`` its ``get_config()``
    dict, so the constructor arguments come from the config) and a
    Lightning checkpoint (``audio_model.``-prefixed keys) load by name."""
    sd = dpt_avnet["model"].state_dict()
    path = str(tmp_path / "model.pth")
    if form == "reference":
        blob = {"model_name": "AVNet", "model_args": {"encoder": {}, "refinement_module": {}},
                "state_dict": sd}
    else:
        blob = {"state_dict": {f"audio_model.{k}": t for k, t in sd.items()}}
    torch.save(blob, path)
    model, package = serialization.load_model(path, device="cpu", conf={"audionet": CONF})
    assert package["model_name"] == "AVNet" and not model.training
    _assert_forward(model, dpt_avnet)


def test_train_step_matches_jax(dpt_avnet):
    d = dpt_avnet
    loss_fn = jlosses.PITLossWrapper(jlosses.pairwise_neg_snr)

    def f(params, stats):
        est, upd = d["jm"].apply({"params": params, "batch_stats": stats}, d["mix"],
                                 d["mouth"], train=True, mutable=["batch_stats"],
                                 rngs={"dropout": jax.random.PRNGKey(0)})
        return loss_fn(est.astype(jnp.float32), d["tgt"])

    loss, grads = jax.jit(jax.value_and_grad(f))(d["v"]["params"], d["v"]["batch_stats"])
    grads = convert.grads_from_jax(jax.tree_util.tree_map(np.asarray, grads), CONF,
                                   d["v"]["batch_stats"])
    model = copy.deepcopy(d["model"])
    system = System(model, make_optimizer(model.parameters(), "adamw"),
                    {"train": losses.PITLossWrapper(losses.pairwise_neg_snr),
                     "val": losses.PITLossWrapper(losses.pairwise_neg_sisdr)})
    got = float(system.backward(tuple(torch.from_numpy(d[k]) for k in ("mix", "tgt", "mouth"))))
    assert abs(got - float(loss)) <= 1e-4 * abs(float(loss))
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    scale = max(float(g.abs().max()) for g in grads.values())
    for name, g in grads.items():
        np.testing.assert_allclose(params[name].grad.numpy(), g.numpy(), rtol=0,
                                   atol=1e-3 * scale, err_msg=name)
