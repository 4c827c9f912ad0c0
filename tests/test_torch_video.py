"""PyTorch port vs JAX package: the lip-reading video front-end.

* ``FRCNNVideoModel`` (Conv3d front-end + ResNet-18 trunk, full width)
  against the JAX model through ``video_state_dict_from_jax`` on a few
  small frames, within 2e-4·max|ref| (18 float32 convs deep);
* its BatchNorm statistics do not move in training mode;
* ``load_video_backbone`` on a made-up reference state dict, and
  ``video_state_dict_from_jax`` as the inverse of the JAX package's
  ``convert_video_backbone``;
* ``separate()`` from raw frames against the JAX AVNet fed by its video
  model, on ``test_torch_avnet.py``'s tiny AV config (5e-4·max|ref|);
* ``System`` with a video model: a step leaves the video parameters as
  they were unless ``train_video_model``.
"""
import copy

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtfs_net_tpu.models import AVNet as JaxAVNet
from rtfs_net_tpu.models.videomodels import FRCNNVideoModel as JaxFRCNNVideoModel
from rtfs_net_tpu.utils.separator import separate as jax_separate
from rtfs_net_tpu.utils.torch_convert import convert_video_backbone
from rtfs_net_tpu_torch import losses
from rtfs_net_tpu_torch.models import build_model, build_video_model, videomodels
from rtfs_net_tpu_torch.ops.activations import PReLU
from rtfs_net_tpu_torch.ops.conv import max_pool
from rtfs_net_tpu_torch.system import System, make_optimizer
from rtfs_net_tpu_torch.utils.convert import (load_video_backbone, state_dict_from_jax,
                                              video_state_dict_from_jax)
from rtfs_net_tpu_torch.utils.separator import separate

from _torch_port import jax_init, one_torch_thread  # noqa: F401
from test_torch_avnet import TINY

VIDEONET = {"model_name": "FRCNNVideoModel", "backbone_type": "resnet", "relu_type": "prelu",
            "width_mult": 1.0, "pretrain": "not read"}
TINY_AV = {**TINY, "pretrained_vout_chan": 512}
L, TV = 2000, 10


def _video_model():
    return build_video_model(VIDEONET, device="cpu")


@pytest.fixture(scope="module")
def jax_video():
    """The JAX video model on (2, 1, TV, 44, 44) frames: its variables with
    the norms' affines and statistics and the PReLU slopes moved off their
    constant initial values (conv weights as initialised, so activations
    keep their scale through the trunk), and its embedding."""
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((2, 1, TV, 44, 44)).astype(np.float32)
    jm = JaxFRCNNVideoModel()
    v = jax.jit(lambda f: nn.Module.init(jm, jax.random.PRNGKey(0), f))(jnp.asarray(frames))

    def perturb(path, a):
        a = np.asarray(a)
        keys = [getattr(p, "key", None) for p in path]
        if a.ndim > 1:
            return a
        if keys[0] == "batch_stats" and keys[-1] == "var":
            return (1.0 + 0.5 * rng.random(a.shape)).astype(a.dtype)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)

    v = jax.tree_util.tree_map_with_path(perturb, v)
    emb = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(frames)))
    return v, frames, emb


def test_video_model_matches_jax(jax_video):
    v, frames, want = jax_video
    model = _video_model()
    sd = video_state_dict_from_jax(v)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (2, 512, TV)
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())


def test_video_state_dict_inverts_convert_video_backbone(jax_video):
    v, _, _ = jax_video
    sd = video_state_dict_from_jax(v)
    zeros = jax.tree_util.tree_map(np.zeros_like, v)
    back = convert_video_backbone({k: t.numpy() for k, t in sd.items()}, zeros)
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=str(path))


def test_batchnorm_statistics_stay_frozen():
    model = _video_model()
    assert not any(p.requires_grad for p in model.parameters())
    before = copy.deepcopy(model.state_dict())
    model.train()
    assert model.training and model.trunk.training
    norms = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    assert len(norms) == 1 + 16 + 3 and not any(m.training for m in norms)
    x = torch.randn(1, 1, 3, 24, 24, generator=torch.Generator().manual_seed(0))
    out_train = model(x)
    for k, t in model.state_dict().items():
        assert torch.equal(t, before[k]), k
    torch.testing.assert_close(out_train, model.eval()(x), atol=0, rtol=0)


def test_load_video_backbone_on_a_reference_state_dict():
    gen = torch.Generator().manual_seed(1)
    donor = _video_model()
    ref = {k: torch.rand(t.shape, generator=gen) + 0.5 if t.is_floating_point() else t + 7
           for k, t in donor.state_dict().items()}
    # the lip-reading head rides along in the published file
    ref["tcn.mb_ms_tcn.0.weight"] = torch.zeros(3, 3)
    ref["tcn_output.bias"] = torch.zeros(500)
    model = load_video_backbone(_video_model(), {"model_state_dict": ref})
    for k, t in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(t) == 0, k  # skipped, as the reference loader skips it
        else:
            assert torch.equal(t, ref[k]), k
    assert load_video_backbone(_video_model(), ref) is not None  # the bare mapping loads too
    with pytest.raises(ValueError, match="shape"):
        load_video_backbone(_video_model(), {**ref, "trunk.layer1.0.conv1.weight":
                                             torch.zeros(64, 64, 5, 5)})
    with pytest.raises(KeyError):
        load_video_backbone(_video_model(), {**ref, "trunk.layer9.0.conv1.weight":
                                             torch.zeros(1)})
    with pytest.raises(KeyError, match="lacks"):
        load_video_backbone(_video_model(), {k: t for k, t in ref.items()
                                             if k != "frontend3D.2.weight"})


def test_registry_and_unported_backbones(monkeypatch):
    """The registry names both video models; each backbone builds (every one
    is ported now), an unknown one raises; and the models run on the card
    unless the caller asks for the CPU. Test name kept from when ShuffleNet
    and AEVideoModel raised ``NotImplementedError``."""
    assert videomodels.get("frcnnVideoModel") is videomodels.FRCNNVideoModel
    assert videomodels.get("AEVIDEOMODEL") is videomodels.AEVideoModel
    assert videomodels.get(None) is None
    with pytest.raises(ValueError):
        videomodels.get("nope")
    shuffle = build_video_model({**VIDEONET, "backbone_type": "shufflenet",
                                 "width_mult": 2.0}, device="cpu")
    assert isinstance(shuffle.trunk, videomodels.ShuffleNetV2Trunk)
    assert (shuffle.frontend_nout, shuffle.backend_out) == (24, 2048)
    resnet = _video_model()
    assert (resnet.frontend_nout, resnet.backend_out) == (64, 512)
    ae = build_video_model({"model_name": "AEVideoModel", "base_channels": 4}, device="cpu")
    assert isinstance(ae.encoder, videomodels.EncoderAE) and ae.out_channels == 16
    with pytest.raises(ValueError, match="backbone_type"):
        build_video_model({**VIDEONET, "backbone_type": "mobilenet"}, device="cpu")
    # like build_model, it runs on the card unless the caller asks for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for conf in (VIDEONET, {"model_name": "AEVideoModel"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_video_model(conf)


def test_conv3d_max_pool_and_per_channel_prelu(rng):
    """The pieces the front-end adds to ``ops``: max-pool on 4-D and 5-D
    tensors, and ``PReLU(num_parameters=C)`` along dim 1 of either."""
    x5 = torch.from_numpy(rng.standard_normal((2, 3, 4, 9, 9)).astype(np.float32))
    pooled = max_pool(x5, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    assert pooled.shape == (2, 3, 4, 5, 5)
    per_frame = max_pool(x5[:, :, 0], (3, 3), (2, 2), (1, 1))
    torch.testing.assert_close(pooled[:, :, 0], per_frame, atol=0, rtol=0)
    act = PReLU(num_parameters=3)
    with torch.no_grad():
        act.weight.copy_(torch.tensor([0.1, 0.2, 0.3]))
        for x in (x5, x5[:, :, 0]):
            slope = act.weight.view(1, 3, *([1] * (x.dim() - 2)))
            torch.testing.assert_close(act(x), torch.where(x >= 0, x, slope * x))
            assert act(x.bfloat16()).dtype == torch.bfloat16


def test_separate_from_frames_matches_jax(jax_video):
    vv, frames, emb = jax_video
    rng = np.random.default_rng(1)
    mix = rng.standard_normal((2, L)).astype(np.float32)
    jm, jvm = JaxAVNet(**TINY_AV), JaxFRCNNVideoModel()
    v = jax_init(jm, rng, mix, emb)
    apply = jax.jit(lambda m, f: jm.apply(v, m, jvm.apply(vv, f)))
    want = jax_separate(apply, mix, jnp.asarray(frames))

    model = build_model(TINY_AV, device="cpu")
    model.load_state_dict(state_dict_from_jax(v, TINY_AV))
    video = _video_model()
    video.load_state_dict(video_state_dict_from_jax(vv))
    got = separate(model, mix, frames, video_model=video, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (2, 1, L)
    np.testing.assert_allclose(got, want, atol=5e-4 * np.abs(want).max())
    # the same as the embedding computed first and handed over
    with torch.no_grad():
        emb_t = video(torch.from_numpy(frames))
    np.testing.assert_allclose(got, separate(model, mix, emb_t, device="cpu"), atol=1e-6)
    with pytest.raises(ValueError, match="frames"):
        separate(model, mix, video_model=video, device="cpu")


@pytest.mark.parametrize("train_video_model", [False, True])
def test_system_with_a_video_model(train_video_model):
    gen = torch.Generator().manual_seed(2)
    conf = copy.deepcopy(TINY_AV)
    conf["video_params"]["layers"]["layer_1"]["dropout"] = 0.0
    for name in ("layer_1", "layer_2"):
        conf["audio_params"]["layers"][name]["num_layers"] = 1
    model = build_model(conf, device="cpu", generator=gen)
    video = build_video_model(VIDEONET, device="cpu", generator=gen)
    mix = torch.randn(2, 1000, generator=gen)
    tgt = (0.5 * mix + 0.3 * torch.randn(2, 1000, generator=gen))[:, None]
    frames = torch.randn(2, 1, 5, 24, 24, generator=gen)
    loss_func = {"train": losses.PITLossWrapper(losses.pairwise_neg_snr),
                 "val": losses.PITLossWrapper(losses.pairwise_neg_sisdr)}

    # the loss is that of the same model fed the embedding
    with torch.no_grad():
        emb = video(frames)
    plain = System(copy.deepcopy(model), make_optimizer(model.parameters(), "adamw", lr=1e-3),
                   loss_func)
    want_loss = float(plain.backward((mix, tgt, emb)))

    system = System(model, make_optimizer(model.parameters(), "adamw", lr=1e-3,
                                          weight_decay=0.1),
                    loss_func, video_model=video, train_video_model=train_video_model)
    assert len(system.optimizer.param_groups) == (2 if train_video_model else 1)
    before_video = copy.deepcopy(video.state_dict())
    before_model = copy.deepcopy(model.state_dict())
    out = system.train_step((mix, tgt, frames))
    assert abs(float(out["loss"]) - want_loss) <= 1e-5 * abs(want_loss)
    assert np.isfinite(float(out["grad_norm"]))
    assert any(not torch.equal(t, before_model[k]) for k, t in model.state_dict().items())
    params = dict(video.named_parameters())
    for k, t in video.state_dict().items():
        moved = not torch.equal(t, before_video[k])
        if k in params and train_video_model:
            assert params[k].grad is not None, k
            assert moved or not bool(params[k].grad.abs().sum() > 0), k
        else:  # frozen parameters; BatchNorm statistics either way
            assert not moved, k
    if train_video_model:
        assert any(not torch.equal(p, before_video[k]) for k, p in params.items())
    else:
        assert all(p.grad is None and not p.requires_grad for p in params.values())
    val = system.val_step((mix, tgt, frames))
    assert np.isfinite(float(val["val_loss"]))
