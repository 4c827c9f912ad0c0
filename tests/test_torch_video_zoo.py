"""PyTorch port vs JAX package: the rest of the video front-end and the
last two CLIs.

* ``ops.conv.avg_pool`` and ``InstanceNorm2d`` against JAX (1e-6);
* ``FRCNNVideoModel(backbone_type="shufflenet")`` at all four widths
  against JAX on two 88x88 frames through ``video_state_dict_from_jax``,
  within 2e-4·max|ref| (as the ResNet test, ``test_torch_video.py``); the
  carry as the inverse of ``convert_video_backbone(..., "shufflenet")``;
  ``load_video_backbone`` on a made-up reference ShuffleNet state dict;
* ``AE``, ``EncoderAE``, ``DecoderAE`` and ``AEVideoModel`` (``is2d`` off
  and on) against JAX (1e-5·max|ref|: three conv + InstanceNorm blocks);
* ``separate()`` from frames through each new backbone on
  ``test_torch_avnet.py``'s tiny AV config, against JAX (5e-4·max|ref|);
* ``System`` with ``AEVideoModel``, as ``tests/test_train_video_model.py``
  holds the JAX one; one AE Adam step against ``optax.adam``;
* the ``train_autoencoder`` CLI end to end on the CPU, its checkpoint
  loaded by ``train.build_video_model``; ``find_unused_params`` against
  JAX's gradients on a tiny config, and a parameter that nothing uses.
"""
import copy
import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from rtfs_net_tpu import losses as jlosses
from rtfs_net_tpu.models import AVNet as JaxAVNet
from rtfs_net_tpu.models.videomodels import AE as JaxAE
from rtfs_net_tpu.models.videomodels import AEVideoModel as JaxAEVideoModel
from rtfs_net_tpu.models.videomodels import FRCNNVideoModel as JaxFRCNNVideoModel
from rtfs_net_tpu.models.videomodels import autoencoder as jae
from rtfs_net_tpu.ops import conv as jconv
from rtfs_net_tpu.utils.avnet_convert import convert_avnet
from rtfs_net_tpu.utils.separator import separate as jax_separate
from rtfs_net_tpu.utils.torch_convert import convert_video_backbone
from rtfs_net_tpu_torch import find_unused_params, losses, train, train_autoencoder
from rtfs_net_tpu_torch.models import build_model, build_video_model, videomodels
from rtfs_net_tpu_torch.ops import conv
from rtfs_net_tpu_torch.ops.normalizations import InstanceNorm2d
from rtfs_net_tpu_torch.system import System, make_optimizer
from rtfs_net_tpu_torch.utils.convert import (ae_blocks, ae_state_dict_from_jax,
                                              grads_from_jax, load_video_backbone,
                                              module_state_dict, state_dict_from_jax,
                                              video_state_dict_from_jax)
from rtfs_net_tpu_torch.utils.separator import separate

from _torch_port import jax_apply, jax_random, one_torch_thread, port_apply  # noqa: F401
from test_torch_avnet import TINY

WIDTHS = (0.5, 1.0, 1.5, 2.0)
SHUFFLENET = {"model_name": "FRCNNVideoModel", "backbone_type": "shufflenet",
              "relu_type": "prelu", "width_mult": 1.0}
AE_VIDEO = {"model_name": "AEVideoModel", "in_channels": 1, "base_channels": 4,
            "num_layers": 3}
FRAME = 88  # ShuffleNet's planes go 22 -> 11 -> 6 -> 3, then its 3x3 pool
L, TV = 2000, 4


def _frames(rng, B, T, size=FRAME):
    return rng.standard_normal((B, 1, T, size, size)).astype(np.float32)


@pytest.mark.parametrize("shape,kernel,stride,ceil_mode,count_include_pad", [
    ((2, 3, 3, 3), (3, 3), None, False, True),
    ((2, 3, 11, 9), (3, 2), (2, 3), False, True),
    ((2, 3, 11, 9), (3, 2), (2, 2), True, False),  # the last windows overhang
    ((2, 3, 12, 9), (3, 3), (3, 3), True, True),  # ceil mode, no window overhangs
])
def test_avg_pool_matches_jax(rng, shape, kernel, stride, ceil_mode, count_include_pad):
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jconv.avg_pool(jnp.asarray(x), kernel, stride, ceil_mode,
                                     count_include_pad))
    got = conv.avg_pool(torch.from_numpy(x), kernel, stride, ceil_mode, count_include_pad)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_jax_avg_pool_ceil_mode_differs_from_torch():
    """The JAX package's fault (ROADMAP Queue 3), pinned. In ``ceil_mode``
    it divides a window that overhangs the input by the whole kernel under
    ``count_include_pad``, where torch divides by the part inside the input
    (there is no padding to count); and it keeps a last window that starts
    past the input, which torch drops (JAX gives 0 there, or NaN without
    ``count_include_pad``). The port follows torch. No caller of either
    package pools in ``ceil_mode``; this fails once the JAX package is
    fixed."""
    x = np.ones((1, 1, 5, 9), np.float32)
    got = conv.avg_pool(torch.from_numpy(x), (2, 2), (2, 3), ceil_mode=True).numpy()
    np.testing.assert_array_equal(got, np.ones((1, 1, 3, 3), np.float32))
    jax_out = np.asarray(jconv.avg_pool(jnp.asarray(x), (2, 2), (2, 3), ceil_mode=True))
    assert jax_out.shape == (1, 1, 3, 4)
    np.testing.assert_array_equal(jax_out[0, 0, :, :3], [[1, 1, 1], [1, 1, 1], [.5, .5, .5]])
    np.testing.assert_array_equal(jax_out[0, 0, :, 3], [0, 0, 0])
    no_pad = np.asarray(jconv.avg_pool(jnp.asarray(x), (2, 2), (2, 3), ceil_mode=True,
                                       count_include_pad=False))
    assert np.isnan(no_pad[0, 0, :, 3]).all()


def test_instance_norm_matches_jax(rng):
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 7, 6))).astype(np.float32)
    jm = jae.InstanceNorm2d(5)
    v = jax_random(jm, rng, x)
    want = jax_apply(jm, v, x)
    norm = InstanceNorm2d(5)
    norm.load_state_dict({"weight": torch.from_numpy(v["params"]["scale"]),
                          "bias": torch.from_numpy(v["params"]["bias"])})
    np.testing.assert_allclose(port_apply(norm, x), want, rtol=1e-6, atol=1e-6)
    assert norm(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


@pytest.fixture(scope="module")
def shufflenets():
    """Per width: the JAX ShuffleNet video model's random variables, and its
    embedding of (2, 1, TV, 88, 88) frames."""
    rng = np.random.default_rng(0)
    frames = _frames(rng, 2, TV)
    out = {}
    for w in WIDTHS:
        jm = JaxFRCNNVideoModel(backbone_type="shufflenet", width_mult=w)
        v = jax_random(jm, rng, frames)
        out[w] = (v, jax_apply(jm, v, frames))
    return frames, out


@pytest.mark.parametrize("width", WIDTHS)
def test_shufflenet_video_model_matches_jax(shufflenets, width):
    frames, by_width = shufflenets
    v, want = by_width[width]
    model = build_video_model({**SHUFFLENET, "width_mult": width}, device="cpu")
    sd = video_state_dict_from_jax(v)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    got = port_apply(model, frames)
    assert got.shape == want.shape == (2, model.backend_out, TV)
    assert model.backend_out == (2048 if width == 2.0 else 1024) and model.frontend_nout == 24
    assert model.frontend3D[2].weight.shape == (24,)
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())


def test_shufflenet_state_dict_inverts_convert_video_backbone(shufflenets):
    _, by_width = shufflenets
    v, _ = by_width[1.0]
    sd = video_state_dict_from_jax(v)
    assert "trunk.0.0.banch1.0.weight" in sd and "trunk.0.1.banch2.3.weight" in sd
    assert "trunk.1.1.running_var" in sd and not any(".banch1." in k for k in sd
                                                     if k.startswith("trunk.0.1."))
    zeros = jax.tree_util.tree_map(np.zeros_like, v)
    back = convert_video_backbone({k: t.numpy() for k, t in sd.items()}, zeros, "shufflenet")
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=str(path))


def test_load_video_backbone_on_a_reference_shufflenet_state_dict():
    gen = torch.Generator().manual_seed(1)
    donor = build_video_model(SHUFFLENET, device="cpu")
    ref = {k: torch.rand(t.shape, generator=gen) + 0.5 if t.is_floating_point() else t + 7
           for k, t in donor.state_dict().items()}
    ref["tcn.tcn_output.weight"] = torch.zeros(500, 1024)
    model = load_video_backbone(build_video_model(SHUFFLENET, device="cpu"),
                                {"model_state_dict": ref})
    for k, t in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(t) == 0, k
        else:
            assert torch.equal(t, ref[k]), k
    with pytest.raises(ValueError, match="shape"):  # a width-0.5 tensor
        load_video_backbone(build_video_model(SHUFFLENET, device="cpu"),
                            {**ref, "trunk.1.0.weight": torch.zeros(1024, 192, 1, 1)})
    with pytest.raises(KeyError):
        load_video_backbone(build_video_model(SHUFFLENET, device="cpu"),
                            {**ref, "trunk.0.16.banch2.0.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match="lacks"):
        load_video_backbone(build_video_model(SHUFFLENET, device="cpu"),
                            {k: t for k, t in ref.items() if k != "trunk.0.3.banch2.4.bias"})


@pytest.mark.parametrize("name", ["AE", "EncoderAE", "DecoderAE"])
def test_autoencoder_matches_jax(rng, name):
    jm = {"AE": JaxAE, "EncoderAE": jae.EncoderAE, "DecoderAE": jae.DecoderAE}[name](
        in_channels=1, base_channels=4, num_layers=3)
    x = rng.standard_normal((3, 16, 11, 11) if name == "DecoderAE"
                            else (3, 1, FRAME, FRAME)).astype(np.float32)
    v = jax_random(jm, rng, x)
    want = jax_apply(jm, v, x)
    model = getattr(videomodels, name)(in_channels=1, base_channels=4, num_layers=3)
    model.load_state_dict(ae_state_dict_from_jax(v) if name == "AE"
                          else module_state_dict(ae_blocks, v))
    got = port_apply(model.eval(), x)
    assert got.shape == want.shape == ((3, 16, 11, 11) if name == "EncoderAE"
                                       else (3, 1, FRAME, FRAME))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("is2d", [False, True])
def test_ae_video_model_matches_jax(rng, is2d):
    frames = _frames(rng, 2, 3)
    jm = JaxAEVideoModel(is2d=is2d)
    v = jax_random(jm, rng, frames)
    want = jax_apply(jm, v, frames)
    model = build_video_model({**AE_VIDEO, "is2d": is2d}, device="cpu")
    model.load_state_dict(video_state_dict_from_jax(v))
    got = port_apply(model, frames)
    assert got.shape == want.shape == ((2, 121, 3, 16) if is2d else (2, 1936, 3))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    assert not any(p.requires_grad for p in model.parameters()) and not model.training


def test_load_video_backbone_on_an_encoder_state_dict():
    gen = torch.Generator().manual_seed(2)
    encoder = videomodels.EncoderAE(1, 4, 3)
    sd = {k: torch.randn(t.shape, generator=gen) for k, t in encoder.state_dict().items()}
    assert set(sd) == {f"layer{i}.{m}.{p}" for i in range(3) for m in ("conv", "norm")
                       for p in ("weight", "bias")}
    model = load_video_backbone(build_video_model(AE_VIDEO, device="cpu"), sd)
    for k, t in sd.items():
        assert torch.equal(model.state_dict()[f"encoder.{k}"], t), k
    whole = {f"encoder.{k}": t for k, t in sd.items()}
    assert load_video_backbone(build_video_model(AE_VIDEO, device="cpu"), whole) is not None
    with pytest.raises(ValueError, match="shape"):  # an encoder of base 8
        load_video_backbone(build_video_model(AE_VIDEO, device="cpu"),
                            {**sd, "layer0.conv.weight": torch.zeros(8, 1, 2, 2)})
    with pytest.raises(KeyError, match="lacks"):
        load_video_backbone(build_video_model(AE_VIDEO, device="cpu"),
                            {k: t for k, t in sd.items() if k != "layer2.norm.bias"})


@pytest.fixture(scope="module")
def jax_avnet():
    """The JAX AVNet of the tiny AV config taking (2, 1024, TV) embeddings
    (what ShuffleNet at width 0.5, and the AE on 64x64 frames, give), its
    random variables, and its separation function, compiled once for both
    backbones."""
    rng = np.random.default_rng(3)
    conf = {**TINY, "pretrained_vout_chan": 1024}
    jm = JaxAVNet(**conf)
    mix = rng.standard_normal((2, L)).astype(np.float32)
    v = jax_random(jm, rng, mix, np.zeros((2, 1024, TV), np.float32))
    apply = jax.jit(jm.apply)
    return conf, v, mix, lambda m, e: apply(v, m, e)


@pytest.mark.parametrize("backbone", ["shufflenet", "ae"])
def test_separate_from_frames_matches_jax(jax_avnet, shufflenets, backbone):
    """The port from frames through its video model against JAX's video
    model, then its AVNet, on the same weights."""
    conf, v, mix, apply = jax_avnet
    if backbone == "shufflenet":
        frames, by_width = shufflenets
        vv, emb = by_width[0.5]
        video = build_video_model({**SHUFFLENET, "width_mult": 0.5}, device="cpu")
    else:
        rng = np.random.default_rng(4)
        frames = _frames(rng, 2, TV, size=64)  # 8x8 planes of 16 channels: 1024
        jvm = JaxAEVideoModel()
        vv = jax_random(jvm, rng, frames)
        emb = jax_apply(jvm, vv, frames)
        video = build_video_model(AE_VIDEO, device="cpu")
    video.load_state_dict(video_state_dict_from_jax(vv))
    want = jax_separate(apply, mix, jnp.asarray(emb))
    model = build_model(conf, device="cpu")
    model.load_state_dict(state_dict_from_jax(v, conf))
    got = separate(model, mix, frames, video_model=video, device="cpu")
    assert got.shape == want.shape == (2, 1, L)
    np.testing.assert_allclose(got, want, atol=5e-4 * np.abs(want).max())


def _tiny_conf(emb_chan):
    conf = copy.deepcopy(TINY)
    conf["pretrained_vout_chan"] = emb_chan
    conf["video_params"]["layers"]["layer_1"]["dropout"] = 0.0
    for name in ("layer_1", "layer_2"):
        conf["audio_params"]["layers"][name]["num_layers"] = 1
    return conf


@pytest.mark.parametrize("train_video_model", [False, True])
def test_system_with_an_ae_video_model(train_video_model):
    """The JAX package's ``tests/test_train_video_model.py`` on the port:
    the AE backbone's parameters move over a few steps if and only if
    ``train_video_model``, and the loss is that of the model fed the
    embedding."""
    gen = torch.Generator().manual_seed(4)
    video = build_video_model(AE_VIDEO, device="cpu", generator=gen)
    model = build_model(_tiny_conf(16 * 3 * 3), device="cpu", generator=gen)
    mix = torch.randn(2, 1000, generator=gen)
    batch = (mix, (0.5 * mix + 0.3 * torch.randn(2, 1000, generator=gen))[:, None],
             torch.randn(2, 1, 4, 24, 24, generator=gen))
    loss_func = {"train": losses.PITLossWrapper(losses.pairwise_neg_snr),
                 "val": losses.PITLossWrapper(losses.pairwise_neg_sisdr)}
    with torch.no_grad():
        emb = video(batch[2])
    assert emb.shape == (2, 144, 4)
    plain = System(copy.deepcopy(model), make_optimizer(model.parameters(), "adamw", lr=2e-3),
                   loss_func)
    want_loss = float(plain.backward((*batch[:2], emb)))
    system = System(model, make_optimizer(model.parameters(), "adamw", lr=2e-3,
                                          weight_decay=0.1),
                    loss_func, video_model=video, train_video_model=train_video_model)
    before = copy.deepcopy(video.state_dict())
    out = system.train_step(batch)
    assert abs(float(out["loss"]) - want_loss) <= 1e-5 * abs(want_loss)
    for _ in range(2):
        out = system.train_step(batch)
    assert np.isfinite(float(out["loss"]))
    changed = [not torch.equal(t, before[k]) for k, t in video.state_dict().items()]
    if train_video_model:
        assert all(changed), "video params did not train"
    else:
        assert not any(changed), "frozen video params drifted"
        assert all(p.grad is None for p in video.parameters())


def test_ae_adam_step_matches_jax(rng):
    """One ``train_autoencoder.train_step`` (per-frame MSE, torch Adam)
    against the JAX CLI's step (``optax.adam``) from the same weights: the
    loss within 1e-6 relative, every parameter within 1e-6 (a first Adam
    update is lr·g/(|g| + eps), ~1e-3). The conv biases are the exception:
    an InstanceNorm follows each conv and cancels its bias, so their exact
    gradient is 0, the float32 one is rounding noise under 1e-6 of the
    largest, and the update's sign is the noise's: each side moves them by
    at most lr."""
    frames = rng.standard_normal((2, 1, 3, 24, 24)).astype(np.float32)
    jm = JaxAE(in_channels=1, base_channels=4, num_layers=3)
    x = jnp.swapaxes(jnp.asarray(frames), 1, 2).reshape(6, 1, 24, 24)
    params = jax_random(jm, rng, np.asarray(x))["params"]
    opt = optax.adam(1e-3)

    def loss_fn(p):
        return jnp.mean((jm.apply({"params": p}, x) - x) ** 2)

    @jax.jit
    def step(params):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, _ = opt.update(grads, opt.init(params), params)
        return loss, grads, optax.apply_updates(params, updates)

    loss, grads, new = jax.tree_util.tree_map(np.asarray, step(params))
    model = videomodels.AE(1, 4, 3)
    before = ae_state_dict_from_jax({"params": params})
    model.load_state_dict(before)
    got = train_autoencoder.train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                                       torch.from_numpy(frames))
    assert abs(float(got) - float(loss)) <= 1e-6 * float(loss)
    want, g = ae_state_dict_from_jax({"params": new}), ae_state_dict_from_jax({"params": grads})
    scale = max(float(t.abs().max()) for t in g.values())
    biases = [k for k in want if k.endswith("conv.bias")]
    assert len(biases) == 6 and all(float(g[k].abs().max()) <= 1e-6 * scale for k in biases)
    for k, t in model.state_dict().items():
        if k in biases:
            for side in (t, want[k]):
                assert float((side - before[k]).abs().max()) <= 1e-3 * (1 + 1e-5), k
        else:
            np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)


def _mouth_manifest(root, n, rng):
    os.makedirs(root)
    rows = []
    for i in range(n):
        path = os.path.join(root, f"s1_{i}.npz")
        np.savez_compressed(path, data=rng.integers(0, 256, (6, 96, 96), dtype=np.uint8))
        rows.append([os.path.join(root, f"s1_{i}.wav"), path, 32000])
    rows.append(["audio_only.wav", 32000])  # a row without a mouth track is skipped
    with open(os.path.join(root, "s1.json"), "w") as f:
        json.dump(rows, f)
    return root


def test_train_autoencoder_cli_on_cpu(tmp_path, capsys, monkeypatch):
    rng = np.random.default_rng(5)
    tr = _mouth_manifest(str(tmp_path / "tr"), 4, rng)
    cv = _mouth_manifest(str(tmp_path / "cv"), 2, rng)
    exp = str(tmp_path / "ae")
    args = train_autoencoder.parse_args(["--train-dir", tr, "--valid-dir", cv, "--exp-dir", exp,
                                         "--epochs", "2", "--batch-size", "2",
                                         "--device", "cpu"])
    assert (args.lr, args.base_channels, args.num_layers) == (1e-3, 4, 3)
    assert train_autoencoder.parse_args([]).device == "cuda"
    assert (train_autoencoder.parse_args([]).epochs, train_autoencoder.parse_args(
        []).batch_size) == (200, 40)
    out = train_autoencoder.main(args)
    history = out["history"]
    assert [h["train_steps"] for h in history] == [2, 2]
    assert all(np.isfinite([h["train_loss"], h["val_loss"]]).all() for h in history)
    assert "epoch 1: train=" in capsys.readouterr().out
    with open(os.path.join(exp, "best_k_models.json")) as f:
        assert set(json.load(f)) == {"epoch0", "epoch1"}
    assert out["best_model"] == os.path.join(exp, "best_model.ckpt")
    assert os.listdir(os.path.join(exp, "tb", "baseline", "version_0"))
    saved = torch.load(out["best_model"], weights_only=True)
    conf = {"main_args": {}, "videonet": {**AE_VIDEO, "pretrain": out["best_model"]}}
    video = train.build_video_model(conf, device="cpu")
    for k, t in saved.items():
        assert torch.equal(video.state_dict()[f"encoder.{k}"], t), k
    frames = torch.from_numpy(_frames(rng, 1, 2))
    with torch.no_grad():
        assert video(frames).shape == (1, 1936, 2)
    # without --device it runs on the card, and refuses a machine without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_autoencoder.main(train_autoencoder.parse_args(["--exp-dir", exp]))


@pytest.fixture(scope="module")
def unused_setup():
    """The tiny AV config (one SRU layer per DualPathRNN, one repeat), its
    port model in eval mode and the JAX variables converted from it."""
    conf = _tiny_conf(16)
    conf["audio_params"]["repeats"] = 1
    model = build_model(conf, device="cpu", generator=torch.Generator().manual_seed(6))
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((1, 1000)).astype(np.float32)
    emb = rng.standard_normal((1, 16, 5)).astype(np.float32)
    jm = JaxAVNet(**conf)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), mix, emb)
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    return conf, model, mix, emb, jm, jax.tree_util.tree_map(
        np.asarray, convert_avnet(sd, template, conf))


def test_find_unused_params_matches_jax(unused_setup, tmp_path, capsys):
    """The root CLI's rule on JAX's gradients (all zeros), under the port's
    names, against the port CLI's list from the same weights and inputs."""
    conf, model, mix, emb, jm, v = unused_setup
    pit = jlosses.PITLossWrapper(jlosses.pairwise_neg_snr)

    def loss_fn(params):
        return pit(jm.apply({**v, "params": params}, mix, emb), mix[:, None, :])

    grads = jax.jit(jax.grad(loss_fn))(v["params"])
    named = grads_from_jax(jax.tree_util.tree_map(np.asarray, grads), conf, v["batch_stats"])
    want = sorted(k for k, g in named.items() if not bool(g.any()))
    assert set(named) == {n for n, _ in model.named_parameters()}
    got = find_unused_params.unused_parameters(model, torch.from_numpy(mix),
                                               torch.from_numpy(emb))
    assert sorted(got) == want

    # the CLI on a YAML of that config, with its own weights and inputs
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump({"audionet": conf}))
    assert find_unused_params.parse_args([]).device == "cuda"
    listed = find_unused_params.main(find_unused_params.parse_args(
        ["--conf-dir", str(path), "--device", "cpu"]))
    assert sorted(listed) == want
    text = capsys.readouterr().out
    assert ("all parameters receive gradient" in text) == (not want)


def test_find_unused_params_reports_an_unused_parameter(unused_setup):
    _, model, mix, emb, _, _ = unused_setup
    model = copy.deepcopy(model)
    model.register_parameter("never_used", torch.nn.Parameter(torch.ones(3)))
    model.mask_generator.register_parameter("also_unused", torch.nn.Parameter(torch.ones(2)))
    got = find_unused_params.unused_parameters(model, torch.from_numpy(mix),
                                               torch.from_numpy(emb))
    assert {"never_used", "mask_generator.also_unused"} <= set(got)
