"""PyTorch port vs JAX package: CTCNet and the modules it brought in.

* The time-domain encoder (1 and 2 dilated branches, at a length that
  needs both of its paddings) and decoder (with the cut to the input's
  length), FRCNN (shared with gLN, per repeat with BatchNorm1d, and one
  2-D block), the six fusions (1-D audio with 1-D video as CTCNet has
  them, and 2-D audio with 1-D video through ``wrangle_dims``; two repeats,
  so video fusion on and off), the LSTM and GRU fusion cells (one and two
  directions), and the mask generators (``output_gate``, ``dw_gate``,
  ``direct``; ``MaskGenerator2Chan`` masked and direct): each against its
  JAX module on the same numpy inputs and weights, 2e-5 abs and rel, as
  tests/test_torch_layers.py.
* A tiny CTCNet AVNet (encoder k=21 stride 10, FRCNN depth 3 shared,
  BatchNorm1d video FRCNN, ConcatFusion): forward and ``separate()``
  within 5e-4·max|ref| (tests/test_avnet_convert.py:324-325); its
  ``state_dict`` through ``convert_avnet`` and back, bit for bit; one
  float32 train step against JAX's loss and gradients (loss 1e-4·|loss|,
  gradients 1e-3·max|g|) with the BatchNorm running statistics after the
  checkpointed step against JAX's new ``batch_stats`` (1e-5); its MACs
  against the JAX package's thop-equivalent count (0.5%); a
  reference-format ``best_model.pth`` through ``load_model``, strictly;
  and its serving artifact, traced on the CPU, against the eager model.

The JAX package's nearest interpolation is off by one source index at
some sizes (ROADMAP Queue 3); every parity test here records the sizes the
port's forward interpolates and asserts that the two maps agree at each
(``assert_nearest_maps_agree``).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtfs_net_tpu import losses as jlosses
from rtfs_net_tpu.models import AVNet as JaxAVNet
from rtfs_net_tpu.models import decoders as jdec
from rtfs_net_tpu.models import encoders as jenc
from rtfs_net_tpu.models import fusion as jfusion
from rtfs_net_tpu.models import mask_generator as jmask
from rtfs_net_tpu.models.layers import fusion_cells as jcells
from rtfs_net_tpu.models.separators import frcnn as jfrcnn
from rtfs_net_tpu.utils.avnet_convert import convert_avnet
from rtfs_net_tpu.utils.flops import conv_dot_macs as jax_conv_dot_macs
from rtfs_net_tpu.utils.separator import separate as jax_separate
from rtfs_net_tpu_torch import export, losses
from rtfs_net_tpu_torch.models import build_model, decoders, encoders, fusion, serialization
from rtfs_net_tpu_torch.models import mask_generator
from rtfs_net_tpu_torch.models.layers import fusion_cells
from rtfs_net_tpu_torch.models.separators import frcnn
from rtfs_net_tpu_torch.system import System, make_optimizer
from rtfs_net_tpu_torch.utils import convert
from rtfs_net_tpu_torch.utils.flops import conv_dot_macs
from rtfs_net_tpu_torch.utils.separator import separate

from _torch_port import (assert_nearest_maps_agree, interpolated_sizes, jax_apply,  # noqa: F401
                         jax_random, load, one_torch_thread, port_apply)

TOL = dict(atol=2e-5, rtol=2e-5)


def _check(port_module, jax_module, variables, *inputs):
    """The port module's output against the JAX module's at TOL, and the
    nearest maps of its interpolations against the JAX package's."""
    with interpolated_sizes() as sizes:
        got = port_apply(port_module, *inputs)
    assert_nearest_maps_agree(sizes)
    want = jax_apply(jax_module, variables, *inputs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("layers", [1, 2])
def test_convolutional_encoder(rng, layers):
    # lcms (32, 40) at depth 3: 1000 -> 1024 -> 1040 samples
    x = rng.standard_normal((2, 1000)).astype(np.float32)
    kw = dict(out_chan=16, kernel_size=21, stride=10, act_type="ReLU", layers=layers,
              upsampling_depth=3)
    jm = jenc.ConvolutionalEncoder(in_chan=1, **kw)
    v = jax_random(jm, rng, x)
    pm = encoders.ConvolutionalEncoder(in_chan=1, **kw)
    assert pm.lcms == jm.lcms == (32, 40)
    _check(load(pm, convert.conv_encoder, v, layers), jm, v, x)


@pytest.mark.parametrize("length", [1000, 1040])
def test_convolutional_decoder(rng, length):
    """104 frames decode to 1040 samples: cut to 1000, or kept."""
    x = rng.standard_normal((2, 1, 6, 104)).astype(np.float32)
    jm = jdec.ConvolutionalDecoder(in_chan=6, n_src=1, kernel_size=21, stride=10)
    v = jax_random(jm, rng, x, input_shape=(2, length))
    pm = load(decoders.ConvolutionalDecoder(6, 1, 21, 10),
              lambda r, out, src, path: convert._leaf(r, out, "decoder", ("decoder",)), v)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), (2, length)).numpy()
    want = jax_apply(jm, v, x, input_shape=(2, length))
    assert got.shape == want.shape == (2, 1, length)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shared,norm_type,is2d", [(True, "gLN", False),
                                                   (False, "BatchNorm1d", False),
                                                   (True, "gLN", True)])
def test_frcnn(rng, shared, norm_type, is2d):
    shape = (2, 6, 13, 9) if is2d else (2, 6, 37)
    x = rng.standard_normal(shape).astype(np.float32)
    params = dict(in_chan=6, hid_chan=8, kernel_size=5 if shared else 3, stride=2,
                  norm_type=norm_type, act_type="PReLU", upsampling_depth=3, repeats=2,
                  shared=shared, is2d=is2d)
    jm = jfrcnn.FRCNN(**params)
    v = jax_random(jm, rng, x)
    pm = load(frcnn.FRCNN(**params), convert.separator, v,
              {**params, "audio_net": "FRCNN"}, "audio")
    _check(pm, jm, v, x)


FUSION_TYPES = ["ConcatFusion", "SumFusion", "InjectionFusion", "LSTMFusion", "GRUFusion",
                "ATTNFusion"]


@pytest.mark.parametrize("audio_2d", [False, True], ids=["1d_audio", "2d_audio"])
@pytest.mark.parametrize("fusion_type", FUSION_TYPES)
def test_fusion(rng, fusion_type, audio_2d):
    """Two repeats: the first with video fusion, the second without. The
    ATTNFusion cells' grouped convs need equal channels, and its video cell
    takes no 4-D audio (neither in JAX nor in the reference), so with 2-D
    audio it has one repeat, without video fusion, as the RTFS-Net configs."""
    attn = fusion_type == "ATTNFusion"
    vin, repeats = 8 if attn else 4, 1 if attn and audio_2d else 2
    audio = rng.standard_normal((2, 8, 12, 5) if audio_2d else (2, 8, 12)).astype(np.float32)
    video = rng.standard_normal((2, vin, 5)).astype(np.float32)
    kw = dict(kernel_size=3, fusion_repeats=repeats, fusion_type=fusion_type,
              fusion_shared=False, is2d=audio_2d)
    jm = jfusion.MultiModalFusion(audio_bn_chan=8, video_bn_chan=vin, **kw)
    v = jax_random(jm, rng, audio, video)
    pm = fusion.MultiModalFusion(8, vin, **kw)
    pm = load(pm, convert.fusion, v, {"fusion_type": fusion_type}, repeats)
    _check(pm, jm, v, audio, video)


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("cell", ["ConvLSTMFusionCell", "ConvGRUFusionCell"])
def test_gated_fusion_cells(rng, cell, bidirectional):
    """The LSTM cell's b is shorter than a (resized after its conv), the
    GRU cell's longer (resized before)."""
    lstm = cell == "ConvLSTMFusionCell"
    (ca, ta), (cb, tb) = ((8, 12), (4, 5)) if lstm else ((4, 5), (8, 12))
    a = rng.standard_normal((2, ca, ta)).astype(np.float32)
    b = rng.standard_normal((2, cb, tb)).astype(np.float32)
    jm = getattr(jcells, cell)(ca, cb, 3, bidirectional)
    v = jax_random(jm, rng, a, b)
    pm = load(getattr(fusion_cells, cell)(ca, cb, 3, bidirectional),
              convert.gated_fusion_cell, v)
    _check(pm, jm, v, a, b)


@pytest.mark.parametrize("cls,kw", [
    ("MaskGenerator", dict(output_gate=True)),
    ("MaskGenerator", dict(output_gate=True, dw_gate=True, RI_split=True)),
    ("MaskGenerator", dict(direct=True)),
    ("MaskGenerator2Chan", dict(output_gate=True, RI_split=True)),
    ("MaskGenerator2Chan", dict(output_gate=True, dw_gate=True, direct=True)),
], ids=["output_gate", "dw_gate", "direct", "2chan", "2chan_direct"])
def test_mask_generators(rng, cls, kw):
    two = cls == "MaskGenerator2Chan"
    emb_chan = 2 if two else 4
    refined = rng.standard_normal((2, 4 if kw.get("direct") and not two else 6, 7, 5)
                                  ).astype(np.float32)
    emb = rng.standard_normal((2, emb_chan, 7, 5)).astype(np.float32)
    args = dict(n_src=2, bottleneck_chan=refined.shape[1], is2d=True, **kw)
    if not two:
        args["audio_emb_dim"] = emb_chan
    jm = getattr(jmask, cls)(**args)
    v = jax_random(jm, rng, refined, emb)
    pm = load(getattr(mask_generator, cls)(**args), convert.mask_generator, v, cls)
    _check(pm, jm, v, refined, emb)


TINY = {
    "n_src": 1,
    "pretrained_vout_chan": 16,
    "video_bn_params": {"out_chan": 8, "kernel_size": 1, "is2d": False},
    "audio_bn_params": {"out_chan": 16, "kernel_size": 1, "is2d": False},
    "enc_dec_params": {"encoder_type": "ConvolutionalEncoder",
                       "decoder_type": "ConvolutionalDecoder", "out_chan": 16,
                       "kernel_size": 21, "stride": 10, "bias": False, "act_type": "ReLU",
                       "norm_type": "gLN", "layers": 1},
    "audio_params": {"audio_net": "FRCNN", "hid_chan": 16, "upsampling_depth": 3,
                     "shared": True, "repeats": 3, "norm_type": "gLN", "act_type": "PReLU",
                     "kernel_size": 5, "stride": 2, "is2d": False},
    "video_params": {"video_net": "FRCNN", "hid_chan": 8, "upsampling_depth": 2,
                     "shared": False, "repeats": 2, "norm_type": "BatchNorm1d",
                     "act_type": "PReLU", "kernel_size": 3, "stride": 2, "is2d": False},
    "fusion_params": {"fusion_type": "ConcatFusion", "fusion_shared": False, "is2d": False},
    "mask_generation_params": {"mask_act": "ReLU", "is2d": False, "output_gate": False},
}
# lcms (32, 40): 2000 -> 2016 -> 2040 samples, 204 frames; 10 video frames
L, TV, B = 2000, 10, 2


def _perturbed_model(seed):
    """A port model whose norms, slopes and gates are off their constant
    initial values (+N(0, 0.1²); BatchNorm variances from [1, 1.5))."""
    gen = torch.Generator().manual_seed(seed)
    model = build_model(TINY, device="cpu", generator=gen)
    sd = {k: (torch.rand(t.shape, generator=gen) * 0.5 + 1.0 if k.endswith("running_var")
              else t + 0.1 * torch.randn(t.shape, generator=gen))
          if t.is_floating_point() else t for k, t in model.state_dict().items()}
    model.load_state_dict(sd)
    return model


@pytest.fixture(scope="module")
def tiny():
    """The batch, a perturbed port model, and its weights as JAX variables
    (``convert_avnet`` into an ``eval_shape`` template: no init compile)."""
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((B, L)).astype(np.float32)
    tgt = (0.5 * mix + 0.3 * rng.standard_normal((B, L))).astype(np.float32)[:, None]
    mouth = rng.standard_normal((B, 16, TV)).astype(np.float32)
    model = _perturbed_model(1)
    shapes = jax.eval_shape(JaxAVNet(**TINY).init, jax.random.PRNGKey(0), mix, mouth)
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    v = jax.tree_util.tree_map(np.asarray, convert_avnet(sd, template, TINY))
    return dict(mix=mix, tgt=tgt, mouth=mouth, model=model, v=v, template=template)


def test_forward_and_separate_match_jax(tiny):
    mix, mouth, model = tiny["mix"], tiny["mouth"], tiny["model"]
    with interpolated_sizes() as sizes, torch.no_grad():
        got = model(torch.from_numpy(mix), torch.from_numpy(mouth)).numpy()
    assert {(204, 10), (10, 204), (102, 204), (51, 102), (5, 10)} <= sizes
    assert_nearest_maps_agree(sizes)
    want = jax_apply(JaxAVNet(**TINY), tiny["v"], mix, mouth)
    assert got.shape == want.shape == (B, 1, L)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=5e-4 * scale)

    want_sep = np.asarray(jax_separate(lambda m, e: jnp.asarray(want), mix, mouth))
    got_sep = separate(model, mix, mouth, device="cpu")
    assert isinstance(got_sep, np.ndarray) and got_sep.shape == (B, 1, L)
    np.testing.assert_allclose(got_sep, want_sep, atol=5e-4 * np.abs(want_sep).max())


def test_state_dict_round_trip_through_convert_avnet(tiny):
    """port state_dict -> convert_avnet -> state_dict_from_jax is exact."""
    gen = torch.Generator().manual_seed(2)
    model = build_model(TINY, device="cpu", generator=gen)
    sd = {k: (torch.rand(t.shape, generator=gen) + 0.5 if k.endswith("running_var") else
              torch.randn(t.shape, generator=gen)) if t.is_floating_point() else t
          for k, t in model.state_dict().items()}
    model.load_state_dict(sd)
    converted = convert_avnet({k: t.numpy() for k, t in sd.items()}, tiny["template"], TINY)
    back = convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, converted), TINY)
    assert set(back) == set(sd)
    for k, t in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), t.numpy(), err_msg=k)


def test_train_step_matches_jax(tiny):
    """One float32 step (CTCNet has no dropout): JAX runs without remat
    (the same values, a smaller compile), the port checkpoints its FRCNN
    blocks, so the BatchNorm statistics must still move once."""
    mix, tgt, mouth, v = tiny["mix"], tiny["tgt"], tiny["mouth"], tiny["v"]
    jconf = copy.deepcopy(TINY)
    jconf["audio_params"]["remat"] = jconf["video_params"]["remat"] = False
    jm = JaxAVNet(**jconf)
    loss_fn = jlosses.PITLossWrapper(jlosses.pairwise_neg_snr)

    def f(params, stats, m, t, mo):
        est, upd = jm.apply({"params": params, "batch_stats": stats}, m, mo, train=True,
                            mutable=["batch_stats"])
        return loss_fn(est.astype(jnp.float32), t), upd["batch_stats"]

    (want_loss, stats), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        v["params"], v["batch_stats"], mix, tgt, mouth)
    grads, stats = jax.tree_util.tree_map(np.asarray, (grads, stats))
    want_loss = float(want_loss)

    model = copy.deepcopy(tiny["model"])
    opt = make_optimizer(model.parameters(), "adamw", lr=1e-3, weight_decay=0.1)
    system = System(model, opt, {"train": losses.PITLossWrapper(losses.pairwise_neg_snr),
                                 "val": losses.PITLossWrapper(losses.pairwise_neg_sisdr)},
                    grad_clip=None)
    loss = float(system.backward(tuple(torch.from_numpy(a) for a in (mix, tgt, mouth))))
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)

    want = convert.grads_from_jax(grads, TINY, v["batch_stats"])
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    scale = max(float(t.abs().max()) for t in want.values())
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=0, atol=1e-3 * scale,
                                   err_msg=name)

    moved = convert.state_dict_from_jax({"params": v["params"], "batch_stats": stats}, TINY)
    start = convert.state_dict_from_jax(v, TINY)
    keys = [k for k in moved if k.endswith(("running_mean", "running_var"))]
    assert keys
    now = model.state_dict()
    for k in keys:
        assert not torch.equal(moved[k], start[k]), k
        np.testing.assert_allclose(now[k].numpy(), moved[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_macs_match_jax(tiny):
    mix, mouth = tiny["mix"][:1], tiny["mouth"][:1]
    jm = JaxAVNet(**TINY, scan_shared_repeats=False)
    want = jax_conv_dot_macs(lambda v, m, e: jm.apply(v, m, e), tiny["template"], mix, mouth,
                             thop_equivalent=True)
    got = conv_dot_macs(tiny["model"], torch.from_numpy(mix), torch.from_numpy(mouth))
    assert abs(got - want) <= 5e-3 * want, (got, want)


def test_load_model_reference_file(tiny, tmp_path):
    """A reference best_model.pth: reference names, ``model_args`` holding
    the constructor arguments."""
    sd = tiny["model"].state_dict()
    torch.save({"model_name": "AVNet", "state_dict": sd, "model_args": copy.deepcopy(TINY),
                "infos": {}}, tmp_path / "best_model.pth")
    loaded, package = serialization.load_model(str(tmp_path / "best_model.pth"), device="cpu")
    assert package["model_args"] == TINY and not loaded.training
    got = loaded.state_dict()
    assert set(got) == set(sd)
    for k, t in sd.items():
        assert torch.equal(got[k], t), k


def test_serving_artifact_of_ctcnet(tiny, tmp_path):
    """The time-domain model traces at pinned shapes (the encoder's padding
    is a constant of the static length), and a saved and loaded one-bucket
    artifact separates as the eager model does (atol 1e-5, rtol 1e-4, the
    tolerance of tests/test_export.py); no ``rtfs::`` kernel node."""
    model, mix, mouth = tiny["model"], tiny["mix"], tiny["mouth"]
    program = export.export_serving(model, B, L, (16, TV), torch.float32, device="cpu")
    assert export.op_counts(program) == {}
    path = str(tmp_path / "ctcnet.rtfsx")
    export.save_serving(path, program, B, L, (16, TV), "float32")
    got = export.load_artifact(path)(mix, mouth)
    with torch.no_grad():
        want = model(torch.from_numpy(mix), torch.from_numpy(mouth)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("net", ["TDANet", "FRCNN"])
def test_separator_without_channels_is_the_identity(rng, net):
    """``hid_chan: -1`` builds no block in either package: each repeat is
    the identity and the residual sum makes the output ``repeats * x``."""
    from rtfs_net_tpu.models.separators import tdanet as jtdanet
    from rtfs_net_tpu_torch.models.separators import tdanet

    x = rng.standard_normal((2, 6, 37)).astype(np.float32)
    params = dict(in_chan=6, hid_chan=-1, repeats=3, shared=False)
    jm = {"TDANet": jtdanet.TDANet, "FRCNN": jfrcnn.FRCNN}[net](**params)
    pm = {"TDANet": tdanet.TDANet, "FRCNN": frcnn.FRCNN}[net](**params)
    assert list(pm.state_dict()) == []
    _check(pm, jm, jax_random(jm, rng, x), x)
    np.testing.assert_allclose(port_apply(pm, x), 3 * x, rtol=1e-6)


@pytest.mark.parametrize("which", ["rtfs", "ctcnet"])
def test_avnet_with_an_identity_video_net_matches_jax(which):
    """A tiny AVNet whose video separator has ``hid_chan: -1`` (a TDANet in
    the RTFS config, an FRCNN in the CTCNet one) builds in both packages,
    its weights carry over, and the forwards agree within 5e-4·max|ref|."""
    from test_torch_avnet import TINY as RTFS_TINY

    conf = copy.deepcopy(RTFS_TINY if which == "rtfs" else TINY)
    conf["video_params"]["hid_chan"] = -1
    rng = np.random.default_rng(3)
    mix = rng.standard_normal((B, L)).astype(np.float32)
    mouth = rng.standard_normal((B, 16, TV)).astype(np.float32)
    jm = JaxAVNet(**conf)
    v = jax_random(jm, rng, mix, mouth)
    assert "video_net" not in v["params"]["refinement_module"]
    model = build_model(conf, device="cpu")
    model.load_state_dict(convert.state_dict_from_jax(v, conf))
    assert not any(k.startswith("refinement_module.video_net") for k in model.state_dict())
    with interpolated_sizes() as sizes, torch.no_grad():
        got = model(torch.from_numpy(mix), torch.from_numpy(mouth)).numpy()
    assert_nearest_maps_agree(sizes)
    want = jax_apply(jm, v, mix, mouth)
    assert got.shape == want.shape == (B, 1, L)
    np.testing.assert_allclose(got, want, atol=5e-4 * np.abs(want).max())
