"""Each configuration's serving forward and train step on an NVIDIA card:
the kernels each launches, from one expectation table (``PATHS``), and the
card against the same models on the CPU.

Marked ``card``; each test skips without a card (``tests/_torch_card.py``).
No JAX is imported::

    python3 -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_card_paths.py

Every model is built at full width from seed-0 weights and every call is
held to exactly its row's launches (a kernel the row does not name: none):

* serving through ``separate()`` from (B, C, 50) lip embeddings or raw
  (B, 1, 50, 88, 88) mouth frames at B = 1, 4, 16 in float32 and bfloat16
  and, where the benchmark or its cells serve, B = 128 in bfloat16; the
  output (B, 1, 32000) and finite. RTFS-Net-4 (embeddings, frames, and the
  ``"pallas"`` route's per-direction SRU, K4), RTFS-Net-4 with LSTM
  DualPathRNNs, an AVNet with DPTNet separators, RTFS-Net-4 behind a
  ShuffleNetV2 video model, RTFS-Net-6 and 12, CTCNet-16 (none of the
  kernels) and TF-GridNet (the window kernel).
* B=1 float32 against the CPU within 5e-4·max|ref|; the ``"pallas"``
  route against the default one within 1e-5 + 1e-4·max|ref|.
* ``System.train_step`` (PIT neg-SNR, the mixture as the target, the
  config's optimizer, or ranger or adafactor): finite loss and grad norm,
  parameters moved (CTCNet-16: its BatchNorm statistics too); one float32
  B=1 step of RTFS-Net-4 (dropout off) and of CTCNet-16 against the CPU:
  the loss within 1e-4·|loss|, every gradient within 1e-3·max|g|.
* The layers no shipped config uses, alone at C = 64, B = 2 on the (125,
  64) plane: float32 against the CPU within 5e-4·max|ref|, bfloat16 finite,
  K3 where a 2-D depthwise conv runs; the port's LSTM against ``nn.LSTM``;
  every optimizer name, 7 steps from one gradient, card against CPU within
  1e-5·max|p|; ShuffleNetV2's video model alone at each width; CTCNet-16's
  MACs within 5% of the paper's 167.2 G.
"""
import copy
from typing import Callable, Dict, NamedTuple, Optional

import pytest
import torch

from rtfs_net_tpu_torch.scripts import load_config
from rtfs_net_tpu_torch.system import optimizers

from _torch_card import DTYPES, assert_launches, card, generator  # noqa: F401

pytestmark = pytest.mark.card

f32, bf16 = torch.float32, torch.bfloat16
SAMPLES, FRAMES, MOUTH = 32000, 50, 88  # 2 s of audio, 2 s of 25 fps 88x88 mouth frames
BIG_BATCH = 128


def per_repeat(counts, repeats):
    return {k: n * repeats for k, n in counts.items()}


def step_of(forward):
    """A train step's launches from its serving forward's: K2's forward
    twice a layer (the checkpointed block runs again in the backward), its
    backward once, K3 three times a conv (forward, recompute, input
    gradient), the DualPathRNN's layout kernels never."""
    k1, k3 = forward.get("K1", 0), forward.get("K3", 0)
    return {"K2_forward": 2 * k1, "K2_backward": k1, "K3": 3 * k3}


# one TDANet repeat of RTFS-Net's audio block in a serving forward: two SRU
# DualPathRNNs of four layers (K1 a layer; one pass into and one out of
# K1's layout each), ten stride-1 depthwise convs (K3)
RTFS_REPEAT = {"K1": 8, "K3": 10, "dual_path_norm_in": 2, "dual_path_out": 2}
RTFS4 = per_repeat(RTFS_REPEAT, 4)


def rtfs4_conf():
    return load_config("lrs2_RTFSNet_4_layer")


def lstm_conf():
    """RTFS-Net-4 with ``rnn_type: LSTM`` in both DualPathRNNs."""
    conf = rtfs4_conf()
    for name in ("layer_1", "layer_2"):
        conf["audionet"]["audio_params"]["layers"][name]["rnn_type"] = "LSTM"
    return conf


def dpt_conf():
    """RTFS-Net-4 with DPTNet separators: the audio one 2-D at hid 64 over
    the bottleneck's 256 channels, 4 shared repeats of an SRU DualPathRNN
    along F (hid 32, 4 layers), a GRU one along T and a GlobalAttention2D
    with its group FFN; the video one 1-D, a GlobalAttentionRNN and a
    GlobalAttention with a ConvolutionalRNN FFN."""
    conf = rtfs4_conf()
    audio = conf["audionet"]
    srnn = audio["audio_params"]["layers"]["layer_1"]
    audio["audio_params"] = {
        "audio_net": "DPTNet", "hid_chan": 64, "repeats": 4, "shared": True, "is2d": True,
        "layers": {
            "layer_1": srnn,
            "layer_2": {**srnn, "dim": 3, "rnn_type": "GRU", "num_layers": 1},
            "layer_3": {"layer_type": "GlobalAttention2D", "kernel_size": 5,
                        "group_ffn": True}}}
    audio["video_params"] = {
        "video_net": "DPTNet", "hid_chan": 64, "repeats": 1, "shared": True, "is2d": False,
        "layers": {"layer_1": {"layer_type": "GlobalAttentionRNN"},
                   "layer_2": {"layer_type": "GlobalAttention", "kernel_size": 3,
                               "ffn_name": "ConvolutionalRNN"}}}
    return conf


def dpt_launches():
    """Each repeat runs each SRU DualPathRNN layer (K1; one of each layout
    kernel per DualPathRNN), each LSTM or GRU DualPathRNN (one window-kernel
    launch) and each GlobalAttention2D's group FFN twice (K3: its 2-D
    depthwise refiner)."""
    params = dpt_conf()["audionet"]["audio_params"]
    layers = params["layers"].values()
    rnn = [l for l in layers if l["layer_type"] == "DualPathRNN"]
    sru_rnn = [l for l in rnn if l["rnn_type"] == "SRU"]
    return per_repeat({
        "K1": sum(l["num_layers"] for l in sru_rnn),
        "K3": sum(2 for l in layers if l["layer_type"] == "GlobalAttention2D" and l["group_ffn"]),
        "dual_path_norm_in": len(sru_rnn), "dual_path_out": len(sru_rnn),
        "dual_path_windows_in": len(rnn) - len(sru_rnn)}, params["repeats"])


def shufflenet_conf():
    """RTFS-Net-4 behind the FRCNN video model with a ShuffleNetV2 trunk at
    width 1.0, whose embedding has 1024 channels."""
    conf = rtfs4_conf()
    conf["videonet"] = {**conf["videonet"], "backbone_type": "shufflenet", "width_mult": 1.0}
    conf["audionet"]["pretrained_vout_chan"] = 1024
    return conf


# ShuffleNetV2's stride-1 depthwise convs per video forward (K3): 3, 7 and 3
# through its three stages at 88x88 frames
SHUFFLE_K3 = 13


class Path(NamedTuple):
    conf: Callable[[], Dict]
    frames: bool        # served from raw frames through its video model
    serve: Dict[str, int]  # launches per serving forward
    train: Optional[Dict[str, int]] = None  # per train step, where one is checked
    backend: str = "scan"  # ops.rnn.DEFAULT_SRU_BACKEND


PATHS = {
    "rtfs4": Path(rtfs4_conf, False, RTFS4, step_of(RTFS4)),
    "rtfs4-frames": Path(rtfs4_conf, True, RTFS4),
    "rtfs4-pallas": Path(rtfs4_conf, True, {"K4": 64, "K3": RTFS4["K3"]}, backend="pallas"),
    "rtfs4-lstm": Path(lstm_conf, False, {"K3": RTFS4["K3"], "dual_path_windows_in": 8},
                       step_of({"K3": RTFS4["K3"]})),
    "dptnet": Path(dpt_conf, False, dpt_launches(), step_of(dpt_launches())),
    "shufflenet": Path(shufflenet_conf, True, {**RTFS4, "K3": RTFS4["K3"] + SHUFFLE_K3}),
    "rtfs6": Path(lambda: load_config("lrs2_RTFSNet_6_layer"), False,
                  per_repeat(RTFS_REPEAT, 6)),
    "rtfs12": Path(lambda: load_config("lrs2_RTFSNet_12_layer"), False,
                   per_repeat(RTFS_REPEAT, 12)),
    "ctcnet16": Path(lambda: load_config("lrs2_CTCNet_16_layer"), False, {}, {}),
    "ctcnet16-frames": Path(lambda: load_config("lrs2_CTCNet_16_layer"), True, {}),
    "tfgridnet": Path(lambda: load_config("lrs2_TFGridNet_6_layer"), False,
                      {"dual_path_windows_in": 12}),
}
# (path, B, dtype) of each serving check
SERVING = (
    [(p, B, dtype) for p in ("rtfs4", "rtfs4-frames", "rtfs4-lstm", "dptnet", "shufflenet",
                             "ctcnet16") for B in (1, 4, 16) for dtype in DTYPES]
    + [(p, BIG_BATCH, bf16) for p in ("rtfs4", "rtfs4-frames", "shufflenet")]
    + [("rtfs4-pallas", 16, f32), ("tfgridnet", 2, bf16)]
    + [(p, 1, dtype) for p in ("rtfs6", "rtfs12") for dtype in DTYPES]
    + [("ctcnet16-frames", 4, dtype) for dtype in DTYPES])
# (path, B, dtype, optimizer) of each train-step check
TRAINING = ([("rtfs4", B, dtype, None) for B in (4, 16) for dtype in DTYPES]
            + [("rtfs4", 4, f32, name) for name in ("ranger", "adafactor")]
            + [("rtfs4-lstm", 4, bf16, None), ("dptnet", 4, f32, None)]
            + [("ctcnet16", 4, dtype, None) for dtype in DTYPES])


_MODELS = {}


def models(path):
    """The path's model and video model (None from embeddings) on the card,
    from seed 0, built once."""
    from rtfs_net_tpu_torch.models import build_model, build_video_model

    if path not in _MODELS:
        conf = PATHS[path].conf()
        _MODELS.clear()  # one path's models on the card at a time
        torch.cuda.empty_cache()
        _MODELS[path] = (
            build_model(conf, device="cuda", generator=torch.Generator().manual_seed(0)),
            build_video_model(conf, device="cuda", generator=torch.Generator().manual_seed(0))
            if PATHS[path].frames else None)
    return _MODELS[path]


def request(path, B, gen):
    """(mixture, third): 2 s mixtures and lip embeddings scaled by 0.1, or
    raw mouth frames."""
    mix = torch.randn((B, SAMPLES), generator=gen, device="cuda")
    if PATHS[path].frames:
        return mix, torch.randn((B, 1, FRAMES, MOUTH, MOUTH), generator=gen, device="cuda")
    chan = PATHS[path].conf()["audionet"]["pretrained_vout_chan"]
    return mix, 0.1 * torch.randn((B, chan, FRAMES), generator=gen, device="cuda")


def _serve(monkeypatch, path, mix, third, dtype):
    from rtfs_net_tpu_torch.ops import rnn
    from rtfs_net_tpu_torch.utils.separator import separate

    model, video = models(path)
    monkeypatch.setattr(rnn, "DEFAULT_SRU_BACKEND", PATHS[path].backend)
    return assert_launches(lambda: separate(model, mix, third, video_model=video, dtype=dtype),
                           PATHS[path].serve)


@pytest.mark.parametrize("path,B,dtype", SERVING,
                         ids=[f"{p}-B{B}-{str(d)[6:]}" for p, B, d in SERVING])
def test_serving_launches(card, monkeypatch, path, B, dtype):
    out = _serve(monkeypatch, path, *request(path, B, generator(path, B)), dtype)
    assert tuple(out.shape) == (B, 1, SAMPLES) and bool(torch.isfinite(out).all())


CPU_PARITY = ["rtfs4", "rtfs4-frames", "rtfs4-lstm", "dptnet", "shufflenet", "rtfs6", "rtfs12",
              "ctcnet16"]


@pytest.mark.parametrize("path", CPU_PARITY)
def test_serving_matches_the_cpu(card, monkeypatch, path):
    """B=1 float32: the card (the kernels) against the same models on the
    CPU (their plain versions), within 5e-4·max|ref|."""
    from rtfs_net_tpu_torch.utils.separator import separate

    mix, third = request(path, 1, generator(path, "cpu"))
    got = _serve(monkeypatch, path, mix, third, f32)
    model, video = models(path)
    ref = separate(copy.deepcopy(model).cpu(), mix.cpu(), third.cpu(), device="cpu",
                   video_model=None if video is None else copy.deepcopy(video).cpu())
    err, scale = float((got.cpu() - ref).abs().max()), float(ref.abs().max())
    assert err <= 5e-4 * scale, (err, scale)


def test_pallas_route_matches_the_scan_route(card, monkeypatch):
    """The B=16 float32 request from frames with
    ``DEFAULT_SRU_BACKEND = "pallas"`` (K4, 64 launches) against the same
    request on the default route."""
    from rtfs_net_tpu_torch.utils.separator import separate

    mix, frames = request("rtfs4-pallas", 16, generator("pallas"))
    got = _serve(monkeypatch, "rtfs4-pallas", mix, frames, f32)
    model, video = models("rtfs4-pallas")
    monkeypatch.setattr("rtfs_net_tpu_torch.ops.rnn.DEFAULT_SRU_BACKEND", "scan")
    want = separate(model, mix, frames, video_model=video)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-5 + 1e-4 * float(want.abs().max())


def make_system(model, dtype, config=None, optimizer=None):
    """``System`` with the optimizer of ``config`` (default: RTFS-Net-4's),
    or the one named by ``optimizer`` with that config's settings."""
    from rtfs_net_tpu_torch.losses import PITLossWrapper, pairwise_neg_sisdr, pairwise_neg_snr
    from rtfs_net_tpu_torch.system import System, make_optimizer

    optim = load_config(config or "lrs2_RTFSNet_4_layer")["optim"]
    if optimizer is not None:
        optim["optimizer"] = optimizer
    return System(model, make_optimizer(model.parameters(), **optim),
                  {"train": PITLossWrapper(pairwise_neg_snr),
                   "val": PITLossWrapper(pairwise_neg_sisdr)},
                  compute_dtype=None if dtype == f32 else dtype)


def train_batch(B, gen, chan=512):
    """A (mix, target, lip embedding) batch; the target is the mixture, as
    the JAX package's train benchmark has it."""
    mix = torch.randn((B, SAMPLES), generator=gen, device="cuda")
    return mix, mix[:, None], 0.1 * torch.randn((B, chan, FRAMES), generator=gen, device="cuda")


def _config_name(path):
    return "lrs2_CTCNet_16_layer" if path.startswith("ctcnet") else None


@pytest.mark.parametrize("path,B,dtype,optimizer", TRAINING,
                         ids=[f"{p}-B{B}-{str(d)[6:]}" + (f"-{o}" if o else "")
                              for p, B, d, o in TRAINING])
def test_train_step_launches(card, path, B, dtype, optimizer):
    model = copy.deepcopy(models(path)[0])
    system = make_system(model, dtype, _config_name(path), optimizer)
    chan = PATHS[path].conf()["audionet"]["pretrained_vout_chan"]
    batch = train_batch(B, generator(path, "train", B), chan)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    out = assert_launches(lambda: system.train_step(
        batch, generator=torch.Generator(device="cuda").manual_seed(4)), PATHS[path].train)
    loss, gnorm = float(out["loss"]), float(out["grad_norm"])
    assert torch.isfinite(torch.tensor([loss, gnorm])).all(), (loss, gnorm)
    assert any(not torch.equal(p, params[n]) for n, p in model.named_parameters())
    if path.startswith("ctcnet"):  # the video FRCNN's BatchNorm statistics moved
        buffers = dict(model.named_buffers())
        assert stats and not [n for n, b in stats.items() if torch.equal(b, buffers[n])]


@pytest.mark.parametrize("path", ["rtfs4", "ctcnet16"])
def test_train_step_matches_the_cpu(card, path):
    """One float32 B=1 step, dropout off: the loss within 1e-4·|loss| and
    every gradient within 1e-3·max|g| of the same step on the CPU."""
    from rtfs_net_tpu_torch.models import build_model

    conf = PATHS[path].conf()["audionet"]
    if path == "rtfs4":
        conf["video_params"]["layers"]["layer_1"]["dropout"] = 0.0
    cpu_model = build_model(conf, device="cpu", generator=torch.Generator().manual_seed(0))
    card_model = copy.deepcopy(cpu_model).cuda()
    batch = train_batch(1, generator(path, "parity"), conf["pretrained_vout_chan"])
    loss_card = float(make_system(card_model, f32, _config_name(path)).backward(batch))
    loss_cpu = float(make_system(cpu_model, f32, _config_name(path)).backward(
        tuple(t.cpu() for t in batch)))
    assert abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu)
    grads = {n: p.grad for n, p in cpu_model.named_parameters()}
    scale = max(float(g.abs().max()) for g in grads.values())
    for n, p in card_model.named_parameters():
        assert float((p.grad.cpu() - grads[n]).abs().max()) <= 1e-3 * scale, n


def test_ctcnet_macs_are_the_papers(card):
    """MACs of one 2 s CTCNet-16 forward within 5% of the paper's 167.2 G
    (``tests/test_macs_paper.py``)."""
    from rtfs_net_tpu_torch.utils.flops import conv_dot_macs

    macs = conv_dot_macs(models("ctcnet16")[0], *request("ctcnet16", 1, generator("macs")))
    assert abs(macs / 1e9 - 167.2) <= 0.05 * 167.2, macs / 1e9


@pytest.mark.parametrize("width", [0.5, 1.0, 1.5, 2.0])
def test_shufflenet_video_model_matches_the_cpu(card, width):
    """The video model alone at each width, B=1 float32, 13 K3 launches,
    within 5e-4·max|ref| of the CPU."""
    from rtfs_net_tpu_torch.models import build_video_model

    conf = {**shufflenet_conf()["videonet"], "width_mult": width}
    video = build_video_model(conf, device="cuda", generator=torch.Generator().manual_seed(0))
    frames = torch.randn((1, 1, FRAMES, MOUTH, MOUTH), generator=generator("width", width),
                         device="cuda")
    with torch.no_grad():
        got = assert_launches(lambda: video(frames), {"K3": SHUFFLE_K3})
        ref = copy.deepcopy(video).cpu()(frames.cpu())
    assert tuple(got.shape) == (1, video.backend_out, FRAMES)
    assert float((got.cpu() - ref).abs().max()) <= 5e-4 * float(ref.abs().max())


ZOO_PLANE, ZOO_BATCH = (64, 125, 64), 2  # (C, T, F); the batch of the layers alone


def zoo_layers():
    """The layers no shipped config uses, at C = 64 on RTFS-Net-4's (125,
    64) plane: name -> (module, K3 launches a forward)."""
    from rtfs_net_tpu_torch.models import layers as L

    C, T, F = ZOO_PLANE
    return {
        "BiLSTM2D": (lambda: L.BiLSTM2D(C, 32), 0),
        "GlobalGALR": (lambda: L.GlobalGALR(C, group_ffn=True), 1),
        "CBAMBlock": (lambda: L.CBAMBlock(C), 0),
        "ShuffleAttention": (lambda: L.ShuffleAttention(C), 0),
        "CoTAttention": (lambda: L.CoTAttention(C), 0),
        "MLP": (lambda: L.MLP(C, (T, F), 8), 0),
        "Permutator": (lambda: L.Permutator(C, (T, F), 8), 0),
        "DepthwiseSeparableConvolution": (lambda: L.DepthwiseSeparableConvolution(
            C, C, 5, norm_type="gLN", act_type="PReLU", is2d=True), 1),
        "ConvolutionalRNN": (lambda: L.ConvolutionalRNN(C, 2 * C, 5, is2d=True), 2),
        "DualPathRNN_Attn_ffn": (lambda: L.DualPathRNN(C, 32, 3, rnn_type="Attn",
                                                       apply_ffn=True), 0),
    }


@pytest.mark.parametrize("name", list(zoo_layers()))
def test_layer_alone_matches_the_cpu(card, name):
    """float32 within 5e-4·max|ref| of the CPU with its K3 launches;
    bfloat16 finite."""
    from rtfs_net_tpu_torch.models import init_weights

    make, k3 = zoo_layers()[name]
    module = init_weights(make(), torch.Generator().manual_seed(0)).eval()
    ref_module = copy.deepcopy(module)
    module = module.cuda()
    x = torch.randn((ZOO_BATCH, *ZOO_PLANE), generator=generator("layer"), device="cuda")
    with torch.no_grad():
        got = assert_launches(lambda: module(x), {"K3": k3})
        ref = ref_module(x.cpu())
        half = module(x.to(bf16))
    assert tuple(got.shape) == tuple(x.shape)
    assert float((got.cpu() - ref).abs().max()) <= 5e-4 * float(ref.abs().max())
    assert bool(torch.isfinite(half).all())


def test_port_lstm_matches_nn_lstm(card):
    """The port's LSTM, which passes its weights cast per call as a list,
    against ``nn.LSTM`` on one flattened buffer, on the windows of one
    DualPathRNN along F at B = 16: within 1e-5."""
    from rtfs_net_tpu_torch.models import init_weights
    from rtfs_net_tpu_torch.models.layers import DualPathRNN
    from rtfs_net_tpu_torch.ops.conv import unfold_1d

    C, T, F = ZOO_PLANE
    B = 16
    layer = rtfs4_conf()["audionet"]["audio_params"]["layers"]["layer_1"]
    kw = {k: v for k, v in layer.items() if k != "layer_type"}
    lstm = init_weights(DualPathRNN(C, **{**kw, "rnn_type": "LSTM"}),
                        torch.Generator().manual_seed(0)).cuda().eval().rnn
    ref = torch.nn.LSTM(C * kw["kernel_size"], kw["hid_chan"], kw["num_layers"],
                        bidirectional=True).cuda()
    ref.load_state_dict(lstm.state_dict())
    x = torch.randn((B, C, T, F), generator=generator("lstm"), device="cuda")
    seq = unfold_1d(x.transpose(-2, -1).permute(0, 3, 1, 2).reshape(B * T, C, F),
                    kw["kernel_size"], kw["stride"]).permute(2, 0, 1).contiguous()
    with torch.no_grad():
        assert float((lstm(seq) - ref(seq)[0]).abs().max()) <= 1e-5


@pytest.fixture(scope="module")
def one_gradient(card):
    """RTFS-Net-4's parameters (dropout off) and one B=1 gradient of them."""
    from rtfs_net_tpu_torch.models import build_model

    conf = rtfs4_conf()["audionet"]
    conf["video_params"]["layers"]["layer_1"]["dropout"] = 0.0
    model = build_model(conf, device="cuda", generator=torch.Generator().manual_seed(0))
    make_system(model, f32).backward(train_batch(1, generator("optimizers")))
    return ([p.detach().clone() for p in model.parameters()],
            [p.grad.clone() for p in model.parameters()])


@pytest.mark.parametrize("name", optimizers.NAMES)
def test_optimizer_matches_the_cpu(card, one_gradient, name):
    """7 steps (the ranger variants' lookahead syncs at the 6th) from one
    gradient, on the card and on the CPU from the same start: within
    1e-5·max|p|, and the parameters moved."""
    from rtfs_net_tpu_torch.system import make_optimizer

    start, grads = one_gradient
    optim = load_config("lrs2_RTFSNet_4_layer")["optim"]
    result = {}
    for device in ("cuda", "cpu"):
        params = [torch.nn.Parameter(p.to(device).clone()) for p in start]
        opt = make_optimizer(params, **{**optim, "optimizer": name})
        for _ in range(7):
            for p, g in zip(params, grads):
                p.grad = g.to(device)
            opt.step()
        result[device] = [p.detach().cpu() for p in params]
    scale = max(float(p.abs().max()) for p in result["cpu"])
    err = max(float((a - b).abs().max()) for a, b in zip(result["cuda"], result["cpu"]))
    moved = max(float((a - b.cpu()).abs().max()) for a, b in zip(result["cuda"], start))
    assert err <= 1e-5 * scale and moved > 0, (err, scale, moved)

