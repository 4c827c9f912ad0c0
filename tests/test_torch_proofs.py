"""The training proofs (``rtfs_net_tpu_torch/scripts/{train_proof,
av_train_proof}.py``) against the JAX side's scripts on the CPU:

* the data: ``speechlike`` and the JAX scripts' arrays, each taken from
  the JAX script's source by AST (``scripts/train_proof.py`` enables a
  compilation cache at import, ``scripts/av_train_proof.py`` trains at
  import), equal to the port's;
* the proof loop (``train_proof.fit``) at a tiny width with dropout 0:
  its first 3 train losses against three jitted steps of the JAX
  package's ``System.train_step`` from the same weights (carried by
  ``convert_avnet``), within 2e-4·|loss|: the single step's 1e-4·|loss|,
  doubled for two AdamW updates that amplify the frameworks' float32
  rounding;
* the AV proof's system at a tiny width (``train_video_model``, the tiny
  lip autoencoder as the video model): the step-1 loss against JAX's
  within 1e-4·|loss| and step 2's within 2e-4·|loss| (float32), every
  video parameter moved in both frameworks; and the proof's own run with
  its ResNet-18 video model on 44x44 frames in bfloat16, with its
  every-parameter check.
"""
import ast
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtfs_net_tpu import losses as jlosses
from rtfs_net_tpu.models import AVNet as JaxAVNet
from rtfs_net_tpu.models.videomodels import AEVideoModel as JaxAEVideoModel
from rtfs_net_tpu.system import System as JaxSystem
from rtfs_net_tpu.system import make_optimizer as jax_make_optimizer
from rtfs_net_tpu.system.core import TrainState
from rtfs_net_tpu.utils.avnet_convert import convert_avnet
from rtfs_net_tpu_torch.models import build_video_model
from rtfs_net_tpu_torch.ops.kernels import KERNELS
from rtfs_net_tpu_torch.scripts import av_train_proof, train_proof
from rtfs_net_tpu_torch.utils.convert import video_state_dict_from_jax

from _torch_port import jax_random, one_torch_thread  # noqa: F401
from test_torch_train import _conf, _perturbed_model
from test_torch_video import TINY_AV
from test_torch_video_zoo import AE_VIDEO

ROOT = os.path.join(os.path.dirname(__file__), "..")
OPTIM = {"optimizer": "adamw", "lr": 1e-3, "weight_decay": 0.1}
B, L, TV = 2, 2000, 10


def _jax_script(name):
    with open(os.path.join(ROOT, "scripts", name)) as f:
        return ast.parse(f.read())


def _jax_speechlike():
    (fn,) = [n for n in _jax_script("train_proof.py").body
             if isinstance(n, ast.FunctionDef) and n.name == "speechlike"]
    scope = {"np": np}
    exec(compile(ast.Module([fn], []), "scripts/train_proof.py", "exec"), scope)
    return scope["speechlike"]


def test_speechlike_is_the_jax_scripts():
    want_fn = _jax_speechlike()
    for n, f0 in ((32000, 150.0), (2000, 310.0), (777, 130.0)):
        got = train_proof.speechlike(np.random.default_rng(3), n, f0=f0)
        want = want_fn(np.random.default_rng(3), n, f0=f0)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_proof_batch_is_the_jax_scripts():
    """``scripts/train_proof.py:39-44`` with its ``speechlike``."""
    speechlike = _jax_speechlike()
    rng = np.random.default_rng(0)
    target = np.stack([speechlike(rng, 32000, f0=130 + 30 * i) for i in range(4)])
    noise = np.stack([speechlike(rng, 32000, f0=280 + 25 * i) for i in range(4)])
    mix = np.asarray(jnp.asarray(target + noise))
    mouth = rng.standard_normal((4, 512, 50)).astype(np.float32) * 0.1
    got = train_proof.proof_batch()
    for g, w in zip(got, (mix, target[:, None, :], mouth)):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_av_batch_is_the_jax_scripts():
    """The assignments of ``scripts/av_train_proof.py:18-23``, run as they are."""
    wanted = {"rng", "B", "src", "noise", "mix", "mouths"}
    body = [n for n in _jax_script("av_train_proof.py").body if isinstance(n, ast.Assign)
            and {getattr(t, "id", None) or t.elts[0].id for t in n.targets} & wanted]
    scope = {"np": np, "jnp": jnp}
    exec(compile(ast.Module(body, []), "scripts/av_train_proof.py", "exec"), scope)
    mix, tgt, mouths = av_train_proof.av_batch()
    np.testing.assert_array_equal(mix, np.asarray(scope["mix"]))
    np.testing.assert_array_equal(tgt, np.asarray(scope["src"])[:, None])
    np.testing.assert_array_equal(mouths, np.asarray(scope["mouths"]))


def _jax_state(system, params, batch_stats, video=None):
    trainable = params if video is None else {"model": params, "video": video["params"]}
    return TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=batch_stats,
                      opt_state=system.optimizer.init(trainable),
                      video_params=None if video is None else video["params"],
                      video_stats=None if video is None else video.get("batch_stats", {}))


def _jax_variables(model, jconf, *inputs):
    shapes = jax.eval_shape(JaxAVNet(**jconf).init, jax.random.PRNGKey(0), *inputs)
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    return jax.tree_util.tree_map(np.asarray, convert_avnet(sd, template, jconf))


def _jax_system(jconf, **kwargs):
    return JaxSystem(JaxAVNet(**jconf), jax_make_optimizer(**OPTIM),
                     {"train": jlosses.PITLossWrapper(jlosses.pairwise_neg_snr),
                      "val": jlosses.PITLossWrapper(jlosses.pairwise_neg_sisdr)}, **kwargs)


def test_proof_loop_matches_jax_train_steps():
    conf = _conf(0.0)
    conf["audio_params"]["repeats"] = 1  # the fused repeat only: a smaller compile
    jconf = copy.deepcopy(conf)
    jconf["audio_params"]["remat"] = jconf["video_params"]["remat"] = False
    mix, tgt, mouth = train_proof.proof_batch(B, L, conf["pretrained_vout_chan"], TV)
    model = _perturbed_model(conf, 1)
    v = _jax_variables(model, jconf, mix, mouth)

    system = _jax_system(jconf)
    state = _jax_state(system, v["params"], v["batch_stats"])
    step = jax.jit(system.train_step)
    want = []
    for i in range(3):
        state, m = step(state, (mix, tgt, mouth), jax.random.PRNGKey(i))
        want.append(float(m["loss"]))

    port = train_proof.make_system(model, OPTIM)
    got = train_proof.fit(port, tuple(torch.from_numpy(a) for a in (mix, tgt, mouth)), 3,
                          torch.Generator().manual_seed(1), log_every=3, log=None)
    assert len(got["losses"]) == 3 and len(got["val_db"]) == 2
    assert want[0] != want[2]  # the steps moved the weights
    np.testing.assert_allclose(got["losses"], want, rtol=2e-4, atol=0)


def test_av_proof_steps_match_jax_and_move_the_video_model():
    """The AV proof's system (``train_video_model``, AdamW lr 1e-3, wd 0.1)
    with the tiny lip autoencoder as its trainable video model (the JAX
    ResNet-18's gradient compile alone takes 25 s here; its forward is
    held to the port in ``test_torch_video.py``): two float32 steps, the
    losses against JAX's, and every video parameter moved on both sides."""
    frames = 4
    mix, tgt, mouths = av_train_proof.av_batch(B, L, frames, 24)
    conf = {**_conf(0.0), "pretrained_vout_chan": 16 * 3 * 3}
    conf["audio_params"]["repeats"] = 1
    jconf = copy.deepcopy(conf)
    jconf["audio_params"]["remat"] = jconf["video_params"]["remat"] = False
    jvideo = JaxAEVideoModel()
    vv = jax.tree_util.tree_map(np.asarray, jax_random(jvideo, np.random.default_rng(1),
                                                       mouths[:1]))
    model = _perturbed_model(conf, 1)
    v = _jax_variables(model, jconf, mix[:1], np.zeros((1, 144, frames), np.float32))

    system = _jax_system(jconf, video_model=jvideo, video_variables=vv,
                         train_video_model=True)
    state = _jax_state(system, v["params"], v["batch_stats"], vv)
    step = jax.jit(system.train_step)
    want = []
    for i in range(2):
        state, m = step(state, (mix, tgt, mouths), jax.random.PRNGKey(i))
        want.append(float(m["loss"]))
    assert all(not np.array_equal(np.asarray(a), b) for a, b in zip(
        jax.tree_util.tree_leaves(state.video_params), jax.tree_util.tree_leaves(vv["params"])))

    video = build_video_model(AE_VIDEO, device="cpu")
    video.load_state_dict(video_state_dict_from_jax(vv))
    port = train_proof.make_system(model, av_train_proof.OPTIM, video_model=video,
                                   train_video_model=True)
    before = [p.detach().clone() for p in video.parameters()]
    got = train_proof.fit(port, tuple(torch.from_numpy(a) for a in (mix, tgt, mouths)), 2,
                          torch.Generator().manual_seed(2), log_every=2, validate=False,
                          log=None)
    assert want[0] != want[1]
    np.testing.assert_allclose(got["losses"][0], want[0], rtol=1e-4, atol=0)
    np.testing.assert_allclose(got["losses"], want, rtol=2e-4, atol=0)
    assert av_train_proof.moved(before, video) == (len(before), len(before))


def test_av_proof_run_in_bfloat16_moves_every_video_parameter():
    out = av_train_proof.run(torch.device("cpu"), conf={"audionet": copy.deepcopy(TINY_AV)},
                             steps=2, arrays=av_train_proof.av_batch(B, L, 4, 44))
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert out["video_moved"] == out["video_params"] > 0
    assert set(out["launches"]) == {k.label for k in KERNELS}
