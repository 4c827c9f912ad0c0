"""PyTorch port vs JAX package: losses, PIT, and the train step.

* SDR-family losses and ``PITLossWrapper`` (all three ``pit_from`` modes,
  n_src 1-3 by permutation search, n_src 4 by the Hungarian path) against
  JAX within 1e-5 relative (float32 sums of 64-256 terms).
* One float32 ``System.train_step`` of ``test_torch_avnet.py``'s tiny AV
  config (one SRU layer per DualPathRNN, one repeat) with dropout 0, against ``jax.value_and_grad`` of the same loss
  from the same weights and batch: loss within 1e-5 relative, pre-clip
  grad norm within 1e-4 relative, the clipped grads by name within
  5e-4·max|g| (the forward's tolerance, tests/test_avnet_convert.py:324),
  and the BatchNorm running statistics after the checkpointed step
  against JAX's ``batch_stats`` within 1e-5 (one momentum-0.1 update).
* AdamW alone: the same grads through optax.adamw and the port's AdamW
  give the same parameters within 1e-6 (updates are ~1e-3).
* ``accum_steps=2`` equals ``accum_steps=1``, and checkpointing leaves the
  grads unchanged with dropout on (both within 1e-6·max|g|: only the
  order of float32 sums differs); a bfloat16 step keeps float32
  parameters and grads and stays finite.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtfs_net_tpu import losses as jlosses
from rtfs_net_tpu.models import AVNet as JaxAVNet
from rtfs_net_tpu.utils.avnet_convert import convert_avnet
from rtfs_net_tpu_torch import losses
from rtfs_net_tpu_torch.models import build_model
from rtfs_net_tpu_torch.system import System, get_lr, make_optimizer, optimizers, set_lr
from rtfs_net_tpu_torch.utils.convert import grads_from_jax, state_dict_from_jax

from _torch_port import one_torch_thread  # noqa: F401
from test_torch_avnet import TINY

L, TV, B = 1000, 5, 2


def _conf(dropout):
    """The tiny AV config with one SRU layer per DualPathRNN (a smaller JAX
    compile; layers with k=3 are held to JAX in test_torch_sru_train.py)."""
    conf = copy.deepcopy(TINY)
    conf["video_params"]["layers"]["layer_1"]["dropout"] = dropout
    for name in ("layer_1", "layer_2"):
        conf["audio_params"]["layers"][name]["num_layers"] = 1
    return conf


def _system(model, lr=1e-3, **kw):
    opt = make_optimizer(model.parameters(), "adamw", lr=lr, weight_decay=0.1)
    return System(model, opt, {"train": losses.PITLossWrapper(losses.pairwise_neg_snr),
                               "val": losses.PITLossWrapper(losses.pairwise_neg_sisdr)},
                  **kw)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((B, L)).astype(np.float32)
    tgt = (0.5 * mix + 0.3 * rng.standard_normal((B, L))).astype(np.float32)[:, None]
    mouth = rng.standard_normal((B, 16, TV)).astype(np.float32)
    return mix, tgt, mouth


def _perturbed_model(conf, seed):
    """A port model whose norms, slopes and gates are off their constant
    initial values (+N(0, 0.1²); BatchNorm variances from [1, 1.5))."""
    gen = torch.Generator().manual_seed(seed)
    model = build_model(conf, device="cpu", generator=gen)
    sd = {k: (torch.rand(t.shape, generator=gen) * 0.5 + 1.0 if k.endswith("running_var")
              else t + 0.1 * torch.randn(t.shape, generator=gen))
          if t.is_floating_point() else t for k, t in model.state_dict().items()}
    model.load_state_dict(sd)
    return model


@pytest.fixture(scope="module")
def jax_step(batch):
    """Initial variables (the port's, converted), and JAX's loss, grads,
    grad norm and updated batch_stats for one training forward with
    dropout 0. JAX runs without remat: the same values, a smaller compile
    (the port's step checkpoints its blocks)."""
    mix, tgt, mouth = batch
    conf = _conf(0.0)
    conf["audio_params"]["repeats"] = 1  # the fused repeat only: a smaller compile
    jconf = copy.deepcopy(conf)
    jconf["audio_params"]["remat"] = jconf["video_params"]["remat"] = False
    jm = JaxAVNet(**jconf)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), mix, mouth)
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    sd = {k: t.numpy() for k, t in _perturbed_model(conf, 1).state_dict().items()}
    v = jax.tree_util.tree_map(np.asarray, convert_avnet(sd, template, conf))
    loss_fn = jlosses.PITLossWrapper(jlosses.pairwise_neg_snr)

    def f(params, stats, m, t, mo):
        est, upd = jm.apply({"params": params, "batch_stats": stats}, m, mo, train=True,
                            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return loss_fn(est.astype(jnp.float32), t), upd["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        v["params"], v["batch_stats"], mix, tgt, mouth)
    grads, stats = jax.tree_util.tree_map(np.asarray, (grads, stats))
    gnorm = float(np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                              for g in jax.tree_util.tree_leaves(grads))))
    return dict(conf=conf, v=v, loss=float(loss), grads=grads, gnorm=gnorm, stats=stats)


@pytest.fixture(scope="module")
def port_step(batch, jax_step):
    """The port's float32 train step from JAX's initial variables."""
    model = _perturbed_model(jax_step["conf"], 1)
    system = _system(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    out = system.train_step(tuple(torch.from_numpy(a) for a in batch),
                            generator=torch.Generator().manual_seed(0))
    return model, before, out


def _assert_grads_close(got, want, rtol):
    assert set(got) == set(want)
    scale = max(float(t.abs().max()) for t in want.values())
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=0,
                                   atol=rtol * scale, err_msg=name)


def test_train_step_matches_jax(jax_step, port_step):
    model, _, out = port_step
    assert abs(float(out["loss"]) - jax_step["loss"]) <= 1e-5 * abs(jax_step["loss"])
    assert abs(float(out["grad_norm"]) - jax_step["gnorm"]) <= 1e-4 * jax_step["gnorm"]
    clip = min(1.0, 5.0 / (jax_step["gnorm"] + 1e-6))
    want = {k: t * clip for k, t in grads_from_jax(
        jax_step["grads"], jax_step["conf"], jax_step["v"]["batch_stats"]).items()}
    got = {n: p.grad for n, p in model.named_parameters()}
    assert all(g.dtype == torch.float32 and bool(g.abs().sum() > 0) for g in got.values())
    _assert_grads_close(got, want, 5e-4)


def test_batchnorm_statistics_after_checkpointed_step(jax_step, port_step):
    model, _, _ = port_step
    want = state_dict_from_jax({"params": jax_step["v"]["params"],
                                "batch_stats": jax_step["stats"]}, jax_step["conf"])
    start = state_dict_from_jax(jax_step["v"], jax_step["conf"])
    got = model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        assert not torch.equal(want[k], start[k]), k  # the step moved them
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_adamw_update_matches_optax(port_step):
    model, before, _ = port_step
    names = list(before)
    params = {n: before[n].numpy() for n in names}
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    opt = optax.adamw(1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1)

    @jax.jit
    def step(params, grads):
        updates, _ = opt.update(grads, opt.init(params), params)
        return optax.apply_updates(params, updates)

    want = step(params, grads)
    got = dict(model.named_parameters())
    for n in names:
        np.testing.assert_allclose(got[n].detach().numpy(), np.asarray(want[n]), rtol=0,
                                   atol=1e-6, err_msg=n)


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def test_accum_steps_match_full_batch(batch):
    """Audio only (no BatchNorm, every op per sample): the mean of the two
    microbatch grads is the full-batch grad."""
    conf = {k: v for k, v in TINY.items()
            if k not in ("video_params", "video_bn_params", "fusion_params")}
    model = build_model(conf, device="cpu", generator=torch.Generator().manual_seed(2))
    mix, tgt, _ = (torch.from_numpy(a) for a in batch)
    out = {}
    for A in (1, 2):
        loss = _system(model, accum_steps=A).backward((mix, tgt, None))
        out[A] = loss, _grads(model)
    assert abs(float(out[2][0]) - float(out[1][0])) <= 1e-5 * abs(float(out[1][0]))
    _assert_grads_close(out[2][1], out[1][1], 1e-6)


def test_checkpointing_keeps_grads_with_dropout(batch):
    conf = _conf(0.1)
    base = build_model(conf, device="cpu", generator=torch.Generator().manual_seed(3))
    data = tuple(torch.from_numpy(a) for a in batch)
    runs = []
    for remat in (True, False):
        model = copy.deepcopy(base)
        for net in (model.refinement_module.audio_net, model.refinement_module.video_net):
            net.remat = remat
        gen = torch.Generator().manual_seed(5)
        start = gen.get_state()
        _system(model).backward(data, generator=gen)
        assert not torch.equal(gen.get_state(), start)  # dropout drew masks
        runs.append((_grads(model), gen.get_state(), model.state_dict()))
    (g_ck, s_ck, sd_ck), (g_plain, s_plain, sd_plain) = runs
    _assert_grads_close(g_ck, g_plain, 1e-6)
    assert torch.equal(s_ck, s_plain)  # the recompute left the generator as it was
    for k in sd_plain:
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            torch.testing.assert_close(sd_ck[k], sd_plain[k], rtol=0, atol=0)


def test_bf16_step_keeps_float32_state(batch):
    model = build_model(_conf(0.1), device="cpu", generator=torch.Generator().manual_seed(4))
    system = _system(model, compute_dtype=torch.bfloat16)
    out = system.train_step(tuple(torch.from_numpy(a) for a in batch),
                            generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(out["loss"])) and np.isfinite(float(out["grad_norm"]))
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
        assert bool(torch.isfinite(p).all() and torch.isfinite(p.grad).all()), n
    val = system.val_step(tuple(torch.from_numpy(a) for a in batch))
    assert np.isfinite(float(val["val_loss"])) and not model.training


def test_batchnorm_training_matches_jax(rng):
    """Training mode: batch statistics with the biased variance normalize;
    the running variance moves by the unbiased one, momentum 0.1."""
    from rtfs_net_tpu.ops.normalizations import BatchNorm1d as JaxBatchNorm1d
    from rtfs_net_tpu_torch.ops.normalizations import BatchNorm1d

    x = (2.0 + 3.0 * rng.standard_normal((4, 6, 7))).astype(np.float32)
    jm = JaxBatchNorm1d(6)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), x,
                                                   use_running_average=True))
    want, upd = jm.apply(v, x, use_running_average=False, mutable=["batch_stats"])
    bn = BatchNorm1d(6).train()
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, ours).numpy(),
                                   np.asarray(upd["batch_stats"][theirs]), atol=1e-6, rtol=1e-5)


def test_droppath_and_dropout_draw_from_the_generator():
    from rtfs_net_tpu_torch.ops.conv import DropPath
    from rtfs_net_tpu_torch.ops.dropout import dropout, use_generator

    x = torch.ones(64, 3, 5)
    dp = DropPath(0.25)
    assert dp.eval()(x) is x and dropout(x, 0.25, training=False) is x
    dp.train()
    outs = []
    for _ in range(2):
        with use_generator(torch.Generator().manual_seed(0)):
            outs.append((dp(x), dropout(x, 0.25, training=True)))
    (y, z), (y2, z2) = outs
    assert torch.equal(y, y2) and torch.equal(z, z2)  # the same seed, the same masks
    # DropPath zeroes whole samples and scales the kept ones by 1/(1-p)
    scaled = float(torch.tensor(1.0) / 0.75)
    assert set(torch.unique(y).tolist()) == {0.0, scaled}
    assert all(len(torch.unique(sample)) == 1 for sample in y)
    assert 0 < int((y[:, 0, 0] == 0).sum()) < 64
    assert set(torch.unique(z).tolist()) == {0.0, scaled}
    assert 0.15 < float((z == 0).float().mean()) < 0.35


def test_optimizer_registry():
    w = [torch.nn.Parameter(torch.zeros(2))]
    assert isinstance(make_optimizer(w, "AdamW", lr=1e-3), torch.optim.AdamW)
    assert isinstance(make_optimizer(w, "adam"), torch.optim.Adam)
    opt = make_optimizer(w, "sgd", lr=0.1, momentum=0.9, weight_decay=1e-4)
    assert get_lr(set_lr(opt, 0.05)) == 0.05
    assert isinstance(make_optimizer(w, "lamb"), optimizers.Lamb)  # the optax rule
    with pytest.raises(ValueError):
        make_optimizer(w, "nope")


SDR_TYPES = ("sdr", "sisdr", "sdsdr", "snr")


@jax.jit
def _jax_losses(est, tgt):
    return {name: (jlosses.pairwise_neg_sdr(est, tgt, sdr_type=name),
                   jlosses.multisrc_neg_sdr(est, tgt, sdr_type=name),
                   jlosses.singlesrc_neg_sdr(est[:, 0], tgt[:, 0], sdr_type=name))
            for name in SDR_TYPES}


@pytest.mark.parametrize("n_src", [1, 2, 3])
def test_losses_match_jax(rng, n_src):
    est = rng.standard_normal((3, n_src, 64)).astype(np.float32)
    tgt = rng.standard_normal((3, n_src, 64)).astype(np.float32)
    t_est, t_tgt = torch.from_numpy(est), torch.from_numpy(tgt)
    want = _jax_losses(est, tgt)
    for name in SDR_TYPES:
        got = (losses.pairwise_neg_sdr(t_est, t_tgt, sdr_type=name),
               losses.multisrc_neg_sdr(t_est, t_tgt, sdr_type=name),
               losses.singlesrc_neg_sdr(t_est[:, 0], t_tgt[:, 0], sdr_type=name))
        for g, w in zip(got, want[name]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("n_src", [1, 2, 3, 4])
def test_pit_matches_jax(rng, n_src):
    """n_src 4 takes the Hungarian path for pw_mtx and pw_pt (perm_avg
    always searches every permutation, as at n_src 1-3)."""
    tgt = rng.standard_normal((3, n_src, 256)).astype(np.float32)
    est = (tgt[:, rng.permutation(n_src)]
           + 0.5 * rng.standard_normal(tgt.shape)).astype(np.float32)
    modes = [("pw_mtx", "pairwise_neg_sisdr"), ("pw_pt", "singlesrc_neg_snr")]
    for pit_from, loss in modes + [("perm_avg", "multisrc_neg_sisdr")] * (n_src <= 3):
        got_loss, got_est = losses.PITLossWrapper(getattr(losses, loss), pit_from)(
            torch.from_numpy(est), torch.from_numpy(tgt), return_ests=True)
        jpit = functools.partial(
            jlosses.PITLossWrapper(jax.jit(getattr(jlosses, loss)), pit_from),
            return_ests=True)
        if n_src <= 3 and pit_from != "perm_avg":  # the others index on the host
            jpit = jax.jit(jpit)
        want_loss, want_est = jpit(jnp.asarray(est), jnp.asarray(tgt))
        np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5,
                                   err_msg=pit_from)
        np.testing.assert_array_equal(got_est.numpy(), np.asarray(want_est), err_msg=pit_from)
