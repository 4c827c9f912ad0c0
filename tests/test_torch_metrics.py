"""PyTorch port vs JAX package: the host metrics, the native extension's
loader, the feature chunking, and the parameter and MAC counts.

* ``stoi`` (plain and extended), ``np_pit_neg_sdr`` (three SDR kinds, one
  and two sources), the eval engine's ``_np_reorder`` and an
  ``ALLMetricsTracker`` CSV round trip agree with JAX's to 1e-9: the
  port's are copies of the same numpy code.
* PESQ through both dispatchers, pinned to one backend, is equal.
* The tfevents writer's native crc32c equals its pure-Python table.
* ``split_feature``/``merge_feature`` agree with JAX's to 1e-6.
* RTFS-Net-4: ``count_params`` equals JAX's, and ``conv_dot_macs`` over a
  2 s input lands within 1% of JAX's ``conv_dot_macs(thop_equivalent=True)``
  (22.09 G, tests/test_macs_paper.py), traced shape-only on the JAX side.
"""
import csv
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rtfs_net_tpu import evaluation as jax_evaluation
from rtfs_net_tpu.models import AVNet as JaxAVNet
from rtfs_net_tpu.utils import features as jax_features
from rtfs_net_tpu.utils import flops as jax_flops
from rtfs_net_tpu_torch import _native, evaluation
from rtfs_net_tpu_torch.models import build_model
from rtfs_net_tpu_torch.system import tb_writer
from rtfs_net_tpu_torch.utils import features, flops

from _torch_port import one_torch_thread  # noqa: F401

# the metrics packages export functions under their modules' names
jax_allwrapper, jax_pesq, jax_stoi, allwrapper, pesq, stoi = (
    importlib.import_module(f"{package}.metrics.{name}")
    for package in ("rtfs_net_tpu", "rtfs_net_tpu_torch")
    for name in ("allwrapper", "pesq", "stoi"))

SR = 16000
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _speech_like(rng, n):
    """A clean signal with syllable-rate energy (STOI's silent-frame removal
    keeps most of it) and a noisy estimate of it."""
    t = np.arange(n) / SR
    clean = (np.sin(2 * np.pi * 4 * t) ** 2) * rng.standard_normal(n)
    return clean.astype(np.float32), (clean + 0.3 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("extended", [False, True])
def test_stoi_matches_jax(extended):
    clean, est = _speech_like(np.random.default_rng(1), 24000)
    want = jax_stoi.stoi(clean, est, SR, extended=extended)
    got = stoi.stoi(clean, est, SR, extended=extended)
    assert 0.1 < abs(want) < 1.0
    assert abs(got - want) <= 1e-9


@pytest.mark.parametrize("kind", ["snr", "sisdr", "sdsdr"])
@pytest.mark.parametrize("n_src", [1, 2])
def test_np_pit_neg_sdr_matches_jax(kind, n_src):
    rng = np.random.default_rng(2)
    ref = rng.standard_normal((n_src, 4000))
    est = ref[::-1] + 0.5 * rng.standard_normal((n_src, 4000))
    want = jax_allwrapper.np_pit_neg_sdr(est, ref, kind)
    assert abs(allwrapper.np_pit_neg_sdr(est, ref, kind) - want) <= 1e-9


@pytest.mark.parametrize("kind", ["snr", "sisdr"])
def test_np_reorder_matches_jax(kind):
    rng = np.random.default_rng(3)
    src = rng.standard_normal((3, 2000)).astype(np.float32)
    est = src[[2, 0, 1]] + 0.1 * rng.standard_normal((3, 2000)).astype(np.float32)
    want = jax_evaluation._np_reorder(est, src, kind)
    got = evaluation._np_reorder(est, src, kind)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, est[[1, 2, 0]])
    assert evaluation._loss_sdr_type(None) == "sisdr"


def _tracker_rows(module, path, utterances):
    tracker = module.ALLMetricsTracker(save_file=str(path))
    for key, (mix, clean, est) in utterances.items():
        tracker(mix=mix, clean=clean, estimate=est, key=key)
    tracker.final()
    with open(path) as f:
        return list(csv.DictReader(f))


def test_tracker_csv_round_trip_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("RTFS_PESQ_BACKEND", "none")  # PESQ has its own test
    for module in (jax_pesq, pesq):
        monkeypatch.setattr(module, "_impl", None)
    rng = np.random.default_rng(4)
    utterances = {}
    for i in range(3):
        clean, est = _speech_like(rng, 16000)
        utterances[f"u{i}"] = (clean + 0.7 * rng.standard_normal(16000).astype(np.float32),
                               clean[None], est[None])
    with pytest.warns(UserWarning, match="no PESQ"):
        want = _tracker_rows(jax_allwrapper, tmp_path / "jax.csv", utterances)
    with pytest.warns(UserWarning, match="no PESQ"):
        got = _tracker_rows(allwrapper, tmp_path / "port.csv", utterances)
    assert [r["snt_id"] for r in got] == ["u0", "u1", "u2", "avg", "std"]
    assert list(got[0]) == allwrapper.ALLMetricsTracker.COLUMNS == list(want[0])
    for g, w in zip(got, want):
        assert g["snt_id"] == w["snt_id"]
        for col in allwrapper.ALLMetricsTracker.COLUMNS[1:]:
            a, b = float(g[col]), float(w[col])
            assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-9, (g["snt_id"], col)


@pytest.mark.parametrize("backend", ["native", "none"])
def test_pesq_dispatchers_agree(backend, monkeypatch):
    monkeypatch.setenv("RTFS_PESQ_BACKEND", backend)
    for module in (jax_pesq, pesq):
        monkeypatch.setattr(module, "_impl", None)
        monkeypatch.setattr(module, "_warned", True)
    clean, est = _speech_like(np.random.default_rng(5), 32000)
    want, got = jax_pesq.pesq(est, clean, SR), pesq.pesq(est, clean, SR)
    assert pesq.pesq_backend() == backend
    if backend == "none":
        assert np.isnan(got) and np.isnan(want)
    else:
        assert got == want and 1.0 < got < 4.6


def test_native_crc32c_matches_the_table():
    """The tfevents record of a seeded scalar: the native crc32c (which the
    writer takes where the extension builds) equals the pure-Python table."""
    assert _native.load_native() is not None, "the native extension did not build"
    value = float(np.random.default_rng(6).standard_normal())
    record = tb_writer._event(1.5e9, 7, tb_writer._summary_value("loss", value))
    assert tb_writer._native_crc32c() is not None
    assert tb_writer.crc32c(record) == tb_writer.crc32c_py(record)


@pytest.mark.parametrize("block", [4, 7, 16])
def test_split_merge_match_jax(block):
    x = np.random.default_rng(7).standard_normal((2, 3, 37)).astype(np.float32)
    want, want_rest = jax_features.split_feature(jnp.asarray(x), block)
    got, rest = features.split_feature(torch.from_numpy(x), block)
    assert rest == want_rest
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(features.merge_feature(got, rest).numpy(),
                               np.asarray(jax_features.merge_feature(want, want_rest)),
                               atol=1e-6)
    np.testing.assert_allclose(features.merge_feature(got, rest).numpy(), 2 * x, atol=1e-6)
    y = np.zeros((2, 3, 50), np.float32)
    np.testing.assert_array_equal(features.pad_x_to_y(torch.from_numpy(x), torch.from_numpy(y)),
                                  np.asarray(jax_features.pad_x_to_y(jnp.asarray(x), y)))
    assert features.get_bandwidths(512) == jax_features.get_bandwidths(512)


def test_rtfs4_params_and_macs_match_jax():
    with open(os.path.join(ROOT, "rtfs_net_tpu_torch", "configs",
                           "lrs2_RTFSNet_4_layer.yaml")) as f:
        conf = yaml.safe_load(f)["audionet"]
    jm = JaxAVNet(**conf)  # conv_dot_macs multiplies a scanned repeat by its count
    mix, emb = jnp.zeros((1, 2 * SR)), jnp.zeros((1, conf["pretrained_vout_chan"], 50))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), mix, emb)
    variables = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    want_macs = jax_flops.conv_dot_macs(lambda v, m, e: jm.apply(v, m, e), variables, mix,
                                        emb, thop_equivalent=True)

    model = build_model(conf, device="cpu")
    assert flops.count_params(model) == jax_flops.count_params(variables["params"])
    macs = flops.conv_dot_macs(model, torch.zeros((1, 2 * SR)),
                               torch.zeros((1, conf["pretrained_vout_chan"], 50)))
    assert abs(macs - want_macs) <= 0.01 * want_macs, (macs / 1e9, want_macs / 1e9)
    assert abs(want_macs / 1e9 - 22.09) < 0.01


def test_profiling_on_the_cpu(tmp_path):
    """``timed`` gives every call its own arguments (warm-up calls -1, -2,
    ..., timed calls 0 .. iters-1); without a card there are no device
    memory statistics; ``trace`` writes a trace file."""
    from rtfs_net_tpu_torch.utils import profiling

    seen = []

    def make_args(i):
        seen.append(i)
        return (torch.full((8,), float(i)),)

    out = profiling.timed(torch.sum, make_args, iters=3, warmup=2)
    assert seen == [-1, -2, 0, 1, 2]
    assert 0 <= out["min_ms"] <= out["mean_ms"]
    assert profiling.device_memory_stats() is None
    with profiling.trace(str(tmp_path)):
        torch.ones(4).sum()
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))
