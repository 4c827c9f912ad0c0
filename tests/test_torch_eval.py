"""PyTorch port vs JAX package: evaluation and separation.

On the JAX tests' tiny config (``tests/test_system.py:TINY_AUDIONET``, cut
to one repeat and one SRU layer), with and without its video branch, the
port's weights (perturbed) carried into JAX by ``convert_avnet``:

* ``run_batched_eval`` against JAX's on the 9-length set of
  tests/test_batched_eval.py (bucket 4000, one batch of 9; a fake lip
  encoder that slices the frames): per utterance, SI-SNR and SDR within
  0.01 dB, STOI within 1e-3, PESQ within 0.05, with float32 frames and
  with uint8 frames normalized on the device;
* the port's batched run (bucket 2000, batches of 4) equals its serial run
  (batches of 1) within 1e-4 dB;
* ``separate`` plain and chunked against the root ``separate.py``'s JAX
  path, within 5e-4·max|ref| (the outputs are 16-bit wavs: one step is
  3e-5); ``separate`` with a serving artifact (``.rtfsx``) against the
  eager CLI, and its refusals;
* ``load_model`` on a Lightning-style checkpoint (``audio_model.`` keys,
  hyper-parameters that ``weights_only=True`` refuses) and on a reference
  blob whose ``model_args`` is ``get_config()``-shaped, each equal to a
  direct ``load_state_dict``; ``import_checkpoint`` of the latter, then
  ``python -m rtfs_net_tpu_torch.test`` on it: ``metrics.csv`` and
  ``results.csv`` with the JAX CLI's row keys in its order.
"""
import argparse
import copy
import csv
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rtfs_net_tpu.datas.transform import MOUTH_MEAN, MOUTH_STD
from rtfs_net_tpu.evaluation import run_batched_eval as jax_run_batched_eval
from rtfs_net_tpu.losses import PITLossWrapper as JaxPIT
from rtfs_net_tpu.losses import pairwise_neg_sisdr as jax_sisdr
from rtfs_net_tpu.metrics import ALLMetricsTracker as JaxTracker
from rtfs_net_tpu.models import AVNet as JaxAVNet
from rtfs_net_tpu.models import serialization as jax_serialization
from rtfs_net_tpu.utils.avnet_convert import convert_avnet
from rtfs_net_tpu_torch import import_checkpoint, local_test, separate as psep, test as ptest
from rtfs_net_tpu_torch.datas import get_preprocessing_pipelines, wavio
from rtfs_net_tpu_torch.evaluation import normalize_mouths, run_batched_eval
from rtfs_net_tpu_torch.export import export_serving, save_serving
from rtfs_net_tpu_torch.losses import PITLossWrapper, pairwise_neg_sisdr
from rtfs_net_tpu_torch.metrics import ALLMetricsTracker
from rtfs_net_tpu_torch.models import build_model, build_video_model, serialization
from rtfs_net_tpu_torch.utils.separator import separate

from _torch_port import one_torch_thread  # noqa: F401
from test_system import TINY_AUDIONET

ROOT = os.path.join(os.path.dirname(__file__), "..")
SR = 16000
LENGTHS = [1500, 1999, 2300, 3999, 1500, 2300, 700, 3999, 2300]
COLUMNS = ("si-snr", "si-snr_i", "sdr", "sdr_i", "stoi", "pesq")


def _tiny(video=True):
    """The JAX tests' tiny config cut to one repeat and one SRU layer per
    DualPathRNN (a JAX compile of it takes 2 s here, of the full tiny one
    6 s), with or without its video branch."""
    conf = copy.deepcopy(TINY_AUDIONET)
    conf["audio_params"]["repeats"] = 1
    conf["audio_params"]["layers"]["layer_1"]["num_layers"] = 1
    if not video:
        conf["video_params"], conf["fusion_params"] = {}, {}
    return conf


def _carried(conf, mouth_shape=None):
    """(JAX model, its variables, the port model): the port's weights from a
    seed, perturbed so that norms, slopes and gates are off their constant
    initial values, carried into JAX by ``convert_avnet`` (a shape-only
    trace, no compile)."""
    jm = JaxAVNet(**conf)
    gen = torch.Generator().manual_seed(0)
    model = build_model(conf, device="cpu", generator=gen)
    sd = {k: (torch.rand(t.shape, generator=gen) + 0.5 if k.endswith("running_var") else
              t + 0.1 * torch.randn(t.shape, generator=gen)) if t.is_floating_point() else t
          for k, t in model.state_dict().items()}
    model.load_state_dict(sd)
    mouth = None if mouth_shape is None else jnp.zeros(mouth_shape)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 2000)), mouth)
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    v = convert_avnet({k: t.numpy() for k, t in sd.items()}, template, conf)
    return jm, v, model.eval()


@pytest.fixture(scope="module")
def av():
    return _carried(_tiny(), (1, 16, 4))


@pytest.fixture(scope="module")
def test_sets():
    """The 9-length set with uint8 frames, and with the same frames
    normalized on the host (float32)."""
    rng = np.random.default_rng(1)
    floats, raws = [], []
    for i, L in enumerate(LENGTHS):
        src = rng.standard_normal(L).astype(np.float32)
        mix = src + 0.5 * rng.standard_normal(L).astype(np.float32)
        raw = rng.integers(0, 256, (1, -(-L * 25 // SR), 88, 88), dtype=np.uint8)
        floats.append((mix, src, (raw.astype(np.float32) - MOUTH_MEAN) / MOUTH_STD,
                       f"utt{i}.wav"))
        raws.append((mix, src, raw, f"utt{i}.wav"))
    return floats, raws


def _rows(path):
    with open(path) as f:
        return {r["snt_id"]: r for r in csv.DictReader(f) if r["snt_id"]}


def _port_eval(model, test_set, video_apply, bucket, batch, path):
    metrics = ALLMetricsTracker(save_file=str(path))
    stats = run_batched_eval(model, test_set, metrics, PITLossWrapper(pairwise_neg_sisdr),
                             video_apply, bucket, batch, SR, progress_every=0)
    metrics.final()
    assert stats["utterances"] == len(test_set) and stats["batch_clock"] == "host"
    return _rows(path)


def _encode(frames):  # fake lip encoder: (B, 1, T_v, 88, 88) -> (B, 16, T_v)
    return frames[:, 0, :, 0, :16].transpose(1, 2)


def _close(got, want, tol):
    assert set(got) == set(want) == {f"utt{i}.wav" for i in range(len(LENGTHS))} | {
        "avg", "std"}
    for key in want:
        for col in COLUMNS:
            a, b = float(got[key][col]), float(want[key][col])
            assert abs(a - b) <= tol[col], (key, col, a, b)


def test_batched_eval_matches_jax(av, test_sets, tmp_path):
    jm, v, model = av
    floats, raws = test_sets
    jax_metrics = JaxTracker(save_file=str(tmp_path / "jax.csv"))
    jax_run_batched_eval(model=jm, variables=v, test_set=floats, metrics=jax_metrics,
                         loss_func=JaxPIT(jax_sisdr, pit_from="pw_mtx"),
                         video_apply=lambda m: jnp.swapaxes(m[:, 0, :, 0, :16], 1, 2),
                         bucket=4000, eval_batch_size=9, sample_rate=SR, progress_every=0)
    jax_metrics.final()
    want = _rows(tmp_path / "jax.csv")
    tol = {"si-snr": 0.01, "si-snr_i": 0.01, "sdr": 0.01, "sdr_i": 0.01, "stoi": 1e-3,
           "pesq": 0.05}
    got = _port_eval(model, floats, _encode, 4000, 9, tmp_path / "float.csv")
    _close(got, want, tol)
    got = _port_eval(model, raws, lambda m: _encode(normalize_mouths(m)), 4000, 9,
                     tmp_path / "uint8.csv")
    _close(got, want, tol)


def test_batched_eval_matches_serial(av, test_sets, tmp_path):
    _, _, model = av
    floats, _ = test_sets
    serial = _port_eval(model, floats, _encode, 2000, 1, tmp_path / "serial.csv")
    batched = _port_eval(model, floats, _encode, 2000, 4, tmp_path / "batched.csv")
    _close(batched, serial, {col: 1e-4 for col in COLUMNS})


# ------------------------------------------------------------- separation
@pytest.fixture(scope="module")
def audio_only(tmp_path_factory):
    """A tiny audio-only model saved by both packages, and a 9100-sample wav."""
    conf = _tiny(video=False)
    _, v, model = _carried(conf)
    d = tmp_path_factory.mktemp("separate")
    jax_serialization.save_model(str(d / "best_model.ckpt"), "AVNet", conf, v)
    serialization.save_model(str(d / "best_model.pth"), "AVNet", conf, model.state_dict())
    wavio.write(str(d / "long.wav"),
                0.1 * np.random.default_rng(2).standard_normal(9100).astype(np.float32), SR)
    return conf, model, d


@pytest.mark.parametrize("chunk", [0, 0.25])
def test_separate_cli_matches_jax(audio_only, chunk):
    _, _, d = audio_only
    sys.path.insert(0, ROOT)
    try:
        import separate as jax_cli
    finally:
        sys.path.remove(ROOT)
    jax_cli.main(argparse.Namespace(
        model=str(d / "best_model.ckpt"), input=str(d / "long.wav"), mouth=None,
        videonet_conf=None, output=str(d / f"jax_{chunk}"), bucket_size=2000, bf16=False,
        chunk_seconds=chunk))
    paths = psep.main(psep.parse_args([
        "--model", str(d / "best_model.pth"), "--input", str(d / "long.wav"),
        "--output", str(d / f"port_{chunk}"), "--bucket-size", "2000",
        "--chunk-seconds", str(chunk), "--device", "cpu"]))
    assert paths == [str(d / f"port_{chunk}" / "long_s1.wav")]
    want, _ = wavio.read(str(d / f"jax_{chunk}" / "long_s1.wav"))
    got, sr = wavio.read(paths[0])
    assert sr == SR and got.shape == want.shape == (9100,)
    np.testing.assert_allclose(got, want, atol=5e-4 * np.abs(want).max())


def test_separate_cli_with_mouth(tmp_path):
    """``--mouth``, plain and chunked, through the FRCNN video model: the
    plain output is ``separate()``'s on the same frames; the chunked one is
    finite and of the input's length."""
    with open(os.path.join(ROOT, "rtfs_net_tpu_torch", "configs",
                           "lrs2_RTFSNet_4_layer.yaml")) as f:
        videonet = {**yaml.safe_load(f)["videonet"], "pretrain": ""}
    conf = {**_tiny(), "pretrained_vout_chan": 512}
    model = build_model(conf, device="cpu")
    serialization.save_model(str(tmp_path / "best_model.pth"), "AVNet", conf,
                             model.state_dict())
    with open(tmp_path / "conf.yaml", "w") as f:
        yaml.safe_dump({"videonet": videonet}, f)
    rng = np.random.default_rng(3)
    L = 7680  # 12 frames at 25 fps
    wav = 0.1 * rng.standard_normal(L).astype(np.float32)
    wavio.write(str(tmp_path / "mix.wav"), wav, SR)
    raw = rng.integers(0, 256, (12, 96, 96), dtype=np.uint8)
    np.savez(tmp_path / "mouth.npz", data=raw)
    outs = {}
    for chunk in (0, 0.16):
        (path,) = psep.main(psep.parse_args([
            "--model", str(tmp_path / "best_model.pth"), "--input", str(tmp_path / "mix.wav"),
            "--mouth", str(tmp_path / "mouth.npz"), "--videonet-conf",
            str(tmp_path / "conf.yaml"), "--output", str(tmp_path / f"out_{chunk}"),
            "--chunk-seconds", str(chunk), "--device", "cpu"]))
        outs[chunk], _ = wavio.read(path)
    video = build_video_model(videonet, device="cpu")
    frames = get_preprocessing_pipelines()["val"](raw)[None, None]  # crop 88, normalize
    wav, _ = wavio.read(str(tmp_path / "mix.wav"))  # as the CLI reads it: 16-bit
    want = separate(model, np.pad(wav, (0, 8000 - L))[None], frames, video_model=video,
                    device="cpu")[0, 0, :L]
    np.testing.assert_allclose(outs[0], want, atol=1.5 / 32768)
    assert outs[0.16].shape == (L,) and np.isfinite(outs[0.16]).all()
    assert np.abs(outs[0.16]).max() > 0


def test_chunk_embedding_takes_each_chunks_frames():
    emb = torch.arange(10.0).view(1, 1, 10)  # frame t holds t
    # 4-frame chunks (0.16 s), hop 2 frames: chunk j covers frames 2j-2 .. 2j+1
    got = psep._chunk_embedding(emb, 6, 2560, SR)
    assert got.shape == (6, 1, 4)
    want = [[t if 0 <= t < 10 else 0.0 for t in range(2 * j - 2, 2 * j + 2)] for j in range(6)]
    np.testing.assert_array_equal(got[:, 0].numpy(), np.array(want))
    with pytest.raises(SystemExit, match="even number"):
        psep._chunk_embedding(emb, 6, 1920, SR)


@pytest.fixture(scope="module")
def artifact(audio_only):
    """The audio-only model's float32 serving artifact: B = 4, a 0.25 s
    segment (4000 samples), traced on the CPU."""
    conf, model, d = audio_only
    program = export_serving(model, 4, 4000, compute_dtype=torch.float32, device="cpu")
    path = str(d / "model.rtfsx")
    save_serving(path, program, 4, 4000, compute_dtype="float32")
    return path


def _separate(model, wav, out, *extra):
    return psep.main(psep.parse_args(["--model", str(model), "--input", str(wav), "--output",
                                      str(out), "--device", "cpu", *extra]))


def test_separate_cli_serves_an_artifact(audio_only, artifact):
    """``--model model.rtfsx``: a 3000-sample wav padded to the segment, and
    the 9100-sample one in chunks of the segment (5 chunks: a call of the B=4
    program and a padded one), each as the eager CLI separates it from the
    same weights with the same padding and chunks (16-bit wavs: 1.5 steps)."""
    _, _, d = audio_only
    wav, _ = wavio.read(str(d / "long.wav"))
    wavio.write(str(d / "short.wav"), wav[:3000], SR)
    for name, extra in (("short", ["--bucket-size", "4000"]), ("long", ["--chunk-seconds", "0.25"])):
        (got,) = _separate(artifact, d / f"{name}.wav", d / f"art_{name}", *extra)
        (want,) = _separate(d / "best_model.pth", d / f"{name}.wav", d / f"eager_{name}", *extra)
        got, sr = wavio.read(got)
        want, _ = wavio.read(want)
        assert sr == SR and got.shape == want.shape == ({"short": 3000, "long": 9100}[name],)
        assert np.abs(got).max() > 0
        np.testing.assert_allclose(got, want, atol=1.5 / 32768)


def test_separate_cli_refuses_an_artifact(audio_only, artifact):
    """An input longer than the artifact's segment needs ``--chunk-seconds``."""
    _, _, d = audio_only
    with pytest.raises(SystemExit, match="exceeds the artifact's exported segment"):
        _separate(artifact, d / "long.wav", d / "refused")


def test_separate_cli_refuses_an_artifact_convention_mismatch(audio_only, artifact, tmp_path):
    """A mouth track for an artifact exported without the mouth input."""
    _, _, d = audio_only
    with open(os.path.join(ROOT, "rtfs_net_tpu_torch", "configs",
                           "lrs2_RTFSNet_4_layer.yaml")) as f:
        videonet = {**yaml.safe_load(f)["videonet"], "pretrain": ""}
    with open(tmp_path / "conf.yaml", "w") as f:
        yaml.safe_dump({"videonet": videonet}, f)
    np.savez(tmp_path / "mouth.npz", data=np.zeros((6, 96, 96), np.uint8))
    wav, _ = wavio.read(str(d / "long.wav"))
    wavio.write(str(tmp_path / "short.wav"), wav[:3000], SR)
    with pytest.raises(SystemExit, match="calling convention .* but mouth input was given"):
        _separate(artifact, tmp_path / "short.wav", tmp_path, "--mouth",
                  str(tmp_path / "mouth.npz"), "--videonet-conf", str(tmp_path / "conf.yaml"))


def test_separate_cli_refuses_an_artifact_chunk_mismatch(audio_only, artifact):
    """``--chunk-seconds`` other than the artifact's segment."""
    _, _, d = audio_only
    with pytest.raises(SystemExit, match="must match the artifact's exported segment: 0.25 s"):
        _separate(artifact, d / "long.wav", d / "refused", "--chunk-seconds", "0.5")


# ---------------------------------------------- checkpoints and test.py
def _get_config_args(conf):
    """A reference blob's ``model_args``: the reflective ``get_config()``
    sections, not constructor arguments (reference tdavnet.py:100-108)."""
    return {"encoder": dict(conf["enc_dec_params"]), "audio_bottleneck": conf["audio_bn_params"],
            "refinement_module": {"audio_params": conf["audio_params"]},
            "mask_generator": conf["mask_generation_params"], "n_src": conf["n_src"]}


def _equal_models(got, want):
    assert list(got.state_dict()) == list(want.state_dict())
    for (k, a), b in zip(got.state_dict().items(), want.state_dict().values()):
        assert torch.equal(a, b), k


def test_load_model_reference_files(audio_only, tmp_path):
    conf, model, _ = audio_only
    sd = model.state_dict()
    direct = build_model(conf, device="cpu", generator=torch.Generator().manual_seed(9))
    direct.load_state_dict(sd)
    lightning = {"state_dict": {**{f"audio_model.{k}": t for k, t in sd.items()},
                                "video_model.frontend.weight": torch.zeros(3)},
                 "hyper_parameters": argparse.Namespace(lr=1e-3), "epoch": 3}
    torch.save(lightning, tmp_path / "epoch=3.ckpt")
    reference = {"model_name": "AVNet", "state_dict": sd, "model_args": _get_config_args(conf),
                 "infos": {"software_versions": {"torch_version": "1.13"}}}
    torch.save(reference, tmp_path / "reference.pth")
    for name in ("epoch=3.ckpt", "reference.pth"):
        loaded, package = serialization.load_model(str(tmp_path / name), device="cpu",
                                                   conf={"audionet": conf})
        _equal_models(loaded, direct)
        assert package["model_args"] == conf and not loaded.training
        with pytest.raises(ValueError, match="constructor arguments"):
            serialization.load_model(str(tmp_path / name), device="cpu")


def _write_test_manifest(root, n_mix, rng):
    d = root / "tt"
    d.mkdir()
    rows = {"mix": [], "s1": [], "s2": []}
    for i, L in enumerate(rng.integers(1200, 3600, n_mix)):
        for name in rows:
            path = str(d / f"{name}_{i}.wav")
            wavio.write(path, 0.1 * rng.standard_normal(L).astype(np.float32), SR)
            rows[name].append([path, int(L)] if name == "mix" else [path, "", int(L)])
    for name, data in rows.items():
        with open(d / f"{name}.json", "w") as f:
            json.dump(data, f)
    return str(d)


def test_import_checkpoint_then_test_cli(audio_only, tmp_path):
    conf, model, _ = audio_only
    torch.save({"model_name": "AVNet", "state_dict": model.state_dict(),
                "model_args": _get_config_args(conf), "infos": {}}, tmp_path / "ref.pth")
    full = {"videonet": {"model_name": None}, "audionet": conf,
            "training": {"batch_size": 2, "epochs": 1},
            "data": {"nondefault_nsrc": 1, "sample_rate": SR, "normalize_audio": False},
            "log": {"path": str(tmp_path), "exp_name": "imported"}}
    exp = tmp_path / "imported"
    path = import_checkpoint.main(["--pth", str(tmp_path / "ref.pth"), "--conf",
                                   _dump(tmp_path / "full.yaml", full), "--exp-dir", str(exp)])
    imported, package = serialization.load_model(path, device="cpu")
    _equal_models(imported, model)
    assert package["model_args"] == conf

    test_dir = _write_test_manifest(tmp_path, 3, np.random.default_rng(4))
    out = ptest.main(ptest.parse_conf(["--conf-dir", str(exp / "conf.yaml"), "--test-dir",
                                       test_dir, "--device", "cpu", "--n-save-ex", "2",
                                       "--bucket-size", "2000"]))
    assert out["eval"]["utterances"] == 6 and out["eval"]["batches"] >= 2
    rows = list(csv.DictReader(open(os.path.join(out["save_dir"], "metrics.csv"))))
    assert len(rows) == 8 and [r["snt_id"] for r in rows[-2:]] == ["avg", "std"]
    assert all(np.isfinite(float(r[c])) for r in rows for c in ("si-snr", "sdr", "stoi"))
    assert len(os.listdir(os.path.join(out["save_dir"], "examples"))) == 6

    # the JAX CLI's rows (root test.py:120-150): no video model, so no
    # Videomodel MACs; the metrics in its order; the audionet conf flattened
    with open(exp / "conf.yaml") as f:
        audionet = yaml.safe_load(f)["audionet"]
    want = ["Model", "Params (M)", "MACs (G, 2s)",
            "si-snr_i", "sdr_i", "pesq", "stoi", "si-snr", "sdr"]
    for k, v in audionet.items():
        want += [f"{k}_{kk}" for kk in v] if isinstance(v, dict) else [k]
    with open(os.path.join(out["save_dir"], "results.csv")) as f:
        got = list(csv.reader(f))
    assert got[0] == ["Key", "Value"] and [r[0] for r in got[1:]] == want
    assert got[1][1] == "imported" and float(got[2][1]) == sum(
        p.numel() for p in model.parameters()) / 1e6
    assert float(got[3][1]) > 0


def _dump(path, conf):
    with open(path, "w") as f:
        yaml.safe_dump(conf, f)
    return str(path)


def test_local_test_on_cpu(tmp_path, capsys):
    conf = {"audionet": _tiny(video=False), "videonet": {"model_name": None},
            "optim": {"optimizer": "adamw", "lr": 1e-3, "weight_decay": 0.1},
            "sche": {"patience": 10, "factor": 0.5}}
    path = _dump(tmp_path / "conf.yaml", conf)
    assert local_test.main(local_test.parse_args(["--conf-dir", path, "--check-only",
                                                  "--device", "cpu"])) is None
    assert "MACs (example input)" in capsys.readouterr().out
    trainer = local_test.main(local_test.parse_args([
        "--conf-dir", path, "--device", "cpu", "--items", "4",
        "--exp-dir", str(tmp_path / "exp")]))
    assert [h["epoch"] for h in trainer.history] == [0]
    assert os.path.isfile(tmp_path / "exp" / "best_model.pth")
    assert "reloaded best model forward: (1, 1, 32000)" in capsys.readouterr().out
