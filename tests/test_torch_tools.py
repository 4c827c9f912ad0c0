"""The port's tools (``rtfs_net_tpu_torch/scripts/``) against the JAX
side's scripts, on the CPU at tiny sizes:

* ``bench_zoo``: ``ZOO`` with the paper's numbers is the JAX script's (by
  AST); each config, its widths cut to a tiny copy that keeps its
  repeats and its separator, serves once at B = 1 and 2 and trains a step;
* ``bench_sweep``: the default batches are the JAX script's; ``--unrolls``
  is refused;
* ``profile_serving``: the stage split composed stage by stage gives the
  full forward within 1e-6·max|ref|, and every stage runs at the shapes
  the forward gave it;
* ``bench_loader``: its synthetic set is the JAX script's ``make_dataset``
  (manifests, wav bytes, mouth arrays) from the same seed, and the bench
  runs an epoch per variant;
* every CLI exits non-zero without a card when no device is given.
"""
import ast
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtfs_net_tpu_torch.models import build_model
from rtfs_net_tpu_torch.scripts import (av_train_proof, bench_loader, bench_sweep, bench_zoo,
                                        load_config, profile_serving, train_proof)

from _torch_port import one_torch_thread  # noqa: F401
from test_torch_avnet import TINY
from test_torch_ctcnet import TINY as TINY_CTC

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
OPTIM = {"optimizer": "adamw", "lr": 1e-3, "weight_decay": 0.1}


def _jax_script(name):
    with open(os.path.join(ROOT, "scripts", name)) as f:
        return ast.parse(f.read())


def test_zoo_is_the_jax_scripts():
    (node,) = [n for n in _jax_script("bench_zoo.py").body if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "ZOO"]
    assert bench_zoo.ZOO == ast.literal_eval(node.value)
    assert bench_zoo.PAPER_MS["lrs2_RTFSNet_12_layer"] == 109.9


def _tiny(name):
    """The config cut to a tiny width: its repeats and its separator kept."""
    conf = load_config(name)
    repeats = conf["audionet"]["audio_params"]["repeats"]
    audionet = copy.deepcopy(TINY_CTC if "CTCNet" in name else TINY)
    audionet["audio_params"]["repeats"] = repeats
    return {"audionet": audionet, "optim": conf["optim"]}


@pytest.mark.parametrize("name", [name for name, _ in bench_zoo.ZOO])
def test_each_zoo_config_serves_and_trains_on_the_cpu(name):
    row = bench_zoo.bench_config(name, CPU, conf=_tiny(name), latency=True, batch=2,
                                 samples=1000, train_batches=(2,), iters=1)
    assert row["config"] == name and row["paper_ms_per_utt"] == bench_zoo.PAPER_MS[name]
    for key in ("serve_ms", "ms_per_utt", "utt_per_s", "latency_ms", "train_b2_ms",
                "train_b2_utt_per_s"):
        assert np.isfinite(row[key]) and row[key] > 0, key
    assert row["calls"] == {"serving": 3, "latency": 3, "train_b2": 2}
    assert all(n == 0 for counts in row["launches"].values() for n in counts.values())
    assert row["peak_mem_GiB"] == {"serving": None, "latency": None, "train_b2": None}
    text = bench_zoo.row_text(row)
    assert text.startswith(name) and "paper's GPU" in text and "train B=2" in text


def test_sweep_defaults_are_the_jax_scripts_and_unrolls_are_refused(capsys):
    (call,) = [n for n in ast.walk(_jax_script("bench_sweep.py"))
               if isinstance(n, ast.Call) and n.args
               and getattr(n.args[0], "value", None) == "--batches"]
    (default,) = [k.value for k in call.keywords if k.arg == "default"]
    assert bench_sweep.BATCHES == ast.literal_eval(default)
    with pytest.raises(SystemExit) as exc:
        bench_sweep.main(["--unrolls", "4", "8"])
    assert exc.value.code == 2 and "TPU lowering" in capsys.readouterr().err


def test_sweep_runs_on_the_cpu():
    conf = {"audionet": copy.deepcopy(TINY)}
    rows, best = bench_sweep.sweep(CPU, [1, 2], conf=conf, samples=2000, iters=1, log=None)
    assert [r["B"] for r in rows] == [1, 2] and best in rows
    assert all(np.isfinite(r["utt_per_s"]) and r["calls"] == 3 for r in rows)


@pytest.fixture(scope="module")
def tiny_model():
    return build_model(TINY, device="cpu", generator=torch.Generator().manual_seed(3))


def test_stage_split_composes_the_forward(tiny_model):
    gen = torch.Generator().manual_seed(0)
    mix = torch.randn(2, 2000, generator=gen)
    emb = torch.randn(2, TINY["pretrained_vout_chan"], 10, generator=gen)
    with torch.no_grad():
        want = tiny_model(mix, emb)
        got = profile_serving.compose(tiny_model, mix, emb)
    assert got.shape == want.shape == (2, 1, 2000)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_stage_shapes_are_the_forwards(tiny_model):
    shapes = profile_serving.stage_shapes(tiny_model, CPU, TINY["pretrained_vout_chan"],
                                          samples=2000, frames=10)
    assert set(shapes) == set(profile_serving.STAGES)
    assert shapes["full"] == [(1, 2000), (1, 16, 10)]
    assert shapes["encoder"] == [(1, 2000)]
    assert shapes["refine"] == [shapes["audio_bn"][0], shapes["video_bn"][0]]
    assert shapes["audio_blk"] == [shapes["audio_bn"][0]]
    assert shapes["maskgen"] == [shapes["audio_bn"][0], shapes["audio_bn"][0]]
    assert shapes["decoder"] == [(1, 1, *shapes["audio_bn"][0][1:])]


def test_profile_runs_every_stage_on_the_cpu():
    ms, shapes, repeats = profile_serving.profile(
        CPU, conf={"audionet": copy.deepcopy(TINY)}, batch=2, samples=2000, frames=10,
        iters=1, log=None)
    assert list(ms) == list(profile_serving.STAGES) and repeats == 2
    assert all(s[0] == 2 for ss in shapes.values() for s in ss)
    s = profile_serving.summary(ms, repeats)
    assert s["stage_sum_ms"] == pytest.approx(sum(ms[k] for k in profile_serving.COMPOSING))
    assert s["residual_ms"] == pytest.approx(ms["full"] - s["stage_sum_ms"])


def _jax_make_dataset():
    (fn,) = [n for n in _jax_script("bench_loader.py").body
             if isinstance(n, ast.FunctionDef) and n.name == "make_dataset"]
    from rtfs_net_tpu.datas import wavio

    scope = {"np": np, "os": os, "json": json, "wavio": wavio}
    exec(compile(ast.Module([fn], []), "scripts/bench_loader.py", "exec"), scope)
    return scope["make_dataset"]


def test_loader_set_is_the_jax_scripts(tmp_path):
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
    _jax_make_dataset()(str(tmp_path / "jax"), 3, seconds=0.5)
    bench_loader.make_dataset(str(tmp_path / "port"), 3, seconds=0.5)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3 * 5 + 3
    for name in names:
        want, got = tmp_path / "jax" / name, tmp_path / "port" / name
        if name.endswith(".npz"):
            np.testing.assert_array_equal(np.load(got)["data"], np.load(want)["data"])
        elif name.endswith(".json"):
            assert json.loads(got.read_text().replace(str(tmp_path / "port"), "R")) == \
                json.loads(want.read_text().replace(str(tmp_path / "jax"), "R"))
        else:
            assert got.read_bytes() == want.read_bytes()


def test_loader_bench_runs_each_variant(tmp_path):
    bench_loader.make_dataset(str(tmp_path), 2)
    results = bench_loader.bench(str(tmp_path), CPU, [1], batch_size=2, log=lambda *a, **k: 0)
    assert set(results) == {f"{v}_{w}" for v, _ in bench_loader.VARIANTS
                            for w in ("inproc", "w1")}
    assert all(np.isfinite(r) and r > 0 for r in results.values())


TOOLS = [train_proof, av_train_proof, bench_zoo, bench_sweep, profile_serving, bench_loader]


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_cli_exits_non_zero_without_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_cli_process_exits_non_zero_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "rtfs_net_tpu_torch.scripts.train_proof"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout.strip() == "" and "no CUDA device" in proc.stderr
