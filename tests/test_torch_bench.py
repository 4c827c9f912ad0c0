"""The port's benchmark (``rtfs_net_tpu_torch/bench.py``) on the CPU, at the
tiny AV config of ``tests/test_torch_avnet.py`` (its ``run`` takes the
device and the sizes): its result has exactly the keys of the JAX
package's ``bench.py`` line, every value finite, and ``vs_baseline`` is
57.8 ms over ``inference_ms_per_utt``; its launch counts name every
kernel (none launches on the CPU). The CLI runs on a card only: without
one it exits non-zero and prints no result."""
import ast
import copy
import json
import math
import os
import subprocess
import sys

import pytest

from rtfs_net_tpu_torch import bench
from rtfs_net_tpu_torch.ops.kernels import KERNELS

from _torch_port import one_torch_thread  # noqa: F401
from test_torch_avnet import TINY

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _jax_bench_keys():
    """The keys of the dict literal ``bench.py`` prints."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    (keys,) = [[k.value for k in node.keys] for node in ast.walk(tree)
               if isinstance(node, ast.Dict) and any(
                   isinstance(k, ast.Constant) and k.value == "vs_baseline" for k in node.keys)]
    return keys


@pytest.fixture(scope="module")
def result():
    conf = {"audionet": copy.deepcopy(TINY),
            "optim": {"optimizer": "adamw", "lr": 1e-3, "weight_decay": 0.1}}
    return bench.run(conf, device="cpu", batch=4, samples=2000, iters=2)


def test_result_has_the_jax_bench_keys_all_finite(result):
    line, _ = result
    assert list(line) == list(bench.KEYS) == _jax_bench_keys()
    assert line["metric"] == "rtfsnet4_bf16_2s_utterances_per_sec_per_chip"
    assert line["unit"] == "utt/s"
    assert all(math.isfinite(v) for k, v in line.items() if k not in ("metric", "unit"))
    assert all(v > 0 for k, v in line.items() if k not in ("metric", "unit"))
    json.loads(json.dumps(line))


def test_vs_baseline_is_the_reference_latency_over_ours(result):
    """Each rate against the time it comes from; both are rounded as
    ``bench.py`` rounds them (0.01 utt/s, 0.001 ms/utt, 0.1 ms/step), so
    they agree within a rounding step of the rate and the change a rounded
    time makes in it."""
    line, _ = result
    ms_utt, b4, b16 = (line[k] for k in ("inference_ms_per_utt", "train_ms_per_step_b4",
                                          "train_ms_per_step_b16"))
    assert line["vs_baseline"] == pytest.approx(bench.BASELINE_MS_PER_UTT / ms_utt,
                                                abs=0.005 + 57.8 * 5e-4 / ms_utt ** 2)
    assert line["value"] == pytest.approx(1e3 / ms_utt, abs=0.005 + 1e3 * 5e-4 / ms_utt ** 2)
    assert line["train_utt_per_s_per_chip"] == pytest.approx(4e3 / b4,
                                                             abs=0.005 + 4e3 * 0.05 / b4 ** 2)
    assert line["train_utt_per_s_per_chip_b16"] == pytest.approx(
        16e3 / b16, abs=0.005 + 16e3 * 0.05 / b16 ** 2)


def test_launch_counts_cover_every_phase_and_kernel(result):
    _, launches = result
    assert list(launches) == ["serving", "train_b4", "train_b16"]
    for counts in launches.values():
        assert counts == {k.label: 0 for k in KERNELS}


def test_cli_refuses_to_run_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "rtfs_net_tpu_torch.bench"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == "" and "no CUDA device" in proc.stderr
