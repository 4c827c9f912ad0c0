"""The command refuses to run without a card, and with a card outside a
checkout that holds the program."""
import os
import shutil
import subprocess
import sys

import pytest

from h100_bench import spec


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "h100_bench", "--workload", "rtfs4-serve-b128",
                           "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env={**os.environ, **(env or {})}, capture_output=True,
                          text=True, timeout=600)


def test_no_card_no_result():
    proc = _run(spec.ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA device" in proc.stderr


@pytest.mark.card
def test_benchmark_files_alone_give_no_result(card, tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "cache"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
