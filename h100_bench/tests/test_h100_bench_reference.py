"""The frozen reference against the port's plain path at tiny widths on the
CPU: the same state dict loads into both, and both compute the same."""
import time

import numpy as np
import pytest
import torch
import yaml

from h100_bench import check, program, run, spec

from _tiny import tiny_conf, tiny_train_cell

CONFIGS = spec.load_benchmark()["configs"]


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: c["name"])
def test_reference_separates_as_the_port(config):
    """Each configuration's reference module, at the tiny widths its
    reference file names."""
    torch.manual_seed(0)
    conf = tiny_conf(config["name"])
    model, video = check.reference_models(spec.reference_files(config["name"])["reference"],
                                          conf, 5, "cpu")
    pm, pv = program.build(conf, "cpu", model.state_dict(), video.state_dict())
    rng = np.random.default_rng(0)
    requests = [(rng.standard_normal((2, 4000)).astype(np.float32) * 0.1,
                 rng.standard_normal((2, 1, 6, 24, 24)).astype(np.float32)) for _ in range(2)]
    want = check.reference_separate(model, video, requests, 3, "cpu")
    for (mix, frames), w in zip(requests, want):
        got = program.separate(pm, pv, mix, frames, "cpu", torch.float32)
        assert got.shape == (2, 1, 4000)
        np.testing.assert_allclose(got[:, 0], w, atol=2e-5 * np.abs(w).max())


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: c["name"])
def test_state_dicts_match_at_published_widths(config):
    conf = yaml.safe_load((spec.ROOT / config["file"]).read_text())
    reference = spec.reference(spec.reference_files(config["name"])["reference"])
    with torch.device("meta"):
        model, video = reference.build(conf)
    from rtfs_net_tpu_torch.models import build_model, build_video_model

    for ours, theirs in ((model, build_model(conf, device="cpu")),
                         (video, build_video_model(conf, device="cpu"))):
        a = {k: tuple(v.shape) for k, v in ours.state_dict().items()}
        b = {k: tuple(v.shape) for k, v in theirs.state_dict().items()}
        assert a == b


def test_train_step_matches_in_float32():
    """The training check on a sound float32 program: the loss, the first
    gradient and the change agree to round-off (dropout masks included)."""
    cell = tiny_train_cell()
    out = run.run_cell(cell, 2 ** 31 + 11, 0.1, False, "cpu", time.time())
    n = out["numbers"]
    assert n["loss_gap_db"] < 1e-4 and n["grad_gap"] < 1e-2 and n["grad_gap_median"] < 1e-4
    assert n["change_gap_median"] < 1e-2 and out["correct"]
