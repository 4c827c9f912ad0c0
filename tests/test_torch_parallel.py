"""The port's data parallelism (``rtfs_net_tpu_torch/parallel/``, the
trainer, the sharded evaluation, the multi-device artifact, the dry run)
on the CPU: two gloo ranks spawned by ``parallel.launch``, which meet
through a file in a temporary directory (no port, so parallel test workers
cannot clash), run every case of ``_torch_parallel_ranks.py`` in one
process group; each case is held here against one process and against JAX.

* ``mesh_size`` (the clamp) against JAX's ``make_mesh(n, batch_size=b)``
  over its 8 CPU devices (``tests/conftest.py``).
* One step of the tiny AV config (``test_torch_avnet.TINY``: a BatchNorm1d
  video TDANet, dropout 0.1) over 2 ranks, SGD: loss, parameters and
  BatchNorm buffers within 1e-6 of one process's step on the concatenated
  batch (the dropout masks drawn for the global batch); a second step
  runs (DDP without ``find_unused_parameters`` raises in it if the first
  left a parameter without gradient). AdamW is held
  exactly only where the summation order is the same (one rank: a batch of
  3 clamps the mesh to rank 0, and rank 1 sits the step out): its first
  update is lr·g/(|g| + eps), which turns the ~1e-6·max|g| differences of
  a gradient summed in two halves into differences of order lr where |g|
  is near zero.
* The same step against JAX's on the global batch
  (``test_torch_train.jax_step``): loss within 1e-5 relative, grad norm
  1e-4, clipped gradients 5e-4·max|g|, BatchNorm statistics 1e-5, the
  tolerances of ``tests/test_torch_train.py``.
* ``online_mix`` over 2 ranks: the remix of the global batch, the step
  within 1e-6 of one process's.
* A checkpoint written under DDP has the plain module names, loads on one
  device and round-trips through JAX's ``convert_avnet``; a one-device
  checkpoint loads under DDP.
* ``Trainer.fit`` over 2 ranks on sharded loaders, SIGTERM to rank 1
  mid-epoch: both ranks stop at the same step boundary, with equal
  parameters and histories; rank 0 writes the 'preempt' checkpoint.
* The sharded ``run_batched_eval``: per-utterance rows equal to a one-rank
  run's (1e-4 dB), partial batches padded and cropped.
* The 2-device artifact against the 1-device one (the counterparts of
  ``tests/test_export.py::test_mesh_sharded_artifact`` and
  ``::test_mesh_export_requires_divisible_batch``), and its refusal of
  fewer devices.
* ``dryrun_multichip(2)``: full RTFS-Net-4 with the ResNet-18 video model,
  one step and the sharded evaluation.
* Without a process group everything is one process; ``launch`` raises
  when a rank fails, and stops the others.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from rtfs_net_tpu.models import AVNet as JaxAVNet
from rtfs_net_tpu.parallel import make_mesh as jax_make_mesh
from rtfs_net_tpu.utils.avnet_convert import convert_avnet
from rtfs_net_tpu_torch import export as E
from rtfs_net_tpu_torch import losses
from rtfs_net_tpu_torch.evaluation import run_batched_eval
from rtfs_net_tpu_torch.models import build_model
from rtfs_net_tpu_torch.parallel import (Mesh, initialize, launch, local_device, make_mesh,
                                         mesh_size, process_info, wait_for_devices)
from rtfs_net_tpu_torch.utils.convert import grads_from_jax, state_dict_from_jax

from _torch_parallel_ranks import RowTracker, all_cases, fail_on_rank, step_result, system_of
from _torch_port import one_torch_thread  # noqa: F401
from test_torch_avnet import TINY
from test_torch_export import AUDIO_ONLY
from test_torch_train import _perturbed_model, batch, jax_step  # noqa: F401

RANKS = 2


def _state(conf, seed):
    model = build_model(conf, device="cpu", generator=torch.Generator().manual_seed(seed))
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _global_batch(B, L, TV, seed, mouths=True):
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((B, L)).astype(np.float32)
    tgt = (0.5 * mix[:, None] + 0.3 * rng.standard_normal((B, 1, L))).astype(np.float32)
    mouth = rng.standard_normal((B, 16, TV)).astype(np.float32) if mouths else None
    return mix, tgt, mouth


def _test_set():
    """Five utterances of 1000 samples and two of 1500: with buckets of 500
    and batches of 4, a full batch, a partial one of 1 (padded to 2 rows
    over 2 ranks) and one of 2."""
    rng = np.random.default_rng(5)
    return [(rng.standard_normal(n).astype(np.float32),
             rng.standard_normal((1, n)).astype(np.float32), f"utt{i}")
            for i, n in enumerate([1000] * 5 + [1500] * 2)]


@pytest.fixture(scope="module")
def cases(tmp_path_factory, jax_step, batch):  # noqa: F811
    tmp = tmp_path_factory.mktemp("parallel")
    tiny_state = _state(TINY, 1)
    plain = system_of(TINY, _state(TINY, 2))
    torch.save(plain.state_dict(), tmp / "plain.pt")
    audio_state = _state(AUDIO_ONLY, 3)
    return {
        "sgd": ("train_step", {"conf": TINY, "state": tiny_state, "optimizer": "sgd",
                               "batch": _global_batch(4, 2000, 10, 0), "seed": 0,
                               "checkpoint": str(tmp / "ddp.pt"),
                               "plain_checkpoint": str(tmp / "plain.pt")}),
        "clamped_adamw": ("train_step", {"conf": TINY, "state": tiny_state,
                                         "batch": _global_batch(3, 2000, 10, 1), "seed": 1}),
        "jax": ("train_step", {"conf": jax_step["conf"],
                               "state": {k: v.numpy() for k, v in _perturbed_model(
                                   jax_step["conf"], 1).state_dict().items()},
                               "batch": batch, "seed": 0}),
        "online_mix": ("train_step", {"conf": AUDIO_ONLY, "state": audio_state,
                                      "optimizer": "sgd", "system": {"online_mix": True},
                                      "batch": _global_batch(4, 2000, 10, 2, mouths=False),
                                      "seed": 3}),
        "fit": ("fit", {"conf": AUDIO_ONLY, "state": audio_state, "length": 1000,
                        "exp_dir": str(tmp / "exp"), "signalled": 1}),
        "eval": ("evaluate", {"conf": AUDIO_ONLY, "state": audio_state,
                              "test_set": _test_set(), "bucket": 500,
                              "eval_batch_size": 4}),
        "dryrun": ("dryrun", RANKS),
    }


@pytest.fixture(scope="module")
def ranks(cases):
    """Every case on each of 2 gloo ranks: a list of {case: result} by rank."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setenv("RTFS_PESQ_BACKEND", "none")
        return launch(all_cases, RANKS, (cases,), device="cpu", timeout_s=600)


def _one_process(case):
    """The case's step by one process on the whole batch."""
    system = system_of(case["conf"], case["state"], case.get("optimizer", "adamw"),
                       **case.get("system", {}))
    out = system.train_step(tuple(None if a is None else torch.from_numpy(a)
                                  for a in case["batch"]),
                            torch.Generator().manual_seed(case["seed"]))
    return step_result(system, out)


def _assert_step_close(got, want, atol):
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)
    for what in ("params", "buffers"):
        assert set(got[what]) == set(want[what])
        for k, v in want[what].items():
            np.testing.assert_allclose(got[what][k], v, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("n,b", [(None, None), (None, 4), (None, 2), (None, 6), (None, 3),
                                 (3, 8), (5, 10), (2, 7), (8, 16)])
def test_mesh_size_matches_jax(n, b):
    assert mesh_size(n, 8, b) == jax_make_mesh(n, batch_size=b).devices.size
    assert len(jax.devices()) == 8


def test_ddp_step_equals_one_process_on_the_global_batch(cases, ranks):
    case = cases["sgd"][1]
    want = _one_process(case)
    for r, result in enumerate(r["sgd"] for r in ranks):
        assert result["mesh"] == (RANKS, r) and result["replica"] == "DistributedDataParallel"
        assert result["sync_bn"] == ["SyncBatchNorm"]
        _assert_step_close(result, want, 1e-6)
        assert np.isfinite(result["second_loss"])
    for k, v in ranks[0]["sgd"]["params"].items():
        np.testing.assert_array_equal(ranks[1]["sgd"]["params"][k], v, err_msg=k)


def test_ranks_outside_the_clamp_sit_out(cases, ranks):
    """A batch of 3 on 2 ranks clamps the mesh to rank 0: its AdamW step is
    the one-process step, bit for bit; rank 1 gets None."""
    got = ranks[0]["clamped_adamw"]
    assert got["mesh"] == (1, 0) and ranks[1]["clamped_adamw"] is None
    want = _one_process(cases["clamped_adamw"][1])
    _assert_step_close(got, want, 0.0)


def test_ddp_step_matches_jax_on_the_global_batch(jax_step, ranks):  # noqa: F811
    conf = jax_step["conf"]
    clip = min(1.0, 5.0 / (jax_step["gnorm"] + 1e-6))
    want = {k: t.numpy() * clip for k, t in grads_from_jax(
        jax_step["grads"], conf, jax_step["v"]["batch_stats"]).items()}
    scale = max(float(np.abs(g).max()) for g in want.values())
    stats = state_dict_from_jax({"params": jax_step["v"]["params"],
                                 "batch_stats": jax_step["stats"]}, conf)
    for r, result in enumerate(r["jax"] for r in ranks):
        assert result["mesh"] == (RANKS, r)
        assert abs(result["loss"] - jax_step["loss"]) <= 1e-5 * abs(jax_step["loss"])
        assert abs(result["grad_norm"] - jax_step["gnorm"]) <= 1e-4 * jax_step["gnorm"]
        assert set(result["grads"]) == set(want)
        for k, g in want.items():
            np.testing.assert_allclose(result["grads"][k], g, rtol=0, atol=5e-4 * scale,
                                       err_msg=k)
        keys = [k for k in stats if k.endswith(("running_mean", "running_var"))]
        assert keys
        for k in keys:
            np.testing.assert_allclose(result["buffers"][k], stats[k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_online_mix_remixes_the_global_batch(cases, ranks):
    want = _one_process(cases["online_mix"][1])
    for result in (r["online_mix"] for r in ranks):
        _assert_step_close(result, want, 1e-6)


def test_checkpoint_under_ddp_loads_on_one_device_and_back(cases, ranks, tmp_path):
    case = cases["sgd"][1]
    state = torch.load(case["checkpoint"], weights_only=True)
    assert state["step"] == 1
    model = build_model(TINY, device="cpu")
    model.load_state_dict(state["model"])  # strict: the plain names, nothing more
    for k, v in ranks[0]["sgd"]["params"].items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v, err_msg=k)
    sd = {k: v.numpy() for k, v in state["model"].items()}
    mix, _, mouth = case["batch"]
    template = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(JaxAVNet(**TINY).init, jax.random.PRNGKey(0), mix, mouth))
    back = state_dict_from_jax(convert_avnet(sd, template, TINY), TINY)
    assert set(back) == set(sd)
    for k, v in back.items():
        if not k.endswith("num_batches_tracked"):  # JAX keeps no step count
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    # the other way round: a one-device checkpoint loaded into the DDP system
    plain = torch.load(case["plain_checkpoint"], weights_only=True)["model"]
    for reloaded in (r["sgd"]["reloaded"] for r in ranks):
        assert set(reloaded) == set(plain)
        for k, v in plain.items():
            np.testing.assert_array_equal(reloaded[k], v.numpy(), err_msg=k)


def test_fit_stops_every_rank_at_the_same_step(cases, ranks):
    """SIGTERM reaches rank 1 while it hands out batch 1 of epoch 1 (4
    steps an epoch); the ranks agree on it one step later, so both stop
    after step 3 of that epoch with the same state."""
    exp_dir = cases["fit"][1]["exp_dir"]
    zero, one = ranks[0]["fit"], ranks[1]["fit"]
    assert zero["step"] == one["step"] == 4 + 3
    assert zero["history"] == one["history"] and len(zero["history"]) == 1
    for k, v in zero["params"].items():
        np.testing.assert_array_equal(one["params"][k], v, err_msg=k)
    with open(os.path.join(exp_dir, "checkpoints", "last.json")) as f:
        last = json.load(f)
    assert last["name"] == "preempt" and last["epoch"] == 0
    saved = torch.load(os.path.join(exp_dir, "checkpoints", "preempt.pt"), weights_only=True)
    assert saved["step"] == 7


def test_sharded_eval_rows_equal_a_one_rank_run(cases, ranks):
    case = cases["eval"][1]
    assert [r["eval"]["ranks"] for r in ranks] == [RANKS, RANKS]
    assert [r["eval"]["utterances"] for r in ranks] == [7, 0] and ranks[1]["eval"]["rows"] is None
    model = build_model(case["conf"], device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"].items()})
    tracker = RowTracker()
    stats = run_batched_eval(model=model, test_set=case["test_set"], metrics=tracker,
                             loss_func=losses.PITLossWrapper(losses.pairwise_neg_sisdr),
                             video_apply=None, bucket=500, eval_batch_size=4,
                             sample_rate=16000, progress_every=0, metric_workers=1)
    assert stats["ranks"] == 1
    got = ranks[0]["eval"]["rows"]
    assert set(got) == set(tracker.rows) == {f"utt{i}" for i in range(7)}
    for key, row in tracker.rows.items():
        for col in ("sdr", "sdr_i", "si-snr", "si-snr_i"):
            assert got[key][col] == pytest.approx(row[col], abs=1e-4), (key, col)


def test_two_device_artifact_matches_the_one_device_one(tmp_path):
    model = build_model(AUDIO_ONLY, device="cpu", generator=torch.Generator().manual_seed(4))
    L = 2000
    one = E.export_serving(model, 4, L, compute_dtype="float32", device="cpu")
    two = E.export_serving(model, 4, L, compute_dtype="float32", device="cpu", mesh_devices=2)
    E.save_serving(str(tmp_path / "one.rtfsx"), one, 4, L, compute_dtype="float32")
    E.save_serving(str(tmp_path / "two.rtfsx"), two, 4, L, compute_dtype="float32")
    art1 = E.load_artifact(str(tmp_path / "one.rtfsx"))
    art2 = E.load_artifact(str(tmp_path / "two.rtfsx"), device=["cpu", "cpu"])
    assert art1.header["nr_devices"] == 1 and art2.header["nr_devices"] == 2
    assert len(art2.devices) == 2
    rng = np.random.default_rng(6)
    for n in (3, 4, 5):
        mix = rng.standard_normal((n, L)).astype(np.float32)
        np.testing.assert_allclose(art2(mix), art1(mix), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="serves on 2 devices and was given 1"):
        E.load_artifact(str(tmp_path / "two.rtfsx"), device=["cpu"])
    with pytest.raises(ValueError, match="shard evenly"):
        E.export_serving(model, 5, L, compute_dtype="float32", device="cpu", mesh_devices=2)


def test_dryrun_multichip_over_two_ranks(ranks):
    zero, one = (r["dryrun"] for r in ranks)
    assert zero["step"] == one["step"] == 1 and zero["loss"] == one["loss"]
    assert np.isfinite(zero["loss"]) and one["eval_means"] is None
    assert zero["eval_means"] and all(np.isfinite(v) for v in zero["eval_means"].values())


def test_without_a_process_group(monkeypatch):
    """No torchrun environment: ``initialize`` does nothing, this process
    is rank 0 of 1 and drives the device asked for; ``wait_for_devices``
    gives up after its timeout when the cards are missing."""
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert initialize("cpu") is False and not torch.distributed.is_initialized()
    assert process_info()[:2] == (0, 1)
    assert local_device("cpu") == torch.device("cpu")
    assert make_mesh(batch_size=3) == Mesh(1, 0)
    with pytest.raises(TimeoutError):
        wait_for_devices(torch.cuda.device_count() + 1, timeout_s=0)


def test_launch_stops_every_rank_when_one_fails():
    with pytest.raises(RuntimeError, match="rank 1 failed:(.|\n)*rank 1 fails"):
        launch(fail_on_rank, RANKS, (1,), device="cpu", timeout_s=120)
