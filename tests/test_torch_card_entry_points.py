"""The port's entry points and tools on an NVIDIA card, each on its card
path with its launch check.

Marked ``card``; each test skips without a card (``tests/_torch_card.py``).
No JAX is imported::

    python3 -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_card_entry_points.py

Every model is full width; the launches per call are those of
``tests/test_torch_card_paths.py``'s table (RTFS-Net-4: K1 32, K3 40 and
each SRU layout kernel 8 a forward; K2 64 + 32 and K3 120 a step;
CTCNet-16 none):

* ``train.main`` on a synthetic LRS2-style manifest (16 train and 8
  validation target-speaker items: 2 s wavs and 50x96x96 uint8 mouth
  tracks) with the FRCNN video model from frames (frozen, seed weights),
  batch 4, float32, 4 process loader workers, 2 epochs: every step's and
  validation batch's launches; finite losses; the ledger, ``last.json``,
  TensorBoard events and ``best_model.pth``. Then a third epoch that
  SIGTERM interrupts after its second step ('preempt' saved) and a fresh
  run that resumes from it (state equal to the checkpoint's, bit for bit);
  ``best_model.pth`` reloaded holds the checkpoint's tensors and separates
  a validation batch exactly as the checkpoint's model does, under cuDNN's
  deterministic algorithms.
* ``test.main`` on that experiment over a synthetic test manifest (12
  mixtures of 1.2-4.0 s, 24 items), eval batch 8: each batch's launches;
  ``metrics.csv`` with 24 rows and ``avg``/``std``, finite SI-SNR, SDR,
  STOI and PESQ from the native extension; ``results.csv``'s rows; the
  first 6 items one at a time within 1e-3 dB of the batched run.
* ``separate`` on a 6 s wav with its mouth track, plain and in 2 s chunks.
* ``export_serving`` of that experiment (float32, buckets 1 and 4): each
  bucket's graph holds exactly the kernels' op nodes; requests of B = 1, 3,
  4 and 5 within 1e-5·max|ref| of eager under cuDNN's deterministic
  algorithms, each bucket call with its launches; ``separate --model
  model.rtfsx`` on 2 s and its refusal of 6 s. A random-weight model
  exported at B = 128 in bfloat16: its op nodes and one call's launches.
* CTCNet-16: ``train.main`` for one epoch, its ``best_model.pth`` exported
  at B=1 (no ``rtfs::`` node) within 1e-5·max|ref| of eager, ``test.main``
  (finite metrics) and ``separate``; nothing launched.
* ``python -m rtfs_net_tpu_torch.bench`` in a process of its own: the
  JAX ``bench.py``'s nine keys, finite, each phase's launches.
* DDP + SyncBatchNorm at world size 1 (NCCL through a file): a step of
  RTFS-Net-4 (B = 4, float32, SGD) against the plain step under cuDNN's
  deterministic algorithms within 1e-6 (gradients 1e-6·max|g|), a second
  step, ``dryrun.dryrun_multichip`` and one ``train.main`` epoch.
* ``train_autoencoder.main`` (2 epochs, batch 4), its checkpoint in
  ``AEVideoModel`` behind RTFS-Net-4 (a 1x1 video bottleneck from its 1936
  channels to 512) serving at B = 1, 4 (B=1 float32 against the CPU) and
  in a train step that moves every AE parameter; ``find_unused_params``
  lists on the card what it lists on the CPU.
* The proofs, under the training entry point's TF32 settings:
  ``train_proof.run`` (200 float32 steps at B = 4: the validation SI-SDR
  rises by more than 5 dB) and ``av_train_proof.run`` (120 bfloat16 steps
  at B = 2 from frames: every video parameter moves), each run's launches
  exactly its steps' and validations'.
* ``bench_zoo.bench_config`` for RTFS-Net-4, 6, 12 and CTCNet-16, the sweep,
  the stage split and the loader bench, at their smallest batches: each
  phase's launches exactly its calls times the config's.
"""
import collections
import contextlib
import copy
import csv
import glob
import json
import math
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtfs_net_tpu_torch.scripts import bench_zoo, config_path, load_config

from _torch_card import assert_launches, card, generator, launched  # noqa: F401
from test_torch_card_paths import (RTFS4, RTFS_REPEAT, make_system, per_repeat, step_of,
                                   train_batch)

pytestmark = pytest.mark.card

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = config_path("lrs2_RTFSNet_4_layer")
CTCNET_CONFIG = config_path("lrs2_CTCNet_16_layer")
STEP = step_of(RTFS4)
SAMPLES, LIP_CHANNELS, LIP_FRAMES, MOUTH = 32000, 512, 50, 88
# the fit: target-speaker items per split (two per mixture), epochs, the
# reference's per-GPU batch, loader worker processes per split, and the
# epoch and step of the third epoch at which SIGTERM arrives
FIT_ITEMS = {"tr": 16, "cv": 8}
FIT_EPOCHS, FIT_BATCH, FIT_WORKERS, FIT_PREEMPT = 2, 4, 4, (2, 1)
# the evaluation: mixtures (two items each), their lengths' range in
# seconds, the items run again one at a time, the engine's default bucket
EVAL_MIXTURES, EVAL_SECONDS, SERIAL_ITEMS, EVAL_BUCKET = 12, (1.2, 4.0), 6, 4000
EVAL_ITEMS = 2 * EVAL_MIXTURES
SEPARATE_SECONDS = 6
# the float32 artifact's buckets and the request batches served through it
# (3 padded to 4, 5 in chunks of 4 and 1)
EXPORT_BUCKETS, EXPORT_REQUESTS = (1, 4), (1, 3, 4, 5)
BENCH_TIMED = 6  # the bench's timed calls after its warm-up


def write_manifest(d, lengths, frames_of, rng):
    """An LRS2-style manifest in ``d``: one mixture per length (mix, s1, s2
    wavs), a 96x96 uint8 mouth track per speaker."""
    from rtfs_net_tpu_torch.datas import wavio

    os.makedirs(d)
    rows = {"mix": [], "s1": [], "s2": []}
    for i, n in enumerate(lengths):
        wavs = {name: os.path.join(d, f"{name}_{i}.wav") for name in rows}
        for path in wavs.values():
            wavio.write(path, 0.1 * rng.standard_normal(n).astype(np.float32), 16000)
        rows["mix"].append([wavs["mix"], n])
        for spk in ("s1", "s2"):
            mouth = os.path.join(d, f"{spk}_{i}.npz")
            np.savez_compressed(mouth, data=rng.integers(0, 256, (frames_of(n), 96, 96),
                                                         dtype=np.uint8))
            rows[spk].append([wavs[spk], mouth, n])
    for name, data in rows.items():
        with open(os.path.join(d, f"{name}.json"), "w") as f:
            json.dump(data, f)
    return d


@pytest.fixture(scope="module")
def root(card, tmp_path_factory):
    """A directory with the fit's ``tr`` and ``cv`` manifests (2 s
    mixtures, 50 frames), the evaluation's ``tt`` manifest and a 6 s wav
    with its mouth track (``long.wav``, ``long.npz``)."""
    from rtfs_net_tpu_torch.datas import wavio

    root = str(tmp_path_factory.mktemp("entry_points"))
    rng = np.random.default_rng(9)
    for split, items in FIT_ITEMS.items():
        write_manifest(os.path.join(root, split), [SAMPLES] * (items // 2), lambda n: 50, rng)
    rng = np.random.default_rng(10)
    write_manifest(os.path.join(root, "tt"),
                   [int(rng.uniform(*EVAL_SECONDS) * 16000) for _ in range(EVAL_MIXTURES)],
                   lambda n: -(-n * 25 // 16000), rng)
    rng = np.random.default_rng(11)
    wavio.write(os.path.join(root, "long.wav"),
                0.1 * rng.standard_normal(SEPARATE_SECONDS * 16000).astype(np.float32), 16000)
    np.savez_compressed(os.path.join(root, "long.npz"), data=rng.integers(
        0, 256, (SEPARATE_SECONDS * 25, 96, 96), dtype=np.uint8))
    return root


class FitWatch:
    """Wraps ``System.train_step`` and ``System.val_step`` for one run of
    the entry point: each call's kernel launches are recorded.
    ``before_first_step``, when set, is called with the system before its
    first train step."""

    def __init__(self, before_first_step=None):
        self.steps, self.vals = [], []
        self.before_first_step = before_first_step

    def __enter__(self):
        from rtfs_net_tpu_torch.system.core import System

        self.original = System.train_step, System.val_step
        train_step, val_step = self.original
        watch = self

        def watched_train_step(system, batch, generator=None):
            if watch.before_first_step is not None and not watch.steps:
                watch.before_first_step(system)
            out, counts = launched(lambda: train_step(system, batch, generator))
            watch.steps.append(counts)
            return out

        def watched_val_step(system, batch):
            out, counts = launched(lambda: val_step(system, batch))
            watch.vals.append(counts)
            return out

        System.train_step, System.val_step = watched_train_step, watched_val_step
        return self

    def __exit__(self, *exc):
        from rtfs_net_tpu_torch.system.core import System

        System.train_step, System.val_step = self.original

    def check_launches(self, want_step=STEP, want_val=RTFS4):
        """Every train step and validation batch launched each kernel as
        often as wanted (default: RTFS-Net-4's) and nothing else."""
        for calls, want in ((self.steps, want_step), (self.vals, want_val)):
            assert calls
            for got in calls:
                assert got == {k: want.get(k, 0) for k in got}, (got, want)


class PreemptingLoader:
    """A training loader that sends this process SIGTERM while handing out
    batch ``at[1]`` of epoch ``at[0]``: the trainer's handler flags the
    loop, that step still runs, and the loop saves 'preempt' after it."""

    def __init__(self, loader, at):
        self.loader, self.at, self.epoch = loader, at, -1

    def set_epoch(self, epoch):
        self.epoch = epoch
        self.loader.set_epoch(epoch)

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if (self.epoch, i) == self.at:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    def close(self):
        self.loader.close()


def assert_tensors_equal(got, want, what):
    """Two (nested) state dicts hold bit-equal tensors."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_tensors_equal(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tensors_equal(g, w, f"{what}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want.to(got.device)), what
    else:
        assert got == want, what


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms inside the block: equal weights
    then give equal outputs (two runs otherwise differ by ~2e-7)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def fit_argv(root, config=CONFIG, path="log", workers=FIT_WORKERS):
    return ["--conf-dir", config, "--train_dir", os.path.join(root, "tr"),
            "--valid_dir", os.path.join(root, "cv"), "--path", os.path.join(root, path),
            "--batch_size", str(FIT_BATCH), "--num_workers", str(workers), "--device", "cuda",
            # the seed's frozen backbone: no published weights are read
            "--pretrain", ""]


@pytest.fixture(scope="module")
def fitted(root):
    """Two epochs of ``train.main`` from scratch: the trainer's history and
    step, its watch, and the experiment directory."""
    from rtfs_net_tpu_torch import train

    conf = train.parse_conf(fit_argv(root) + ["--epochs", str(FIT_EPOCHS)])
    with FitWatch() as watch:
        trainer = train.main(conf)
    exp_dir = os.path.join(conf["log"]["path"], conf["log"]["exp_name"])
    return {"history": trainer.history, "step": trainer.system.step, "watch": watch,
            "exp_dir": exp_dir}


def test_fit_two_epochs(fitted):
    fitted["watch"].check_launches()
    assert [h["epoch"] for h in fitted["history"]] == list(range(FIT_EPOCHS))
    assert fitted["step"] == FIT_EPOCHS * FIT_ITEMS["tr"] // FIT_BATCH
    for h in fitted["history"]:
        assert math.isfinite(h["train_loss"]) and math.isfinite(h["val_loss"]), h
    exp_dir = fitted["exp_dir"]
    for name in ("best_k_models.json", "checkpoints/last.json", "best_model.pth", "conf.yaml"):
        assert os.path.isfile(os.path.join(exp_dir, name)), name
    assert glob.glob(os.path.join(exp_dir, "tb", "*", "*", "events.out.tfevents.*"))


def test_fit_is_preempted_and_resumes(root, fitted):
    """A third epoch interrupted by SIGTERM after its second step, a fresh
    run that resumes from 'preempt' and finishes it, and the exported best
    model against the checkpoint it came from."""
    from rtfs_net_tpu_torch import train
    from rtfs_net_tpu_torch.models import build_model, serialization
    from rtfs_net_tpu_torch.utils.separator import separate

    exp_dir = fitted["exp_dir"]
    conf = train.parse_conf(fit_argv(root) + ["--epochs", str(FIT_EPOCHS + 1)])
    build_dataloaders = train.build_dataloaders

    def preempting(c, *shard):
        train_loader, val_loader = build_dataloaders(c, *shard)
        return PreemptingLoader(train_loader, FIT_PREEMPT), val_loader

    train.build_dataloaders = preempting
    try:
        preempted = train.main(conf)
    finally:
        train.build_dataloaders = build_dataloaders
    with open(os.path.join(exp_dir, "checkpoints", "last.json")) as f:
        last = json.load(f)
    steps_per_epoch = FIT_ITEMS["tr"] // FIT_BATCH
    want_steps = FIT_EPOCHS * steps_per_epoch + FIT_PREEMPT[1] + 1
    assert last["name"] == "preempt" and last["epoch"] == FIT_EPOCHS - 1, last
    assert preempted.system.step == want_steps
    saved = torch.load(os.path.join(exp_dir, "checkpoints", "preempt.pt"), map_location="cpu",
                       weights_only=True)
    assert_tensors_equal(preempted.system.state_dict(), saved, "preempt checkpoint")
    del preempted

    with FitWatch(before_first_step=lambda system: assert_tensors_equal(
            system.state_dict(), saved, "resumed state")) as watch:
        resumed = train.main(conf)
    watch.check_launches()
    # the interrupted epoch restarts from the mid-epoch state
    assert resumed.start_epoch == FIT_EPOCHS
    assert [h["epoch"] for h in resumed.history] == [FIT_EPOCHS]
    assert resumed.system.step == want_steps + steps_per_epoch

    best = resumed.ckpt.best_name()
    video = resumed.system.video_model
    ckpt_model = build_model(conf["audionet"], device="cuda")
    ckpt_model.load_state_dict(resumed.ckpt.restore(best, map_location="cpu")["model"])
    exported, _ = serialization.load_model(os.path.join(exp_dir, "best_model.pth"),
                                           device="cuda")
    _, val_loader = build_dataloaders(conf)
    try:
        mix, _, frames, _ = next(iter(val_loader))
    finally:
        val_loader.close()
    mix, frames = torch.from_numpy(mix).cuda(), torch.from_numpy(frames).cuda()
    assert_tensors_equal(exported.state_dict(), ckpt_model.state_dict(), "best_model.pth")
    with deterministic():
        want, got = (separate(m, mix, frames, video_model=video) for m in (ckpt_model, exported))
    assert bool(torch.isfinite(got).all()) and float((got - want).abs().max()) == 0


def metric_rows(path):
    """metrics.csv's rows, and by key the sorted SI-SNR and SDR values of
    the key's utterance rows (a mixture's two items share its key)."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    by_key = collections.defaultdict(lambda: ([], []))
    for r in rows:
        if r["snt_id"] not in ("avg", "std"):
            by_key[r["snt_id"]][0].append(float(r["si-snr"]))
            by_key[r["snt_id"]][1].append(float(r["sdr"]))
    return rows, {k: (sorted(a), sorted(b)) for k, (a, b) in by_key.items()}


def test_evaluate(root, fitted):
    from rtfs_net_tpu_torch import evaluation
    from rtfs_net_tpu_torch import test as evaluate_cli
    from rtfs_net_tpu_torch import train
    from rtfs_net_tpu_torch.datas import AVSpeechDataset
    from rtfs_net_tpu_torch.losses import PITLossWrapper, pairwise_neg_sisdr
    from rtfs_net_tpu_torch.metrics import ALLMetricsTracker, pesq_backend
    from rtfs_net_tpu_torch.models.serialization import load_model

    exp_dir = fitted["exp_dir"]
    conf = evaluate_cli.parse_conf(["--conf-dir", os.path.join(exp_dir, "conf.yaml"),
                                    "--test-dir", os.path.join(root, "tt"), "--device", "cuda"])
    eval_batch = 2 * conf["training"]["batch_size"]
    forward_batch, calls = evaluation.forward_batch, []

    def watched(model, video_apply, mix, mouths):
        out, counts = launched(lambda: forward_batch(model, video_apply, mix, mouths))
        calls.append((counts, mix.shape[0]))
        return out

    evaluation.forward_batch = watched
    try:
        out = evaluate_cli.main(conf)
    finally:
        evaluation.forward_batch = forward_batch
    stats = out["eval"]
    for got, _ in calls:
        assert got == {k: RTFS4.get(k, 0) for k in got}, got
    assert stats["batch_clock"] == "cuda_events"
    sizes = [size for _, size in calls]
    assert sum(sizes) == EVAL_ITEMS and max(sizes) == eval_batch
    assert stats["batches"] == len(sizes)

    rows, batched = metric_rows(os.path.join(out["save_dir"], "metrics.csv"))
    assert len(rows) == EVAL_ITEMS + 2 and [r["snt_id"] for r in rows[-2:]] == ["avg", "std"]
    assert pesq_backend() == "native"
    for r in rows[:-2]:
        for col in ("si-snr", "sdr", "stoi", "pesq"):
            assert math.isfinite(float(r[col])), (r["snt_id"], col, r[col])
    keys = [k for k, _ in out["results"]]
    head = ["Model", "Params (M)", "MACs (G, 2s)", "Videomodel MACs (G, 2s)",
            "si-snr_i", "sdr_i", "pesq", "stoi", "si-snr", "sdr"]
    assert keys[:len(head)] == head and "enc_dec_params_win" in keys
    with open(os.path.join(out["save_dir"], "results.csv")) as f:
        assert f.readline().strip() == "Key,Value" and len(f.readlines()) == len(keys)

    # the first SERIAL_ITEMS utterances again, one at a time, through the engine
    model, _ = load_model(os.path.join(exp_dir, "best_model.pth"), device="cuda", conf=conf)
    video = train.build_video_model(conf, "cuda")
    test_set = AVSpeechDataset(os.path.join(root, "tt"), n_src=1, sample_rate=16000,
                               segment=None, normalize_audio=conf["data"]["normalize_audio"])
    serial_csv = os.path.join(root, "serial.csv")
    tracker = ALLMetricsTracker(save_file=serial_csv)
    evaluation.run_batched_eval(
        model, [test_set[i] for i in range(SERIAL_ITEMS)], tracker,
        PITLossWrapper(pairwise_neg_sisdr), lambda m: video(evaluation.normalize_mouths(m)),
        EVAL_BUCKET, 1, 16000, progress_every=0)
    tracker.final()
    _, serial = metric_rows(serial_csv)
    err = max(abs(a - b) for key, pair in serial.items()
              for got, ref in zip(pair, batched[key]) for a, b in zip(got, ref))
    assert err <= 1e-3, err


@pytest.mark.parametrize("chunk", [0, 2], ids=["plain", "chunks_of_2s"])
def test_separate_cli(root, fitted, chunk):
    from rtfs_net_tpu_torch import separate as separate_cli
    from rtfs_net_tpu_torch.datas import wavio

    exp_dir = fitted["exp_dir"]
    argv = ["--model", os.path.join(exp_dir, "best_model.pth"),
            "--input", os.path.join(root, "long.wav"), "--mouth", os.path.join(root, "long.npz"),
            "--videonet-conf", os.path.join(exp_dir, "conf.yaml"),
            "--output", os.path.join(root, f"separated_{chunk}"),
            "--chunk-seconds", str(chunk), "--device", "cuda"]
    (path,) = assert_launches(lambda: separate_cli.main(separate_cli.parse_args(argv)), RTFS4)
    out, sr = wavio.read(path)
    assert sr == 16000 and out.shape == (SEPARATE_SECONDS * 16000,)
    assert np.isfinite(out).all() and np.abs(out).max() > 0


def bucket_calls(n, buckets=EXPORT_BUCKETS):
    """The bucket calls an artifact makes for a request of ``n``: the
    smallest bucket that fits, else chunks of the largest."""
    calls = []
    while n > 0:
        b = next((s for s in buckets if s >= n), buckets[-1])
        calls.append(b)
        n -= min(n, b)
    return calls


def eager_serving(model, dtype):
    """What an artifact computes, run eagerly: float32 in, the model in
    ``dtype``, float32 out (``export._Serving``)."""
    def forward(mix, emb):
        with torch.inference_mode():
            return model(mix.to(dtype), emb.to(dtype)).float()

    return forward


def export_and_load(ckpt, out, *flags, nodes):
    """``export_serving``'s CLI on the card, then the artifact loaded; each
    bucket's graph holds exactly ``nodes`` ``rtfs::`` op nodes."""
    from rtfs_net_tpu_torch import export, export_serving

    path, _ = export_serving.main(["--ckpt", ckpt, "--out", out, "--device", "cuda", *flags])
    art = export.load_artifact(path)
    assert art.header["platforms"] == ["cuda"]
    for b in art.batch_sizes:
        assert export.op_counts(art.program(b)) == nodes, b
    return art


# K1, K3 and the SRU layout kernels as op nodes of an RTFS-Net-4 graph
RTFS4_NODES = {"sru_stack_layer": RTFS4["K1"], "dw_conv2d_same": RTFS4["K3"],
               "dual_path_norm_in": RTFS4["dual_path_norm_in"],
               "dual_path_out": RTFS4["dual_path_out"]}


def test_export_artifact(root, fitted):
    """The experiment's float32 artifact with buckets against the same
    weights eagerly, then ``separate --model model.rtfsx``."""
    from rtfs_net_tpu_torch import separate as separate_cli
    from rtfs_net_tpu_torch.datas import wavio
    from rtfs_net_tpu_torch.models import serialization

    exp_dir = fitted["exp_dir"]
    best = os.path.join(exp_dir, "best_model.pth")
    rtfsx = os.path.join(root, "model.rtfsx")
    art = export_and_load(best, rtfsx, "--batch-sizes", ",".join(map(str, EXPORT_BUCKETS)),
                          "--dtype", "float32", nodes=RTFS4_NODES)
    model, _ = serialization.load_model(best, device="cuda")
    eager = eager_serving(model, torch.float32)
    gen = generator(12)
    with deterministic():
        for n in EXPORT_REQUESTS:
            mix = torch.randn((n, SAMPLES), generator=gen, device="cuda")
            emb = 0.1 * torch.randn((n, LIP_CHANNELS, LIP_FRAMES), generator=gen, device="cuda")
            want = eager(mix, emb).cpu().numpy()
            calls = len(bucket_calls(n))
            got = assert_launches(lambda: art(mix, emb), per_repeat(RTFS4, calls))
            assert got.shape == (n, 1, SAMPLES) and np.isfinite(got).all()
            assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max()), n

    # separate --model model.rtfsx: 2 s of the 6 s wav with its 50 frames
    wav, sr = wavio.read(os.path.join(root, "long.wav"))
    frames = np.load(os.path.join(root, "long.npz"))["data"]
    cut, cut_mouth = os.path.join(root, "cut.wav"), os.path.join(root, "cut.npz")
    wavio.write(cut, wav[:SAMPLES], sr)
    np.savez_compressed(cut_mouth, data=frames[:LIP_FRAMES])
    argv = ["--model", rtfsx, "--mouth", cut_mouth,
            "--videonet-conf", os.path.join(exp_dir, "conf.yaml"), "--device", "cuda"]
    (path,) = assert_launches(lambda: separate_cli.main(separate_cli.parse_args(
        argv + ["--input", cut, "--output", os.path.join(root, "separated_rtfsx")])), RTFS4)
    out, _ = wavio.read(path)
    assert out.shape == (SAMPLES,) and np.isfinite(out).all() and np.abs(out).max() > 0
    with pytest.raises(SystemExit, match="exceeds the artifact's exported segment"):
        separate_cli.main(separate_cli.parse_args(
            argv + ["--input", os.path.join(root, "long.wav"), "--output", root]))


def test_export_at_the_benchmark_batch(root):
    """RTFS-Net-4 from seed 0 exported at B = 128 in bfloat16 (the JAX
    ``bench.py``'s serving point): its op nodes and one call's launches."""
    from rtfs_net_tpu_torch.models import build_model, serialization

    conf = load_config("lrs2_RTFSNet_4_layer")
    model = build_model(conf, device="cuda", generator=torch.Generator().manual_seed(0))
    ckpt = os.path.join(root, "serving", "best_model.pth")
    serialization.save_model(ckpt, "AVNet", conf["audionet"], model.state_dict())
    art = export_and_load(ckpt, os.path.join(root, "serving", "model.rtfsx"), "--batch-size",
                          "128", "--dtype", "bfloat16", nodes=RTFS4_NODES)
    gen = generator(13)
    mix = torch.randn((128, SAMPLES), generator=gen, device="cuda")
    emb = 0.1 * torch.randn((128, LIP_CHANNELS, LIP_FRAMES), generator=gen, device="cuda")
    out = assert_launches(lambda: art(mix, emb), RTFS4)
    assert out.shape == (128, 1, SAMPLES) and np.isfinite(out).all()


def test_ctcnet_entry_points(root):
    """CTCNet-16: ``train.main`` for one epoch on the fit's manifest, its
    ``best_model.pth`` exported at B=1 float32 and held against eager,
    ``test.main`` and ``separate`` on that experiment; none of the kernels
    launches."""
    from rtfs_net_tpu_torch import separate as separate_cli
    from rtfs_net_tpu_torch import test as evaluate_cli
    from rtfs_net_tpu_torch import train
    from rtfs_net_tpu_torch.datas import wavio
    from rtfs_net_tpu_torch.models import serialization

    conf = train.parse_conf(fit_argv(root, CTCNET_CONFIG, "ctcnet") + ["--epochs", "1"])
    with FitWatch() as watch:
        trainer = train.main(conf)
    watch.check_launches({}, {})
    history = trainer.history
    assert len(history) == 1
    assert math.isfinite(history[0]["train_loss"]) and math.isfinite(history[0]["val_loss"])
    del trainer
    exp_dir = os.path.join(conf["log"]["path"], conf["log"]["exp_name"])
    best = os.path.join(exp_dir, "best_model.pth")
    art = export_and_load(best, os.path.join(root, "ctcnet.rtfsx"), "--batch-size", "1",
                          "--dtype", "float32", nodes={})
    loaded, _ = serialization.load_model(best, device="cuda")
    gen = generator(14)
    mix = torch.randn((1, SAMPLES), generator=gen, device="cuda")
    emb = 0.1 * torch.randn((1, LIP_CHANNELS, LIP_FRAMES), generator=gen, device="cuda")
    with deterministic():
        want = eager_serving(loaded, torch.float32)(mix, emb).cpu().numpy()
        got = assert_launches(lambda: art(mix, emb), {})
    assert got.shape == (1, 1, SAMPLES) and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())

    eval_conf = evaluate_cli.parse_conf(["--conf-dir", os.path.join(exp_dir, "conf.yaml"),
                                         "--test-dir", os.path.join(root, "tt"),
                                         "--device", "cuda"])
    evaluated = assert_launches(lambda: evaluate_cli.main(eval_conf), {})
    rows, _ = metric_rows(os.path.join(evaluated["save_dir"], "metrics.csv"))
    assert len(rows) == EVAL_ITEMS + 2
    assert all(math.isfinite(float(r[col])) for r in rows[:-2]
               for col in ("si-snr", "sdr", "stoi", "pesq"))
    argv = ["--model", best, "--input", os.path.join(root, "long.wav"),
            "--mouth", os.path.join(root, "long.npz"),
            "--videonet-conf", os.path.join(exp_dir, "conf.yaml"),
            "--output", os.path.join(root, "ctcnet_separated"), "--device", "cuda"]
    (path,) = assert_launches(lambda: separate_cli.main(separate_cli.parse_args(argv)), {})
    out, _ = wavio.read(path)
    assert out.shape == (SEPARATE_SECONDS * 16000,) and np.isfinite(out).all()


def test_bench_cli(card):
    """``python -m rtfs_net_tpu_torch.bench`` in a process of its own: its
    last line has exactly ``bench.py``'s keys, every value finite; its
    launches are RTFS-Net-4's per serving call (the float32 sanity slice,
    the warm-up and the timed calls) and per train step (the warm-up and
    the timed steps), nothing else."""
    from rtfs_net_tpu_torch import bench

    torch.cuda.empty_cache()  # the bench's own process needs the card's memory
    proc = subprocess.run([sys.executable, "-m", "rtfs_net_tpu_torch.bench"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1])
    launches = json.loads(next(line for line in reversed(lines)
                               if line.startswith("launches "))[len("launches "):])
    assert list(result) == list(bench.KEYS)
    assert all(math.isfinite(v) for k, v in result.items() if k not in ("metric", "unit"))
    per_call = {"serving": (RTFS4, 2 + BENCH_TIMED), "train_b4": (STEP, 1 + BENCH_TIMED),
                "train_b16": (STEP, 1 + BENCH_TIMED)}
    assert list(launches) == list(per_call)
    for phase, (counts, calls) in per_call.items():
        assert launches[phase] == {k: counts.get(k, 0) * calls for k in launches[phase]}, phase


def test_data_parallel_at_world_size_1(root):
    """A DDP + SyncBatchNorm train step of RTFS-Net-4 (B = 4, float32, SGD
    with the config's lr and weight decay) against the plain
    ``System.train_step`` on the same batch and generator seed, both under
    cuDNN's deterministic algorithms: loss, parameters and BatchNorm
    buffers within 1e-6, gradients within 1e-6·max|g|. (Not AdamW: two
    plain steps on the card already differ by ~1e-7·max|g|, PyTorch's
    ``adaptive_avg_pool2d`` backward having no deterministic
    implementation, and AdamW's first update turns that into up to ~3e-4
    where |g| is near zero.) A second DDP step (DDP raises in it if the
    first left a parameter without gradient), ``dryrun_multichip`` over the
    group and one data-parallel ``train.main`` epoch."""
    from rtfs_net_tpu_torch import parallel, train
    from rtfs_net_tpu_torch.dryrun import dryrun_multichip
    from rtfs_net_tpu_torch.models import build_model
    from rtfs_net_tpu_torch.parallel import make_mesh, make_parallel_train_step, shard_batch

    tol, batch_size = 1e-6, 4
    parallel.initialize("cuda", init_method="file://" + os.path.join(root, "rendezvous"),
                        world_size=1, rank=0)
    try:
        with deterministic():
            base = build_model(load_config("lrs2_RTFSNet_4_layer")["audionet"], device="cuda",
                               generator=torch.Generator().manual_seed(0))
            batch = train_batch(batch_size, generator(12))

            def worst(a, b):
                return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))

            plain = make_system(copy.deepcopy(base), torch.float32, optimizer="sgd")
            want = plain.train_step(batch, generator(13))
            system = make_system(copy.deepcopy(base), torch.float32, optimizer="sgd")
            mesh = make_mesh(batch_size=batch_size)
            step = make_parallel_train_step(system, mesh)
            local = shard_batch(batch, mesh)
            got = assert_launches(lambda: step(local, generator(13)), STEP)
            assert type(system.replica).__name__ == "DistributedDataParallel"
            assert any(type(m).__name__ == "SyncBatchNorm" for m in system.model.modules())
            params, plain_params = list(system.model.parameters()), list(plain.model.parameters())
            assert abs(float(got["loss"]) - float(want["loss"])) <= tol * abs(float(want["loss"]))
            assert worst([p.detach() for p in params], [p.detach() for p in plain_params]) <= tol
            assert worst(list(system.model.buffers()), list(plain.model.buffers())) <= tol
            scale = max(float(p.grad.abs().max()) for p in plain_params)
            assert worst([p.grad for p in params], [p.grad for p in plain_params]) <= tol * scale
            assert_launches(lambda: step(local, generator(14)), STEP)
        del base, plain, system, step
        dryrun_multichip(1)

        with FitWatch() as watch:
            trainer = train.main(train.parse_conf(fit_argv(root, path="ddp_log", workers=2)
                                                  + ["--epochs", "1"]))
        watch.check_launches()
        assert trainer.system.step == FIT_ITEMS["tr"] // FIT_BATCH
        assert type(trainer.system.replica).__name__ == "DistributedDataParallel"
        assert all(math.isfinite(h[k]) for h in trainer.history for k in ("train_loss",
                                                                            "val_loss"))
    finally:
        parallel.shutdown()


def test_train_autoencoder_and_its_video_model(root, monkeypatch):
    """``train_autoencoder.main`` on mouth tracks (2 epochs, batch 4), then
    its encoder as ``AEVideoModel`` behind RTFS-Net-4 with a 1936-channel
    embedding (a 1x1 video bottleneck to 512 channels: the fusion's grouped
    convs need a multiple of 256), serving at B = 1, 4 (B=1 float32 within
    5e-4·max|ref| of the CPU) and in one train step with the backbone
    unfrozen, which moves every AE parameter."""
    from rtfs_net_tpu_torch import train, train_autoencoder
    from rtfs_net_tpu_torch.losses import PITLossWrapper, pairwise_neg_sisdr, pairwise_neg_snr
    from rtfs_net_tpu_torch.models import build_model
    from rtfs_net_tpu_torch.system import System, make_optimizer
    from rtfs_net_tpu_torch.utils.separator import separate

    exp = os.path.join(root, "autoencoder")
    args = train_autoencoder.parse_args([
        "--train-dir", os.path.join(root, "tr"), "--valid-dir", os.path.join(root, "cv"),
        "--exp-dir", exp, "--epochs", "2", "--batch-size", "4", "--device", "cuda"])
    trained = assert_launches(lambda: train_autoencoder.main(args), {})
    history = trained["history"]
    assert len(history) == 2 and trained["best_model"] is not None
    assert all(math.isfinite(h["train_loss"]) and math.isfinite(h["val_loss"]) for h in history)
    assert os.path.exists(os.path.join(exp, "best_k_models.json"))

    conf = load_config("lrs2_RTFSNet_4_layer")
    conf["videonet"] = {**conf["videonet"], "model_name": "AEVideoModel", "in_channels": 1,
                        "base_channels": 4, "num_layers": 3, "pretrain": trained["best_model"]}
    conf["audionet"]["pretrained_vout_chan"] = 1936
    conf["main_args"] = {}
    conf["audionet"]["video_bn_params"] = {"kernel_size": 1, "out_chan": 512}
    video = train.build_video_model(conf, device="cuda")
    saved = torch.load(trained["best_model"], weights_only=True)
    for k, t in saved.items():
        assert torch.equal(video.state_dict()[f"encoder.{k}"].cpu(), t), k
    model = build_model(conf, device="cuda", generator=torch.Generator().manual_seed(0))
    gen = generator(15)
    for B in (1, 4):
        mix = torch.randn((B, SAMPLES), generator=gen, device="cuda")
        frames = torch.randn((B, 1, LIP_FRAMES, MOUTH, MOUTH), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            out = assert_launches(
                lambda: separate(model, mix, frames, video_model=video, dtype=dtype), RTFS4)
            assert tuple(out.shape) == (B, 1, SAMPLES) and bool(torch.isfinite(out).all())
            if B == 1 and dtype == torch.float32:
                ref = separate(copy.deepcopy(model).cpu(), mix.cpu(), frames.cpu(),
                               device="cpu", video_model=copy.deepcopy(video).cpu())
                assert float((out.cpu() - ref).abs().max()) <= 5e-4 * float(ref.abs().max())

    system = System(model, make_optimizer(model.parameters(), **conf["optim"]),
                    {"train": PITLossWrapper(pairwise_neg_snr),
                     "val": PITLossWrapper(pairwise_neg_sisdr)},
                    video_model=video, train_video_model=True)
    mix = torch.randn((4, SAMPLES), generator=gen, device="cuda")
    frames = torch.randn((4, 1, LIP_FRAMES, MOUTH, MOUTH), generator=gen, device="cuda")
    before = {k: t.clone() for k, t in video.state_dict().items()}
    out = assert_launches(lambda: system.train_step((mix, mix[:, None], frames),
                                                    generator=generator(4)), STEP)
    assert math.isfinite(float(out["loss"])) and math.isfinite(float(out["grad_norm"]))
    assert not [k for k, t in video.state_dict().items() if torch.equal(t, before[k])]


def test_find_unused_params(card):
    """At full width on the card (one forward and backward: K2 32 + 32, K3
    80) it lists what it lists on the CPU."""
    from rtfs_net_tpu_torch import find_unused_params

    argv = ["--conf-dir", CONFIG]
    unused = assert_launches(
        lambda: find_unused_params.main(find_unused_params.parse_args(argv + ["--device",
                                                                              "cuda"])),
        {"K2_forward": RTFS4["K1"], "K2_backward": RTFS4["K1"], "K3": 2 * RTFS4["K3"]})
    assert unused == find_unused_params.main(find_unused_params.parse_args(
        argv + ["--device", "cpu"]))


@contextlib.contextmanager
def train_precision():
    """PyTorch's default TF32 settings, those ``rtfs_net_tpu_torch.train``
    trains with (cuDNN's float32 convolutions may use TF32, matmuls run in
    full float32), inside the block; TF32 off again after it."""
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False


def test_train_proof(card):
    """200 float32 steps at B = 4 on one batch: the validation SI-SDR rises
    by more than ``train_proof.MIN_GAIN_DB``; the launches are exactly the
    steps' and the validations'."""
    from rtfs_net_tpu_torch.scripts import train_proof

    with train_precision():
        proof, launches = launched(lambda: train_proof.run(torch.device("cuda")))
    vals = 1 + train_proof.STEPS // train_proof.LOG_EVERY
    assert launches == {k: STEP.get(k, 0) * train_proof.STEPS + RTFS4.get(k, 0) * vals
                        for k in launches}
    assert proof["improvement_db"] > train_proof.MIN_GAIN_DB, proof["improvement_db"]


def test_av_train_proof(card):
    """120 bfloat16 steps at B = 2 from raw frames through a trainable FRCNN
    video model: every video parameter moves; the launches are exactly the
    steps'."""
    from rtfs_net_tpu_torch.scripts import av_train_proof

    with train_precision():
        av, launches = launched(lambda: av_train_proof.run(torch.device("cuda")))
    assert launches == {k: STEP.get(k, 0) * av_train_proof.STEPS for k in launches}
    assert av["video_moved"] == av["video_params"]


@pytest.mark.parametrize("name", [name for name, _ in bench_zoo.ZOO])
def test_config_zoo(card, name):
    """``bench_zoo.bench_config`` with ``--latency`` at its smallest
    batches (serving at B = 4 and 1, a train step at B = 4, one timed call
    each): each phase's launches exactly its calls times the config's (per
    TDANet repeat of RTFS-Net; CTCNet none)."""
    conf = load_config(name)
    repeats = conf["audionet"]["audio_params"]["repeats"] if "RTFSNet" in name else 0
    forward = per_repeat(RTFS_REPEAT, repeats)
    row, launches = launched(lambda: bench_zoo.bench_config(
        name, torch.device("cuda"), conf=conf, latency=True, batch=4, train_batches=(4,),
        iters=1))
    for phase, calls in row["calls"].items():
        want = step_of(forward) if phase.startswith("train") else forward
        assert row["launches"][phase] == {k: want.get(k, 0) * calls
                                          for k in row["launches"][phase]}, phase
    assert set(row["calls"]) == {"serving", "latency", "train_b4"}
    assert launches == {k: sum(n[k] for n in row["launches"].values()) for k in launches}


def test_sweep(card):
    """``bench_sweep.sweep`` at B = 1 and 2, one timed call each: each
    batch's calls launch RTFS-Net-4's kernels each."""
    from rtfs_net_tpu_torch.scripts import bench_sweep

    rows, _ = bench_sweep.sweep(torch.device("cuda"), batches=(1, 2), iters=1, log=None)
    for row in rows:
        assert row["launches"] == {k: RTFS4.get(k, 0) * row["calls"] for k in row["launches"]}


def test_stages(card):
    """``profile_serving.profile`` at B = 1, one timed call a stage: every
    stage's time finite; the launches those of the full forward's and the
    refinement's calls (a whole forward's kernels each), of one audio
    block's (one TDANet repeat's) and of the B=1 forward that reads the
    stages' shapes."""
    from rtfs_net_tpu_torch.scripts import profile_serving

    (ms, _, repeats), launches = launched(
        lambda: profile_serving.profile(torch.device("cuda"), batch=1, iters=1, log=None))
    calls = 1 + 1  # a warm-up and the timed call
    assert launches == {k: (calls * (2 * repeats + 1) + repeats) * RTFS_REPEAT.get(k, 0)
                        for k in launches}
    assert all(math.isfinite(t) and t > 0 for t in ms.values()), ms


def test_loader(card, tmp_path):
    """``bench_loader`` on a synthetic on-disk set of 8 files per speaker,
    each variant in process and at one worker, batches of 4 uploaded to the
    card: no kernel launches."""
    from rtfs_net_tpu_torch.scripts import bench_loader

    bench_loader.make_dataset(str(tmp_path), 8)
    results, launches = launched(lambda: bench_loader.bench(
        str(tmp_path), torch.device("cuda"), (1,), batch_size=4, log=lambda *a, **k: None))
    assert not any(launches.values())
    assert all(math.isfinite(v) and v > 0 for v in results.values()), results
