"""PyTorch port vs JAX package: the training loop (schedulers, ``online_mix``,
checkpoints, TensorBoard events, serialization, ``Trainer`` and the
``rtfs_net_tpu_torch.train`` entry point).

* The schedulers give the LR, stop and ``state_dict`` sequences of JAX's
  under one ``val_loss`` sequence.
* ``remix_sources`` on the permutations JAX's ``online_mixing_collate``
  drew gives its mixture and sources within 1e-6·max|ref| (float32
  products and sums of 64 terms); each remixed source keeps its slot's
  energy; ``System(online_mix=True)`` trains on the remix.
* ``CheckpointManager`` leaves the ledger, file names and ``last.json`` of
  JAX's under one score sequence, and restores model, optimizer, step and
  scheduler state exactly.
* The slice as a whole: one epoch of ``Trainer.fit`` (2 train batches, 1
  val batch, an audio-only tiny config without dropout) from JAX's initial
  weights against JAX's ``Trainer.fit`` on the same batches: the epoch's
  train and val losses within 1e-4·|loss|, and the parameters' change over
  the epoch held twice. Every element within 1e-3·max|change| over all
  leaves: tests/test_torch_train.py holds one step's gradients to
  5e-4·max|g|, and the epoch's change sums two steps' gradients. And each
  leaf against its own change, ||change - ref|| <= 2e-2·||ref|| +
  2·eps32·||param||, the last term the float32 rounding of the parameters:
  the worst leaf measured on a CPU, the attention keys' bias of the second
  block, is at 1.2e-2 (a small gradient left after the softmax's
  cancellation, whose float32 error is large beside it); leaves no
  gradient reaches in the reference must not move. The optimizer is SGD
  with momentum 0.9 and no weight decay, so the change is all gradient;
  its update is linear in the gradients and so carries their tolerance
  over. AdamW's m/sqrt(v) would
  not: it turns the gradients' error into a few percent of the update for
  the smallest gradients, and flips the sign of the update (2·lr) of
  gradients within their error of zero (2 of 2048 weights of one SRU layer
  after this epoch, on a CPU). AdamW's update itself is held
  to optax's within 1e-6 in tests/test_torch_train.py.
* Preemption by SIGTERM, resume, and ``export_best`` without a scored
  checkpoint, as tests/test_preemption.py holds the JAX trainer; the entry
  point trains, resumes and exports on the CPU, as tests/test_cli_e2e.py
  drives the JAX one.
"""
import copy
import glob
import json
import math
import os
import signal
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from rtfs_net_tpu import system as jsystem
from rtfs_net_tpu.datas import wavio
from rtfs_net_tpu.losses import PITLossWrapper as JaxPIT
from rtfs_net_tpu.losses import pairwise_neg_sisdr as jax_sisdr
from rtfs_net_tpu.losses import pairwise_neg_snr as jax_snr
from rtfs_net_tpu.models import AVNet as JaxAVNet
from rtfs_net_tpu_torch import losses, train
from rtfs_net_tpu_torch import system as psystem
from rtfs_net_tpu_torch.datas import DataLoader
from rtfs_net_tpu_torch.models import build_model, serialization
from rtfs_net_tpu_torch.system import (CheckpointManager, EarlyStopping, ReduceLROnPlateau,
                                       System, TensorBoardLogger, Trainer, make_optimizer,
                                       online_mixing_collate, remix_sources)
from rtfs_net_tpu_torch.system.tb_writer import _masked_crc, crc32c
from rtfs_net_tpu_torch.utils.convert import state_dict_from_jax

from _torch_port import jax_init, one_torch_thread  # noqa: F401
from test_system import TINY_AUDIONET

L = 1000  # samples per utterance


def _audio_conf(repeats=1, num_layers=1):
    """The JAX tests' tiny config without the video branch (no dropout)."""
    conf = copy.deepcopy(TINY_AUDIONET)
    conf["video_params"], conf["fusion_params"] = {}, {}
    conf["audio_params"]["repeats"] = repeats
    conf["audio_params"]["layers"]["layer_1"]["num_layers"] = num_layers
    return conf


def _system(model, optim=None, **kw):
    optim = optim or {"optimizer": "adamw", "lr": 1e-3, "weight_decay": 0.1}
    return System(model, make_optimizer(model.parameters(), **optim),
                  {"train": losses.PITLossWrapper(losses.pairwise_neg_snr),
                   "val": losses.PITLossWrapper(losses.pairwise_neg_sisdr)}, **kw)


class _Batches:
    """A fixed list of (mix, sources) numpy batches, the same every epoch."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.batches = [tuple(0.5 * rng.standard_normal((2, L)).astype(np.float32)
                              for _ in range(2)) for _ in range(n)]

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(self.batches)


def _events(exp_dir):
    """The scalars of the experiment's one tfevents file, by tag, after
    checking every record's two masked CRC32Cs."""
    from tensorboard.compat.proto.event_pb2 import Event

    (path,) = glob.glob(os.path.join(exp_dir, "tb", "default", "version_0", "events.*"))
    raw = open(path, "rb").read()
    scalars, off, first = {}, 0, None
    while off < len(raw):
        header = raw[off:off + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", raw[off + 8:off + 12])[0] == _masked_crc(header)
        payload = raw[off + 12:off + 12 + n]
        assert struct.unpack("<I", raw[off + 12 + n:off + 16 + n])[0] == _masked_crc(payload)
        off += 16 + n
        ev = Event()
        ev.ParseFromString(payload)
        first = first or ev
        for v in ev.summary.value:
            scalars.setdefault(v.tag, []).append((ev.step, v.simple_value))
    assert first.file_version == "brain.Event:2"
    return scalars


# ------------------------------------------------------------- schedulers
VAL_LOSSES = [5.0, 4.0, 4.0, 3.9999, 4.1, 4.2, 3.0, 3.0, 3.5, 3.5, 3.5, 3.6]


@pytest.mark.parametrize("kind", ["plateau", "staircase", "early"])
def test_schedulers_match_jax(kind):
    make = {"plateau": lambda mod: mod.ReduceLROnPlateau(0.5, 2),
            "staircase": lambda mod: mod.StaircaseLR(1e-3, 2.0, 3),
            "early": lambda mod: mod.EarlyStopping(3)}[kind]
    ours, theirs = make(psystem), make(jsystem)
    lr = (1e-3, 1e-3)
    for epoch, v in enumerate(VAL_LOSSES):
        if kind == "plateau":
            lr = (ours.step(v, lr[0]), theirs.step(v, lr[1]))
        elif kind == "staircase":
            lr = (ours.step(epoch, lr[0]), theirs.step(epoch, lr[1]))
        else:
            assert ours.step(v) == theirs.step(v)
        assert lr[0] == lr[1]
        if kind != "staircase":
            assert ours.state_dict() == theirs.state_dict()
    if kind == "plateau":
        assert lr[0] == 1e-3 / 4  # halved twice
        fresh = ReduceLROnPlateau(0.5, 2)
    elif kind == "early":
        assert ours.stopped
        fresh = EarlyStopping(3)
    else:
        assert lr[0] == 1e-3 / 2 ** 3  # epochs 3, 6, 9
        return
    fresh.load_state_dict(json.loads(json.dumps(ours.state_dict())))
    assert fresh.state_dict() == ours.state_dict()


# ------------------------------------------------------------- online_mix
def test_remix_matches_jax():
    B, n_src = 5, 3
    rng = np.random.default_rng(0)
    targets = rng.standard_normal((B, n_src, 64)).astype(np.float32)

    @jax.jit
    def remix_and_perms(key, targets):
        perms, r = [], key
        for _ in range(n_src):  # the draws online_mixing_collate makes
            r, sub = jax.random.split(r)
            perms.append(jax.random.permutation(sub, B))
        return jsystem.online_mixing_collate(key, targets), perms

    (want_mix, want_src), perms = jax.tree_util.tree_map(
        np.array, remix_and_perms(jax.random.PRNGKey(3), targets))
    got_mix, got_src = remix_sources(torch.from_numpy(targets),
                                     [torch.from_numpy(p) for p in perms])
    for got, want in ((got_mix, want_mix), (got_src, want_src)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())

    # the port's own draws: each source slot keeps its energy and holds a
    # rescaled source of the same slot from a permuted utterance
    mix, src = online_mixing_collate(torch.from_numpy(targets), torch.Generator().manual_seed(1))
    torch.testing.assert_close(src.pow(2).sum(-1), torch.from_numpy(targets).pow(2).sum(-1),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(mix, src.sum(1))
    for i in range(n_src):
        unit = torch.nn.functional.normalize(torch.from_numpy(targets[:, i]), dim=-1)
        cos = torch.nn.functional.normalize(src[:, i], dim=-1) @ unit.T
        assert torch.allclose(cos.max(1).values, torch.ones(B), atol=1e-5)


def test_online_mix_trains_on_the_remix():
    model = build_model(_audio_conf(), device="cpu", generator=torch.Generator().manual_seed(2))
    mix, tgt = (torch.from_numpy(a) for a in _Batches(1, 0).batches[0])
    loss = _system(model, online_mix=True).backward((mix, tgt, None), torch.Generator().manual_seed(4))
    remix, remixed = online_mixing_collate(tgt[:, None], torch.Generator().manual_seed(4))
    # with autograd on, as the step runs: without it the SRU DualPathRNNs take
    # their inference route, whose float32 sums run in another order
    model.train()
    want = losses.PITLossWrapper(losses.pairwise_neg_snr)(model(remix, None), remixed).detach()
    assert abs(float(loss) - float(want)) <= 1e-6 * abs(float(want))


# ------------------------------------------------------------ checkpoints
SCORES = [3.0, 1.0, 2.0, 0.5]


def test_checkpoint_ledger_matches_jax(tmp_path):
    ours = CheckpointManager(str(tmp_path / "port"), top_k=2, config={"a": 1})
    theirs = jsystem.CheckpointManager(str(tmp_path / "jax"), top_k=2, config={"a": 1})
    extra = {"schedulers": {"plateau": {"best": math.inf, "num_bad_epochs": 0}}}
    for epoch, score in enumerate(SCORES):
        ours.save({"w": torch.full((3,), float(epoch))}, epoch, score, extra=extra)
        theirs.save({"w": np.full((3,), float(epoch))}, epoch, score, extra=extra)
    ours.save_preempt({"w": torch.zeros(3)}, 3, extra=extra)
    theirs.save_preempt({"w": np.zeros(3)}, 3, extra=extra)
    read = lambda *p: open(os.path.join(*p)).read()  # noqa: E731
    assert read(ours.exp_dir, "best_k_models.json") == read(theirs.exp_dir, "best_k_models.json")
    assert list(json.loads(read(ours.exp_dir, "best_k_models.json"))) == ["epoch1", "epoch3"]
    assert read(ours.ckpt_dir, "last.json") == read(theirs.ckpt_dir, "last.json")
    names = sorted(n[:-3] if n.endswith(".pt") else n for n in os.listdir(ours.ckpt_dir))
    assert names == sorted(os.listdir(theirs.ckpt_dir))
    for name in ("epoch1", "epoch3", "preempt"):
        assert read(ours.ckpt_dir, name + ".meta.json") == read(theirs.ckpt_dir,
                                                               name + ".meta.json")
    assert ours.best_name() == theirs.best_name() == "epoch3"
    assert torch.equal(ours.restore()["w"], torch.full((3,), 3.0))


def test_checkpoint_round_trips_training_state(tmp_path):
    model = build_model(_audio_conf(), device="cpu", generator=torch.Generator().manual_seed(5))
    system = _system(model)
    batch = tuple(torch.from_numpy(a) for a in _Batches(1, 1).batches[0]) + (None,)
    system.train_step(batch)
    system.optimizer.param_groups[0]["lr"] = 5e-4
    plateau = ReduceLROnPlateau(0.5, 2)
    plateau.step(1.0, 1e-3)
    ckpt = CheckpointManager(str(tmp_path), config={"optim": {"lr": 1e-3}})
    ckpt.save(system.state_dict(), 0, 1.0, extra={"schedulers": {"plateau": plateau.state_dict()}})

    fresh = _system(build_model(_audio_conf(), device="cpu",
                                generator=torch.Generator().manual_seed(6)))
    state, last = ckpt.restore_last(map_location="cpu")
    fresh.load_state_dict(state)
    assert fresh.step == system.step == 1 and last["epoch"] == 0
    for (n, a), (_, b) in zip(model.state_dict().items(), fresh.model.state_dict().items()):
        assert torch.equal(a, b), n
    want, got = system.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"]
    for i, s in want["state"].items():
        for k, v in s.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    restored = ReduceLROnPlateau(0.5, 2)
    restored.load_state_dict(last["schedulers"]["plateau"])
    assert restored.state_dict() == plateau.state_dict()


# --------------------------------------------------------------- tfevents
def test_crc32c_known_vectors():
    assert crc32c(b"") == 0x0
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"\x00" * 32) == 0x8A9136AA


def test_tb_events_parse_back(tmp_path):
    logger = TensorBoardLogger(str(tmp_path / "tb"))
    for step in range(5):
        logger.add_scalar("train_loss", -float(step), step)
    logger.add_scalar("val_loss", 1.5, 0)
    logger.log_hyperparams({"optim": {"lr": 1e-3}, "none_val": None, "t": (1, 2)})
    logger.finalize()
    scalars = _events(str(tmp_path))
    assert scalars["train_loss"] == [(s, -float(s)) for s in range(5)]
    assert scalars["val_loss"] == [(0, 1.5)]
    with open(tmp_path / "tb" / "default" / "version_0" / "hparams.yaml") as f:
        assert yaml.safe_load(f) == {"optim": {"lr": 1e-3}, "none_val": None, "t": [1, 2]}


# ---------------------------------------------------------- serialization
def test_serialization_round_trip(tmp_path):
    conf = _audio_conf()
    model = build_model(conf, device="cpu", generator=torch.Generator().manual_seed(7))
    path = str(tmp_path / "best_model.pth")
    serialization.save_model(path, "AVNet", conf, model.state_dict())
    blob = torch.load(path, weights_only=True)
    assert set(blob) == {"model_name", "model_args", "state_dict", "infos"}
    assert blob["infos"]["software_versions"]["torch_version"] == torch.__version__
    loaded, package = serialization.load_model(path, device="cpu")
    assert package["model_args"] == conf and not loaded.training
    for (n, a), (_, b) in zip(model.state_dict().items(), loaded.state_dict().items()):
        assert torch.equal(a, b), n
    x = torch.from_numpy(_Batches(1, 2).batches[0][0])
    with torch.no_grad():
        assert torch.equal(model(x, None), loaded(x, None))
    serialization.save_model(path, "DPTNet", conf, model.state_dict())
    with pytest.raises(ValueError, match="Could not interpret model identifier"):
        serialization.load_model(path, device="cpu")


# --------------------------------------------------- the slice as a whole
SGD = {"optimizer": "sgd", "lr": 1e-3, "momentum": 0.9, "weight_decay": 0.0}


@pytest.fixture(scope="module")
def jax_epoch(tmp_path_factory):
    """JAX's Trainer.fit for one epoch, on one device, from perturbed init
    variables."""
    conf = _audio_conf()
    jconf = copy.deepcopy(conf)
    jconf["audio_params"]["remat"] = False  # the same values, a smaller compile
    model = JaxAVNet(**jconf)
    v = jax_init(model, np.random.default_rng(1), np.zeros((1, L), np.float32))
    opt = jsystem.make_optimizer(**SGD)
    system = jsystem.System(model, opt, {"train": JaxPIT(jax_snr), "val": JaxPIT(jax_sisdr)})
    state = jsystem.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                               batch_stats={}, opt_state=opt.init(v["params"]))
    # placed as the trainer's outputs are, so the step compiles once
    replicated = NamedSharding(Mesh(np.asarray(jax.devices()[:1]), ("data",)), PartitionSpec())
    state = jax.device_put(state, replicated)
    exp_dir = str(tmp_path_factory.mktemp("jax_fit"))
    trainer = jsystem.Trainer(system, exp_dir=exp_dir, epochs=1,
                              config={"optim": {"lr": 1e-3}}, n_devices=1)
    final = trainer.fit(state, _Batches(2, 10), _Batches(1, 11))
    params = jax.tree_util.tree_map(np.asarray, final.params)
    return dict(conf=conf, v=v, exp_dir=exp_dir, params=params, step=int(final.step))


def test_trainer_epoch_matches_jax(jax_epoch, tmp_path):
    conf = jax_epoch["conf"]
    model = build_model(conf, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax_epoch["v"], conf))
    trainer = Trainer(_system(model, SGD), str(tmp_path), epochs=1,
                      config={"optim": {"lr": 1e-3}}, device="cpu")
    trainer.fit(_Batches(2, 10), _Batches(1, 11))
    assert trainer.system.step == jax_epoch["step"] == 2

    got, want = _events(str(tmp_path)), _events(jax_epoch["exp_dir"])
    assert set(got) == set(want)
    for tag in ("train_loss", "val_loss"):
        (step, g), = got[tag]
        (_, w), = want[tag]
        assert step == 0 and abs(g - w) <= 1e-4 * abs(w), (tag, g, w)
    assert got["learning_rate"] == want["learning_rate"]
    assert list(trainer.ckpt.best_k) == ["epoch0"]

    final = state_dict_from_jax({"params": jax_epoch["params"]}, conf)
    start = state_dict_from_jax(jax_epoch["v"], conf)
    moved = {name: final[name] - start[name] for name in final}
    scale = max(float(d.abs().max()) for d in moved.values())
    eps = float(np.finfo(np.float32).eps)
    still = []
    for name, p in model.state_dict().items():
        got, want = p - start[name], moved[name]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-3 * scale,
                                   err_msg=name)
        if not bool(want.abs().max() > 0):  # no gradient reaches it in the reference
            assert not bool(got.abs().max() > 0), name
            still.append(name)
            continue
        # each leaf against its own change; the second term is the float32
        # rounding of the parameters the change is taken from
        err, size = float((got - want).norm()), float(want.norm())
        assert err <= 2e-2 * size + 2 * eps * float(final[name].norm()), (name, err, size)
    # the keys' norm shifts (softmax ignores a shift of the keys) and one PReLU slope
    assert len(still) == 3, still


# ------------------------------------------------------------- preemption
class _AudioSet:
    """Audio-only items (mix, source, key), as AVSpeechDataset yields them."""

    audio_only = True

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.items = [(rng.standard_normal(L).astype(np.float32),
                       rng.standard_normal(L).astype(np.float32), f"utt{i}") for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class _Preempting:
    """Sends this process SIGTERM while handing out batch ``at_batch`` of
    epoch ``at_epoch``: the step still runs, the loop stops after it."""

    def __init__(self, loader, at_epoch, at_batch):
        self.loader, self.at = loader, (at_epoch, at_batch)
        self.epoch = -1

    def set_epoch(self, epoch):
        self.epoch = epoch
        self.loader.set_epoch(epoch)

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if (self.epoch, i) == self.at:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


def _loaders(shuffle=True):
    return (DataLoader(_AudioSet(8, 0), batch_size=4, shuffle=shuffle, worker_type="thread"),
            DataLoader(_AudioSet(4, 1), batch_size=4, worker_type="thread"))


def _trainer(exp_dir, seed=0, epochs=4):
    model = build_model(_audio_conf(), device="cpu", generator=torch.Generator().manual_seed(seed))
    return Trainer(_system(model), exp_dir, epochs=epochs, config={"optim": {"lr": 1e-3}},
                   device="cpu")


def test_sigterm_checkpoints_and_resumes(tmp_path):
    exp_dir = str(tmp_path)
    trainer = _trainer(exp_dir)
    train_loader, val_loader = _loaders()
    trainer.fit(_Preempting(train_loader, 1, 0), val_loader)
    assert trainer.system.step == 3  # epoch 0's two steps, then one of epoch 1
    last = json.load(open(os.path.join(exp_dir, "checkpoints", "last.json")))
    assert last["name"] == "preempt" and last["preempted"] and last["epoch"] == 0
    assert os.path.isfile(os.path.join(exp_dir, "checkpoints", "preempt.pt"))
    assert "preempt" not in json.load(open(os.path.join(exp_dir, "best_k_models.json")))
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL

    resumed = _trainer(exp_dir, seed=7)
    resumed.resume()
    assert resumed.start_epoch == 1 and resumed.system.step == 3
    for (n, a), (_, b) in zip(trainer.system.model.state_dict().items(),
                              resumed.system.model.state_dict().items()):
        assert torch.equal(a, b), n
    resumed.fit(train_loader, val_loader)
    assert resumed.system.step == 3 + 3 * 2  # epochs 1..3, two steps each
    assert [h["epoch"] for h in resumed.history] == [1, 2, 3]


def test_preempt_during_validation_checkpoints_immediately(tmp_path):
    class PreemptOnVal:
        def __init__(self, loader):
            self.loader, self.served = loader, 0

        def __iter__(self):
            os.kill(os.getpid(), signal.SIGTERM)
            for batch in self.loader:
                self.served += 1
                yield batch

    train_loader, _ = _loaders()
    val_loader = PreemptOnVal(DataLoader(_AudioSet(8, 1), batch_size=4, worker_type="thread"))
    trainer = _trainer(str(tmp_path))
    trainer.fit(train_loader, val_loader)
    assert trainer.system.step == 2 and val_loader.served == 1
    last = json.load(open(os.path.join(tmp_path, "checkpoints", "last.json")))
    assert last["name"] == "preempt" and last["epoch"] == 0
    resumed = _trainer(str(tmp_path), seed=7)
    resumed.resume()
    assert resumed.start_epoch == 1


def test_export_best_survives_preemption_before_first_epoch(tmp_path):
    trainer = _trainer(str(tmp_path / "a"))
    train_loader, val_loader = _loaders()
    trainer.fit(_Preempting(train_loader, 0, 0), val_loader)
    assert trainer.system.step == 1 and not trainer.ckpt.best_k
    live = {k: v.clone() for k, v in trainer.system.model.state_dict().items()}
    trainer.system.model.load_state_dict(
        build_model(_audio_conf(), device="cpu").state_dict())  # 'last' must win
    exported, _ = serialization.load_model(trainer.export_best("AVNet", _audio_conf()),
                                           device="cpu")
    for n, t in exported.state_dict().items():
        assert torch.equal(t, live[n]), n

    # no checkpoint at all: the live model, not freshly initialised weights
    bare = _trainer(str(tmp_path / "b"), seed=3)
    exported, _ = serialization.load_model(bare.export_best("AVNet", _audio_conf()),
                                           device="cpu")
    for n, t in exported.state_dict().items():
        assert torch.equal(t, bare.system.model.state_dict()[n]), n


def test_multi_device_is_not_ported(tmp_path):
    """``n_devices=2`` no longer raises (data parallel is ported,
    ``tests/test_torch_parallel.py``): without a process group it is
    clamped to the one process there is, as JAX's ``make_mesh`` clamps it to
    the devices there are, and the steps run on this device undistributed."""
    trainer = Trainer(_system(build_model(_audio_conf(), device="cpu")), str(tmp_path),
                      n_devices=2, device="cpu")
    assert (trainer.mesh.size, trainer.mesh.index, trainer.mesh.distributed) == (1, 0, False)
    assert trainer.system.replica is None


# ------------------------------------------------------------ entry point
def test_train_entry_point_on_cpu(tmp_path):
    data = tmp_path / "data"
    rng = np.random.default_rng(0)
    for split in ("tr", "cv"):
        (data / split).mkdir(parents=True)
        entries = {"mix": [], "s1": [], "s2": []}
        for i in range(2):
            for name in entries:
                p = str(data / split / f"{name}_{i}.wav")
                wavio.write(p, 0.1 * rng.standard_normal(2400).astype(np.float32), 1000)
                entries[name].append([p, 2400] if name == "mix" else [p, "none.npz", 2400])
        for name, rows in entries.items():
            with open(data / split / f"{name}.json", "w") as f:
                json.dump(rows, f)
    conf = {"videonet": {"model_name": None}, "audionet": _audio_conf(),
            "training": {"epochs": 1, "batch_size": 2, "num_workers": 2, "half_lr": True,
                         "early_stop": True, "divide_lr_by": None, "online_mix": True},
            "optim": {"optimizer": "adamw", "lr": 0.001, "weight_decay": 0.1},
            "sche": {"patience": 10, "factor": 0.5},
            "data": {"train_dir": str(data / "tr"), "valid_dir": str(data / "cv"),
                     "nondefault_nsrc": 1, "sample_rate": 1000, "segment": 2.0,
                     "normalize_audio": False},
            "log": {"path": str(tmp_path / "log"), "pro_name": "p", "exp_name": "tiny"}}
    with open(tmp_path / "conf.yaml", "w") as f:
        yaml.safe_dump(conf, f)
    argv = ["--conf-dir", str(tmp_path / "conf.yaml"), "--device", "cpu", "--audio-only", "true"]

    parsed = train.parse_conf(argv)
    assert parsed["main_args"]["device"] == "cpu" and parsed["main_args"]["audio_only"] is True
    first = train.main(parsed)
    assert first.system.online_mix and [h["epoch"] for h in first.history] == [0]
    exp_dir = os.path.join(conf["log"]["path"], "tiny")
    for name in ("conf.yaml", "best_k_models.json", "best_model.pth",
                 "checkpoints/epoch0.pt", "checkpoints/last.json"):
        assert os.path.isfile(os.path.join(exp_dir, name)), name
    assert set(_events(exp_dir)) >= {"train_loss", "val_loss", "learning_rate"}

    second = train.main(train.parse_conf(argv + ["--epochs", "2"]))  # resumes epoch 1
    assert second.start_epoch == 1 and [h["epoch"] for h in second.history] == [1]
    assert second.system.step == 4  # 4 items in batches of 2: two steps per epoch
    exported, _ = serialization.load_model(os.path.join(exp_dir, "best_model.pth"), device="cpu")
    best = torch.load(os.path.join(exp_dir, "checkpoints",
                                   second.ckpt.best_name() + ".pt"), weights_only=True)
    for n, t in exported.state_dict().items():
        assert torch.equal(t, best["model"][n]), n
