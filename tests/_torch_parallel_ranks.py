"""What each rank of ``tests/test_torch_parallel.py``'s process group runs
(``rtfs_net_tpu_torch.parallel.launch`` imports ``all_cases`` by name in
its spawned processes). Imports torch and the port only."""
import os
import signal

import numpy as np
import torch
import torch.distributed as dist

from rtfs_net_tpu_torch import losses
from rtfs_net_tpu_torch.datas import DataLoader
from rtfs_net_tpu_torch.evaluation import run_batched_eval
from rtfs_net_tpu_torch.metrics import ALLMetricsTracker
from rtfs_net_tpu_torch.models import build_model
from rtfs_net_tpu_torch.parallel import make_mesh, make_parallel_train_step, shard_batch
from rtfs_net_tpu_torch.system import System, Trainer, make_optimizer


def system_of(conf, state, optimizer="adamw", **kw):
    """A float32 ``System`` of ``conf`` holding ``state`` (numpy arrays by
    key), lr 1e-3, weight decay 0.1."""
    model = build_model(conf, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    opt = make_optimizer(model.parameters(), optimizer, lr=1e-3, weight_decay=0.1)
    return System(model, opt, {"train": losses.PITLossWrapper(losses.pairwise_neg_snr),
                               "val": losses.PITLossWrapper(losses.pairwise_neg_sisdr)},
                  **kw)


def step_result(system, out):
    """The loss, the grad norm, and every parameter, (clipped) gradient and
    buffer by name, as numpy."""
    model = system.model
    return {"loss": float(out["loss"]), "grad_norm": float(out["grad_norm"]),
            "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()},
            "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
            "buffers": {n: b.numpy().copy() for n, b in model.named_buffers()}}


def train_step(case):
    """One data-parallel step of the global ``case["batch"]`` (numpy; None
    for no mouths) over the ranks ``make_mesh`` picks for it; None on a
    rank outside the mesh."""
    system = system_of(case["conf"], case["state"], case.get("optimizer", "adamw"),
                       **case.get("system", {}))
    batch = tuple(None if a is None else torch.from_numpy(a) for a in case["batch"])
    mesh = make_mesh(batch_size=len(batch[0]))
    step = make_parallel_train_step(system, mesh)
    out = step(shard_batch(batch, mesh), torch.Generator().manual_seed(case["seed"]))
    if out is None:
        return None
    result = step_result(system, out)
    result["mesh"] = (mesh.size, mesh.index)
    result["replica"] = type(system.replica).__name__
    result["sync_bn"] = sorted({type(m).__name__ for m in system.model.modules()
                                if "BatchNorm" in type(m).__name__})
    if case.get("checkpoint"):
        # this rank's checkpoint; a second step (DDP, built without
        # find_unused_parameters, raises in it if the first left a
        # parameter without gradient); then a one-device checkpoint loaded back
        if dist.get_rank() == 0:
            torch.save(system.state_dict(), case["checkpoint"])
        result["second_loss"] = float(step(shard_batch(batch, mesh))["loss"])
        system.load_state_dict(torch.load(case["plain_checkpoint"], weights_only=True))
        result["reloaded"] = {n: t.numpy().copy()
                              for n, t in system.model.state_dict().items()}
    return result


class AudioSet:
    """Audio-only items (mix, source, key) of ``length`` samples."""

    audio_only = True

    def __init__(self, n, seed, length):
        rng = np.random.default_rng(seed)
        self.items = [(rng.standard_normal(length).astype(np.float32),
                       rng.standard_normal(length).astype(np.float32), f"utt{i}")
                      for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class SignalOn:
    """Sends this process SIGTERM while handing out batch ``at[1]`` of epoch
    ``at[0]`` (the step still runs)."""

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


def fit(case):
    """``Trainer.fit`` over the ranks on sharded loaders (global batch 4),
    one rank signalled mid-epoch; returns the step reached, the history
    and the parameters."""
    rank = dist.get_rank()
    system = system_of(case["conf"], case["state"], "sgd")
    trainer = Trainer(system, case["exp_dir"], epochs=3, config={"training": {"batch_size": 4}},
                      device="cpu")
    n, i = trainer.mesh.size, trainer.mesh.index
    train = DataLoader(AudioSet(16, 0, case["length"]), batch_size=4 // n, shuffle=True,
                       shard_index=i, num_shards=n, worker_type="thread")
    val = DataLoader(AudioSet(4, 1, case["length"]), batch_size=4 // n, shard_index=i,
                     num_shards=n, worker_type="thread")
    if rank == case["signalled"]:
        train = SignalOn(train, (1, 1))
    trainer.fit(train, val)
    return {"step": system.step, "history": [(h["train_loss"], h["val_loss"])
                                              for h in trainer.history],
            "params": {n: p.detach().numpy().copy()
                       for n, p in system.model.named_parameters()}}


class RowTracker(ALLMetricsTracker):
    """The metrics tracker, also keeping each utterance's row by key."""

    def __init__(self):
        super().__init__()
        self.rows = {}

    def ingest(self, row):
        super().ingest(row)
        self.rows[row["snt_id"]] = row


def evaluate(case):
    """``run_batched_eval`` of ``case["test_set"]`` over the ranks; rank 0
    returns the per-utterance rows."""
    model = build_model(case["conf"], device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"].items()})
    tracker = RowTracker() if dist.get_rank() == 0 else None
    stats = run_batched_eval(model=model, test_set=case["test_set"], metrics=tracker,
                             loss_func=losses.PITLossWrapper(losses.pairwise_neg_sisdr),
                             video_apply=None, bucket=case["bucket"],
                             eval_batch_size=case["eval_batch_size"], sample_rate=16000,
                             progress_every=0, metric_workers=1)
    return {"ranks": stats["ranks"], "utterances": stats["utterances"],
            "rows": None if tracker is None else tracker.rows}


def all_cases(cases):
    """Every case of ``cases`` (name -> (function name, argument)) on this
    rank, in order, on one intra-op thread."""
    torch.set_num_threads(1)
    return {name: globals()[fn](arg) for name, (fn, arg) in cases.items()}


def dryrun(n_devices):
    """``dryrun_multichip`` on this rank of the group."""
    from rtfs_net_tpu_torch.dryrun import dryrun_multichip

    return dryrun_multichip(n_devices, "cpu")


def fail_on_rank(rank):
    """Raises on ``rank``; the others wait in a barrier that never completes."""
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails")
    dist.barrier()
