"""The multi-device dry run (``__graft_entry__.dryrun_multichip``'s
counterpart):

    python -m rtfs_net_tpu_torch.dryrun [N] [--device cuda|cpu]

Over N ranks (the calling process group's, or N spawned processes), one
full RTFS-Net-4 training step (``configs/lrs2_RTFSNet_4_layer.yaml``,
weights from seed 0) from raw (B, 1, 4, 88, 88) mouth frames through
``FRCNNVideoModel(resnet, prelu)`` with ``train_video_model=True``:
forward, PIT neg-SNR, gradients of the audio and the video parameters
averaged over the ranks, the clip and AdamW, BatchNorm statistics over the
global batch; one 2000-sample utterance per rank (the shortest the model
runs), two on a single rank: the video TDANet's BatchNorm1d sees one time
step per utterance at its coarsest scale (4 frames halved three times),
and PyTorch refuses batch statistics of one value (JAX takes a zero
variance). It checks that the loss is finite and that the video parameters
moved; then the sharded evaluation (``evaluation.run_batched_eval``) of
max(N - 2, 1) utterances of two bucket lengths, PESQ off, checking that
the means are finite.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                      "lrs2_RTFSNet_4_layer.yaml")
L, TV, SAMPLE_RATE = 2000, 4, 16000


@contextlib.contextmanager
def _pesq_off():
    previous = os.environ.get("RTFS_PESQ_BACKEND")
    os.environ["RTFS_PESQ_BACKEND"] = "none"
    try:
        yield
    finally:
        if previous is None:
            del os.environ["RTFS_PESQ_BACKEND"]
        else:
            os.environ["RTFS_PESQ_BACKEND"] = previous


def _dryrun(n_devices: int, device) -> dict:
    """The dry run on this rank of an ``n_devices``-rank process group;
    returns the loss, the step count and (rank 0) the evaluation's means."""
    import yaml

    from .evaluation import run_batched_eval
    from .losses import PITLossWrapper, pairwise_neg_sisdr, pairwise_neg_snr
    from .metrics import ALLMetricsTracker
    from .models import build_model, build_video_model
    from .parallel import local_device, make_mesh, make_parallel_train_step, shard_batch
    from .system import System, make_optimizer

    device = local_device(device)
    rank0 = dist.get_rank() == 0
    with open(CONFIG) as f:
        conf = yaml.safe_load(f)
    model = build_model(conf["audionet"], device=device)
    video = build_video_model({"model_name": "FRCNNVideoModel", "backbone_type": "resnet",
                               "relu_type": "prelu"}, device=device,
                              generator=torch.Generator().manual_seed(1))
    system = System(model, make_optimizer(model.parameters(), **conf["optim"]),
                    {"train": PITLossWrapper(pairwise_neg_snr),
                     "val": PITLossWrapper(pairwise_neg_sisdr)},
                    video_model=video, train_video_model=True)
    B = n_devices if n_devices > 1 else 2  # see the module's docstring
    rng = np.random.default_rng(0)
    mouths = torch.from_numpy(rng.standard_normal((B, 1, TV, 88, 88)).astype(np.float32))
    mix = torch.from_numpy(rng.standard_normal((B, L)).astype(np.float32))
    mesh = make_mesh(n_devices, batch_size=B)
    step = make_parallel_train_step(system, mesh)
    batch = shard_batch(tuple(t.to(device) for t in (mix, mix[:, None], mouths)), mesh)
    vp0 = next(video.parameters()).detach().clone()
    metrics = step(batch, torch.Generator(device=device).manual_seed(1))
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip({n_devices}): loss {loss}")
    if torch.equal(vp0, next(video.parameters()).detach()):
        raise RuntimeError("video params did not update under train_video_model=True")
    if rank0:
        print(f"dryrun_multichip({n_devices}): ok, loss={loss:.3f}, step={system.step}",
              flush=True)

    # the sharded evaluation over the same ranks: variable lengths in two
    # buckets, a partial batch (>= 1 utterance, so 2 ranks still score one)
    n_utts = max(n_devices - 2, 1)
    test_set = []
    for i in range(n_utts):
        li = L + 500 * (i % 2)
        tv = -(-li * 25 // SAMPLE_RATE)
        test_set.append((rng.standard_normal(li).astype(np.float32),
                         rng.standard_normal((1, li)).astype(np.float32),
                         rng.standard_normal((1, tv, 88, 88)).astype(np.float32),
                         f"utt{i}.wav"))
    system.model.eval()
    with tempfile.TemporaryDirectory() as td, _pesq_off():
        tracker = (ALLMetricsTracker(save_file=os.path.join(td, "metrics.csv"))
                   if rank0 else None)
        run_batched_eval(model=system.model, test_set=test_set, metrics=tracker,
                         loss_func=PITLossWrapper(pairwise_neg_sisdr), video_apply=video,
                         bucket=500, eval_batch_size=n_devices, sample_rate=SAMPLE_RATE,
                         progress_every=0)
        means = None
        if rank0:
            tracker.final()
            # PESQ is off: its column is NaN by construction
            means = {k: v for k, v in tracker.get_mean().items() if k != "pesq"}
            if not means or not all(math.isfinite(v) for v in means.values()):
                raise RuntimeError(f"dryrun_multichip({n_devices}): eval means {means}")
            print(f"dryrun_multichip({n_devices}): eval ok over {n_utts} utts, "
                  f"si-snr={means.get('si-snr', float('nan')):.2f}", flush=True)
    return {"loss": loss, "step": system.step, "eval_means": means}


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The dry run over ``n_devices`` ranks: those of the calling process
    group (which must have that many), or else ``n_devices`` spawned
    processes (``parallel.launch``; NCCL on the cards, gloo for the CPU).
    Returns rank 0's result."""
    from .parallel import launch

    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) in a process group of "
                             f"{dist.get_world_size()} ranks")
        return _dryrun(n_devices, device)
    return launch(_dryrun, n_devices, (n_devices, device), device=device)[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n_devices", nargs="?", type=int, default=None,
                   help="ranks (default: every visible card)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    n = args.n_devices or max(torch.cuda.device_count(), 1)
    return dryrun_multichip(n, args.device)


if __name__ == "__main__":
    main()
