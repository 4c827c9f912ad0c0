"""Audio-visual training proof (``scripts/av_train_proof.py`` of the JAX
side): raw mouth frames go through a *trainable* FRCNN video model
(ResNet-18 trunk, PReLU) into RTFS-Net-4's CAF fusion, and the pair
overfits a small batch:

    python -m rtfs_net_tpu_torch.scripts.av_train_proof [--device cpu]

Two 2 s N(0, 1) sources, each mixed with half of an N(0, 1) noise, and
(2, 1, 50, 88, 88) frames of N(0, 0.3²) (the JAX script's arrays, from
``numpy.random.default_rng(0)``); RTFS-Net-4 from seed 0 and the video
model from seed 1; ``System(..., video_model=, train_video_model=True,
compute_dtype=torch.bfloat16)`` with AdamW (lr 1e-3, weight decay 0.1),
which joins the video model's parameters to the optimizer; 120 steps,
dropout masks from a ``torch.Generator`` seeded 2. The video model's
BatchNorms keep their running statistics, as in the JAX package and the
reference (``frcnn_videomodel.py:78-83``); its weights train.

It prints the loss at steps 0, 20, ..., 100 and 119, how many video
parameters moved, the start and end of the SI-SDR proxy (the negated
train loss), ms per step, the kernel launches and a last line of JSON. It
exits 1 unless every video parameter moved (the JAX script prints that
check; here it is a hard one), 2 when asked for a card and there is none.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import device_name, device_or_none, load_config
from .train_proof import fit, make_system

CONFIG = "lrs2_RTFSNet_4_layer"
STEPS, BATCH, SAMPLES, FRAMES, MOUTH = 120, 2, 32000, 50, 88
LOG_EVERY = 20
OPTIM = {"optimizer": "adamw", "lr": 1e-3, "weight_decay": 0.1}
VIDEONET = {"model_name": "FRCNNVideoModel", "backbone_type": "resnet", "relu_type": "prelu"}


def av_batch(batch=BATCH, samples=SAMPLES, frames=FRAMES, size=MOUTH):
    """(mix, targets, mouth frames) as numpy (``scripts/av_train_proof.py:18-23``)."""
    rng = np.random.default_rng(0)
    src = rng.standard_normal((batch, samples)).astype(np.float32)
    noise = rng.standard_normal((batch, samples)).astype(np.float32)
    mouths = rng.standard_normal((batch, 1, frames, size, size)).astype(np.float32) * 0.3
    return src + 0.5 * noise, src[:, None], mouths


def moved(before, module):
    """How many of ``module``'s parameters differ from ``before`` (clones
    taken earlier), and how many there are."""
    after = list(module.parameters())
    return sum(not bool((a == b).all()) for a, b in zip(after, before)), len(after)


def run(device, conf=None, steps=STEPS, arrays=None):
    """The proof on ``device``: returns ``fit``'s result with the video
    parameters moved (``video_moved``, ``video_params``) and the kernel
    launches."""
    import torch

    from ..bench import launched
    from ..models import build_model, build_video_model

    conf = conf or load_config(CONFIG)
    model = build_model(conf, device=device)
    video = build_video_model(VIDEONET, device=device,
                              generator=torch.Generator().manual_seed(1))
    system = make_system(model, OPTIM, video_model=video, train_video_model=True,
                         compute_dtype=torch.bfloat16)
    before = [p.detach().clone() for p in video.parameters()]
    tensors = tuple(torch.from_numpy(a).to(device) for a in (arrays or av_batch()))
    generator = torch.Generator(device=device).manual_seed(2)
    out, launches = launched(lambda: fit(system, tensors, steps, generator, LOG_EVERY,
                                         validate=False, log=None))
    out["video_moved"], out["video_params"] = moved(before, video)
    out["launches"] = launches
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = device_or_none("av_train_proof", p.parse_args(argv).device)
    if device is None:
        return 2
    out = run(device)
    losses = out["losses"]
    for i, loss in enumerate(losses):
        if i % LOG_EVERY == 0 or i == len(losses) - 1:
            print(f"step {i}: loss {loss:.2f}")
    ok = out["video_moved"] == out["video_params"]
    print(f"video params updated: {ok} ({out['video_moved']} of {out['video_params']} moved)")
    print(f"SI-SDR proxy: start {-losses[0]} end {-losses[-1]}; "
          f"{out['ms_per_step']:.1f} ms/step; launches {json.dumps(out['launches'])}")
    print(json.dumps({"tool": "av_train_proof", "device": device_name(device),
                      "proxy_start_db": -losses[0], "proxy_end_db": -losses[-1],
                      **{k: out[k] for k in ("video_moved", "video_params", "ms_per_step",
                                             "launches")}}))
    if not ok:
        print("AV TRAINING PROOF FAILED: the video parameters did not all move",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
