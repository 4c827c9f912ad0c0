"""Stage split of RTFS-Net-4's serving forward (``scripts/profile_serving.py``
of the JAX side) at the serving point, B = 128 in bfloat16, on one card:

    python -m rtfs_net_tpu_torch.scripts.profile_serving

Times the full forward and each top-level stage alone, with the model's
weights (seed 0): the STFT encoder, the audio and video bottlenecks, the
refinement module (4 repeats with the video net and the fusion), one
audio block, the video net's block, the fusion block, the mask generator
and the STFT decoder. Each stage runs on random bfloat16 inputs (drawn on the device) at the
shapes it receives inside the port's own forward, read by forward
pre-hooks from one B=1 forward and given the batch B (timing does not
depend on the values); a stage's inputs are freed before the next stage
(one (128, 256, 251, 129) bfloat16 tensor is 2.1 GB). Each time is the
minimum of 6 calls after a warm-up, timed by CUDA events
(``utils.profiling.timed``), call i adding i·1e-6 to the first input.

Prints a line per stage (ms, us per utterance), then the full forward,
the stage sum, the residual (what running the stages together saves or
costs), the refinement's share, repeats x one audio block and video net +
fusion, then a line of JSON. Runs on a card unless ``--device cpu``;
without one it exits 2.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import device_name, device_or_none, load_config

CONFIG = "lrs2_RTFSNet_4_layer"
BATCH, SAMPLES, FRAMES, ITERS = 128, 32000, 50, 6
# the stages of the serving forward, in the JAX script's order; the first
# six (after "full") compose the forward
STAGES = ("full", "encoder", "audio_bn", "video_bn", "refine", "audio_blk", "video_net",
          "fusion", "maskgen", "decoder")
COMPOSING = ("encoder", "audio_bn", "video_bn", "refine", "maskgen", "decoder")
LABELS = {"full": "FULL forward", "encoder": "STFTEncoder", "audio_bn": "audio bottleneck",
          "video_bn": "video bottleneck",
          "refine": "RefinementModule (repeats + video + fusion)",
          "audio_blk": "  one audio TDANetBlock", "video_net": "  video TDANet (1 repeat)",
          "fusion": "  crossmodal fusion block", "maskgen": "mask generator",
          "decoder": "STFTDecoder"}


def stage_modules(model):
    """The module each stage calls (whose forward pre-hook sees its inputs)."""
    rm = model.refinement_module

    def first_block(net):
        return net.blocks if net.shared else net.blocks[0]

    return {"full": model, "encoder": model.encoder, "audio_bn": model.audio_bottleneck,
            "video_bn": model.video_bottleneck, "refine": rm,
            "audio_blk": first_block(rm.audio_net), "video_net": first_block(rm.video_net),
            "fusion": rm.crossmodal_fusion.get_fusion_block(0),
            "maskgen": model.mask_generator, "decoder": model.decoder}


def stage_calls(model, batch, samples):
    """Each stage as a function of its tensor inputs."""
    mods = stage_modules(model)
    calls = {name: mods[name] for name in STAGES}
    calls["fusion"] = lambda a, v: mods["fusion"](a, v)[0]
    calls["decoder"] = lambda s: mods["decoder"](s, (batch, samples))
    return calls


def compose(model, mix, emb):
    """The forward run stage by stage through ``stage_calls``."""
    f = stage_calls(model, *mix.shape)
    enc = f["encoder"](mix)
    refined = f["refine"](f["audio_bn"](enc), f["video_bn"](emb))
    return f["decoder"](f["maskgen"](refined, enc))


def stage_shapes(model, device, lip_channels, samples=SAMPLES, frames=FRAMES):
    """Each stage's tensor input shapes at B = 1, read from the port's
    forward by forward pre-hooks (each module's first call)."""
    import torch

    shapes, hooks = {}, []

    def record(name):
        def hook(module, args):
            shapes.setdefault(name, [tuple(a.shape) for a in args
                                     if isinstance(a, torch.Tensor)])
        return hook

    for name, module in stage_modules(model).items():
        hooks.append(module.register_forward_pre_hook(record(name)))
    try:
        with torch.inference_mode():
            model(torch.zeros((1, samples), device=device),
                  torch.zeros((1, lip_channels, frames), device=device))
    finally:
        for h in hooks:
            h.remove()
    return shapes


def profile(device, conf=None, batch=BATCH, samples=SAMPLES, frames=FRAMES, iters=ITERS,
            log=print):
    """ms of each stage (``STAGES``) at ``batch`` in bfloat16, the shapes it
    ran at, and the repeats of the audio net."""
    import torch

    from ..models import build_model
    from ..utils.profiling import timed

    conf = conf or load_config(CONFIG)
    model = build_model(conf, device=device)
    shapes = {name: [(batch, *s[1:]) for s in ss]
              for name, ss in stage_shapes(
        model, device, conf["audionet"]["pretrained_vout_chan"], samples, frames).items()}
    calls = stage_calls(model, batch, samples)
    ms = {}
    for name in STAGES:
        # drawn on the device: numpy would take seconds a (128, 256, 251, 129) tensor
        gen = torch.Generator(device=device).manual_seed(0)
        args = [torch.randn(s, generator=gen, device=device, dtype=torch.bfloat16)
                for s in shapes[name]]
        with torch.inference_mode():
            ms[name] = timed(calls[name], lambda i: (args[0] + i * 1e-6, *args[1:]),
                             iters=iters)["min_ms"]
        del args
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if log is not None:
            log(f"{LABELS[name]:48s} {ms[name]:8.2f} ms  ({ms[name] / batch * 1e3:6.1f} "
                f"us/utt)", flush=True)
    rm = model.refinement_module
    return ms, shapes, rm.fusion_repeats + rm.audio_repeats


def summary(ms, repeats):
    """The full forward, the stage sum and its residual, the refinement's
    share, repeats x one audio block and the video net with the fusion."""
    accounted = sum(ms[name] for name in COMPOSING)
    return {"full_ms": ms["full"], "stage_sum_ms": accounted,
            "residual_ms": ms["full"] - accounted,
            "refine_share": ms["refine"] / ms["full"], "repeats": repeats,
            "audio_blocks_ms": repeats * ms["audio_blk"],
            "video_and_fusion_ms": ms["video_net"] + ms["fusion"]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = device_or_none("profile_serving", p.parse_args(argv).device)
    if device is None:
        return 2
    print(f"device={device_name(device)}  B={BATCH} dtype=bfloat16", flush=True)
    ms, shapes, repeats = profile(device)
    s = summary(ms, repeats)
    print(f"\nfull {s['full_ms']:.2f} ms; stage sum {s['stage_sum_ms']:.2f} ms "
          f"(residual {s['residual_ms']:+.2f} = what running the stages together changes)")
    print(f"refinement = {s['refine_share'] * 100:.0f}% of full; {repeats}x audio block = "
          f"{s['audio_blocks_ms']:.2f} ms, video+fusion = {s['video_and_fusion_ms']:.2f} ms")
    print(json.dumps({"tool": "profile_serving", "device": device_name(device),
                      "batch": BATCH, "dtype": "bfloat16", "stage_ms": ms, "shapes": shapes,
                      **s}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
