#!/usr/bin/env python3
"""Peak device memory of one RTFS-Net-4 train step of the PyTorch port
(``rtfs_net_tpu_torch``), float32 at B=16, under a few backend settings,
to tell activations from convolution workspace.

    python3 scripts/torch_train_memory.py     # needs one CUDA card and nvcc

Each variant builds the model from seed 0, runs two steps (AdamW, PIT
neg-SNR, the target is the mixture) and prints one JSON line with the peak
of ``torch.cuda.max_memory_allocated`` over the second step, and the step
time. Variants: TF32 off with cuDNN (the setting of the card tests'
float32 runs), TF32 on, cuDNN off, and bfloat16 with TF32 off.
"""
import copy
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def make_system(model, conf, dtype):
    """``System`` with the config's optimizer and the PIT losses."""
    import torch

    from rtfs_net_tpu_torch.losses import PITLossWrapper, pairwise_neg_sisdr, pairwise_neg_snr
    from rtfs_net_tpu_torch.system import System, make_optimizer

    return System(model, make_optimizer(model.parameters(), **conf["optim"]),
                  {"train": PITLossWrapper(pairwise_neg_snr),
                   "val": PITLossWrapper(pairwise_neg_sisdr)},
                  compute_dtype=None if dtype == torch.float32 else dtype)


def train_batch(B, gen):
    """A (mix, target, lip embedding) batch; the target is the mixture."""
    import torch

    mix = torch.randn((B, 32000), generator=gen, device="cuda")
    return mix, mix[:, None], 0.1 * torch.randn((B, 512, 50), generator=gen, device="cuda")


def main():
    import torch

    from rtfs_net_tpu_torch.models import build_model
    from rtfs_net_tpu_torch.scripts import load_config

    if not torch.cuda.is_available():
        print("torch_train_memory: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    conf = load_config("lrs2_RTFSNet_4_layer")
    base = build_model(conf["audionet"], device="cuda", generator=torch.Generator().manual_seed(0))
    batch = train_batch(16, torch.Generator(device="cuda").manual_seed(3))
    variants = [("tf32_off", torch.float32, False, True), ("tf32_on", torch.float32, True, True),
                ("cudnn_off", torch.float32, False, False),
                ("bf16_tf32_off", torch.bfloat16, False, True)]
    for name, dtype, tf32, cudnn in variants:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.enabled = cudnn
        system = make_system(copy.deepcopy(base), conf, dtype)
        gen = torch.Generator(device="cuda").manual_seed(4)
        system.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        system.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        print(json.dumps({"variant": name, "B": 16, "ms_per_step": (time.perf_counter() - t0) * 1e3,
                          "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2 ** 30}))
        del system
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
