"""Gradient-coverage check (the JAX package's root ``find_unused_params.py``;
reference ``find_unused_params.py``).

    python -m rtfs_net_tpu_torch.find_unused_params \
        [--conf-dir rtfs_net_tpu_torch/configs/lrs2_RTFSNet_4_layer.yaml] [--device cuda|cpu]

Builds the config's AVNet (weights from seed 0, eval mode, as the JAX CLI
applies it), runs one forward and backward of ``PITLossWrapper(
pairwise_neg_snr)`` on a (1, 32000) mixture and a (1, pretrained_vout_chan,
50) lip embedding from ``np.random.default_rng(0)``, with the mixture as
the target, and prints the state-dict names of the parameters that got no
gradient: none at all, or all zeros (JAX gives every parameter a gradient
array, so all zeros is its test).
"""
import argparse

import numpy as np
import yaml


def unused_parameters(model, mix, mouth_emb):
    """Names of ``model``'s parameters whose gradient is None or all zeros
    after one backward of the PIT neg-SNR loss of ``model(mix, mouth_emb)``
    against ``mix``."""
    from .losses import PITLossWrapper, pairwise_neg_snr

    model.zero_grad(set_to_none=True)
    PITLossWrapper(pairwise_neg_snr)(model(mix, mouth_emb), mix[:, None, :]).backward()
    return [name for name, p in model.named_parameters()
            if p.grad is None or not bool(p.grad.any())]


def main(args):
    import torch

    from .models import build_model

    with open(args.conf_dir) as f:
        conf = yaml.safe_load(f)
    model = build_model(conf["audionet"], device=args.device)
    device = next(model.parameters()).device
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((1, 32000)).astype(np.float32)
    mouth_emb = rng.standard_normal(
        (1, conf["audionet"]["pretrained_vout_chan"], 50)).astype(np.float32)
    unused = unused_parameters(model, torch.from_numpy(mix).to(device),
                               torch.from_numpy(mouth_emb).to(device))
    if unused:
        print(f"{len(unused)} params with zero gradient:")
        for name in unused:
            print("  ", name)
    else:
        print("all parameters receive gradient")
    return unused


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf-dir",
                        default="rtfs_net_tpu_torch/configs/lrs2_RTFSNet_4_layer.yaml")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
