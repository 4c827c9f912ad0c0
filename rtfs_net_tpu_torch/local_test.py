"""Synthetic end-to-end smoke run (the JAX package's root ``local_test.py``;
reference: ``local_test.py``): a fake dataset of random tensors drives the
build, ``Trainer.fit``, checkpoint and export path for one epoch on one
device, then reloads the exported model and runs it.

    python -m rtfs_net_tpu_torch.local_test [--conf-dir ...] [--check-only] \
        [--epochs N] [--device cuda|cpu]

``--check-only`` builds the model and prints its params/MACs report, then
exits (reference ``local_test.py:64-65``). A config without a
``videonet.model_name`` runs audio-only.

This module imports no torch at the top: the data loader's spawned
workers import it again to unpickle the fake dataset.
"""
import argparse
import os
import time

import numpy as np
import yaml


class FakeAVSpeechDataset:
    """Random-tensor dataset with the reference's sample shapes
    (local_test.py:22-35): 2 s mixtures and (1, 50, 88, 88) mouths."""

    def __init__(self, n_items=8, sample_rate=16000, seconds=2, frames=50,
                 audio_only=False, seed=0):
        self.n = n_items
        self.L = sample_rate * seconds
        self.frames = frames
        self.audio_only = audio_only
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng((self.seed, idx))
        mix = rng.standard_normal(self.L).astype(np.float32)
        src = rng.standard_normal(self.L).astype(np.float32)
        if self.audio_only:
            return mix, src, f"utt{idx}"
        mouth = rng.standard_normal((1, self.frames, 88, 88)).astype(np.float32)
        return mix, src, mouth, f"utt{idx}"


def main(args):
    import torch

    from .datas import DataLoader
    from .losses import PITLossWrapper, pairwise_neg_sisdr, pairwise_neg_snr
    from .models import build_model, build_video_model, resolve_device
    from .models.serialization import load_model
    from .system import System, Trainer, make_optimizer
    from .utils.flops import count_params, model_macs_report

    device = resolve_device(args.device)
    with open(args.conf_dir) as f:
        conf = yaml.safe_load(f)
    audio_only = not (conf.get("videonet") or {}).get("model_name")

    t0 = time.time()
    model = build_model(conf["audionet"], device=device)
    print(f"model built in {time.time() - t0:.1f}s: {count_params(model) / 1e6:.3f} M params")
    mix = torch.zeros((1, 32000), device=device)
    emb = None if audio_only else torch.zeros(
        (1, conf["audionet"]["pretrained_vout_chan"], 50), device=device)
    if args.check_only:
        print(model_macs_report(model, mix, emb))
        return None

    # a frozen video model from a seed (no pretrained backbone in the smoke run)
    video = None if audio_only else build_video_model(conf["videonet"], device=device)
    system = System(
        model, make_optimizer(model.parameters(), **conf["optim"]),
        {"train": PITLossWrapper(pairwise_neg_snr), "val": PITLossWrapper(pairwise_neg_sisdr)},
        video_model=video)
    loaders = [DataLoader(FakeAVSpeechDataset(n, audio_only=audio_only, seed=seed),
                          args.batch_size, shuffle=shuffle, num_workers=2)
               for n, seed, shuffle in ((args.items, 0, True), (args.items // 2, 1, False))]
    try:
        exp_dir = args.exp_dir or os.path.join("log", "local_test")
        trainer = Trainer(system, exp_dir=exp_dir, epochs=args.epochs, config=conf,
                          sche_patience=conf["sche"]["patience"],
                          sche_factor=conf["sche"]["factor"], device=device)
        t1 = time.time()
        trainer.fit(*loaders)
        print(f"trained {args.epochs} epoch(s) in {time.time() - t1:.1f}s")
    finally:
        for loader in loaders:
            loader.close()
    best = trainer.export_best("AVNet", conf["audionet"])
    print(f"exported {best}")

    # reload and run the exported model (the reference's serialize round trip)
    reloaded, _ = load_model(best, device=device)
    with torch.inference_mode():
        out = reloaded(mix, emb)
    print(f"reloaded best model forward: {tuple(out.shape)}")
    return trainer


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf-dir",
                        default="rtfs_net_tpu_torch/configs/lrs2_RTFSNet_4_layer.yaml")
    parser.add_argument("--check-only", action="store_true")
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--items", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--exp-dir", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
