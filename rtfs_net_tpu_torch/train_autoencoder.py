"""Lip-autoencoder pretraining entry point (the JAX package's root
``train_autoencoder.py``; reference ``train_autoencoder.py``).

    python -m rtfs_net_tpu_torch.train_autoencoder \
        [--train-dir data_preprocess/LRS2/tr] [--valid-dir data_preprocess/LRS2/cv] \
        [--exp-dir log/autoencoder] [--epochs 200] [--batch-size 40] [--lr 1e-3] \
        [--base-channels 4] [--num-layers 3] [--device cuda|cpu]

Trains the conv autoencoder (``models.videomodels.AE``) on the mouth tracks
listed in each split's ``s1.json``, every frame on its own: the loss is the
MSE between a frame and its reconstruction, the optimizer Adam. Each epoch's
mean train and validation losses go to stdout and to TensorBoard under
``<exp-dir>/tb``.

Checkpoint format: ``<exp-dir>/best_model.ckpt`` is ``torch.save`` of the
best epoch's **encoder** ``state_dict()`` (keys ``layer{i}.conv.weight``,
``layer{i}.conv.bias``, ``layer{i}.norm.weight``, ``layer{i}.norm.bias``;
float32 CPU tensors). A ``videonet`` block with ``model_name: AEVideoModel``
names it as its ``pretrain``, and ``train.build_video_model`` loads it
through ``utils.convert.load_video_backbone``. The JAX CLI writes flax
msgpack instead, which this package neither reads nor writes.
``<exp-dir>/best_k_models.json`` maps ``epoch{i}`` to that epoch's
validation loss.

This module imports no torch at the top: the data loader's workers
unpickle ``MouthFramesDataset`` by importing it.
"""
import argparse
import json
import os
import time

import numpy as np


class MouthFramesDataset:
    """Mouth-only dataset (reference ``videomodels/autoencoder/
    datamodule.py``): each item is the npz mouth track of one ``s1.json``
    row, through the ``val`` frame pipeline (88x88 centre crop, normalized),
    cut to ``segment_frames``, as a (1, T, 88, 88) float32 clip."""

    def __init__(self, json_dir, segment_frames=50):
        from .datas.transform import get_preprocessing_pipelines

        with open(os.path.join(json_dir, "s1.json")) as f:
            infos = json.load(f)
        self.paths = [i[1] for i in infos if len(i) > 2]
        self.segment_frames = segment_frames
        self.pipeline = get_preprocessing_pipelines()["val"]

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        frames = np.load(self.paths[idx])["data"]
        frames = self.pipeline(frames)[: self.segment_frames]
        return (frames[None].astype(np.float32),)


def frame_loss(model, frames):
    """MSE of the autoencoder on every frame of a (B, C, T, H, W) batch,
    taken as B·T images."""
    B, C, T, H, W = frames.shape
    x = frames.transpose(1, 2).reshape(B * T, C, H, W)
    return ((model(x) - x) ** 2).mean()


def train_step(model, optimizer, frames):
    """One Adam step on ``frame_loss``; returns the loss (a detached tensor)."""
    optimizer.zero_grad(set_to_none=True)
    loss = frame_loss(model, frames)
    loss.backward()
    optimizer.step()
    return loss.detach()


def main(args):
    """Train as ``args`` says; returns ``{"history": per-epoch dicts,
    "best_model": the checkpoint's path or None, "best_k": the json's
    mapping}``."""
    import torch

    from .datas import DataLoader
    from .models import init_weights, resolve_device
    from .models.videomodels import AE
    from .system.tb_writer import TensorBoardLogger

    device = resolve_device(args.device)
    model = init_weights(AE(in_channels=1, base_channels=args.base_channels,
                            num_layers=args.num_layers), torch.Generator().manual_seed(0))
    model = model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)

    def upload(frames):
        return torch.from_numpy(frames).to(device, non_blocking=True)

    exp_dir = args.exp_dir
    os.makedirs(exp_dir, exist_ok=True)
    best_path = os.path.join(exp_dir, "best_model.ckpt")
    logger = TensorBoardLogger(os.path.join(exp_dir, "tb"), name="baseline")
    train_loader = DataLoader(MouthFramesDataset(args.train_dir), args.batch_size, shuffle=True)
    val_loader = DataLoader(MouthFramesDataset(args.valid_dir), args.batch_size)
    best, best_k, history, saved = float("inf"), {}, [], None
    try:
        for epoch in range(args.epochs):
            t0 = time.perf_counter()
            train_loader.set_epoch(epoch)
            losses = [train_step(model, optimizer, upload(frames))
                      for (frames,) in train_loader]
            tl = float(torch.stack(losses).mean()) if losses else float("nan")
            train_s = time.perf_counter() - t0
            with torch.no_grad():
                val_losses = [frame_loss(model, upload(frames)) for (frames,) in val_loader]
            vl = float(torch.stack(val_losses).mean()) if val_losses else float("nan")
            logger.add_scalar("train/loss", tl, epoch)
            logger.add_scalar("val/loss", vl, epoch)
            print(f"epoch {epoch}: train={tl:.5f} val={vl:.5f}")
            best_k[f"epoch{epoch}"] = vl
            if vl < best:
                best = vl
                # the encoder only (reference train_autoencoder.py:75)
                torch.save({k: t.detach().cpu() for k, t in model.encoder.state_dict().items()},
                           best_path)
                saved = best_path
            history.append({"epoch": epoch, "train_loss": tl, "val_loss": vl,
                            "train_steps": len(losses),
                            "ms_per_step": train_s / max(1, len(losses)) * 1e3,
                            "wall_s": time.perf_counter() - t0})
    finally:
        train_loader.close()
        val_loader.close()
        logger.finalize()
    with open(os.path.join(exp_dir, "best_k_models.json"), "w") as f:
        json.dump(best_k, f, indent=0)
    print("Finished Training")
    return {"history": history, "best_model": saved, "best_k": best_k}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train-dir", default="data_preprocess/LRS2/tr")
    parser.add_argument("--valid-dir", default="data_preprocess/LRS2/cv")
    parser.add_argument("--exp-dir", default="log/autoencoder")
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--batch-size", type=int, default=40)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--base-channels", type=int, default=4)
    parser.add_argument("--num-layers", type=int, default=3)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
