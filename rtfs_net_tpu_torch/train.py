"""Training entry point (the JAX package's ``train.py``; reference:
``train.py``).

    python -m rtfs_net_tpu_torch.train \
        --conf-dir rtfs_net_tpu_torch/configs/lrs2_RTFSNet_4_layer.yaml \
        [--checkpoint <name>] [--device cuda|cpu]

Builds the loaders, the model, its video model and the optimizer from the
YAML config (every second-level leaf is a CLI flag), resumes from the
experiment's last checkpoint, trains and exports the best model as
``<log.path>/<log.exp_name>/best_model.pth``.

Data parallel: ``torchrun --nproc_per_node=N -m rtfs_net_tpu_torch.train
...`` starts one process per card; they join one process group
(``parallel.initialize``) and train data-parallel, ``training.batch_size``
being the global batch (each rank reads its shard of it) and rank 0
writing the checkpoints, the logs and the export. Without ``torchrun`` it
trains on one device.

This module imports no torch at the top: the data loader's spawned
workers import the main module again.
"""
import argparse
import os

import yaml

from .utils import parse_args_as_dict, prepare_parser_from_dict, str2bool_arg


def build_dataloaders(conf, shard_index=0, num_shards=1):
    """The train and validation loaders; with ``num_shards`` ranks, this
    rank's shard of each global batch of ``training.batch_size``."""
    from .datas import AVSpeechDataset, DataLoader

    audio_only = conf["main_args"].get("audio_only", False)
    sets = [AVSpeechDataset(
        json_dir=conf["data"][split],
        n_src=conf["data"]["nondefault_nsrc"],
        sample_rate=conf["data"]["sample_rate"],
        segment=conf["data"]["segment"],
        normalize_audio=conf["data"]["normalize_audio"],
        audio_only=audio_only,
    ) for split in ("train_dir", "valid_dir")]
    return tuple(DataLoader(
        ds, batch_size=conf["training"]["batch_size"] // num_shards, shuffle=shuffle,
        num_workers=conf["training"]["num_workers"], drop_last=True,
        shard_index=shard_index, num_shards=num_shards,
    ) for ds, shuffle in zip(sets, (True, False)))


def build_video_model(conf, device="cuda"):
    """The video model of ``conf["videonet"]`` on ``device`` (weights from
    seed 0, frozen), with the published backbone from ``videonet.pretrain``
    loaded when that file exists; None for audio-only runs."""
    import torch

    from .models import build_video_model as build
    from .utils.convert import load_video_backbone

    videonet = conf.get("videonet") or {}
    if not videonet.get("model_name") or conf["main_args"].get("audio_only", False):
        return None
    model = build(videonet, device=device)
    pretrain = videonet.get("pretrain")
    if pretrain and os.path.exists(pretrain):
        load_video_backbone(model, torch.load(pretrain, map_location="cpu",
                                              weights_only=True))
        print(f"loaded pretrained video backbone from {pretrain}")
    elif pretrain:
        print(f"WARNING: pretrain path {pretrain} not found; using random "
              "(frozen) video backbone weights")
    return model


def main(conf):
    """Train as ``conf`` says; returns the ``Trainer`` (its ``history``,
    ``system`` and ``exp_dir``) after exporting ``best_model.pth`` (rank
    0). Under ``torchrun`` every rank runs it and they train data-parallel;
    a process group this call made, it leaves at the end."""
    import torch.distributed as dist

    from .losses import PITLossWrapper, pairwise_neg_sisdr, pairwise_neg_snr
    from .models import build_model
    from .parallel import initialize, local_device, shutdown
    from .system import System, Trainer, make_optimizer

    device = conf["main_args"].get("device", "cuda")
    owns_group = not dist.is_initialized() and initialize(device)
    loaders = ()
    try:
        device = local_device(device)
        video_model = build_video_model(conf, device)
        model = build_model(conf["audionet"], device=device)
        optimizer = make_optimizer(model.parameters(), **conf["optim"])

        exp_dir = os.path.join(conf["log"]["path"], conf["log"]["exp_name"])
        os.makedirs(exp_dir, exist_ok=True)

        loss_func = {
            "train": PITLossWrapper(pairwise_neg_snr, pit_from="pw_mtx"),
            "val": PITLossWrapper(pairwise_neg_sisdr, pit_from="pw_mtx"),
        }
        system = System(
            model, optimizer, loss_func, video_model=video_model,
            train_video_model=conf["main_args"].get("train_video_model", False),
            accum_steps=int(conf["training"].get("accum_steps")
                            or conf["main_args"].get("accum_steps") or 1),
            online_mix=bool(conf["training"].get("online_mix", False)
                            and video_model is None))
        trainer = Trainer(
            system,
            exp_dir=exp_dir,
            epochs=conf["training"]["epochs"],
            config=conf,
            half_lr=conf["training"]["half_lr"],
            sche_patience=conf["sche"]["patience"],
            sche_factor=conf["sche"]["factor"],
            divide_lr_by=conf["training"]["divide_lr_by"],
            early_stop=conf["training"]["early_stop"],
            device=device,
        )
        if trainer.rank0:
            with open(os.path.join(exp_dir, "conf.yaml"), "w") as f:
                yaml.safe_dump(conf, f, default_flow_style=None)
        if trainer.mesh.member:
            loaders = build_dataloaders(conf, trainer.mesh.index, trainer.mesh.size)
            trainer.resume(conf["main_args"].get("checkpoint"))
            trainer.fit(*loaders)
        if trainer.rank0:
            print(f"exported {trainer.export_best('AVNet', conf['audionet'])}")
        return trainer
    finally:
        for loader in loaders:
            loader.close()
        if owns_group:
            shutdown()


def parse_conf(argv=None):
    """The YAML config named by ``--conf-dir``, with every flag of
    ``argv`` applied; the flags outside the YAML go to ``main_args``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf-dir",
                        default="rtfs_net_tpu_torch/configs/lrs2_RTFSNet_4_layer.yaml",
                        help="Full path to the YAML config")
    parser.add_argument("--checkpoint", default=None,
                        help="Checkpoint name to resume from")
    parser.add_argument("--audio-only", dest="audio_only", default=False,
                        type=str2bool_arg, help="Train without the video branch")
    parser.add_argument("--train-video-model", dest="train_video_model",
                        default=False, type=str2bool_arg,
                        help="Unfreeze and train the video backbone "
                             "(BN stats stay frozen, matching the reference)")
    parser.add_argument("--accum-steps", dest="accum_steps", default=1, type=int,
                        help="Microbatch gradient-accumulation factor: the "
                             "batch runs as this many sequential microbatches "
                             "inside one step (trades step latency for peak "
                             "memory)")
    parser.add_argument("--device", default="cuda",
                        help="Device to train on: cuda (default) or cpu")
    args, _ = parser.parse_known_args(argv)
    with open(args.conf_dir) as f:
        def_conf = yaml.safe_load(f)
    parser = prepare_parser_from_dict(def_conf, parser=parser)
    return parse_args_as_dict(parser, args=argv)


if __name__ == "__main__":
    main(parse_conf())
