"""The system under test: the port's models, its ``separate`` and its
training ``System``, built from a configuration file and given the
benchmark's weights. Nothing else of the harness imports the port, apart
from the readers of its kernel counters."""
from __future__ import annotations

from typing import Dict

import torch


def build(conf: Dict, device, model_state: Dict, video_state: Dict):
    """The port's AVNet and video model of ``conf`` on ``device``, in eval
    mode, with the benchmark's state dicts loaded."""
    from rtfs_net_tpu_torch.models import build_model, build_video_model

    model = build_model(conf, device=device)
    video = build_video_model(conf, device=device)
    model.load_state_dict(model_state)
    video.load_state_dict(video_state)
    return model, video


def separate(model, video, mix, frames, device, dtype):
    """One served request: numpy in, numpy out."""
    from rtfs_net_tpu_torch.utils.separator import separate as port_separate

    return port_separate(model, mix, frames, video_model=video, device=device, dtype=dtype)


def system(conf: Dict, model, video, grad_clip: float, dtype):
    """The port's training step over ``model`` with the config's optimizer
    and the reference's losses; the frozen video model runs on the frames."""
    from rtfs_net_tpu_torch.losses import PITLossWrapper, pairwise_neg_sisdr, pairwise_neg_snr
    from rtfs_net_tpu_torch.system import System, make_optimizer

    return System(model, make_optimizer(model.parameters(), **conf["optim"]),
                  {"train": PITLossWrapper(pairwise_neg_snr),
                   "val": PITLossWrapper(pairwise_neg_sisdr)},
                  grad_clip=grad_clip, compute_dtype=dtype, video_model=video)


def kernel_launches() -> Dict[str, int]:
    """The port's own counters of launches of its hand-written kernels."""
    from rtfs_net_tpu_torch.ops.kernels import dw_conv, sru, sru_direction, sru_train

    return {"K1": sru.launches, "K2_forward": sru_train.forward_launches,
            "K2_backward": sru_train.backward_launches, "K3": dw_conv.launches,
            "K4": sru_direction.launches}


def stage_modules(model, video) -> Dict[str, torch.nn.Module]:
    """The modules the benchmark brackets with ranges, by range name."""
    named = {f"avnet.{name}": m for name, m in model.named_children()}
    named["video_frontend"] = video
    return named
