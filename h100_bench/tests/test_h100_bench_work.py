"""The yardstick's arithmetic against hand counts."""
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import work


def test_k1_bytes_and_operations():
    # B=128's T pass, layer 0: u (118, 4·64, 8192) bfloat16, no skip
    L, O, rows = 118, 64, 64 * 128
    nbytes = (4 * O + O) * L * rows * 2
    ops = 22 * L * O * rows
    assert work.k1_least_s([[L, 4 * O, rows], []], 2) == max(nbytes / 3.35e12, ops / 67e12)
    # a later layer: k = 3, the input is the highway
    nbytes = (3 * O + O + O) * L * rows * 2
    assert work.k1_least_s([[L, 3 * O, rows], [L, O, rows]], 2) == max(
        nbytes / 3.35e12, 22 * L * O * rows / 67e12)


def test_k2_bytes_and_operations():
    L, O, rows = 57, 64, 500
    fwd = (3 * O + O + 2 * O) * L * rows * 2
    assert work.k2_forward_least_s([[L, 3 * O, rows], [L, O, rows]], 2) == max(
        fwd / 3.35e12, 22 * L * O * rows / 67e12)
    bwd = ((4 * O + 2 * O) + 4 * O) * L * rows * 4 + 4 * O * rows * 4
    shapes = [[L, 4 * O, rows], [], [L, O, rows], [2 * O], [2 * O], [L, O, rows]]
    assert work.k2_backward_least_s(shapes, 4) == max(bwd / 3.35e12,
                                                      41 * L * O * rows / 67e12)


def test_k3_bytes_and_operations():
    x, w = [128, 64, 251, 129], [64, 1, 4, 4]
    n = 128 * 64 * 251 * 129
    assert work.k3_least_s([x, w], 2) == max((2 * n * 2 + 64 * 16 * 4) / 3.35e12,
                                             2 * 16 * n / 67e12)


def test_conv_backward_flops_count_groups_once():
    mapping = {torch.ops.aten.convolution_backward: work.conv_backward_flops}
    with torch.device("meta"):
        x = torch.empty(4, 64, 100, 65, requires_grad=True)
        for w, groups in ((torch.empty(64, 1, 4, 4, requires_grad=True), 64),
                          (torch.empty(32, 64, 1, 1, requires_grad=True), 1)):
            with FlopCounterMode(display=False, custom_mapping=mapping) as c:
                F.conv2d(x, w, groups=groups).sum().backward()
            counts = c.get_flop_counts()["Global"]
            forward = counts[torch.ops.aten.convolution]
            assert counts[torch.ops.aten.convolution_backward] == 2 * forward
            out_plane = (100 - w.shape[2] + 1) * (65 - w.shape[3] + 1)
            assert forward == 2 * 4 * w.numel() * out_plane


def test_reference_flops_of_both_configs():
    """FLOPs per 2 s utterance with the video model: the video model's
    forward once, AVNet's forward and, in training, its backward (about
    twice the forward: the first convolution's input takes no gradient)."""
    import json

    import yaml

    from h100_bench import spec
    from h100_bench.reference import model as ref

    with torch.device("meta"):
        video = ref.FRCNNVideoModel()
        frames = torch.empty(1, 1, 50, 88, 88)
    with FlopCounterMode(display=False) as c:
        video(frames)
    video_flops = c.get_total_flops()
    got = {}
    for name in ("rtfsnet4-lrs2", "ctcnet16-lrs2"):
        conf = yaml.safe_load((spec.HERE / "configs" / f"{name}.yaml").read_text())
        for kind in ("serve", "train"):
            t = {"kind": kind, "seconds_of_audio": 2.0, "sample_rate": 16000, "frames": 50,
                 "frame_size": 88}
            got[kind] = work.reference_flops(spec.reference_files(name)["reference"],
                                             json.dumps(conf), json.dumps(t))
        avnet = got["serve"] - video_flops
        assert video_flops + 2.9 * avnet < got["train"] <= video_flops + 3 * avnet
        # the port's own count (utils/flops.py): 22.10 and 167.2 GMACs
        macs = {"rtfsnet4-lrs2": 22.10e9, "ctcnet16-lrs2": 167.2e9}[name]
        assert abs(avnet - 2 * macs) < 0.01 * 2 * macs
