"""The yardstick's arithmetic: the H100's published peaks, the operations
and bytes of each hand-written kernel's call (the formulas of the port's
``chip_smoke.py``, copied), and the model's FLOPs counted on the plain
reference.

A kernel call's least time is the larger of its bytes over the HBM rate and
its operations over float32's rate outside the tensor cores; each input
byte is counted read once and each output byte written once.
"""
from __future__ import annotations

import functools
import json
import math
from typing import Sequence

import torch

from . import spec

# NVIDIA H100 SXM data sheet, dense: HBM rate, float32 outside the tensor
# cores, bfloat16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
# float32 operations per SRU output element: two gates (3 + sigmoid's 4
# each), the carry update (4), the highway mix (4)
SRU_OPS_PER_ELEMENT = 22
# per element of the backward sweep: the two gates again (14), dm (5), dct
# (2), da (5), du0 and dskip (4), the four gate sums (6), the carry (5)
SRU_BWD_OPS_PER_ELEMENT = 41


def least_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def _sru_shape(shapes: Sequence[Sequence[int]]):
    """(L, O, rows, k, skip channels) from the op's inputs (u, skip, ...):
    u is (L, k·O, rows); a skip of (L, O, rows) means k == 3."""
    L, kO, rows = shapes[0]
    skip = shapes[1] if len(shapes) > 1 and len(shapes[1]) == 3 else None
    if skip:
        return L, skip[1], rows, 3, skip[1]
    return L, kO // 4, rows, 4, 0


def k1_least_s(shapes, item: int) -> float:
    """``rtfs::sru_stack_layer``: reads u (and skip), writes h."""
    L, O, rows, k, skip_ch = _sru_shape(shapes)
    return least_s((k * O + O + skip_ch) * L * rows * item,
                   SRU_OPS_PER_ELEMENT * L * O * rows)


def k2_forward_least_s(shapes, item: int) -> float:
    """``rtfs::sru_train_forward``: reads u (and skip), writes h and c."""
    L, O, rows, k, skip_ch = _sru_shape(shapes)
    return least_s((k * O + skip_ch + 2 * O) * L * rows * item,
                   SRU_OPS_PER_ELEMENT * L * O * rows)


def k2_backward_least_s(shapes, item: int) -> float:
    """``rtfs::sru_train_backward``: reads u, skip, c and dh, writes du and
    dskip, and the float32 per-row gate partials."""
    L, O, rows, k, skip_ch = _sru_shape(shapes)
    nbytes = ((k * O + 2 * O + skip_ch) + (k * O + skip_ch)) * L * rows * item \
        + 4 * O * rows * 4
    return least_s(nbytes, SRU_BWD_OPS_PER_ELEMENT * L * O * rows)


def k3_least_s(shapes, item: int) -> float:
    """``rtfs::dw_conv2d_same``: reads x, writes y, reads the float32 taps."""
    x, w = shapes[0], shapes[1]
    n = math.prod(x)
    taps = w[-2] * w[-1]
    return least_s(2 * n * item + math.prod(w) * 4, 2 * taps * n)


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                        _dilation, transposed, _output_padding, _groups, output_mask,
                        out_shape=None) -> int:
    """A convolution's backward: each of the input's and the weight's
    gradient costs what the forward does, 2·batch·|w|·|output plane| (the
    input plane for a transposed one). ``FlopCounterMode``'s own formula
    counts a grouped convolution's gradients as if it were dense, so a
    depthwise one ``groups`` times over."""
    plane = x_shape[2:] if transposed else grad_out_shape[2:]
    forward = 2 * grad_out_shape[0] * math.prod(w_shape) * math.prod(plane)
    return forward * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


@functools.lru_cache(maxsize=8)
def reference_flops(reference: str, conf_json: str, traffic_json: str) -> float:
    """FLOPs per utterance of the plain reference module at ``reference``
    at the cell's shapes, counted by ``FlopCounterMode`` on the meta device
    (matmuls and convolutions; elementwise work is not counted): the video
    model's forward and AVNet's forward, and for a training cell AVNet's
    backward too."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.train import neg_snr

    conf, traffic = json.loads(conf_json), json.loads(traffic_json)
    train = traffic["kind"] == "train"
    n = int(traffic["seconds_of_audio"] * traffic["sample_rate"])
    with torch.device("meta"):
        model, video = spec.reference(reference).build(conf)
        mix = torch.empty(1, n)
        frames = torch.empty(1, 1, traffic["frames"], traffic["frame_size"],
                             traffic["frame_size"])
    model.train(train)
    with FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten.convolution_backward: conv_backward_flops}) as counter:
        with torch.no_grad():
            emb = video(frames)
        if train:
            neg_snr(model(mix, emb), mix).backward()
        else:
            with torch.no_grad():
                model(mix, emb)
    return float(counter.get_total_flops())
