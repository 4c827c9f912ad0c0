"""Feature chunking utilities on torch tensors (``rtfs_net_tpu/utils/features.py``;
reference: ``src/models/utils/utils.py``): 50%-overlap split/merge for
long-form chunked inference, the band-split helper and ``pad_x_to_y``."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def pad_x_to_y(x: torch.Tensor, y: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Zero-pad x to y's length along the last axis
    (reference ``torch_utils.py:13-18``)."""
    if axis != -1:
        raise NotImplementedError
    return F.pad(x, (0, y.shape[axis] - x.shape[axis]))


def pad_segment(x: torch.Tensor, block_size: int) -> Tuple[torch.Tensor, int]:
    """(B, N, T): pad so T splits into 50%-overlapped blocks."""
    T = x.shape[-1]
    stride = block_size // 2
    rest = block_size - (stride + T % block_size) % block_size
    return F.pad(x, (stride, rest + stride)), rest


def split_feature(x: torch.Tensor, block_size: int) -> Tuple[torch.Tensor, int]:
    """(B, N, T) -> (B, N, block_size, n_chunks) with 50% overlap."""
    x, rest = pad_segment(x, block_size)
    B, N, _ = x.shape
    stride = block_size // 2
    b1 = x[:, :, :-stride].reshape(B, N, -1, block_size)
    b2 = x[:, :, stride:].reshape(B, N, -1, block_size)
    block = torch.cat([b1, b2], dim=3).reshape(B, N, -1, block_size)
    return block.transpose(2, 3), rest


def merge_feature(x: torch.Tensor, rest: int) -> torch.Tensor:
    """(B, N, block_size, n_chunks) -> (B, N, T) overlap-add inverse."""
    B, N, block_size, _ = x.shape
    stride = block_size // 2
    x = x.transpose(2, 3).reshape(B, N, -1, block_size * 2)
    x1 = x[:, :, :, :block_size].reshape(B, N, -1)[:, :, stride:]
    x2 = x[:, :, :, block_size:].reshape(B, N, -1)[:, :, :-stride]
    out = x1 + x2
    return out[:, :, :-rest] if rest > 0 else out


def get_bandwidths(win: int, sr: int = 16000) -> List[int]:
    """Band-split helper (reference ``utils.py:58-80``; no config uses it)."""
    enc_dim = win // 2 + 1
    bw = lambda hz: int(np.floor(hz / (sr / 2.0) * enc_dim))
    band_width = [bw(100)] * 5 + [bw(250)] * 6 + [bw(500)] * 4 + [bw(1000)] * 4
    if sr > 160000:
        band_width += [bw(2000)]
    assert enc_dim > np.sum(band_width)
    band_width.append(enc_dim - int(np.sum(band_width)))
    return band_width
