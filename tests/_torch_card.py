"""What the card modules (``tests/test_torch_card_*.py``) share: the ``card``
fixture, the tolerances of a kernel against its plain version and the
launch counts over ``ops.kernels.KERNELS``.

The card modules are marked ``card`` and skip at the ``card`` fixture where
there is no CUDA device. Neither they nor this file import JAX, so on the
card's machine they run without the suite's ``conftest.py``::

    python3 -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_card_*.py

A module takes the fixture by name: ``from _torch_card import card``.
"""
import math
import zlib

import pytest
import torch

from rtfs_net_tpu_torch.bench import launched as _launched

# bf16 kernel vs the plain version on the same bf16 inputs: both carry and
# compute in float32 and round once, so they differ by one bf16 ulp where
# the float32 results straddle a rounding boundary. One ulp is 2^-8 to
# 2^-7 of the value, so the limit 2^-7*|ref| + 1e-5 admits one to two ulps.
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["float32", "bfloat16"]


@pytest.fixture(scope="session")
def card():
    """The card, with TF32 off (cuDNN's convolutions and the matmuls in full
    float32); skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def tol(dtype, rtol32=1e-5):
    """Elementwise |got - want| <= atol + rtol·|want|: float32 1e-5 +
    ``rtol32``·|ref|, bfloat16 ``BF16_ATOL`` + ``BF16_RTOL``·|ref|."""
    return dict(atol=1e-5 if dtype == torch.float32 else BF16_ATOL,
                rtol=rtol32 if dtype == torch.float32 else BF16_RTOL)


def assert_close(got, want, dtype, rtol32=1e-5):
    """``got`` finite, of ``want``'s shape, within ``tol(dtype, rtol32)``."""
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), **tol(dtype, rtol32))


def launched(fn):
    """``fn()``, synchronised, and the kernel launches it made, by label."""
    out, counts = _launched(fn)
    torch.cuda.synchronize()
    return out, counts


def assert_launches(fn, want):
    """``fn()``; fails unless it launched each kernel exactly as often as
    ``want`` says (kernels it does not name: never)."""
    out, got = launched(fn)
    assert got == {k: want.get(k, 0) for k in got}, f"launches {got}, want {want}"
    return out


def generator(*key):
    """A card generator seeded from ``key``, the same in every run."""
    return torch.Generator(device="cuda").manual_seed(zlib.crc32(repr(key).encode()))


def randn(gen, *shape, dtype=torch.float32):
    """A normal sample on the card, drawn in float32, cast to ``dtype``."""
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def edge_operand(shape, dtype, offset, gen):
    """A contiguous ``shape`` tensor that starts ``offset`` elements into
    its storage (odd offsets misalign a bfloat16 tensor's 4-byte words)."""
    return randn(gen, math.prod(shape) + offset, dtype=dtype)[offset:].view(shape)
