"""Losses (``rtfs_net_tpu/losses``; reference ``src/losses/__init__.py``)."""
from .pit import PITLossWrapper
from .sdr import (
    pairwise_neg_sdr,
    singlesrc_neg_sdr,
    multisrc_neg_sdr,
    pairwise_neg_sisdr,
    pairwise_neg_sdsdr,
    pairwise_neg_snr,
    singlesrc_neg_sisdr,
    singlesrc_neg_sdsdr,
    singlesrc_neg_snr,
    multisrc_neg_sisdr,
    multisrc_neg_sdsdr,
    multisrc_neg_snr,
)

__all__ = [
    "PITLossWrapper",
    "pairwise_neg_sdr",
    "singlesrc_neg_sdr",
    "multisrc_neg_sdr",
    "pairwise_neg_sisdr",
    "pairwise_neg_sdsdr",
    "pairwise_neg_snr",
    "singlesrc_neg_sisdr",
    "singlesrc_neg_sdsdr",
    "singlesrc_neg_snr",
    "multisrc_neg_sisdr",
    "multisrc_neg_sdsdr",
    "multisrc_neg_snr",
]
