"""Evaluation metrics (``rtfs_net_tpu/metrics``; reference: ``src/metrics/``),
on the host in numpy and the repo's native PESQ extension."""
from .allwrapper import ALLMetricsTracker, np_pit_neg_sdr
from .stoi import stoi
from .pesq import pesq, pesq_backend

__all__ = ["ALLMetricsTracker", "np_pit_neg_sdr", "stoi", "pesq", "pesq_backend"]
