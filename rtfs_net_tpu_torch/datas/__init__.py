"""Data pipeline (``rtfs_net_tpu/datas``; reference: ``src/datas/``).

numpy and the standard library only: the loader's spawned workers import
this package, and must not load torch or touch a CUDA device."""
from .avspeech_dataset import AVSpeechDataset, normalize_wav
from .transform import get_preprocessing_pipelines
from .loader import DataLoader, default_collate
from . import wavio

__all__ = [
    "AVSpeechDataset",
    "normalize_wav",
    "get_preprocessing_pipelines",
    "DataLoader",
    "default_collate",
    "wavio",
]
