"""Training system (``rtfs_net_tpu/system``): ``System``, the optimizer
factory, the epoch schedulers, checkpoints and the ``Trainer``."""
from .checkpoint import CheckpointManager
from .core import System, online_mixing_collate, remix_sources
from .optimizers import get_lr, make_optimizer, set_lr
from .schedulers import EarlyStopping, ReduceLROnPlateau, StaircaseLR
from .tb_writer import TensorBoardLogger
from .trainer import Trainer

__all__ = [
    "System",
    "Trainer",
    "CheckpointManager",
    "TensorBoardLogger",
    "online_mixing_collate",
    "remix_sources",
    "make_optimizer",
    "get_lr",
    "set_lr",
    "ReduceLROnPlateau",
    "StaircaseLR",
    "EarlyStopping",
]
