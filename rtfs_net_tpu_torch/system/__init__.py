"""Training system (``rtfs_net_tpu/system``): ``System`` and the optimizer
factory."""
from .core import System
from .optimizers import get_lr, make_optimizer, set_lr

__all__ = ["System", "make_optimizer", "get_lr", "set_lr"]
