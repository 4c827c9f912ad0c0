"""Manifest builders for the AVSS datasets (``data_preprocess/`` of the
JAX side): ``python -m rtfs_net_tpu_torch.data_preprocess.preprocess``."""
