"""The benchmark of the PyTorch and CUDA port (``rtfs_net_tpu_torch``) on
an NVIDIA H100: ``python -m h100_bench --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once."""
