"""K3's share of its roofline, in %: every ``rtfs::dw_conv2d_same`` call of
the traced stretch, least time from its shapes over measured device time."""
from h100_bench import trace, work


def read(run):
    return trace.roofline_share(run.trace, {"rtfs::dw_conv2d_same": work.k3_least_s},
                                2 if run.traffic["dtype"] == "bfloat16" else 4)
