"""K1's share of its roofline, in %: the least time of every
``rtfs::sru_stack_layer`` call of the traced stretch (from its recorded
shapes) over the device time of all kernels launched under the op."""
from h100_bench import trace, work


def read(run):
    return trace.roofline_share(run.trace, {"rtfs::sru_stack_layer": work.k1_least_s},
                                2 if run.traffic["dtype"] == "bfloat16" else 4)
