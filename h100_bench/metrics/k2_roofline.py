"""K2's share of its roofline, in %: every ``rtfs::sru_train_forward`` and
``rtfs::sru_train_backward`` call of the traced stretch together."""
from h100_bench import trace, work


def read(run):
    return trace.roofline_share(run.trace, {"rtfs::sru_train_forward": work.k2_forward_least_s,
                                            "rtfs::sru_train_backward": work.k2_backward_least_s},
                                2 if run.traffic["dtype"] == "bfloat16" else 4)
