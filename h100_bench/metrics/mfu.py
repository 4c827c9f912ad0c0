"""The whole step's share of the card's bfloat16 dense peak, in %: the
plain reference's FLOPs per utterance (matmuls and convolutions, counted on
the meta device) times the device-only traced stretch's utterances, over its wall."""
from h100_bench.work import BF16_FLOPS_PER_S


def read(run):
    t = run.light
    flops = run.flops_per_utterance * run.window.stretch_utterances
    return 100.0 * flops / t.wall_s / BF16_FLOPS_PER_S if flops and t.device else None
