"""The LSTM recurrence's share of its roofline, in %: every ``aten::lstm``
call of the traced stretch, the least time from its shapes over the
device time of all kernels launched under the op. A call's least time is
the larger of its bytes over the HBM rate and its FLOPs over the bfloat16
tensor-core peak (its GEMMs run there, so float32's rate outside the
tensor cores would put them over 100%):

* FLOPs = 2·ndir·steps·rows·4H·(input + H): each step's input and hidden
  GEMMs, each direction;
* bytes = (steps·rows·input + steps·rows·ndir·H)·item + the weights once:
  the windows read, the output written.

``aten::lstm`` records its input's shape, (steps, rows, input) (or
(rows, steps, input): both formulas are symmetric in the two), but not
the shapes of its ``hx`` and ``params`` lists, so H, the directions and
the weights come from the cell's plain reference, built on the meta
device: each one-layer LSTM of its state dict (``nn.LSTM``'s names, which
the reference contract fixes), by input width. A call of another width
reads nothing."""
import functools
import json

import torch

from h100_bench import spec, trace, work


@functools.lru_cache(maxsize=8)
def lstms(reference: str, conf_json: str):
    """Input width -> (H, ndir, weight elements) of each one-layer LSTM of
    the plain reference at ``reference`` built from the configuration."""
    with torch.device("meta"):
        model, _ = spec.reference(reference).build(json.loads(conf_json))
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    found = {}
    for key, w_ih in shapes.items():
        if not key.endswith("weight_ih_l0"):
            continue
        p = key[:-len("weight_ih_l0")]
        w_hh = shapes.get(p + "weight_hh_l0")
        if w_hh is None or p + "weight_ih_l1" in shapes or w_ih[0] != 4 * w_hh[1]:
            continue
        sfxs = ("_l0", "_l0_reverse") if p + "weight_ih_l0_reverse" in shapes else ("_l0",)
        found[w_ih[1]] = (w_hh[1], len(sfxs), sum(
            shapes[p + n + s].numel() for s in sfxs
            for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")))
    return found


def least_s(shapes, item: int, widths) -> float:
    steps, rows, d_in = shapes[0]
    H, ndir, weights = widths[d_in]
    flops = 2 * ndir * steps * rows * 4 * H * (d_in + H)
    nbytes = (steps * rows * d_in + steps * rows * ndir * H + weights) * item
    return max(nbytes / work.HBM_BYTES_PER_S, flops / work.BF16_FLOPS_PER_S)


def read(run):
    widths = lstms(run.cell.reference, json.dumps(run.cell.conf, sort_keys=True))
    calls = run.trace.spans("aten::lstm")
    if not calls or any(not c.shapes or len(c.shapes[0]) != 3 or c.shapes[0][2] not in widths
                        for c in calls):
        return None
    return trace.roofline_share(run.trace,
                                {"aten::lstm": lambda shapes, item: least_s(shapes, item, widths)},
                                2 if run.traffic["dtype"] == "bfloat16" else 4)
