"""The weights and FLOPs that every reading of the cells rests on, pinned:
each configuration's state dicts, as ``weights.make_state`` draws them on
the CPU from its reference module at two seeds (a sha256 over names,
dtypes, shapes and bytes), and each cell's FLOPs per utterance."""
import hashlib
import json

import pytest
import torch
import yaml

from h100_bench import inputs, spec, weights, work

STATES = {
    ("rtfsnet4-lrs2", 5): "81ce2a8a1d91942a24b7c76c8f01fa0d352b79a3c6eb6f4103ef2d9fec25e75f",
    ("rtfsnet4-lrs2", 2 ** 31 + 17):
        "d99ed4ba9b4f2f61a2aa6830fe7987ec269ba96f86e0f340959785da998be353",
    ("ctcnet16-lrs2", 5): "e78bc2661721f00347e4338a2f07c997f328d1594a24d51f6dc5bb97d9006475",
    ("ctcnet16-lrs2", 2 ** 31 + 17):
        "f2d164d258bc70ee7d6f9c8e82164efc39380e5b2c955bb9ac88f2ca76b834ed",
}
FLOPS = {"rtfs4-serve-b128": 75476852224.0, "ctcnet16-serve-b128": 365147164928.0}


def digest(states) -> str:
    h = hashlib.sha256()
    for state in states:
        for k in sorted(state):
            v = state[k].contiguous()
            for part in (k, str(v.dtype), str(tuple(v.shape))):
                h.update(part.encode())
            h.update(v.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config,seed", sorted(STATES))
def test_state_dicts_are_pinned(config, seed):
    entry = next(c for c in spec.load_benchmark()["configs"] if c["name"] == config)
    conf = yaml.safe_load((spec.ROOT / entry["file"]).read_text())
    module = spec.reference(spec.reference_files(config)["reference"])
    with torch.device("meta"):
        model, video = module.build(conf)
    states = weights.make_state(model, video, inputs.torch_seed(seed, 0), "cpu", module.INIT)
    assert digest(states) == STATES[config, seed]


@pytest.mark.parametrize("workload", sorted(FLOPS))
def test_flops_per_utterance_are_pinned(workload):
    cell = spec.cell(workload)
    assert work.reference_flops(cell.reference, json.dumps(cell.conf, sort_keys=True),
                                json.dumps(cell.traffic, sort_keys=True)) == FLOPS[workload]
