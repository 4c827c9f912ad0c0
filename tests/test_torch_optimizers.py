"""PyTorch port vs JAX package: every optimizer name of the JAX registry.

Each name takes 7 steps (so the ranger variants' lookahead syncs at step
6) over a parameter set with a vector, a 256x192 matrix (adafactor
factors it, sm3 keeps a row and a column accumulator) and a 4-D conv
weight, with a new gradient at each step, from the same start as JAX's
``make_optimizer(...).update`` under ``jax.jit``. After step 3 the
learning rate is halved with ``set_lr`` and the optimizer is rebuilt
from its ``state_dict`` (in the middle of a lookahead cycle). The
parameters agree within 1e-6·max|p|: only float32 rounding differs.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtfs_net_tpu.system import optimizers as jopt
from rtfs_net_tpu_torch.system import optimizers

from _torch_port import jax_optimizer_names, one_torch_thread  # noqa: F401

SHAPES = {"vector": (96,), "matrix": (256, 192), "conv": (8, 4, 3, 3)}
STEPS, SWITCH = 7, 3
LR, LR2 = 1e-2, 5e-3
NAMES = jax_optimizer_names()
# the names whose rule reads ``momentum``, again with a momentum of their own
MOMENTUM = ["sgd", "rmsprop", "lars", "sgdw", "asgd", "accsgd", "qhm", "pid"]
CASES = [(name, 0.0) for name in NAMES] + [(name, 0.5) for name in MOMENTUM]


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    return params, grads


def _jax_run(problem, name, hyper):
    params, grads = problem
    opt = jopt.make_optimizer(name, **hyper)
    update = jax.jit(opt.update)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    for t in range(STEPS):
        if t == SWITCH:
            state = jopt.set_lr(state, LR2)
        u, state = update({k: jnp.asarray(v) for k, v in grads[t].items()}, state, p)
        p = optax.apply_updates(p, u)
    return {k: np.asarray(v) for k, v in p.items()}


def _port_run(problem, name, hyper):
    params, grads = problem
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = optimizers.make_optimizer(list(ps.values()), name, **hyper)
    for t in range(STEPS):
        if t == SWITCH:
            optimizers.set_lr(opt, LR2)
            saved = copy.deepcopy(opt.state_dict())
            opt = optimizers.make_optimizer(list(ps.values()), name, **hyper)
            opt.load_state_dict(saved)
            assert optimizers.get_lr(opt) == LR2
        for k, p in ps.items():
            p.grad = torch.from_numpy(grads[t][k])
        opt.step()
    return {k: p.detach().numpy() for k, p in ps.items()}


def test_the_registry_has_29_names():
    assert len(NAMES) == 29 and not hasattr(optimizers, "NOT_PORTED")


@pytest.mark.parametrize("name,momentum", CASES)
def test_rule_matches_jax(problem, name, momentum):
    hyper = dict(lr=LR, weight_decay=1e-2, momentum=momentum)
    want, got = _jax_run(problem, name, hyper), _port_run(problem, name, hyper)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k in SHAPES:
        assert not np.array_equal(want[k], problem[0][k]), k  # the rule moved it
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6 * scale, err_msg=k)


def test_unknown_name_raises():
    with pytest.raises(ValueError, match="interpret optimizer"):
        optimizers.make_optimizer([torch.nn.Parameter(torch.zeros(2))], "nope")
