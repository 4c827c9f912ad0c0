"""Helpers for the PyTorch-port parity tests (``tests/test_torch_*.py``):
run a JAX module and its port on the same numpy inputs and weights.

The JAX side is jitted (on the CPU, one compile beats op-by-op dispatch
by several times at these sizes); its init variables are perturbed so
that norms, slopes and gates are not at their constant initial values,
then carried into the port with ``rtfs_net_tpu_torch.utils.convert``.
Test modules import ``one_torch_thread`` to run their torch code on one
intra-op thread.

The JAX package's nearest interpolation computes its source indices as
float64 ``floor(dst * (in/out))``, which lands one below the exact
``dst*in // out`` where that quotient is an integer (ROADMAP Queue 3);
torch's follows the exact rule. ``interpolated_sizes`` and
``assert_nearest_maps_agree`` let a parity test show that none of its
interpolations is at such a size.
"""
import contextlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rtfs_net_tpu.ops import conv as jconv
from rtfs_net_tpu_torch.utils.convert import module_state_dict


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the test runner's
    parallel workers would otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_init(module, rng, *args, **kwargs):
    """Jitted ``module.init`` -> numpy variables, perturbed by
    N(0, 0.1²) (BatchNorm variances drawn from [1, 1.5))."""
    jargs = [jnp.asarray(a) for a in args]
    # Module.init, not module.init: PReLU has a field named ``init``
    v = jax.jit(lambda *a: nn.Module.init(module, jax.random.PRNGKey(0), *a,
                                          **kwargs))(*jargs)
    v = jax.tree_util.tree_map(np.asarray, v)

    def perturb(path, a):
        keys = [getattr(p, "key", None) for p in path]
        if keys[0] == "batch_stats" and keys[-1] == "var":
            return (1.0 + 0.5 * rng.random(a.shape)).astype(a.dtype)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(perturb, v)


def jax_random(module, rng, *args, **kwargs):
    """Variables of ``module`` drawn from ``rng``, their shapes from
    ``eval_shape`` (no init compile): weights U(±1/sqrt(fan_in)) as torch's
    default init, norm scales 1 + N(0, 0.1²), PReLU slopes 0.25 + N(0, 0.1²),
    biases and BatchNorm means N(0, 0.1²), BatchNorm variances from [1, 1.5)."""
    jargs = [jnp.asarray(a) for a in args]
    shapes = jax.eval_shape(lambda *a: nn.Module.init(module, jax.random.PRNGKey(0), *a,
                                                      **kwargs), *jargs)

    def draw(path, leaf):
        shape, name = leaf.shape, getattr(path[-1], "key", None)
        normal = 0.1 * rng.standard_normal(shape)
        if getattr(path[0], "key", None) == "batch_stats":
            value = 1.0 + 0.5 * rng.random(shape) if name == "var" else normal
        elif name == "weight" and len(shape) >= 2:
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            value = rng.uniform(-bound, bound, shape)
        else:
            value = normal + {"scale": 1.0, "alpha": 0.25}.get(name, 0.0)
        return value.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_apply(module, variables, *args, **kwargs):
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    fn = jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))
    return np.asarray(fn(variables, *jargs))


def port_apply(module, *args):
    with torch.no_grad():
        out = module(*[None if a is None else torch.from_numpy(a) for a in args])
    return out.numpy()


def load(module, mapper, variables, *mapper_args):
    """Load the port ``module`` strictly from JAX ``variables``."""
    module.load_state_dict(module_state_dict(mapper, variables, *mapper_args))
    return module.eval()


@contextlib.contextmanager
def interpolated_sizes():
    """Collect the (in, out) sizes, per spatial dim, of every nearest
    interpolation torch runs inside the block."""
    sizes, interpolate = set(), F.interpolate

    def recording(x, size=None, **kwargs):
        out = interpolate(x, size=size, **kwargs)
        sizes.update(zip(x.shape[2:], out.shape[2:]))
        return out

    F.interpolate = recording
    try:
        yield sizes
    finally:
        F.interpolate = interpolate


def jax_nearest_index(n_in, n_out):
    """The source index of each output position of the JAX package's
    ``interpolate_nearest`` from ``n_in`` to ``n_out``."""
    x = jnp.arange(n_in, dtype=jnp.float32).reshape(1, 1, n_in)
    return np.asarray(jconv.interpolate_nearest(x, (n_out,))).reshape(-1).astype(np.int64)


def assert_nearest_maps_agree(sizes):
    """Each (in, out) in ``sizes`` is one where the JAX package's index map
    equals the exact one, which the port's follows."""
    for n_in, n_out in sorted(sizes):
        if n_in != n_out:
            np.testing.assert_array_equal(jax_nearest_index(n_in, n_out),
                                          np.arange(n_out) * n_in // n_out,
                                          err_msg=f"{n_in} -> {n_out}")


def jax_optimizer_names():
    """Every name the JAX package's ``make_optimizer`` takes, read from its
    source: the string constants its ``build`` compares ``name`` with."""
    import ast
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "rtfs_net_tpu", "system",
                        "optimizers.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    make = next(n for n in tree.body if getattr(n, "name", None) == "make_optimizer")
    names = set()
    for node in ast.walk(make):
        if isinstance(node, ast.Compare) and getattr(node.left, "id", None) == "name":
            for comp in node.comparators:
                elts = comp.elts if isinstance(comp, ast.Tuple) else [comp]
                names.update(e.value for e in elts if isinstance(e, ast.Constant))
    return sorted(names)
