"""Helpers for the PyTorch-port parity tests (``tests/test_torch_*.py``):
run a JAX module and its port on the same numpy inputs and weights.

The JAX side is jitted (on the CPU, one compile beats op-by-op dispatch
by several times at these sizes); its init variables are perturbed so
that norms, slopes and gates are not at their constant initial values,
then carried into the port with ``rtfs_net_tpu_torch.utils.convert``.
Test modules import ``one_torch_thread`` to run their torch code on one
intra-op thread.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
