"""Shared helpers of the reftr_torch parity tests (tests/test_torch_*.py).

The JAX package is the oracle: a Flax module and its port get the same
seeded random weights (every leaf replaced, so a zero-initialised layer or
an identity FrozenBN statistic cannot hide a mapping error) and the same
numpy inputs, on the CPU in float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from reftr_torch.convert import flax_state_dict

torch.set_num_threads(1)


def random_flax_params(module, *args, seed: int = 0, **kwargs):
    """Params of a Flax ``module`` for these inputs: shapes from
    ``eval_shape`` (no slow eager init), values from a numpy seed."""
    args = jax.tree_util.tree_map(jnp.asarray, args)
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in flatten_dict(shapes["params"]).items():
        name, shape = path[-1], leaf.shape
        if name == "running_var":
            val = rng.uniform(0.5, 1.5, shape)
        elif name == "kernel":  # variance-preserving, so depth stays O(1)
            val = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name in ("scale", "weight"):  # norm scales, FrozenBN weight
            val = 1.0 + rng.normal(0.0, 0.1, shape)
        else:  # biases, running means, embeddings, level/query embeds
            val = rng.normal(0.0, 0.1, shape)
        out[path] = val.astype(np.float32)
    return unflatten_dict(out)


def load_port(module: torch.nn.Module, params) -> torch.nn.Module:
    """Load a Flax param tree into a port module (strict) and set eval."""
    module.load_state_dict(flax_state_dict(params, module.state_dict()))
    return module.eval()


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def close(got: torch.Tensor, want, atol: float, rtol: float = 0.0) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def close_to_scale(got: torch.Tensor, want, tol: float) -> None:
    """Max abs error within ``tol`` times the reference's largest
    magnitude: for deep stacks whose activations grow past one, where the
    summation-order error grows with the activation scale, not with each
    element."""
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    bound = tol * max(1.0, float(np.abs(want).max()))
    assert err <= bound, f"max abs error {err:.3g} > {bound:.3g}"
