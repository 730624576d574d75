"""Shared helpers of the port's parity tests (JAX side)."""

import numpy as np
import jax
import jax.numpy as jnp


def randomize(params, seed, std=0.02):
    """Every leaf of a JAX parameter tree replaced by a seeded numpy draw,
    normal x std; norm weights ("scale" leaves) get 1 + that draw. Nothing
    is zero, unlike the reference init's adaLN and final layer."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        v = rng.standard_normal(leaf.shape).astype(np.float32) * np.float32(std)
        if "scale" in jax.tree_util.keystr(path):
            v += np.float32(1.0)
        return jnp.asarray(v)

    return jax.tree_util.tree_map_with_path(draw, params)


def to_numpy(params):
    return jax.tree_util.tree_map(np.asarray, params)
