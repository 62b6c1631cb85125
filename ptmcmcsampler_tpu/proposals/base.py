"""Shared proposal helpers.

Proposal kernels follow a single-chain protocol and are vmapped over chains
and temperatures by the step kernel:

    proposal(key, x[D], beta, it, ctx) -> (q[D], log_qxy)

``ctx`` is a :class:`ProposalContext` pytree view of the adaptation state.
This is the JAX-native analogue of the reference's proposal-callable protocol
``proposal(x, iter, beta) -> (q, qxy)`` (PTMCMCSampler.py:1059) with explicit
PRNG keys instead of global numpy RNG state.
"""

from __future__ import annotations

import chex
import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


@chex.dataclass
class ProposalContext:
    """Adaptation inputs a proposal may read (replicated across chains)."""

    group_u: tuple  # per-group eigenvectors
    group_s: tuple  # per-group eigenvalues
    chol: jax.Array  # [D, D] lower Cholesky of the mass-matrix inverse
    chol_inv: jax.Array  # [D, D]
    de_buf: jax.Array  # [B, D]
    de_valid: jax.Array  # scalar i32


def draw_am_scale(key, beta, dtype):
    """The reference's occasional jump-size modulation.

    PTMCMCSampler.py:843-862 (and identically :899-920): with prob 0.03 a
    "large" 10x jump, with prob 0.07 a "small" 0.2x jump, else 1.0; scaled by
    sqrt(T) for chains with T <= 100.
    """
    prob = jax.random.uniform(key)
    scale = jnp.where(prob > 0.97, 10.0, jnp.where(prob > 0.9, 0.2, 1.0)).astype(dtype)
    temp = safe_temperature(beta)
    scale = jnp.where(temp <= 100.0, scale * jnp.sqrt(temp), scale)
    return scale


def safe_temperature(beta):
    """T = 1/beta with the beta->0 hot chain clamped to a finite huge value."""
    return jnp.where(beta > 0, 1.0 / jnp.maximum(beta, 1e-30), 1e30)


class GroupEmbed:
    """Static helpers expressing per-group gather/scatter as exact matmuls.

    Under vmap over thousands of chains, ``x[g]`` / ``x.at[g].add(...)`` with
    a *traced-free but fancy* index lower to per-element gathers/scatters.
    Since groups are static, the same values are produced exactly (each
    selection row holds a single 1.0) by tiny matmuls and masked selects —
    at full float32 precision, which the contractions below pin.
    """

    def __init__(self, g, ndim, dtype):
        g = np.asarray(g)
        self.identity = bool(np.array_equal(g, np.arange(ndim)))
        sel = np.zeros((ndim, len(g)), dtype=np.float64)
        sel[g, np.arange(len(g))] = 1.0
        mask = np.zeros((ndim,), bool)
        mask[g] = True
        self.sel = jnp.asarray(sel, dtype)
        self.mask = jnp.asarray(mask)

    def take(self, x):
        """``x[g]``."""
        return x if self.identity else jnp.matmul(self.sel.T, x, precision=lax.Precision.HIGHEST)

    def add_at(self, x, step):
        """``x.at[g].add(step)``."""
        if self.identity:
            return x + step
        return jnp.where(
            self.mask, x + jnp.matmul(self.sel, step, precision=lax.Precision.HIGHEST), x
        )

    def set_at(self, x, vals):
        """``x.at[g].set(vals)``."""
        if self.identity:
            return vals
        return jnp.where(
            self.mask, jnp.matmul(self.sel, vals, precision=lax.Precision.HIGHEST), x
        )


def random_group(key, ngroups):
    """Uniform group choice (PTMCMCSampler.py:839, :897, :955)."""
    if ngroups == 1:
        return jnp.zeros((), jnp.int32)
    return jax.random.randint(key, (), 0, ngroups)


def switch_over_groups(gidx, fns, *args):
    """lax.switch over the (static, usually tiny) list of parameter groups."""
    if len(fns) == 1:
        return fns[0](*args)
    return jax.lax.switch(gidx, fns, *args)
