"""Adaptive-Metropolis family: SCAM and AM jumps.

Behavioral parity targets:
  * SCAM — ``covarianceJumpProposalSCAM`` (PTMCMCSampler.py:820-876): jump
    along one random eigenvector of a random parameter group's covariance,
    with step ``randn() * (2.4/sqrt(2)) * scale * sqrt(S[ind]) * U[:, ind]``.
  * AM — ``covarianceJumpProposalAM`` (PTMCMCSampler.py:879-933): rotate the
    group into its eigenbasis, perturb every component with
    ``randn(sg) * (2.4/sqrt(2*sg)) * scale * sqrt(S)``, rotate back.

Both are symmetric (log_qxy = 0).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .base import GroupEmbed, draw_am_scale, random_group, switch_over_groups


def eigen_pick(u, s, ind):
    """``(sqrt(s[ind]), u[:, ind])`` as one-hot contractions.

    A traced per-chain index lowers to a slow per-element gather under vmap;
    a dot with a one-hot vector picks the identical values (a single 1.0
    row), but only at full float32 precision: a TF32 product would round the
    picked values to 10 mantissa bits.
    """
    oh = jax.nn.one_hot(ind, s.shape[0], dtype=u.dtype)
    sval = jnp.dot(jnp.sqrt(jnp.maximum(s, 0.0)), oh, precision=lax.Precision.HIGHEST)
    vec = jnp.dot(u, oh, precision=lax.Precision.HIGHEST)
    return sval, vec


def make_scam(config):
    groups = [np.asarray(g) for g in config.groups]
    embeds = [GroupEmbed(g, config.ndim, config.dtype) for g in groups]

    def scam(key, x, beta, it, ctx):
        kg, ks, ki, kn = jax.random.split(key, 4)
        scale = draw_am_scale(ks, beta, x.dtype)

        def branch(gi):
            g = groups[gi]
            sg = len(g)
            emb = embeds[gi]

            def apply(x, scale, ctx):
                u, s = ctx.group_u[gi], ctx.group_s[gi]
                sval, vec = eigen_pick(u, s, jax.random.randint(ki, (), 0, sg))
                # neff == 1 always in the reference (:868-870)
                cd = jnp.asarray(2.4 / np.sqrt(2.0), x.dtype)
                step = jax.random.normal(kn, dtype=x.dtype) * cd * scale * sval * vec
                return emb.add_at(x, step)

            return apply

        gidx = random_group(kg, len(groups))
        q = switch_over_groups(gidx, [branch(i) for i in range(len(groups))], x, scale, ctx)
        return q, jnp.zeros((), x.dtype)

    return scam


def make_am(config):
    groups = [np.asarray(g) for g in config.groups]
    embeds = [GroupEmbed(g, config.ndim, config.dtype) for g in groups]

    def am(key, x, beta, it, ctx):
        kg, ks, kn = jax.random.split(key, 3)
        scale = draw_am_scale(ks, beta, x.dtype)

        def branch(gi):
            g = groups[gi]
            sg = len(g)
            cd0 = np.float64(2.4 / np.sqrt(2.0 * sg))
            emb = embeds[gi]

            def apply(x, scale, ctx):
                u, s = ctx.group_u[gi], ctx.group_s[gi]
                # Rotate into the eigenbasis and back at full float32
                # precision: with rounded products U(U^T x + xi) is not a
                # symmetric proposal.
                y = jnp.matmul(u.T, emb.take(x), precision=lax.Precision.HIGHEST)
                cd = jnp.asarray(cd0, x.dtype) * scale
                y = y + jax.random.normal(kn, (sg,), dtype=x.dtype) * cd * jnp.sqrt(
                    jnp.maximum(s, 0.0)
                )
                return emb.set_at(x, jnp.matmul(u, y, precision=lax.Precision.HIGHEST))

            return apply

        gidx = random_group(kg, len(groups))
        q = switch_over_groups(gidx, [branch(i) for i in range(len(groups))], x, scale, ctx)
        return q, jnp.zeros((), x.dtype)

    return am
