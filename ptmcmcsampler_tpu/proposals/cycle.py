"""Weighted proposal-cycle machinery as a stochastic `lax.switch`.

Reference behavior reproduced (PTMCMCSampler.py:987-1067):
  * each proposal enters the cycle with an integer weight; a uniform draw over
    the cycle picks the proposal, so pick probability = weight/sum(weights)
    (:1058-1059 — the reference's shuffled cycle is never actually read, an
    independent uniform index is drawn every iteration, which is what we do);
  * the DE jump only enters the cycle after burn-in (:579-585), expressed here
    as an activation mask on the weights;
  * auxiliary jumps run after every standard proposal, with summed log_qxy
    (:1062-1065).

Design: in ``jump_select="shared"`` mode one kind is drawn per
iteration (independent of all chain states, so each chain still evolves by the
same mixture kernel) and dispatched through a scalar-index ``lax.switch`` —
at runtime only the selected family's cost is paid, so cheap AM iterations
never pay for NUTS trajectories. ``per_chain`` mode draws a kind per chain
(rotation scheme or stacked masked-select; see kernel.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    KIND_AM,
    KIND_CHEES,
    KIND_CUSTOM,
    KIND_DE,
    KIND_HMC,
    KIND_MALA,
    KIND_NUTS,
    KIND_PRIOR,
    KIND_SCAM,
    SamplerConfig,
)
from . import am, chees, de, gradient, nuts
from .base import ProposalContext


def _wrap_legacy(fn, ndim, dtype):
    """Adapt a legacy numpy proposal ``f(x, iter, beta) -> (q, lqxy)`` via
    ``pure_callback`` (host round-trip; correctness fallback, not the fast
    path). Mirrors the reference custom-jump protocol (tests/test_simple.py:50-62)."""

    def host(x, it, beta):
        q, lqxy = fn(np.asarray(x, np.float64), int(it), float(beta))
        return np.asarray(q, dtype), np.asarray(lqxy, dtype).reshape(())

    def wrapped(key, x, beta, it, ctx):
        del key, ctx
        out_shapes = (
            jax.ShapeDtypeStruct((ndim,), dtype),
            jax.ShapeDtypeStruct((), dtype),
        )
        q, lqxy = jax.pure_callback(host, out_shapes, x, it, beta, vmap_method="sequential")
        return q, lqxy

    return wrapped


def _wrap_legacy_aux(fn, ndim, dtype):
    def host(x0, q, it, beta):
        qn, lqxy = fn(np.asarray(x0, np.float64), np.asarray(q, np.float64), int(it), float(beta))
        return np.asarray(qn, dtype), np.asarray(lqxy, dtype).reshape(())

    def wrapped(key, x0, q, it, beta):
        del key
        out_shapes = (
            jax.ShapeDtypeStruct((ndim,), dtype),
            jax.ShapeDtypeStruct((), dtype),
        )
        return jax.pure_callback(host, out_shapes, x0, q, it, beta, vmap_method="sequential")

    return wrapped


def _single_chain_kernel(spec, config: SamplerConfig, func_grad, logp=None):
    kind = spec.kind
    if kind == KIND_SCAM:
        return am.make_scam(config)
    if kind == KIND_AM:
        return am.make_am(config)
    if kind == KIND_DE:
        return de.make_de(config)
    if kind == KIND_MALA:
        return gradient.make_mala(config, func_grad)
    if kind == KIND_HMC:
        return gradient.make_hmc(config, func_grad)
    if kind == KIND_PRIOR:
        # Independence proposal drawing from the user prior (BASELINE.json
        # config 4 "prior-draw jumps"; no reference built-in — the enterprise
        # pattern is a user jump that samples the prior). Hastings correction
        # qxy = logp(x) - logp(q): exact when ``draw`` samples the density
        # ``logp`` (up to a constant), which the caller asserts by
        # registering the pair together.
        draw = spec.fn
        if spec.protocol == "legacy":
            def prior_jump(key, x, beta, it, ctx, _draw=draw):
                del beta, it, ctx
                out_shape = jax.ShapeDtypeStruct((config.ndim,), config.dtype)
                seed = jax.random.randint(key, (), 0, 2**31 - 1)

                def host(s):
                    return np.asarray(
                        _draw(np.random.default_rng(int(s))), np.float64
                    ).astype(config.dtype)

                q = jax.pure_callback(host, out_shape, seed, vmap_method="sequential")
                return q, logp(x) - logp(q)
        else:
            def prior_jump(key, x, beta, it, ctx, _draw=draw):
                del beta, it, ctx
                q = jnp.asarray(_draw(key), x.dtype)
                return q, logp(x) - logp(q)

        return prior_jump
    if kind == KIND_CUSTOM:
        if spec.protocol == "legacy":
            return _wrap_legacy(spec.fn, config.ndim, config.dtype)

        def custom(key, x, beta, it, ctx):
            q, lqxy = spec.fn(key, x, it, beta)
            return jnp.asarray(q, x.dtype), jnp.asarray(lqxy, x.dtype)

        return custom
    raise ValueError(f"unknown jump kind {kind!r}")


def build_jump_branches(config: SamplerConfig, func_grad=None, logp=None):
    """Build batched branch functions for `lax.switch`.

    Each branch has signature
        branch(keys[T,C,...], x[T,D,C], betas[T], it, ctx, ss_dict) ->
            (q[T,D,C], log_qxy[T,C], new_ss_dict)
    (x and q are chain-minor; per-chain kernels are vmapped with the chain
    batch on the minor, contiguous axis)
    where ``ss_dict`` holds the per-(T,C) NUTS dual-averaging scalars.
    ``logp`` (single-chain prior log-density) is required by prior-draw jumps
    for their Hastings correction.
    """
    branches = []
    for spec in config.jumps:
        if spec.kind == KIND_DE and config.de_pair in ("blocked", "rolled"):
            # Batch-level kernels: pair draws shared per chain group
            # ("blocked", default) or per iteration ("rolled") —
            # proposals/de.py documents the trade-off.
            kernel = (
                de.make_de_blocked(config)
                if config.de_pair == "blocked"
                else de.make_de_batch(config)
            )

            def branch(keys, x, betas, it, ctx, ss, _kernel=kernel):
                return _kernel(keys, x, betas, it, ctx, ss)

        elif spec.kind == KIND_CHEES:
            # Batch-level kernel: needs cross-chain reductions for the ChEES
            # criterion, so it is not vmapped per chain.
            kernel = chees.make_chees(config, func_grad)

            def branch(keys, x, betas, it, ctx, ss, _kernel=kernel):
                return _kernel(keys, x, betas, it, ctx, ss)

        elif spec.kind == KIND_NUTS:
            kernel = nuts.make_nuts(config, func_grad)

            def branch(keys, x, betas, it, ctx, ss, _kernel=kernel):
                per_chain = jax.vmap(  # over the minor chain axis
                    lambda k, xx, b, s: _kernel(k, xx, b, it, ctx, s),
                    in_axes=(0, -1, None, 0),
                    out_axes=(-1, 0, 0),
                )
                per_temp = jax.vmap(per_chain, in_axes=(0, 0, 0, 0))
                q, qxy, new_ss = per_temp(keys, x, betas, ss)
                return q, qxy, new_ss

        else:
            kernel = _single_chain_kernel(spec, config, func_grad, logp=logp)

            def branch(keys, x, betas, it, ctx, ss, _kernel=kernel):
                per_chain = jax.vmap(
                    lambda k, xx, b: _kernel(k, xx, b, it, ctx),
                    in_axes=(0, -1, None),
                    out_axes=(-1, 0),
                )
                per_temp = jax.vmap(per_chain, in_axes=(0, 0, 0))
                q, qxy = per_temp(keys, x, betas)
                return q, qxy, ss

        branches.append(branch)
    return branches


def build_aux_chain(config: SamplerConfig):
    """Chained auxiliary jumps applied after every proposal."""
    if not config.aux_jumps:
        return None
    wrapped = []
    for spec in config.aux_jumps:
        if spec.protocol == "legacy":
            wrapped.append(_wrap_legacy_aux(spec.fn, config.ndim, config.dtype))
        else:
            fn = spec.fn

            def jax_aux(key, x0, q, it, beta, _fn=fn):
                qn, lqxy = _fn(key, x0, q, it, beta)
                return jnp.asarray(qn, q.dtype), jnp.asarray(lqxy, q.dtype)

            wrapped.append(jax_aux)

    def apply_aux(keys, x, q, qxy, betas, it):
        """keys [T,C,A,...]; x,q [T,D,C] (chain-minor); updated (q, qxy)."""

        def single(key_list, x1, q1, beta):
            total = jnp.zeros((), q1.dtype)
            for ai, aux in enumerate(wrapped):
                q1, lq = aux(key_list[ai], x1, q1, it, beta)
                total = total + lq
            return q1, total

        per_chain = jax.vmap(single, in_axes=(0, -1, -1, None), out_axes=(-1, 0))
        per_temp = jax.vmap(per_chain, in_axes=(0, 0, 0, 0))
        q2, extra = per_temp(keys, x, q, betas)
        return q2, qxy + extra

    return apply_aux


def jump_probabilities(config: SamplerConfig, it):
    """Active-cycle pick probabilities at iteration ``it``."""
    w, act = config.weights_and_activation()
    w = jnp.asarray(w)
    active = it > jnp.asarray(act)
    # activate_after == 0 means always active.
    active = active | (jnp.asarray(act) == 0)
    probs = w * active.astype(w.dtype)
    return probs / jnp.maximum(jnp.sum(probs), 1e-9)
