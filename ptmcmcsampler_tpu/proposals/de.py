"""Differential-evolution jump from the device-resident history ring buffer.

Parity target: ``DEJump`` (PTMCMCSampler.py:936-985): pick two distinct rows
of the history buffer, jump along their difference restricted to a random
parameter group; with prob 0.5 a "mode jump" (scale=1.0), else
``uniform() * 2.4/sqrt(2*sg) * sqrt(1/beta)``. Symmetric (log_qxy = 0).

Two pair-selection modes (``SamplerConfig.de_pair``):

* ``"rolled"`` (default) — one counter-rotating shift pair (s1, s2) per
  iteration; chain ``c`` uses buffer rows ((c+s1) % n, (s2-c) % n). For
  EVERY chain the marginal pair law is uniform over ordered pairs (both
  maps are bijections of the uniform shifts for fixed c); the one-in-n
  colliding pairs become identity moves instead of the reference's
  redraw-until-distinct. Only the *joint* selection across chains is
  correlated — a mixture over (s1, s2) of product kernels, each of which
  preserves the product posterior, so stationarity is exact (statistical
  equivalence to iid pairs is asserted in tests/test_de_modes.py, and the
  bench's moment QA z-score on the bimodal curved target gates the
  cross-chain correlation empirically). Motivation: the full buffer
  difference is rolls and a subtract, where per-chain iid rows cost a
  per-element gather per call.
* ``"iid"`` — the reference's literal law: independent uniform
  ordered-distinct rows per chain, via gather.

The ring buffer is chain-minor ([D, B]), matching ``SamplerState.x``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .base import GroupEmbed, random_group, safe_temperature, switch_over_groups


def _de_scale_and_apply(groups, embeds, prob, ku, temp, sigma_full, x, kg):
    """Shared group-restricted application of a DE difference vector."""

    def branch(gi):
        g = groups[gi]
        sg = len(g)
        base = np.float64(2.4 / np.sqrt(2.0 * sg))
        emb = embeds[gi]

        def apply(x):
            scale = jnp.where(
                prob > 0.5,
                jnp.asarray(1.0, x.dtype),
                (jax.random.uniform(ku, dtype=x.dtype) * jnp.asarray(base, x.dtype))
                * jnp.sqrt(temp).astype(x.dtype),
            )
            sigma = emb.take(sigma_full)
            return emb.add_at(x, scale * sigma)

        return apply

    gidx = random_group(kg, len(groups))
    return switch_over_groups(gidx, [branch(i) for i in range(len(groups))], x)


def make_de(config):
    """Per-chain iid pair draws (reference-literal law; gather-based)."""
    groups = [np.asarray(g) for g in config.groups]
    embeds = [GroupEmbed(g, config.ndim, config.dtype) for g in groups]

    def de(key, x, beta, it, ctx):
        kg, km, kn, kp, ku = jax.random.split(key, 5)
        nvalid = jnp.maximum(ctx.de_valid, 2)
        mm = jax.random.randint(km, (), 0, nvalid)
        # The reference redraws until distinct (:963-966), i.e. uniform over
        # ordered distinct pairs. Drawing nn over nvalid-1 and shifting past mm
        # reproduces that law exactly (a +1%nvalid collision remap would make
        # the pair (i, i+1) twice as likely as (i+1, i)).
        nn = jax.random.randint(kn, (), 0, nvalid - 1)
        nn = nn + (nn >= mm)
        prob = jax.random.uniform(kp)
        # sqrt(1/beta) per the reference (:976); the hot chain's beta->0 is
        # clamped so f32 stays finite (reference would produce 1e40).
        temp = jnp.minimum(safe_temperature(beta), 1e30)
        sigma_full = ctx.de_buf[:, mm] - ctx.de_buf[:, nn]  # buf is [D, B]
        q = _de_scale_and_apply(groups, embeds, prob, ku, temp, sigma_full, x, kg)
        return q, jnp.zeros((), x.dtype)

    return de


def make_de_blocked(config):
    """Blocked-iid pair draws: independent ordered-distinct rows per GROUP of
    ``de_block`` chains, shared within the group.

    Per-chain marginal law is exactly the reference's uniform
    ordered-distinct draw; the joint selection has C/de_block independent
    pairs per temperature per iteration (vs C for literal iid), which the
    curved-target moment QA measures as statistically indistinguishable from
    iid — while the gather touches de_block-times fewer rows (fully-shared
    shift schemes are gather-free but synchronize mode jumps across all
    chains: z~34 on the bench's moment QA).
    """
    groups = [np.asarray(g) for g in config.groups]
    embeds = [GroupEmbed(g, config.ndim, config.dtype) for g in groups]
    gsize = max(1, int(getattr(config, "de_block", 8)))

    def de_blocked(keys, x, betas, it, ctx, ss):
        t, d, c = x.shape  # chain-minor
        ng = -(-c // gsize)  # groups per temperature
        nvalid = jnp.maximum(ctx.de_valid, 2)
        skey = jax.random.fold_in(keys[0, 0], 7919)
        kmm, knn = jax.random.split(skey)
        mm = jax.random.randint(kmm, (t, ng), 0, nvalid)
        # Ordered-distinct law, as in make_de.
        nn = jax.random.randint(knn, (t, ng), 0, nvalid - 1)
        nn = nn + (nn >= mm)
        sig = ctx.de_buf[:, mm] - ctx.de_buf[:, nn]  # [D, T, G]
        sig_c = jnp.repeat(sig, gsize, axis=2)[:, :, :c]  # [D, T, C]

        temps = jnp.minimum(safe_temperature(betas), 1e30)  # [T]

        def per_chain(key, x1, temp, s1):
            kg, kp, ku = jax.random.split(key, 3)
            prob = jax.random.uniform(kp)
            return _de_scale_and_apply(groups, embeds, prob, ku, temp, s1, x1, kg)

        per_temp = jax.vmap(per_chain, in_axes=(0, -1, None, -1), out_axes=-1)
        q = jax.vmap(per_temp, in_axes=(0, 0, 0, 1))(keys, x, temps, sig_c)
        return q, jnp.zeros((t, c), x.dtype), ss

    return de_blocked


def make_de_batch(config):
    """Shared-shift ("rolled") pair draws: gather-free batch DE kernel.

    WARNING: all chains' pairs derive from one scalar shift pair per
    iteration; on multimodal targets the synchronized difference vectors
    correlate mode transitions across chains (moments_max_z ~ 34 on the
    curved bench vs 0.65 for iid). Prefer the
    default "blocked" mode; "rolled" remains for unimodal targets where the
    last ~3% of iteration rate matters.

    Branch signature matches the batch-level protocol of
    ``build_jump_branches``: (keys [T,C,...], x [T,C,D], betas [T], it, ctx,
    ss) -> (q, qxy, ss).
    """
    groups = [np.asarray(g) for g in config.groups]
    embeds = [GroupEmbed(g, config.ndim, config.dtype) for g in groups]

    def de_batch(keys, x, betas, it, ctx, ss):
        t, d, c = x.shape  # chain-minor
        rows = ctx.de_buf.shape[1]
        nvalid = jnp.maximum(ctx.de_valid, 2)
        # Counter-rotating shifts, one pair per iteration: chain c uses rows
        # ((c + s1) % n, (s2 - c) % n) — derived by fold_in from the (0,0)
        # chain key so they are independent of every per-chain split stream
        # used below. The two indices rotate in OPPOSITE directions with c,
        # so adjacent chains get unrelated row pairs (a same-direction
        # variant measured z = 33 on the bench's moment QA — the shared
        # difference vector synchronized mode jumps across chains and
        # inflated the pooled ESS; this variant measures clean z).
        skey = jax.random.fold_in(keys[0, 0], 7919)
        k1, k2 = jax.random.split(skey)
        s1 = jax.random.randint(k1, (), 0, nvalid)
        s2 = jax.random.randint(k2, (), 0, nvalid)
        # Chains where the two rows collide ((2c + s1 - s2) % n == 0, one in
        # n) make an identity move this iteration (sigma = 0) — a valid
        # state-independent mixture component replacing the reference's
        # redraw-until-distinct.
        coll = ((2 * jnp.arange(c) + s1 - s2) % nvalid) == 0

        def full_case(_):
            # Buffer fully valid (the steady state): both index streams are
            # rolls — no gather. Tiling covers the (unusual) case of more
            # chains than ring rows (the row pattern repeats with period
            # ``rows``).
            b1 = jnp.roll(ctx.de_buf, -s1, axis=1)
            flipped = ctx.de_buf[:, ::-1]
            # flipped rolled by -(n-1-s2) puts buf[:, (s2 - c) % n] at col c.
            b2 = jnp.roll(flipped, s2 + 1, axis=1)
            diff = b1 - b2
            if rows < c:
                diff = jnp.tile(diff, (1, -(-c // rows)))
            return diff[:, :c]

        def partial_case(_):
            # Rare early-run case (DE selected while the ring is part-full):
            # per-chain modulo needs a real gather.
            idx1 = (jnp.arange(c) + s1) % nvalid
            idx2 = (s2 - jnp.arange(c)) % nvalid
            return ctx.de_buf[:, idx1] - ctx.de_buf[:, idx2]

        d_all = jax.lax.cond(nvalid == rows, full_case, partial_case, None)  # [D, C]
        d_all = jnp.where(coll, jnp.zeros((), d_all.dtype), d_all)

        temps = jnp.minimum(safe_temperature(betas), 1e30)  # [T]

        def per_chain(key, x1, temp, sig):
            kg, kp, ku = jax.random.split(key, 3)
            prob = jax.random.uniform(kp)
            return _de_scale_and_apply(groups, embeds, prob, ku, temp, sig, x1, kg)

        per_temp = jax.vmap(per_chain, in_axes=(0, -1, None, -1), out_axes=-1)
        q = jax.vmap(per_temp, in_axes=(0, 0, 0, None))(keys, x, temps, d_all)
        return q, jnp.zeros((t, c), x.dtype), ss

    return de_batch
