"""ChEES-HMC: adaptive-trajectory HMC designed for batched (vmapped) chains.

Beyond-reference capability (SURVEY.md §7 build order 3 flags it as the
vmap-friendly alternative to NUTS; see PAPERS.md — Hoffman, Radul & Sountsov,
"An Adaptive-MCMC Scheme for Setting Trajectory Lengths in Hamiltonian Monte
Carlo", and the ChEES criterion follow-ups): instead of NUTS's per-chain
variable-depth tree (whose masked while-loop cost is the *max* depth across
the batch), every chain runs a fixed-length leapfrog trajectory whose shared
length is adapted by maximizing the ChEES criterion

    ChEES = 1/4 E[ (||q' - E q'||^2 - ||q - E q||^2)^2 ],

the change in the estimator of the expected squared distance from the mean —
a proxy for ESS of second-moment estimands. The trajectory time ``tau`` is
jittered per chain (tau_c = u_c * tlen, u ~ U(0,1]), which both regularizes
the criterion and desynchronizes periodic orbits.

Mechanics per selected iteration (one temperature rung at a time, batched
over its chains):

* whitened leapfrog with per-temperature step size ``eps`` (mass matrix =
  proposal covariance, as the reference's GradientJump, nutsjump.py:51-76);
* per-chain step counts ``ceil(tau_c / eps)`` capped at ``chees_max_steps``;
  the batch pays the per-rung *max*, which the jitter keeps near the mean —
  unlike NUTS there is no 2^depth tail;
* MH correction ``qxy = K0 - K1`` so acceptance equals the Hamiltonian error
  (same convention as our HMC jump);
* adaptation during burn-in only: dual averaging of ``log eps`` toward the
  ChEES paper's target acceptance 0.651, and Adam ascent on ``log tlen``
  along the per-chain criterion gradient estimate
  ``u_c * (d1_c - d0_c) * <q1_c - mean(q1), r1_c>`` weighted by the
  acceptance probabilities. After burn-in both freeze (eps at its dual-
  averaged mean), preserving detailed balance exactly.

All adaptation statistics are cross-chain means, so under a sharded chain
axis they lower to ``psum``s — every device owns identical ChEES state
without broadcasts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .gradient import leapfrog, make_whitened_funcs

# Dual-averaging constants shared with the NUTS jump (nutsjump.py:414-420).
from .nuts import GAMMA, KAPPA, T0  # noqa: E402
# Adam constants for the trajectory-length ascent (ChEES paper defaults).
B1 = 0.9
B2 = 0.999
ADAM_EPS = 1e-8


def make_chees(config, func_grad):
    forward, backward, fgw = make_whitened_funcs(func_grad)
    max_steps = config.chees_max_steps
    delta = config.chees_delta
    lr = config.chees_lr
    nburn = config.burn
    eps0 = config.hmc_stepsize

    def chees(keys, x, betas, it, ctx, ss):
        """Batched kernel over the full [T, C] replica block; ``x`` is
        chain-minor [T, D, C].

        ``ss`` holds [T, C] arrays; the chees_* entries are constant across
        the chain axis (they are per-temperature scalars, replicated so the
        step-size pytree keeps a uniform [T, C] layout).
        """
        t, d, c = x.shape
        dt = x.dtype

        def split4(k):
            return jax.random.split(k, 4)

        ks = jax.vmap(jax.vmap(split4))(keys)  # [T, C, 4, 2]
        k_mom, k_jit = ks[:, :, 0], ks[:, :, 1]

        eps_tc = jnp.where(ss["chees_eps"] > 0, ss["chees_eps"], eps0).astype(dt)
        tlen_tc = jnp.maximum(ss["chees_tlen"], eps_tc).astype(dt)
        eps_t = eps_tc  # [T, C], constant over C
        u = jax.vmap(
            jax.vmap(lambda k: jax.random.uniform(k, (), dtype=dt, minval=1e-3, maxval=1.0))
        )(k_jit)
        tau = u * tlen_tc
        nsteps = jnp.clip(
            jnp.ceil(tau / eps_t), 1, max_steps
        ).astype(jnp.int32)  # [T, C]

        fwd = jax.vmap(jax.vmap(lambda xx: forward(ctx, xx), in_axes=-1, out_axes=-1))
        q0 = fwd(x)  # [T, D, C] whitened
        fgw_b = jax.vmap(
            jax.vmap(
                lambda qq, b: fgw(ctx, qq, b), in_axes=(-1, None), out_axes=(0, -1)
            ),
            in_axes=(0, 0),
        )
        logp0, grad0 = fgw_b(q0, betas)

        r0 = jax.vmap(
            jax.vmap(lambda k: jax.random.normal(k, (d,), dtype=dt), out_axes=-1)
        )(k_mom)  # [T, D, C]
        k0 = 0.5 * jnp.sum(r0 * r0, axis=1)

        lf = jax.vmap(
            jax.vmap(
                lambda z, r, g, e, b: leapfrog(fgw, ctx, b, z, r, g, e),
                in_axes=(-1, -1, -1, 0, None),
                out_axes=(-1, -1, -1, 0),
            ),
            in_axes=(0, 0, 0, 0, 0),
        )

        max_n = jnp.max(nsteps)

        def body(carry):
            # Finished lanes take an eps=0 step — an exact identity
            # leapfrog (z + 0*rh, r + 0*g, grad/logp recomputed at the
            # unchanged point) — instead of masked selects on four
            # carries: one [T, C] where replaces four full-state wheres
            # per step.
            i, z, r, g, logp = carry
            e_step = jnp.where(i < nsteps, eps_t, jnp.zeros((), dt))
            z, r, g, logp = lf(z, r, g, e_step, betas)
            return i + 1, z, r, g, logp

        def cond(carry):
            return carry[0] < max_n

        _, z1, r1, g1, logp1 = jax.lax.while_loop(
            cond, body, (jnp.zeros((), jnp.int32), q0, r0, grad0, logp0)
        )

        k1 = 0.5 * jnp.sum(r1 * r1, axis=1)
        joint0 = logp0 - k0
        joint1 = logp1 - k1
        denergy = joint1 - joint0
        denergy = jnp.where(jnp.isnan(denergy), -jnp.inf, denergy)
        # qxy = K0 - K1 so the outer tempered-MH ratio equals exp(dH).
        qxy = (k0 - k1).astype(dt)
        qxy = jnp.where(jnp.isnan(qxy), -jnp.inf, qxy)

        alpha = jnp.minimum(1.0, jnp.exp(denergy))  # [T, C]

        new_ss = dict(ss)
        in_burn = it <= nburn

        # ---- step-size dual averaging toward delta, per temperature ----
        ncalls = ss["chees_count"][:, 0] + 1.0  # [T]
        mean_alpha = jnp.mean(alpha, axis=1)  # [T]
        mu = jnp.where(
            ss["chees_mu"][:, 0] == 0.0,
            jnp.log(10.0 * jnp.asarray(eps0, jnp.float32)),
            ss["chees_mu"][:, 0],
        )
        eta = 1.0 / (ncalls + T0)
        hbar = (1.0 - eta) * ss["chees_hbar"][:, 0] + eta * (
            delta - mean_alpha.astype(jnp.float32)
        )
        eps_burn = jnp.exp(mu - jnp.sqrt(ncalls) / GAMMA * hbar)
        eta2 = ncalls**-KAPPA
        had_calls = ss["chees_count"][:, 0] > 0
        epsbar_prev = jnp.where(
            had_calls, jnp.maximum(ss["chees_epsbar"][:, 0], 1e-30), jnp.asarray(eps0, jnp.float32)
        )
        epsbar = jnp.exp(
            (1.0 - eta2) * jnp.log(epsbar_prev) + eta2 * jnp.log(jnp.maximum(eps_burn, 1e-30))
        )
        new_eps = jnp.where(in_burn, eps_burn, epsbar_prev).astype(dt)  # [T]

        # ---- ChEES gradient ascent on log trajectory length ----
        q1m = z1 - jnp.mean(z1, axis=2, keepdims=True)  # center over chains
        q0m = q0 - jnp.mean(q0, axis=2, keepdims=True)
        d1 = jnp.sum(q1m * q1m, axis=1)
        d0 = jnp.sum(q0m * q0m, axis=1)
        per_chain = u * (d1 - d0) * jnp.sum(q1m * r1, axis=1)  # [T, C]
        w = jnp.where(jnp.isfinite(per_chain), alpha, 0.0)
        per_chain = jnp.where(jnp.isfinite(per_chain), per_chain, 0.0)
        grad_t = (jnp.sum(w * per_chain, axis=1) / jnp.maximum(jnp.sum(w, axis=1), 1e-6)).astype(
            jnp.float32
        )
        # Normalize scale so the Adam step is dimensionless.
        m_t = B1 * ss["chees_m"][:, 0] + (1.0 - B1) * grad_t
        v_t = B2 * ss["chees_v"][:, 0] + (1.0 - B2) * grad_t * grad_t
        mhat = m_t / (1.0 - B1**ncalls)
        vhat = v_t / (1.0 - B2**ncalls)
        step = lr * mhat / (jnp.sqrt(vhat) + ADAM_EPS)
        log_tlen = jnp.log(jnp.maximum(tlen_tc[:, 0].astype(jnp.float32), 1e-10))
        new_tlen = jnp.exp(jnp.where(in_burn, log_tlen + step, log_tlen))
        new_tlen = jnp.clip(
            new_tlen, new_eps.astype(jnp.float32), new_eps.astype(jnp.float32) * max_steps
        ).astype(dt)

        def rep(v):  # [T] -> [T, C]
            return jnp.broadcast_to(v[:, None], (t, c))

        def freeze(new, old):
            """Adaptation state only moves during burn-in; after burn the
            kernel is a fixed Markov kernel (mirrors nuts.py's in_burn gating)
            so detailed balance holds exactly."""
            return jnp.where(in_burn, new, old)

        new_ss["chees_eps"] = rep(freeze(new_eps, jnp.where(had_calls, epsbar_prev, eps0).astype(dt)))
        new_ss["chees_epsbar"] = rep(freeze(epsbar, epsbar_prev).astype(jnp.float32))
        new_ss["chees_hbar"] = rep(freeze(hbar, ss["chees_hbar"][:, 0]))
        new_ss["chees_mu"] = rep(mu)
        new_ss["chees_count"] = rep(freeze(ncalls, ss["chees_count"][:, 0]))
        new_ss["chees_m"] = rep(freeze(m_t, ss["chees_m"][:, 0]))
        new_ss["chees_v"] = rep(freeze(v_t, ss["chees_v"][:, 0]))
        new_ss["chees_tlen"] = rep(new_tlen)

        bwd = jax.vmap(jax.vmap(lambda zz: backward(ctx, zz), in_axes=-1, out_axes=-1))
        return bwd(z1), qxy, new_ss

    return chees
