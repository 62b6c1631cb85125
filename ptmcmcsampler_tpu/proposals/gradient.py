"""Gradient-based jumps: whitened leapfrog dynamics, MALA and HMC.

Parity targets in the reference's ``nutsjump.py``:
  * whitening through the Cholesky factor of the mass-matrix inverse
    (``set_cf``/``forward``/``backward``/``func_grad_white``,
    nutsjump.py:51-90);
  * ``leapfrog`` (nutsjump.py:149-169);
  * ``MALAJump`` (nutsjump.py:182-235) — one-eigenvector Langevin step with
    exact forward/backward correction;
  * ``HMCJump`` (nutsjump.py:238-291) — random trajectory length in
    [nminsteps, nmaxsteps), fixed step size, divergence break, and
    ``qxy = joint1 - joint0`` so the outer MH step accepts by Hamiltonian
    error;
  * ``find_reasonable_epsilon`` (nutsjump.py:435-463).

The tempered log-density is ``beta*ll + lp`` with matching gradient
(``func_grad``, nutsjump.py:71-76). All dynamics run per-chain and are
vmapped by the step kernel; loops are ``lax``-native so everything stays
inside one compiled program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .base import ProposalContext  # noqa: F401  (docs)


def make_whitened_funcs(func_grad):
    """Build the whitened-space helpers around a tempered ``func_grad``.

    ``func_grad(x, beta) -> (val, grad)`` operates in the original space. The
    whitening products are pinned to full float32 precision so that
    ``backward(forward(x))`` returns ``x`` to within rounding.
    """

    def forward(ctx, x):
        return jnp.matmul(ctx.chol_inv.T, x, precision=lax.Precision.HIGHEST)

    def backward(ctx, q):
        return jnp.matmul(ctx.chol.T, q, precision=lax.Precision.HIGHEST)

    def func_grad_white(ctx, q, beta):
        x = backward(ctx, q)
        fv, fg = func_grad(x, beta)
        return fv, jnp.matmul(ctx.chol, fg, precision=lax.Precision.HIGHEST)

    return forward, backward, func_grad_white


def leapfrog(func_grad_white, ctx, beta, theta, r, grad, epsilon):
    """One leapfrog step in whitened coordinates (nutsjump.py:149-169)."""
    rprime = r + 0.5 * epsilon * grad
    thetaprime = theta + epsilon * rprime
    logpprime, gradprime = func_grad_white(ctx, thetaprime, beta)
    rprime = rprime + 0.5 * epsilon * gradprime
    return thetaprime, rprime, gradprime, logpprime


def loghamiltonian(logp, r):
    """H = logp - r.r/2 (nutsjump.py:96-101), NaN-safe."""
    h = logp - 0.5 * jnp.dot(r, r)
    return jnp.where(jnp.isnan(h), -jnp.inf, h)


def make_mala(config, func_grad):
    forward, backward, fgw = make_whitened_funcs(func_grad)
    ndim = config.ndim
    cd = 2.4 / jnp.sqrt(jnp.asarray(float(ndim)))

    def mala(key, x, beta, it, ctx):
        ki, kd = jax.random.split(key)
        q0 = forward(ctx, x)
        _, grad0 = fgw(ctx, q0, beta)

        # Whitened space: eigenvectors are the identity, eigenvalues 1
        # (nutsjump.py:193-198).
        i = jax.random.randint(ki, (), 0, ndim)
        # one_hot, not .at[i].set: a traced index scatter per vmapped chain
        # lowers to a slow per-element scatter.
        vec = jax.nn.one_hot(i, ndim, dtype=x.dtype)
        dist = jax.random.normal(kd, dtype=x.dtype)

        cdt = cd.astype(x.dtype)
        mq0 = q0 + 0.5 * vec * cdt**2 * jnp.dot(vec, grad0) / 2.0
        q1 = mq0 + dist * vec * cdt
        _, grad1 = fgw(ctx, q1, beta)
        mq1 = q1 + 0.5 * vec * cdt**2 * jnp.dot(vec, grad1) / 2.0

        # Forward/backward correction for the Gaussian proposal with stddev
        # cd along `vec`. NOTE: the reference computes this without the 1/cd^2
        # normalization (nutsjump.py:233), which breaks detailed balance and
        # is why it warns "MALA jumps are not working properly yet"
        # (PTMCMCSampler.py:230-231). We implement the correct density ratio.
        qxy = 0.5 * (jnp.sum((mq0 - q1) ** 2) - jnp.sum((mq1 - q0) ** 2)) / cdt**2
        qxy = jnp.where(jnp.isnan(qxy), -jnp.inf, qxy)
        return backward(ctx, q1), qxy

    return mala


def make_hmc(config, func_grad):
    forward, backward, fgw = make_whitened_funcs(func_grad)
    nmin, nmax = config.hmc_nminsteps, config.hmc_nmaxsteps
    eps0 = config.hmc_stepsize

    def hmc(key, x, beta, it, ctx):
        kp, kn = jax.random.split(key)
        q0 = forward(ctx, x)
        logp0, grad0 = fgw(ctx, q0, beta)
        p0 = jax.random.normal(kp, (config.ndim,), dtype=x.dtype)
        joint0 = loghamiltonian(logp0, p0)

        nsteps = jax.random.randint(kn, (), nmin, nmax)
        eps = jnp.asarray(eps0, x.dtype)

        def cond(carry):
            ii, _, _, _, _, _, stopped = carry
            return (ii < nsteps) & ~stopped

        def body(carry):
            ii, q, p, grad, logp1, joint1, stopped = carry
            q1, p1, grad1, logp1 = leapfrog(fgw, ctx, beta, q, p, grad, eps)
            joint1 = loghamiltonian(logp1, p1)
            # Divergence break — the reference keeps the diverged point and
            # lets qxy reject it (nutsjump.py:285-287).
            stopped = (joint1 - 1000.0) < joint0
            return ii + 1, q1, p1, grad1, logp1, joint1, stopped

        init = (
            jnp.zeros((), jnp.int32), q0, p0, grad0, logp0, joint0,
            jnp.zeros((), bool),
        )
        _, q, _, _, logp1, joint1, _ = jax.lax.while_loop(cond, body, init)

        # Kinetic-energy correction K0 - K1, so the outer MH ratio
        # (newlnprob - lnprob0 + qxy) equals the Hamiltonian error
        # joint1 - joint0 — the acceptance the reference *intends*
        # (nutsjump.py:288-289 comment). NOTE: the reference actually returns
        # qxy = joint1 - joint0, which double-counts the potential-energy
        # difference in the outer MH step and makes its HMC sample
        # ~exp(2*logp) instead of exp(logp) (empirically: variance 0.5 on a
        # standard normal). We return the correct correction.
        qxy = (joint1 - joint0) - (logp1 - logp0)
        qxy = jnp.where(jnp.isnan(qxy), -jnp.inf, qxy)
        return backward(ctx, q), qxy

    return hmc


def find_reasonable_epsilon(key, fgw, ctx, beta, theta0, grad0, logp0, max_iters=64):
    """Step-size doubling heuristic (nutsjump.py:435-463), loop-bounded."""
    dt = theta0.dtype
    r0 = jax.random.normal(key, theta0.shape, dtype=dt)
    one = jnp.ones((), dt)

    def lf(eps):
        return leapfrog(fgw, ctx, beta, theta0, r0, grad0, eps)

    # Shrink until logp and grad are finite (nutsjump.py:446-451).
    def shrink_cond(carry):
        k, i, bad = carry
        return bad & (i < max_iters)

    def shrink_body(carry):
        k, i, _ = carry
        k = k * 0.5
        _, _, gradp, logpp = lf(one * k)
        bad = jnp.isinf(logpp) | jnp.any(jnp.isinf(gradp)) | jnp.isnan(logpp) | jnp.any(
            jnp.isnan(gradp)
        )
        return k, i + 1, bad

    _, rp, gradp, logpp = lf(one)
    bad0 = jnp.isinf(logpp) | jnp.any(jnp.isinf(gradp)) | jnp.isnan(logpp) | jnp.any(
        jnp.isnan(gradp)
    )
    k, _, _ = jax.lax.while_loop(
        shrink_cond, shrink_body, (one * 2.0, jnp.zeros((), jnp.int32), bad0)
    )
    # (start at 2.0 so the first halving reproduces k=1.0 when bad0)
    k = jnp.where(bad0, k, one)

    epsilon = 0.5 * k
    joint0 = loghamiltonian(logp0, r0)

    def accept_prob(eps):
        _, rprime, _, logpprime = lf(eps)
        return jnp.exp(loghamiltonian(logpprime, rprime) - joint0)

    ap0 = accept_prob(epsilon)
    ap0 = jnp.where(jnp.isnan(ap0), jnp.zeros((), dt), ap0)
    a = jnp.where(ap0 > 0.5, one, -one)

    def dbl_cond(carry):
        eps, ap, i = carry
        return (ap**a > 2.0 ** (-a)) & (i < max_iters)

    def dbl_body(carry):
        eps, _, i = carry
        eps = eps * 2.0**a
        ap = accept_prob(eps)
        ap = jnp.where(jnp.isnan(ap), jnp.zeros((), dt), ap)
        return eps, ap, i + 1

    epsilon, _, _ = jax.lax.while_loop(
        dbl_cond, dbl_body, (epsilon, ap0, jnp.zeros((), jnp.int32))
    )
    return jnp.maximum(epsilon, jnp.asarray(1e-8, dt))
