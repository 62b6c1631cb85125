"""Sampler state pytrees.

The reference mutates ``self.*`` attributes across a Python loop
(PTMCMCSampler.py:499-528); here the entire sampler state is one pytree and
one pure ``step(state) -> state`` function is scanned on device.
"""

from __future__ import annotations

import chex
import jax
import jax.numpy as jnp
import numpy as np

from . import utils
from .config import SamplerConfig


@chex.dataclass
class AdaptState:
    """Proposal-covariance adaptation (reference ``_updateRecursive``,
    PTMCMCSampler.py:769-803, and the gradient jumps' whitening factors,
    nutsjump.py:51-69)."""

    mean: jax.Array  # [D] running mean (Welford mu)
    m2: jax.Array  # [D, D] running scatter (Welford M2)
    # Samples consumed, as a Kahan-compensated f32 pair: f32 alone stops
    # incrementing once ulp(count) exceeds the per-update batch size
    # (~3e10 samples at 4096 chains/iter); the compensation term keeps the
    # integer sum exact far beyond any run length without requiring x64.
    count: jax.Array  # scalar f32
    count_err: jax.Array  # scalar f32 Kahan compensation
    cov: jax.Array  # [D, D] current proposal covariance
    group_u: tuple  # per-group eigenvectors, shapes [(sg, sg), ...]
    group_s: tuple  # per-group eigenvalues, shapes [(sg,), ...]
    chol: jax.Array  # [D, D] lower Cholesky of mass-matrix inverse (cov)
    chol_inv: jax.Array  # [D, D] inverse of chol


@chex.dataclass
class DEState:
    """Differential-evolution history ring buffer (reference ``_DEbuffer``,
    PTMCMCSampler.py:219-221, :806-817) — device-resident, written every
    iteration from the cold chains instead of bulk-copied every ``burn``."""

    buf: jax.Array  # [D, B] (chain/history-minor, matching SamplerState.x)
    filled: jax.Array  # scalar i32: valid rows


@chex.dataclass
class StepSizeState:
    """NUTS dual-averaging state (nutsjump.py:414-420, :804-816), one per
    (temperature, chain) instead of the reference's per-rank scalars."""

    epsilon: jax.Array  # [T, C]; <=0 means "not yet initialized" (nutsjump.py:671)
    epsilonbar: jax.Array  # [T, C]
    hbar: jax.Array  # [T, C]
    mu: jax.Array  # [T, C] log(10*eps0)
    ncalls: jax.Array  # [T, C] gradient-jump call counter (GradientJump.iter)
    # ChEES-HMC per-temperature state, replicated along C for a uniform
    # [T, C] pytree layout (proposals/chees.py).
    chees_eps: jax.Array  # [T, C]
    chees_epsbar: jax.Array  # [T, C] f32
    chees_hbar: jax.Array  # [T, C] f32
    chees_mu: jax.Array  # [T, C] f32; 0 = "uninitialized"
    chees_count: jax.Array  # [T, C] f32
    chees_m: jax.Array  # [T, C] f32 Adam first moment (log tlen)
    chees_v: jax.Array  # [T, C] f32 Adam second moment
    chees_tlen: jax.Array  # [T, C] trajectory length (time units)


@chex.dataclass
class Counters:
    """Acceptance bookkeeping (PTMCMCSampler.py:214-217, :602, :620-622,
    :662, :692)."""

    naccepted: jax.Array  # [T, C] i32
    jump_proposed: jax.Array  # [J, T, C] i32
    jump_accepted: jax.Array  # [J, T, C] i32
    # Per adjacent-pair proposal counts (pair i = (i, i+1), index T-1 unused):
    # the sweep scheme proposes every pair per swap event, DEO only the
    # active-parity pairs, so accepted/proposed is mode-consistent.
    swaps_proposed: jax.Array  # [T] i32
    swaps_accepted: jax.Array  # [T, C] i32 (per adjacent pair index)
    # Snapshots of the two swap counters at the last ladder-geometry update:
    # the adaptive ladder (Vousden+ 2016) feeds on RECENT-window acceptance
    # rates (delta since the snapshot), not lifetime cumulative rates — with
    # cumulative rates the geometry update is increasingly dominated by stale
    # early-burn history and converges slower than the scheme it cites.
    swaps_proposed_lad: jax.Array  # [T] i32
    swaps_accepted_lad: jax.Array  # [T, C] i32


@chex.dataclass
class SamplerState:
    key: jax.Array  # PRNG key (uint32[2])
    it: jax.Array  # scalar i32, current iteration number
    # Positions are CHAIN-MINOR ([T, D, C], not [T, C, D]): the vmapped chain
    # batch is the throughput axis, and keeping it minormost makes every
    # elementwise op run over contiguous chains (at small D, a [T, C, D]
    # layout leaves the minor axis D wide and forces layout copies).
    x: jax.Array  # [T, D, C] positions (chain-minor)
    lnlike: jax.Array  # [T, C]
    lnprior: jax.Array  # [T, C]
    betas: jax.Array  # [T] inverse temperatures
    adapt: AdaptState
    de: DEState
    stepsize: StepSizeState
    counters: Counters
    # NUTS trajectory capture for (temp 0, chain 0); None unless
    # config.nuts_trajectory is set (reference trajectoryDir facility).
    traj: object = None

    @property
    def lnprob(self):
        return utils.tempered_lnprob(self.lnlike, self.lnprior, self.betas[:, None])


def init_adapt_state(config: SamplerConfig, cov0: np.ndarray) -> AdaptState:
    d = config.ndim
    dt = config.dtype
    cov0 = np.asarray(cov0, dtype=np.float64)
    group_u, group_s = [], []
    for g in config.groups:
        sub = cov0[np.ix_(g, g)]
        # Reference uses SVD of the symmetric PSD group covariance
        # (PTMCMCSampler.py:139-145); eigh of the symmetric block is equivalent.
        s, u = np.linalg.eigh(sub)
        s = np.maximum(s, 0.0)
        group_u.append(jnp.asarray(u, dtype=dt))
        group_s.append(jnp.asarray(s, dtype=dt))
    chol = np.linalg.cholesky(cov0 + 1e-12 * np.mean(np.diag(cov0)) * np.eye(d))
    chol_inv = np.linalg.solve(chol, np.eye(d))
    return AdaptState(
        mean=jnp.zeros((d,), dt),
        m2=jnp.zeros((d, d), dt),
        count=jnp.zeros((), jnp.float32),
        count_err=jnp.zeros((), jnp.float32),
        cov=jnp.asarray(cov0, dtype=dt),
        group_u=tuple(group_u),
        group_s=tuple(group_s),
        chol=jnp.asarray(chol, dtype=dt),
        chol_inv=jnp.asarray(chol_inv, dtype=dt),
    )


def init_state(
    config: SamplerConfig,
    key: jax.Array,
    x0: np.ndarray,
    cov0: np.ndarray,
    betas: np.ndarray,
    lnlike0: jax.Array,
    lnprior0: jax.Array,
) -> SamplerState:
    t, c, d = config.ntemps, config.nchains, config.ndim
    j = config.njumps
    dt = config.dtype
    de_rows = max(config.de_size, c)
    traj = None
    if config.nuts_trajectory:
        from .trajectory import empty_capture

        traj = empty_capture(config)
    # Accept x0 as a single start point [D] (broadcast to all chains) or as
    # per-chain starts in the caller-facing [T, C, D] convention; the stored
    # state is chain-minor [T, D, C].
    x0a = np.asarray(x0, dtype=np.float64)
    if x0a.ndim == 3:
        xs0 = np.moveaxis(x0a, 2, 1)
    else:
        xs0 = np.broadcast_to(x0a.reshape(d, 1), (t, d, c))
    return SamplerState(
        traj=traj,
        key=utils.ensure_typed_key(key),
        it=jnp.zeros((), jnp.int32),
        x=jnp.asarray(xs0, dtype=dt),
        lnlike=jnp.asarray(lnlike0, dtype=dt).reshape(t, c),
        lnprior=jnp.asarray(lnprior0, dtype=dt).reshape(t, c),
        betas=jnp.asarray(betas, dtype=dt),
        adapt=init_adapt_state(config, cov0),
        de=DEState(buf=jnp.zeros((d, de_rows), dt), filled=jnp.zeros((), jnp.int32)),
        stepsize=StepSizeState(
            epsilon=jnp.full((t, c), -1.0, dt),
            epsilonbar=jnp.ones((t, c), dt),
            hbar=jnp.zeros((t, c), dt),
            mu=jnp.zeros((t, c), dt),
            ncalls=jnp.zeros((t, c), dt),
            chees_eps=jnp.zeros((t, c), dt),
            chees_epsbar=jnp.zeros((t, c), jnp.float32),
            chees_hbar=jnp.zeros((t, c), jnp.float32),
            chees_mu=jnp.zeros((t, c), jnp.float32),
            chees_count=jnp.zeros((t, c), jnp.float32),
            chees_m=jnp.zeros((t, c), jnp.float32),
            chees_v=jnp.zeros((t, c), jnp.float32),
            chees_tlen=jnp.full((t, c), float(config.hmc_stepsize), dt),
        ),
        counters=Counters(
            naccepted=jnp.zeros((t, c), jnp.int32),
            jump_proposed=jnp.zeros((j, t, c), jnp.int32),
            jump_accepted=jnp.zeros((j, t, c), jnp.int32),
            swaps_proposed=jnp.zeros((t,), jnp.int32),
            swaps_accepted=jnp.zeros((t, c), jnp.int32),
            swaps_proposed_lad=jnp.zeros((t,), jnp.int32),
            swaps_accepted_lad=jnp.zeros((t, c), jnp.int32),
        ),
    )
