"""Statistical validation of replica-exchange machinery.

The reference's design point: the default geometric ladder spacing
``1 + sqrt(2/ndim)`` targets ~25% adjacent-pair swap acceptance
(PTMCMCSampler.py:699-704). We verify both swap modes hit a sane acceptance
band on a Gaussian target and that DEO and sweep agree statistically —
SURVEY.md §7's "swap-scheme fidelity" hard part.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptmcmcsampler_tpu.config import SamplerConfig, build_default_jumps
from ptmcmcsampler_tpu.kernel import build_step
from ptmcmcsampler_tpu.ladder import ladder_betas, temperature_ladder
from ptmcmcsampler_tpu.state import init_state


def build(ndim=8, ntemps=6, nchains=32, swap_mode="sweep", hot_chain=False, seed=0):
    def logl(x):
        return -0.5 * jnp.sum(x**2)

    def logp(x):
        return jnp.where(jnp.all(jnp.abs(x) < 30.0), 0.0, -jnp.inf)

    cfg = SamplerConfig(
        ndim=ndim, ntemps=ntemps, nchains=nchains,
        groups=(tuple(range(ndim)),),
        jumps=build_default_jumps(burn=200),
        tskip=10, cov_update=200, burn=200, thin=5, de_size=500,
        swap_mode=swap_mode,
    )
    step, run_block = build_step(cfg, logl, logp)
    ladder = temperature_ladder(ndim, ntemps)
    lad, betas = ladder_betas(ladder, hot_chain=hot_chain)
    xs = jnp.zeros((ntemps, nchains, ndim)) + 0.1
    ll0 = jax.vmap(jax.vmap(logl))(xs)
    lp0 = jax.vmap(jax.vmap(logp))(xs)
    state = init_state(
        cfg, jax.random.PRNGKey(seed), np.zeros(ndim) + 0.1, np.eye(ndim) * 0.5,
        betas, ll0, lp0,
    )
    return cfg, run_block, state


def swap_rates(state):
    # Per-pair accounting: proposed[i] counts events where pair (i, i+1) was
    # actually proposed (all pairs per sweep event; alternating pairs in DEO),
    # so accepted/proposed is directly comparable across swap modes.
    prop = np.asarray(state.counters.swaps_proposed, dtype=np.float64)[:-1]
    acc = np.asarray(state.counters.swaps_accepted, dtype=np.float64)
    return acc.mean(axis=1)[:-1] / np.maximum(prop, 1.0)


@pytest.mark.slow
def test_sweep_acceptance_design_point():
    cfg, run_block, state = build(swap_mode="sweep")
    state, _ = run_block(state, 400)  # burn
    state, _ = run_block(state, 1600)
    rates = swap_rates(state)
    # ~25% target for equilibrated Gaussian chains; generous band
    assert np.all(rates > 0.08), rates
    assert np.all(rates < 0.8), rates
    assert 0.12 < rates.mean() < 0.6, rates


@pytest.mark.slow
def test_deo_matches_sweep_statistics():
    # 64 chains x 4800 recorded rows (24k iterations, 2400 swap events) give
    # >150k proposals per adjacent pair: the nominal per-pair MC error is
    # <1% and even with chain autocorrelation stays well under 5%, so a
    # per-pair 15% gate has real teeth against a swap-law regression
    _, run_sweep, s1 = build(swap_mode="sweep", seed=1, nchains=64)
    _, run_deo, s2 = build(swap_mode="deo", seed=2, nchains=64)
    s1, _ = run_sweep(s1, 400)
    s1, o1 = run_sweep(s1, 4800)
    s2, _ = run_deo(s2, 400)
    s2, o2 = run_deo(s2, 4800)
    # cold-chain marginal std must agree between swap schemes
    std1 = np.moveaxis(np.asarray(o1.x[:, 0]), 1, 2).reshape(-1, 8).std(axis=0)
    std2 = np.moveaxis(np.asarray(o2.x[:, 0]), 1, 2).reshape(-1, 8).std(axis=0)
    np.testing.assert_allclose(std1, std2, rtol=0.15)
    # Counters before the burn segment are included in the cumulative rates;
    # both modes share the same burn treatment so the comparison is fair.
    r1 = swap_rates(s1)
    r2 = swap_rates(s2)
    np.testing.assert_allclose(r1, r2, rtol=0.15)
    np.testing.assert_allclose(r1.mean(), r2.mean(), rtol=0.08)


def test_hot_chain_samples_prior():
    cfg, run_block, state = build(hot_chain=True, ntemps=4, ndim=2)
    assert float(state.betas[-1]) == 0.0
    state, out = run_block(state, 800)
    hot = np.moveaxis(np.asarray(out.x[400:, -1]), 1, 2).reshape(-1, 2)
    # beta=0 chain samples the uniform box prior: wide spread, no pull to 0
    assert hot.std() > 5.0
    cold = np.moveaxis(np.asarray(out.x[400:, 0]), 1, 2).reshape(-1, 2)
    assert cold.std() < 3.0
