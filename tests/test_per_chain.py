"""per_chain jump selection: full default cycle, rotation + stacked modes.

Reference law: a fresh independent kind draw per rank per iteration
(PTMCMCSampler.py:1058-1059). The rotation scheme preserves each chain's
marginal kind law (weights quantized to 1/nchains) with state-independent
selection; these tests check the partition math, that the full default
cycle (including gradient jumps — forbidden before round 5) runs in both
modes, that realized per-kind proposal counts track the weights, and that
posterior moments match the "shared" mode statistically.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptmcmcsampler_tpu.config import SamplerConfig, build_default_jumps
from ptmcmcsampler_tpu.kernel import build_step
from ptmcmcsampler_tpu.ladder import ladder_betas, temperature_ladder
from ptmcmcsampler_tpu.state import init_state


def _gaussian(ndim):
    def logl(x):
        return -0.5 * jnp.sum(x**2)

    def logp(x):
        return jnp.where(jnp.all(jnp.abs(x) < 30.0), 0.0, -jnp.inf)

    def func_grad(x, beta):
        return beta * logl(x) + logp(x), beta * jax.grad(logl)(x)

    return logl, logp, func_grad


def _build(ndim=3, ntemps=2, nchains=128, jump_select="per_chain",
           per_chain_mode="auto", with_grads=True, burn=60, seed=0):
    logl, logp, func_grad = _gaussian(ndim)
    cfg = SamplerConfig(
        ndim=ndim, ntemps=ntemps, nchains=nchains,
        groups=(tuple(range(ndim)),),
        jumps=build_default_jumps(
            SCAMweight=20, AMweight=20, DEweight=20, NUTSweight=10,
            HMCweight=10, MALAweight=0, burn=burn, have_grads=with_grads,
        ),
        tskip=10, cov_update=100, burn=burn, thin=2, de_size=200,
        jump_select=jump_select, per_chain_mode=per_chain_mode,
        hmc_stepsize=0.1, hmc_nmaxsteps=10, nuts_max_depth=4,
    )
    step, run_block = build_step(cfg, logl, logp, func_grad if with_grads else None)
    ladder = temperature_ladder(ndim, ntemps)
    _, betas = ladder_betas(ladder)
    xs = jnp.zeros((ntemps, nchains, ndim)) + 0.3
    ll0 = jax.vmap(jax.vmap(logl))(xs)
    lp0 = jax.vmap(jax.vmap(logp))(xs)
    state = init_state(
        cfg, jax.random.key(seed), np.zeros(ndim) + 0.3, np.eye(ndim) * 0.2,
        betas, ll0, lp0,
    )
    return cfg, run_block, state


def test_rotation_full_cycle_runs_and_tracks_weights():
    cfg, run_block, state = _build(nchains=128, per_chain_mode="rotation")
    state, out = run_block(state, 100)  # 200 iterations
    assert np.isfinite(np.asarray(out.x)).all()
    prop = np.asarray(state.counters.jump_proposed).sum(axis=(1, 2)).astype(float)
    it = int(state.it)
    # All five kinds fired; realized fractions track the (activation-phased)
    # weights: pre-burn SCAM/AM/NUTS/HMC at 20/20/10/10, DE joins at 20
    # after iteration 60.
    assert (prop > 0).all()
    frac = prop / prop.sum()
    names = cfg.jump_names()
    de = names.index("DEJump")
    w = dict(zip(names, [10, 10, 20, 20, 20]))  # HMC, NUTS, SCAM, AM, DE order varies
    # weight-proportional within a few percent (rotation is exact per phase)
    expected_de = 20 / 90 * (it - 60) / it
    assert abs(frac[de] - expected_de) < 0.05
    # per-chain variety: at a given iteration chains drew different kinds
    per_chain_prop = np.asarray(state.counters.jump_proposed)[:, 0, :]
    assert (per_chain_prop.sum(axis=0) == it).all()


def test_stacked_mode_with_gradient_jumps_runs():
    cfg, run_block, state = _build(nchains=16, per_chain_mode="stacked")
    state, out = run_block(state, 40)
    assert np.isfinite(np.asarray(out.x)).all()
    prop = np.asarray(state.counters.jump_proposed).sum(axis=(1, 2))
    assert (prop > 0).sum() >= 4


def test_rotation_partition_matches_weights_exactly():
    """The static slot layout is the largest-remainder rounding of C*p."""
    cfg, run_block, state = _build(nchains=90, per_chain_mode="rotation",
                                   burn=10_000)  # DE inactive
    state, _ = run_block(state, 30)  # 60 iterations, all pre-activation
    prop = np.asarray(state.counters.jump_proposed).sum(axis=(1, 2)).astype(float)
    names = cfg.jump_names()
    de = names.index("DEJump")
    assert prop[de] == 0  # not yet active
    it = int(state.it)
    total = 2 * 90 * it  # ntemps * nchains * iters
    # active weights 20/20/10/10 over 90 chains: counts 30/30/15/15 exactly
    frac = prop / total
    for j, n in enumerate(names):
        if j == de:
            continue
        w = {"covarianceJumpProposalSCAM": 20, "covarianceJumpProposalAM": 20,
             "NUTSJUMP": 10, "HMCJump": 10}[n]
        np.testing.assert_allclose(frac[j], w / 60, atol=1e-12)


@pytest.mark.slow
def test_per_chain_matches_shared_statistics():
    ndim = 3
    res = {}
    for mode in ("shared", "per_chain"):
        cfg, run_block, state = _build(
            ndim=ndim, nchains=128, jump_select=mode, seed=3
        )
        state, _ = run_block(state, 150)  # 300 iters burn
        state, out = run_block(state, 600)  # 1200 iters
        cold = np.moveaxis(np.asarray(out.x[:, 0]), 1, 2).reshape(-1, ndim)
        res[mode] = (cold.mean(axis=0), cold.std(axis=0))
    m_s, s_s = res["shared"]
    m_p, s_p = res["per_chain"]
    np.testing.assert_allclose(m_p, m_s, atol=0.1)
    np.testing.assert_allclose(s_p, s_s, rtol=0.1)
    np.testing.assert_allclose(s_p, np.ones(ndim), rtol=0.12)


def test_rotation_with_chees_runs():
    """ChEES inside per_chain rotation: the chees_* step-size entries are
    per-temperature and must broadcast row-wide from the ChEES slice."""
    from ptmcmcsampler_tpu.config import JumpSpec, KIND_AM, KIND_CHEES

    logl, logp, func_grad = _gaussian(2)
    cfg = SamplerConfig(
        ndim=2, ntemps=2, nchains=128, groups=((0, 1),),
        jumps=(
            JumpSpec("am", KIND_AM, 20),
            JumpSpec("ChEESHMCJump", KIND_CHEES, 20),
        ),
        tskip=10, cov_update=100, burn=40, thin=2, de_size=128,
        jump_select="per_chain", per_chain_mode="rotation",
        hmc_stepsize=0.1, chees_max_steps=16,
    )
    step, run_block = build_step(cfg, logl, logp, func_grad)
    ladder = temperature_ladder(2, 2)
    _, betas = ladder_betas(ladder)
    xs = jnp.zeros((2, 128, 2)) + 0.3
    ll0 = jax.vmap(jax.vmap(logl))(xs)
    lp0 = jax.vmap(jax.vmap(logp))(xs)
    state = init_state(cfg, jax.random.key(4), np.zeros(2) + 0.3,
                       np.eye(2) * 0.2, betas, ll0, lp0)
    state, out = run_block(state, 60)
    assert np.isfinite(np.asarray(out.x)).all()
    prop = np.asarray(state.counters.jump_proposed).sum(axis=(1, 2))
    assert (prop > 0).all()
    # chees_* stayed replicated across the chain axis (per-temp semantics)
    eps = np.asarray(state.stepsize.chees_eps)
    assert np.all(eps == eps[:, :1])
    assert np.all(eps > 0)
