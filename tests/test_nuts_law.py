"""The vmapped XLA NUTS tree (``proposals/nuts.py``) against closed-form laws.

NUTS has one implementation. These checks pin its law without a second
implementation to compare against:

* proposal law: started from exact draws of a Gaussian target, one tree
  (whose ``qxy`` makes the outer MH step always accept) must return draws
  with the target's closed-form mean and covariance;
* tree-size law: on the 1-D harmonic oscillator the trajectory U-turns after
  about half a period (time pi), so the leaves per tree times the step size
  sits near pi, and the leapfrog's energy error at small steps keeps the
  acceptance statistic near one;
* divergence: at a huge step size every first leaf diverges;
* kernel-level moments and dual averaging through the scanned step;
* depth 8 and 10 trees compile and run.

Reference semantics: ``NUTSJump`` (nutsjump.py:379-840).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptmcmcsampler_tpu.config import JumpSpec, SamplerConfig
from ptmcmcsampler_tpu.kernel import build_step
from ptmcmcsampler_tpu.proposals import nuts as nuts_mod
from ptmcmcsampler_tpu.proposals.base import ProposalContext
from ptmcmcsampler_tpu.state import init_state
from ptmcmcsampler_tpu.utils import split_grid


def _gauss_model(cov):
    icov = jnp.asarray(np.linalg.inv(cov), jnp.float32)

    def logl(x):
        return -0.5 * x @ icov @ x

    def logp(x):
        return jnp.where(jnp.all(jnp.abs(x) < 50.0), 0.0, -jnp.inf)

    def func_grad(x, beta):
        return beta * logl(x), -beta * (icov @ x)

    return logl, logp, func_grad


def _cfg(ndim, nchains, max_depth=5, burn=10**6):
    return SamplerConfig(
        ndim=ndim, ntemps=1, nchains=nchains, groups=(tuple(range(ndim)),),
        jumps=(JumpSpec("NUTSJUMP", "nuts", 10),), nuts_max_depth=max_depth,
        burn=burn, thin=1, tskip=10**9, cov_update=10**9, de_size=16,
    )


def _ctx(ndim):
    return ProposalContext(
        group_u=(jnp.eye(ndim),), group_s=(jnp.ones(ndim),),
        chol=jnp.eye(ndim), chol_inv=jnp.eye(ndim),
        de_buf=jnp.zeros((ndim, 4)), de_valid=jnp.asarray(0, jnp.int32),
    )


def _one_tree(cfg, func_grad, x, eps, seed=0):
    """One NUTS call per chain at a pre-seeded step size (dual averaging
    still runs): returns (q [C, D], qxy [C], new step-size state)."""
    c, d = x.shape
    keys = split_grid(jax.random.key(seed), (c,))
    z = jnp.zeros((c,), jnp.float32)
    ss = dict(epsilon=z + eps, epsilonbar=z + 1.0, hbar=z, mu=z, ncalls=z)
    kern = nuts_mod.make_nuts(cfg, func_grad)
    q, qxy, new = jax.jit(jax.vmap(
        lambda k, xx, s: kern(k, xx, jnp.ones(()), 1, _ctx(d), s)
    ))(keys, x, ss)
    return np.asarray(q), np.asarray(qxy), {k: np.asarray(v) for k, v in new.items()}


def _accept_stat(cfg, ss):
    """alpha/nalpha of the one call, recovered from hbar = eta (delta - stat)
    with eta = 1 / (1 + t0) on the first call."""
    return cfg.nuts_delta - ss["hbar"] * (1.0 + nuts_mod.T0)


@pytest.mark.parametrize(
    "cov", [np.array([[1.0, 0.6], [0.6, 2.0]]), np.diag([0.25, 4.0])], ids=["corr", "diag"]
)
def test_one_tree_preserves_the_gaussian_target(cov):
    n = 4096
    _, _, func_grad = _gauss_model(cov)
    x0 = np.random.default_rng(0).multivariate_normal(np.zeros(2), cov, n)
    q, qxy, _ = _one_tree(_cfg(2, n), func_grad, jnp.asarray(x0, jnp.float32), 0.3)
    assert np.isfinite(q).all() and np.isfinite(qxy).all()
    se = np.sqrt(np.diag(cov) / n)
    np.testing.assert_array_less(np.abs(q.mean(axis=0)), 5 * se)
    np.testing.assert_allclose(np.cov(q.T), cov, rtol=0.1, atol=0.05)
    assert np.abs(q - x0).max() > 0.1  # the trees moved


@pytest.mark.parametrize("eps", [0.1, 0.2, 0.4])
def test_tree_size_follows_the_half_period(eps):
    n = 1024
    cfg = _cfg(1, n, max_depth=8)
    _, _, func_grad = _gauss_model(np.eye(1))
    x0 = np.random.default_rng(1).normal(size=(n, 1))
    _, _, ss = _one_tree(cfg, func_grad, jnp.asarray(x0, jnp.float32), eps, seed=2)
    # nalpha = leaves built; dual averaging sees alpha/nalpha. Recover the
    # leaves from the doubling schedule: trajectories stop once their span
    # passes half a period, so their integration time is of order pi.
    stat = _accept_stat(cfg, ss)
    assert stat.mean() > 0.9  # leapfrog energy error is small at these steps
    kern = nuts_mod.make_nuts(cfg, func_grad, capture=True)
    keys = split_grid(jax.random.key(2), (n,))
    z = jnp.zeros((n,), jnp.float32)
    s0 = dict(epsilon=z + eps, epsilonbar=z + 1.0, hbar=z, mu=z, ncalls=z)
    *_, cap = jax.jit(jax.vmap(
        lambda k, xx, s: kern(k, xx, jnp.ones(()), 1, _ctx(1), s)
    ))(keys, jnp.asarray(x0, jnp.float32), s0)
    leaves = np.asarray(cap["len_plus"]) + np.asarray(cap["len_minus"]) - 1
    t_med = np.median(leaves) * eps
    assert np.pi / 2 < t_med < 3 * np.pi, t_med
    assert leaves.max() < 2**8  # the depth cap was never reached


def test_divergence_at_huge_epsilon():
    """At eps=50 every first leaf diverges: the proposal stays at the start
    point and the acceptance statistic is ~0."""
    cfg = _cfg(2, 64, max_depth=4)
    _, _, func_grad = _gauss_model(np.eye(2))
    x0 = jnp.full((64, 2), 0.3, jnp.float32)
    q, _, ss = _one_tree(cfg, func_grad, x0, 50.0, seed=6)
    np.testing.assert_allclose(q, np.asarray(x0), atol=1e-5)
    assert np.all(_accept_stat(cfg, ss) < 0.05)


def _run_kernel(cov, nchains, burn, blocks, seed, max_depth=4):
    logl, logp, func_grad = _gauss_model(cov)
    d = cov.shape[0]
    cfg = _cfg(d, nchains, max_depth=max_depth, burn=burn)
    _, run_block = build_step(cfg, logl, logp, func_grad)
    xs = jnp.zeros((1, nchains, d))
    state = init_state(
        cfg, jax.random.key(seed), np.zeros(d), np.eye(d), np.ones(1),
        jax.vmap(jax.vmap(logl))(xs), jax.vmap(jax.vmap(logp))(xs),
    )
    outs = []
    for n in blocks:
        state, out = run_block(state, n)
        outs.append(out)
    return cfg, state, outs


def test_kernel_level_moments_match_target():
    """Full MH kernel with a NUTS-only cycle on a correlated Gaussian (identity
    mass, so the tree does the work): moments match the closed form."""
    cov = np.array([[1.0, 0.8], [0.8, 2.0]])
    _, _, outs = _run_kernel(cov, 64, burn=150, blocks=(200, 300), seed=0)
    samples = np.moveaxis(np.asarray(outs[-1].x[:, 0]), 1, 2).reshape(-1, 2)
    np.testing.assert_allclose(np.cov(samples.T), cov, atol=0.3)
    np.testing.assert_allclose(samples.mean(axis=0), [0, 0], atol=0.12)


def test_dual_averaging_reaches_the_target_acceptance():
    """During burn-in the step size is tuned until the acceptance statistic
    averages the target delta: after many calls the running hbar (a
    weighted mean of delta - stat) is near zero and every epsilon is sane."""
    cfg, state, _ = _run_kernel(np.eye(3), 32, burn=10**6, blocks=(150,), seed=2)
    e = np.asarray(state.stepsize.epsilon)
    hbar = np.asarray(state.stepsize.hbar)
    assert np.all(e > 0) and np.all(np.isfinite(e))
    assert abs(hbar.mean()) < 0.05, hbar.mean()
    # On a unit Gaussian in 3-D the tuned step sits in a narrow band.
    assert 0.2 < np.exp(np.log(e).mean()) < 2.0


@pytest.mark.parametrize("depth", [8, 10])
def test_deep_trees_compile_and_run(depth):
    cfg = _cfg(2, 4, max_depth=depth)
    _, _, func_grad = _gauss_model(np.eye(2))
    x0 = jnp.full((4, 2), 0.4, jnp.float32)
    q, qxy, _ = _one_tree(cfg, func_grad, x0, 0.05, seed=11)
    assert np.all(np.isfinite(q)) and np.all(np.isfinite(qxy))
