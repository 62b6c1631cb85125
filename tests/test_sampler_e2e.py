"""End-to-end PTSampler tests.

Mirrors the reference's integration philosophy (tests/test_simple.py:65-97:
20-D correlated Gaussian + uniform box prior + custom uniform jump) but adds
the statistical assertions the reference lacks (SURVEY.md §4), plus chain-file
format, resume, and checkpoint coverage.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from ptmcmcsampler_tpu import PTSampler


class GaussianLikelihood:
    """JAX-traceable version of the reference test model (tests/test_simple.py:14-41)."""

    def __init__(self, ndim=20, pmin=-10.0, pmax=10.0, seed=42):
        self.a = np.ones(ndim) * pmin
        self.b = np.ones(ndim) * pmax
        rng = np.random.default_rng(seed)
        self.mu = rng.uniform(pmin, pmax, ndim)
        cov = 0.5 - rng.random(ndim**2).reshape((ndim, ndim))
        cov = np.triu(cov)
        cov += cov.T - np.diag(cov.diagonal())
        self.cov = np.dot(cov, cov)
        self.icov = np.linalg.inv(self.cov)

    def lnlikefn(self, x):
        diff = x - self.mu
        return -jnp.dot(diff, jnp.dot(self.icov, diff)) / 2.0

    def lnpriorfn(self, x):
        inside = jnp.all(self.a <= x) & jnp.all(self.b >= x)
        return jnp.where(inside, 0.0, -jnp.inf)


class UniformJump:
    """Reference custom-jump protocol, JAX-native variant."""

    def __init__(self, pmin, pmax):
        self.pmin = pmin
        self.pmax = pmax

    def jump(self, key, x, it, beta):
        import jax

        q = jax.random.uniform(key, x.shape, x.dtype, self.pmin, self.pmax)
        return q, jnp.zeros((), x.dtype)


class NumpyUniformJump:
    """Legacy numpy custom-jump protocol (tests/test_simple.py:44-62)."""

    def __init__(self, pmin, pmax):
        self.pmin = pmin
        self.pmax = pmax

    def jump(self, x, it, beta):
        q = np.random.uniform(self.pmin, self.pmax, len(x))
        return q, 0.0


@pytest.fixture
def glo():
    return GaussianLikelihood(ndim=6, pmin=-10, pmax=10)


def run_sampler(glo, tmp_path, niter=3000, **kw):
    ndim = len(glo.mu)
    p0 = np.clip(glo.mu + 0.1, -9, 9)
    cov0 = np.eye(ndim) * 0.5
    defaults = dict(
        ntemps=2, nchains=16, outDir=str(tmp_path / "chains"), verbose=False, seed=1
    )
    defaults.update(kw)
    sampler = PTSampler(ndim, glo.lnlikefn, glo.lnpriorfn, np.copy(cov0), **defaults)
    sampler.sample(
        p0, niter, burn=500, thin=2, covUpdate=500, isave=500,
        SCAMweight=20, AMweight=20, DEweight=20, Tskip=50,
    )
    return sampler


class TestSimpleSampler:
    def test_runs_and_writes_chains(self, glo, tmp_path):
        sampler = run_sampler(glo, tmp_path)
        outdir = str(tmp_path / "chains")
        f = os.path.join(outdir, "chain_1.0.txt")
        assert os.path.isfile(f)
        data = np.loadtxt(f, ndmin=2)
        assert data.shape[1] == sampler.ndim + 4
        # initial row + niter/thin rows
        assert data.shape[0] == 1 + 3000 // 2
        # acceptance-rate column within [0, 1], per-row cumulative (reference
        # PTMCMCSampler.py:731-745): it must VARY inside an isave block, not
        # be block-constant staircases.
        assert np.all(data[1:, -2] >= 0) and np.all(data[1:, -2] <= 1)
        assert data[-1, -2] > 0
        isave_rows = 500 // 2
        first_block = data[1 : 1 + isave_rows, -2]
        assert np.unique(first_block).size > isave_rows // 4
        assert os.path.isfile(os.path.join(outdir, "cov.npy"))
        assert os.path.isfile(os.path.join(outdir, "jumps.txt"))
        assert os.path.isfile(os.path.join(outdir, "covarianceJumpProposalAM_jump.txt"))

    def test_posterior_moments(self, glo, tmp_path):
        sampler = run_sampler(glo, tmp_path, niter=6000, nchains=48)
        state = sampler.state
        # pull all cold chains from device state history? use host chain +
        # final state positions across chains for a cheap moment check
        chain = sampler.chain  # cold chain-0 thinned history
        burn_rows = 500
        samples = chain[burn_rows:]
        mean = samples.mean(axis=0)
        # single-chain mean is noisy; allow generous MC tolerance
        err = np.abs(mean - glo.mu) / np.sqrt(np.diag(glo.cov))
        assert np.all(err < 1.0)
        del state

    def test_custom_jax_jump(self, glo, tmp_path):
        ndim = len(glo.mu)
        p0 = np.clip(glo.mu, -9, 9)
        sampler = PTSampler(
            ndim, glo.lnlikefn, glo.lnpriorfn, np.eye(ndim) * 0.5,
            ntemps=1, nchains=8, outDir=str(tmp_path / "c2"), verbose=False, seed=2,
        )
        uj = UniformJump(-10, 10)
        sampler.addProposalToCycle(uj.jump, 5, name="UniformJump")
        sampler.sample(p0, 1000, burn=200, thin=1, covUpdate=200, isave=500,
                       SCAMweight=20, AMweight=20, DEweight=20)
        names = sampler.config.jump_names()
        assert "UniformJump" in names
        idx = names.index("UniformJump")
        proposed = np.asarray(sampler.state.counters.jump_proposed)[idx]
        assert proposed.sum() > 0

    def test_custom_numpy_jump_fallback(self, glo, tmp_path):
        ndim = len(glo.mu)
        p0 = np.clip(glo.mu, -9, 9)
        sampler = PTSampler(
            ndim, glo.lnlikefn, glo.lnpriorfn, np.eye(ndim) * 0.5,
            ntemps=1, nchains=2, outDir=str(tmp_path / "c3"), verbose=False, seed=3,
        )
        uj = NumpyUniformJump(-10, 10)
        sampler.addProposalToCycle(uj.jump, 5, name="UniformJump")
        sampler.sample(p0, 200, burn=100, thin=1, covUpdate=100, isave=100,
                       SCAMweight=20, AMweight=20, DEweight=20)
        assert sampler.chain.shape[0] == 201

    def test_numpy_loglike_fallback(self, tmp_path):
        ndim = 3
        mu = np.zeros(ndim)

        def lnlike(x):
            return float(-0.5 * np.sum((x - mu) ** 2))

        def lnprior(x):
            return 0.0 if np.all(np.abs(x) < 10) else float(-np.inf)

        sampler = PTSampler(
            ndim, lnlike, lnprior, np.eye(ndim) * 0.25,
            ntemps=1, nchains=2, outDir=str(tmp_path / "c4"), verbose=False, seed=4,
        )
        assert not sampler._logl_traceable
        sampler.sample(np.zeros(ndim), 200, burn=100, thin=1, covUpdate=100,
                       isave=100, SCAMweight=20, AMweight=20, DEweight=20)
        assert sampler.chain.shape[0] == 201


class TestResume:
    def test_checkpoint_resume_continues(self, glo, tmp_path):
        outdir = str(tmp_path / "chains")
        s1 = run_sampler(glo, tmp_path, niter=1000)
        rows_before = np.loadtxt(os.path.join(outdir, "chain_1.0.txt"), ndmin=2).shape[0]
        assert os.path.isfile(os.path.join(outdir, "checkpoint.npz"))

        ndim = len(glo.mu)
        s2 = PTSampler(
            ndim, glo.lnlikefn, glo.lnpriorfn, np.eye(ndim) * 0.5,
            ntemps=2, nchains=16, outDir=outdir, verbose=False, seed=1, resume=True,
        )
        s2.sample(
            np.clip(glo.mu + 0.1, -9, 9), 2000, burn=500, thin=2, covUpdate=500,
            isave=500, SCAMweight=20, AMweight=20, DEweight=20, Tskip=50,
        )
        rows_after = np.loadtxt(os.path.join(outdir, "chain_1.0.txt"), ndmin=2).shape[0]
        assert rows_after == rows_before + (2000 - 1000) // 2
        del s1

    def test_torn_resume_truncates_jump_series(self, glo, tmp_path):
        """A kill between a drain and its checkpoint leaves one extra entry
        in each <name>_jump.txt; resume must drop it (using the drain count
        persisted in the checkpoint meta) so the series length stays equal
        to the number of drains."""
        outdir = str(tmp_path / "chains")
        run_sampler(glo, tmp_path, niter=1500)
        jf = os.path.join(outdir, "covarianceJumpProposalAM_jump.txt")
        n0 = len(open(jf).readlines())
        assert n0 == 3  # 1500 iters / isave 500
        with open(jf, "a") as f:
            f.write("0.5\n")  # torn post-checkpoint entry

        ndim = len(glo.mu)
        s2 = PTSampler(
            ndim, glo.lnlikefn, glo.lnpriorfn, np.eye(ndim) * 0.5,
            ntemps=2, nchains=16, outDir=outdir, verbose=False, seed=1, resume=True,
        )
        s2.sample(
            np.clip(glo.mu + 0.1, -9, 9), 3000, burn=500, thin=2, covUpdate=500,
            isave=500, SCAMweight=20, AMweight=20, DEweight=20, Tskip=50,
        )
        assert len(open(jf).readlines()) == 6  # duplicate dropped, 3 drains added

    def test_chainfile_resume_without_checkpoint(self, glo, tmp_path):
        outdir = str(tmp_path / "chains")
        run_sampler(glo, tmp_path, niter=1000)
        os.remove(os.path.join(outdir, "checkpoint.npz"))

        ndim = len(glo.mu)
        s2 = PTSampler(
            ndim, glo.lnlikefn, glo.lnpriorfn, np.eye(ndim) * 0.5,
            ntemps=2, nchains=16, outDir=outdir, verbose=False, seed=1, resume=True,
        )
        s2.sample(
            np.clip(glo.mu + 0.1, -9, 9), 2000, burn=500, thin=2, covUpdate=500,
            isave=500, SCAMweight=20, AMweight=20, DEweight=20, Tskip=50,
        )
        data = np.loadtxt(os.path.join(outdir, "chain_1.0.txt"), ndmin=2)
        assert data.shape[0] == 501 + 500


class TestNeffTermination:
    def test_stops_early(self, glo, tmp_path):
        ndim = len(glo.mu)
        p0 = np.clip(glo.mu, -9, 9)
        sampler = PTSampler(
            ndim, glo.lnlikefn, glo.lnpriorfn, np.copy(glo.cov),
            ntemps=1, nchains=16, outDir=str(tmp_path / "c5"), verbose=False, seed=5,
        )
        sampler.sample(p0, 100000, burn=100, thin=2, covUpdate=200, isave=200,
                       SCAMweight=20, AMweight=20, DEweight=20, neff=50)
        # should stop well before 100k iterations
        assert int(sampler.state.it) < 100000

    def test_multichain_neff_stops_faster_than_single(self, glo, tmp_path):
        """Pooled multichain ESS drives the neff stop: 64 chains must reach a
        large neff target in far fewer iterations than one chain could."""
        ndim = len(glo.mu)
        p0 = np.clip(glo.mu, -9, 9)
        sampler = PTSampler(
            ndim, glo.lnlikefn, glo.lnpriorfn, np.copy(glo.cov),
            ntemps=1, nchains=64, outDir=str(tmp_path / "c6"), verbose=False, seed=6,
        )
        sampler.sample(p0, 50000, burn=100, thin=2, covUpdate=200, isave=200,
                       SCAMweight=20, AMweight=20, DEweight=20, neff=2000)
        it = int(sampler.state.it)
        assert it < 50000  # single chain would need >> 2000 * tau iterations


class TestAllChainHarvest:
    def test_all_chains_recorded_and_written(self, glo, tmp_path):
        """The vmapped nchains axis is harvested: nchains=64 yields ~64x the
        recorded samples, on host and in the all-chain binary output."""
        nchains = 64
        sampler = run_sampler(glo, tmp_path, niter=1000, nchains=nchains)
        rows = sampler.chain.shape[0]
        assert rows == 1 + 1000 // 2
        chains = sampler.chains  # [C, rows, D]
        assert chains.shape == (nchains, rows, sampler.ndim)
        assert sampler.pooled_chain.shape == (nchains * rows, sampler.ndim)
        # chain 0 of the chains-major view is the text-file chain
        np.testing.assert_allclose(chains[0], sampler.chain, rtol=1e-6)
        # chains are genuinely distinct samples, not copies
        assert not np.allclose(chains[0, rows // 2:], chains[1, rows // 2:])
        # binary all-chain file round-trips
        outdir = str(tmp_path / "chains")
        from ptmcmcsampler_tpu.io.chainfile import ChainWriter

        loaded = sampler._writer.load_all(0)
        assert loaded is not None and loaded.shape == (rows, nchains, sampler.ndim)
        np.testing.assert_allclose(
            np.moveaxis(loaded, 0, 1), chains, rtol=1e-5, atol=1e-6
        )
        del ChainWriter


def test_chainfile_resume_restores_per_chain_positions(tmp_path):
    """Chain-file resume must restart every vmapped chain from ITS OWN last
    position (chain_all sidecar), not collapse the batch onto chain 0's."""
    import jax

    outdir = str(tmp_path / "chains")

    def build():
        return PTSampler(
            2,
            lambda x: -0.5 * jnp.sum(x**2),
            lambda x: jnp.where(jnp.all(jnp.abs(x) < 10.0), 0.0, -jnp.inf),
            np.eye(2) * 0.1,
            outDir=outdir, verbose=False, ntemps=2, nchains=8, seed=4,
            resume=True,
        )

    import jax.numpy as jnp

    s = build()
    s.sample(np.zeros(2), 100, burn=20, thin=1, isave=50, SCAMweight=1,
             AMweight=1, DEweight=0, NUTSweight=0, HMCweight=0, MALAweight=0)
    last_per_chain = np.asarray(jax.device_get(s.state.x[0])).T  # [C, D]
    os.remove(os.path.join(outdir, "checkpoint.npz"))  # force file resume

    s2 = build()
    s2.sample(np.zeros(2), 150, burn=20, thin=1, isave=50, SCAMweight=1,
              AMweight=1, DEweight=0, NUTSweight=0, HMCweight=0, MALAweight=0)
    # The resumed window's first post-resume rows must be distinct across
    # chains (not a broadcast of one position).
    chains = s2.chains
    row = chains[:, min(101, chains.shape[1] - 1), :]
    assert not np.allclose(row, row[0]), "chains restarted degenerate"
    del last_per_chain


def test_resume_falls_back_on_stale_checkpoint(tmp_path):
    """A checkpoint from an older state layout (fewer leaves) must not crash
    resume; the sampler falls back to chain-file resume."""
    import jax.numpy as jnp

    outdir = str(tmp_path / "chains")

    def build():
        return PTSampler(
            2,
            lambda x: -0.5 * jnp.sum(x**2),
            lambda x: jnp.where(jnp.all(jnp.abs(x) < 10.0), 0.0, -jnp.inf),
            np.eye(2) * 0.1,
            outDir=outdir,
            verbose=False,
            ntemps=2,
            nchains=4,
            seed=3,
            resume=True,
        )

    s = build()
    s.sample(np.zeros(2), 100, burn=20, thin=1, isave=50, SCAMweight=1, AMweight=1,
             DEweight=0, NUTSweight=0, HMCweight=0, MALAweight=0)
    # Corrupt the checkpoint into an "old layout" with missing leaves.
    ckpt = os.path.join(outdir, "checkpoint.npz")
    data = dict(np.load(ckpt, allow_pickle=False))
    keys = [k for k in data if not k.startswith("__")]
    for k in sorted(keys)[-4:]:
        del data[k]
    np.savez(ckpt, **data)

    s2 = build()
    s2.sample(np.zeros(2), 200, burn=20, thin=1, isave=50, SCAMweight=1, AMweight=1,
              DEweight=0, NUTSweight=0, HMCweight=0, MALAweight=0)
    rows = np.loadtxt(os.path.join(outdir, "chain_1.0.txt"), ndmin=2)
    assert rows.shape[0] >= 150


def test_grad_wrappers_elide_noop_reshapes():
    """A user grad that already returns the right shapes must not gain no-op
    reshape ops from the wrapper: the compiled program carries exactly the
    user's operations."""
    import jax

    from ptmcmcsampler_tpu.models import IntervalTransformedGaussian
    from ptmcmcsampler_tpu.sampler import _wrap_grad_fn, _wrap_scalar_fn

    d = 8
    m = IntervalTransformedGaussian(ndim=d)
    g, traceable = _wrap_grad_fn(m.lnlikefn_grad, [], {}, d, np.dtype(np.float32))
    assert traceable
    jaxpr = jax.make_jaxpr(g)(jnp.zeros(d, jnp.float32)).jaxpr
    zero_d_reshapes = [
        e for e in jaxpr.eqns
        if e.primitive.name == "reshape" and e.outvars[0].aval.shape == ()
    ]
    assert not zero_d_reshapes, zero_d_reshapes

    f, traceable = _wrap_scalar_fn(m.lnlikefn, [], {}, d, np.dtype(np.float32))
    assert traceable
    jaxpr = jax.make_jaxpr(f)(jnp.zeros(d, jnp.float32)).jaxpr
    zero_d_reshapes = [
        e for e in jaxpr.eqns
        if e.primitive.name == "reshape" and e.outvars[0].aval.shape == ()
    ]
    assert not zero_d_reshapes, zero_d_reshapes
