"""Unit tests for core math kernels against closed forms and the reference's
formulas (SURVEY.md §7 build order step 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptmcmcsampler_tpu import adaptation, diagnostics, ladder, utils
from ptmcmcsampler_tpu.config import SamplerConfig, JumpSpec, KIND_AM
from ptmcmcsampler_tpu.state import init_adapt_state


def _mini_config(ndim=4, groups=None):
    return SamplerConfig(
        ndim=ndim,
        ntemps=1,
        nchains=1,
        groups=groups or ((tuple(range(ndim))),),
        jumps=(JumpSpec("am", KIND_AM, 1),),
    )


class TestLadder:
    def test_default_spacing(self):
        # c = 1 + sqrt(2/ndim) (PTMCMCSampler.py:711)
        lad = ladder.temperature_ladder(ndim=8, ntemps=4)
        c = 1 + np.sqrt(2 / 8)
        np.testing.assert_allclose(lad, [c**i for i in range(4)])

    def test_tmax_spacing(self):
        lad = ladder.temperature_ladder(ndim=8, ntemps=5, tmin=1.0, tmax=16.0)
        np.testing.assert_allclose(lad, [1, 2, 4, 8, 16], rtol=1e-12)

    def test_single_chain(self):
        np.testing.assert_array_equal(ladder.temperature_ladder(8, 1), [1.0])

    def test_hot_chain(self):
        lad, betas = ladder.ladder_betas(np.array([1.0, 2.0, 4.0]), hot_chain=True)
        assert lad[-1] == 1e80
        assert betas[-1] == 1e-80


class TestTemperedLnprob:
    def test_basic(self):
        out = utils.tempered_lnprob(jnp.asarray(-10.0), jnp.asarray(-1.0), jnp.asarray(0.5))
        assert float(out) == pytest.approx(-6.0)

    def test_neginf_prior_dominates(self):
        out = utils.tempered_lnprob(jnp.asarray(-10.0), jnp.asarray(-jnp.inf), jnp.asarray(0.5))
        assert np.isneginf(float(out))

    def test_neginf_like_at_zero_beta(self):
        # hot chain still rejects -inf likelihood (reference temp=1e80 math)
        out = utils.tempered_lnprob(jnp.asarray(-jnp.inf), jnp.asarray(0.0), jnp.asarray(0.0))
        assert np.isneginf(float(out))
        assert not np.isnan(float(out))


class TestWelford:
    def test_matches_numpy_cov(self):
        rng = np.random.default_rng(0)
        xs = rng.normal(size=(500, 4)).astype(np.float32) * np.array([1, 2, 3, 4], np.float32)
        cfg = _mini_config(4)
        adapt = init_adapt_state(cfg, np.eye(4))
        # feed in uneven batches, like per-iteration chain batches
        i = 0
        for m in [3, 50, 121, 200, 126]:
            adapt = adaptation.welford_batch_update(adapt, jnp.asarray(xs[i : i + m].T))
            i += m
        adapt = adaptation.refresh_factors(cfg, adapt)
        np.testing.assert_allclose(
            np.asarray(adapt.cov), np.cov(xs.T), rtol=2e-3, atol=2e-3
        )

    def test_sequential_equals_batched(self):
        rng = np.random.default_rng(1)
        xs = rng.normal(size=(64, 3)).astype(np.float32)
        cfg = _mini_config(3)
        a1 = init_adapt_state(cfg, np.eye(3))
        for row in xs:
            a1 = adaptation.welford_batch_update(a1, jnp.asarray(row[:, None]))
        a2 = init_adapt_state(cfg, np.eye(3))
        a2 = adaptation.welford_batch_update(a2, jnp.asarray(xs.T))
        np.testing.assert_allclose(np.asarray(a1.m2), np.asarray(a2.m2), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(a1.mean), np.asarray(a2.mean), rtol=1e-4, atol=1e-4)

    def test_group_factors(self):
        cfg = _mini_config(4, groups=((0, 1), (2, 3)))
        rng = np.random.default_rng(2)
        xs = rng.normal(size=(2000, 4)).astype(np.float32)
        xs[:, 1] += 2 * xs[:, 0]
        adapt = init_adapt_state(cfg, np.eye(4))
        adapt = adaptation.welford_batch_update(adapt, jnp.asarray(xs.T))
        adapt = adaptation.refresh_factors(cfg, adapt)
        cov = np.cov(xs.T)
        for gi, g in enumerate(cfg.groups):
            sub = cov[np.ix_(g, g)]
            u = np.asarray(adapt.group_u[gi])
            s = np.asarray(adapt.group_s[gi])
            np.testing.assert_allclose(u @ np.diag(s) @ u.T, sub, rtol=5e-2, atol=5e-2)


class TestWelfordKahanCount:
    def test_count_exact_at_huge_n(self):
        """f32 alone saturates once ulp(count) reaches the batch size; the
        Kahan pair must keep accumulating exactly."""
        cfg = _mini_config(2)
        adapt = init_adapt_state(cfg, np.eye(2))
        # Pretend a long run already consumed 2^36 samples (ulp = 8192 > m).
        base = float(2**36)
        adapt = adapt.replace(count=jnp.asarray(base, jnp.float32))
        m = 4096
        xs = jnp.ones((2, m), jnp.float32)  # [D, m] chain-minor
        steps = 64
        upd = jax.jit(adaptation.welford_batch_update)
        for _ in range(steps):
            adapt = upd(adapt, xs)
        effective = float(adapt.count) - float(adapt.count_err)
        expected = base + steps * m
        assert effective == expected
        # Plain f32 accumulation would have been stuck at base (round-to-even
        # ties at exactly half-ulp increments) — prove the failure mode.
        plain = np.float32(base)
        for _ in range(steps):
            plain = np.float32(plain + np.float32(m))
        assert float(plain) == base

    def test_closed_form_cov_after_merge(self):
        """Batched merges at large synthetic counts still match the closed
        form cov of the full sample."""
        rng = np.random.default_rng(11)
        cfg = _mini_config(3)
        adapt = init_adapt_state(cfg, np.eye(3))
        xs = rng.normal(size=(200000, 3)).astype(np.float32)
        for i in range(0, len(xs), 4096):
            adapt = adaptation.welford_batch_update(adapt, jnp.asarray(xs[i : i + 4096].T))
        adapt = adaptation.refresh_factors(cfg, adapt)
        assert float(adapt.count) - float(adapt.count_err) == len(xs)
        np.testing.assert_allclose(
            np.asarray(adapt.cov), np.cov(xs.T), rtol=2e-2, atol=2e-2
        )


class TestDEPairLaw:
    def test_ordered_pairs_uniform(self):
        """The (mm, nn) draw must be uniform over *ordered distinct* pairs,
        matching the reference's redraw-until-distinct loop
        (PTMCMCSampler.py:963-966). The old +1-mod collision remap made
        (i, i+1) twice as likely as (i+1, i)."""
        from ptmcmcsampler_tpu.proposals.de import make_de
        from ptmcmcsampler_tpu.proposals.base import ProposalContext
        from ptmcmcsampler_tpu.config import JumpSpec, KIND_DE

        cfg = SamplerConfig(
            ndim=1,
            ntemps=1,
            nchains=1,
            groups=((0,),),
            jumps=(JumpSpec("de", KIND_DE, 1),),
        )
        de = make_de(cfg)
        nvalid = 4
        # Distinct row values whose ordered differences are all distinct, so
        # a mode jump (scale=1) uniquely identifies the drawn (mm, nn) pair.
        vals = np.array([0.0, 1.0, 3.0, 9.0], np.float32)
        buf = jnp.asarray(vals[None, :])  # [D, B]
        ctx = ProposalContext(
            group_u=(jnp.eye(1),),
            group_s=(jnp.ones(1),),
            chol=jnp.eye(1),
            chol_inv=jnp.eye(1),
            de_buf=buf,
            de_valid=jnp.asarray(nvalid, jnp.int32),
        )
        n = 40000
        keys = jax.random.split(jax.random.key(7), n)
        x = jnp.zeros((1,), jnp.float32)

        def draw(k):
            q, _ = de(k, x, jnp.asarray(1.0), jnp.asarray(0, jnp.int32), ctx)
            return q[0]

        deltas = np.asarray(jax.jit(jax.vmap(draw))(keys))
        diffs = {}
        for a in range(nvalid):
            for b in range(nvalid):
                if a != b:
                    diffs[(a, b)] = vals[a] - vals[b]
        counts = {
            p: int(np.sum(np.isclose(deltas, d, atol=1e-6))) for p, d in diffs.items()
        }
        total = sum(counts.values())
        # ~half the draws are mode jumps (scale exactly 1); each of the 12
        # ordered pairs should carry ~1/12 of those.
        assert total > n * 0.4
        for p, c in counts.items():
            assert abs(c / total - 1 / 12) < 0.015, (p, c / total)
        # Direction symmetry: the old bug gave (i, i+1) twice (i+1, i).
        for a in range(nvalid - 1):
            fwd, rev = counts[(a, a + 1)], counts[(a + 1, a)]
            assert 0.75 < fwd / rev < 1.33, (a, fwd, rev)


class TestDEBuffer:
    def test_ring_write(self):
        from ptmcmcsampler_tpu.state import DEState

        # buf is chain-minor [D, B]; pushes append [D, m] column blocks.
        de = DEState(buf=jnp.zeros((2, 8)), filled=jnp.zeros((), jnp.int32))
        for k in range(5):
            xs = jnp.full((2, 2), float(k))
            de = adaptation.de_buffer_push(de, xs)
        assert int(de.filled) == 10
        assert int(adaptation.de_valid_rows(de)) == 8
        buf = np.asarray(de.buf)
        # columns 0..1 were overwritten by k=4 (wraparound)
        np.testing.assert_array_equal(buf[:, 0], [4, 4])
        np.testing.assert_array_equal(buf[:, 2], [1, 1])


def _multichain_ess_loop_oracle(chains):
    """The pre-vectorization per-series implementation of multichain_ess,
    kept as a regression oracle for the batched-rFFT version."""
    chains = np.asarray(chains, dtype=np.float64)
    m, n, d = chains.shape
    ess = np.empty(d)
    for k in range(d):
        x = chains[:, :, k]
        chain_means = x.mean(axis=1)
        chain_vars = x.var(axis=1, ddof=1)
        w = chain_vars.mean()
        b = n * chain_means.var(ddof=1) if m > 1 else 0.0
        var_plus = w * (n - 1) / n + b / n if m > 1 else w * (n - 1) / n
        if var_plus <= 0 or not np.isfinite(var_plus):
            ess[k] = float(m * n)
            continue
        acov = np.zeros(n)
        for j in range(m):
            f = diagnostics.autocorr_function(x[j])
            acov += f * chain_vars[j] * (n - 1) / n
        acov /= m
        rho = 1.0 - (w - acov) / var_plus
        npairs = n // 2
        prev = np.inf
        s = 0.0
        for t in range(npairs):
            pair = rho[2 * t] + (rho[2 * t + 1] if 2 * t + 1 < n else 0.0)
            if pair < 0:
                break
            pair = min(pair, prev)
            prev = pair
            s += pair
        tau = max(1.0, -1.0 + 2.0 * s)
        ess[k] = m * n / tau
    return ess


class TestMultichainESSVectorized:
    def _cases(self):
        rng = np.random.default_rng(21)
        # iid chains
        yield rng.normal(size=(6, 500, 3))
        # correlated AR(1) chains
        n = 800
        eps = rng.normal(size=(4, n, 2))
        x = np.zeros_like(eps)
        for i in range(1, n):
            x[:, i] = 0.8 * x[:, i - 1] + eps[:, i]
        yield x
        # chains stuck at different means (between-chain variance dominates)
        yield rng.normal(size=(5, 300, 2)) + np.arange(5)[:, None, None]
        # single chain
        yield rng.normal(size=(1, 400, 2))
        # constant (degenerate) chains
        yield np.ones((3, 100, 2))
        # odd length
        yield rng.normal(size=(3, 257, 2))

    def test_matches_loop_oracle(self):
        for chains in self._cases():
            got = diagnostics.multichain_ess(chains)
            want = _multichain_ess_loop_oracle(chains)
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-8)

    def test_fast_at_many_chains(self):
        import time

        rng = np.random.default_rng(22)
        chains = rng.normal(size=(4096, 64, 2))
        t0 = time.perf_counter()
        ess = diagnostics.multichain_ess(chains)
        dt = time.perf_counter() - t0
        assert np.all(ess > 0)
        # The old loop took seconds at this scale; batched rFFT is ~ms.
        assert dt < 2.0, dt


class TestDiagnostics:
    def test_iid_tau_near_one(self):
        rng = np.random.default_rng(3)
        x = rng.normal(size=20000)
        tau = diagnostics.integrated_autocorr_time(x)
        assert 0.5 < tau < 2.0

    def test_ar1_tau(self):
        rng = np.random.default_rng(4)
        rho = 0.9
        n = 200000
        x = np.empty(n)
        x[0] = 0
        eps = rng.normal(size=n)
        for i in range(1, n):
            x[i] = rho * x[i - 1] + eps[i]
        tau = diagnostics.integrated_autocorr_time(x)
        expected = (1 + rho) / (1 - rho)  # = 19
        assert expected * 0.7 < tau < expected * 1.3

    def test_split_rhat_converged_vs_not(self):
        rng = np.random.default_rng(5)
        # converged: 8 iid N(0,1) chains
        good = rng.normal(size=(8, 2000, 2))
        r_good = diagnostics.split_rhat(good)
        assert np.all(r_good < 1.01), r_good
        # non-converged: chains stuck at different means
        bad = good + np.arange(8)[:, None, None]
        r_bad = diagnostics.split_rhat(bad)
        assert np.all(r_bad > 1.5), r_bad
        # within-chain drift is caught by the split (single chain, trend)
        drift = np.linspace(0, 5, 4000)[None, :, None] + rng.normal(
            size=(1, 4000, 1)
        )
        assert diagnostics.split_rhat(drift)[0] > 1.2
