"""Chain diagnostics: integrated autocorrelation time and effective samples.

Replaces the reference's optional ``acor`` dependency (PTMCMCSampler.py:15-24,
:510-521) with an FFT-based integrated autocorrelation time using Sokal's
automatic windowing (the standard emcee-style estimator). Used for the
``neff`` early-termination criterion.
"""

from __future__ import annotations

import numpy as np


#: Cap on the complex FFT intermediate per multichain_ess chunk (bytes).
_ESS_FFT_CHUNK_BYTES = 128e6


def _next_pow_two(n):
    i = 1
    while i < n:
        i <<= 1
    return i


def autocorr_function(x):
    """Normalized autocorrelation function of a 1-D series."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if n < 2:
        return np.ones(1)
    f = np.fft.fft(x - np.mean(x), n=2 * _next_pow_two(n))
    acf = np.fft.ifft(f * np.conjugate(f))[:n].real
    if acf[0] <= 0:
        return np.ones(n)
    return acf / acf[0]


def integrated_autocorr_time(x, c=5.0):
    """Integrated autocorrelation time with Sokal auto-windowing."""
    f = autocorr_function(x)
    taus = 2.0 * np.cumsum(f) - 1.0
    window = np.arange(len(taus)) < c * taus
    if np.any(~window):
        m = int(np.argmin(window))
        return max(taus[m], 1.0)
    return max(taus[-1], 1.0)


def max_autocorr_time(chain):
    """Max integrated autocorrelation time over parameter columns.

    Mirrors the reference's termination statistic
    ``max_i acor(chain[:, i])`` (PTMCMCSampler.py:512-517).
    """
    chain = np.atleast_2d(np.asarray(chain))
    taus = [integrated_autocorr_time(chain[:, i]) for i in range(chain.shape[1])]
    return float(np.nanmax(taus)) if taus else 1.0


def effective_samples(chain, niter=None):
    """N_eff = iterations / max-tau (reference formula, PTMCMCSampler.py:512)."""
    n = niter if niter is not None else len(chain)
    return n / max(1.0, max_autocorr_time(chain))


def split_rhat(chains):
    """Split-chain potential scale reduction factor (Gelman-Rubin R-hat).

    chains: [nchains, nsteps, ndim]. Each chain is split in half (so a single
    long chain still yields a meaningful statistic), then the classic
    between/within variance ratio is computed per parameter. Values near 1
    indicate convergence; > ~1.01 is suspect. Companion to
    :func:`multichain_ess` for the vmapped chain batches the reference's
    one-chain-per-rank model cannot produce.
    """
    chains = np.asarray(chains, dtype=np.float64)
    m, n, d = chains.shape
    half = n // 2
    if half < 2:
        return np.full(d, np.nan)
    split = np.concatenate([chains[:, :half], chains[:, half : 2 * half]], axis=0)
    sm, sn = split.shape[0], split.shape[1]
    means = split.mean(axis=1)  # [2m, d]
    variances = split.var(axis=1, ddof=1)  # [2m, d]
    w = variances.mean(axis=0)
    b = sn * means.var(axis=0, ddof=1)
    var_plus = (sn - 1) / sn * w + b / sn
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_plus / w)


def moment_gate(samples, ess, target_mean):
    """Posterior-mean gate against a known target.

    samples: [..., ndim] pooled cold-chain draws; ess: [ndim] effective
    sample counts (:func:`multichain_ess`). Passes when every coordinate's
    sampled mean lies within 8 standard errors plus 0.02 posterior standard
    deviations of the target (the floor absorbs ESS-estimation error and
    float32 accumulation). Returns ``(ok, max_z)`` with ``z`` the error in
    standard errors.
    """
    samples = np.asarray(samples)
    flat = samples.reshape(-1, samples.shape[-1])
    mean = flat.mean(axis=0, dtype=np.float64)
    sd = flat.std(axis=0, dtype=np.float64)
    se = np.maximum(sd / np.sqrt(np.maximum(ess, 1.0)), 1e-9)
    err = np.abs(mean - np.asarray(target_mean, np.float64))
    ok = bool(np.all(err < 8.0 * se + 0.02 * np.maximum(sd, 1e-9)))
    return ok, float(np.max(err / se))


def multichain_ess(chains):
    """Cross-chain effective sample size per parameter (Stan-style).

    chains: [nchains, nsteps, ndim]. Uses the rank-normalization-free
    Vehtari/Gelman combined estimator: per-chain autocovariances averaged,
    corrected by the between-chain variance, with Geyer initial-monotone
    truncation. This correctly *penalizes* chains stuck in different modes
    (vital for multimodal targets like the curved likelihood), so vmapped
    chain batches cannot overclaim ESS.

    Returns an array [ndim] of ESS estimates for the pooled sample.
    """
    chains = np.asarray(chains)  # [m, n, d]; f64 conversion happens per chunk
    m, n, d = chains.shape
    if n < 2:
        return np.full(d, float(m * n))
    chain_means = chains.mean(axis=1, dtype=np.float64)  # [m, d]
    chain_vars = chains.var(axis=1, ddof=1, dtype=np.float64)  # [m, d]
    w = chain_vars.mean(axis=0)  # [d]
    b = n * chain_means.var(axis=0, ddof=1) if m > 1 else np.zeros(d)
    var_plus = w * (n - 1) / n + b / n
    # Batched rFFT over m*d series (the per-series Python loop this replaced
    # cost thousands of sequential FFTs per neff check at production chain
    # counts) — CHUNKED over the chain axis: the complex intermediate is
    # [chunk, nfft/2+1, d] complex128, so the whole-batch form would peak at
    # tens of GiB for 4096-chain production windows. Each chunk is capped at
    # ~128 MiB of FFT intermediate and the per-chain normalized ACFs are
    # accumulated into the cross-chain mean incrementally.
    nfft = 2 * _next_pow_two(n)
    chunk_m = max(1, int(_ESS_FFT_CHUNK_BYTES // (nfft * max(d, 1) * 16)))
    acov_sum = np.zeros((n, d))
    scale = chain_vars * (n - 1) / n  # [m, d]
    for i0 in range(0, m, chunk_m):
        blk = slice(i0, min(m, i0 + chunk_m))
        xc = chains[blk].astype(np.float64) - chain_means[blk, None, :]
        f = np.fft.rfft(xc, n=nfft, axis=1)
        acf = np.fft.irfft(f * np.conj(f), n=nfft, axis=1)[:, :n, :]
        acf0 = acf[:, :1, :]
        # Per-chain normalized ACF (constant chains fall back to 1s,
        # matching autocorr_function), scaled to autocovariance.
        ok0 = acf0 > 0
        fnorm = np.where(ok0, acf / np.where(ok0, acf0, 1.0), 1.0)
        acov_sum += (fnorm * scale[blk, None, :]).sum(axis=0)
    acov = acov_sum / m  # [n, d]
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = 1.0 - (w - acov) / var_plus  # [n, d]
    # Geyer initial-positive + initial-monotone sequence over pair sums
    # P_t = rho[2t] + rho[2t+1]; tau = -1 + 2 * sum(P_t). Vectorized:
    # the "break at first negative pair" is a cumulative-product mask and
    # the running minimum is minimum.accumulate.
    npairs = n // 2
    pair = rho[0 : 2 * npairs : 2] + rho[1 : 2 * npairs : 2]  # [npairs, d]
    included = np.cumprod(pair >= 0, axis=0).astype(bool)
    mono = np.minimum.accumulate(pair, axis=0)
    s = np.where(included, mono, 0.0).sum(axis=0)
    tau = np.maximum(1.0, -1.0 + 2.0 * s)
    ess = m * n / tau
    return np.where(np.isfinite(var_plus) & (var_plus > 0), ess, float(m * n))
