"""Pure functional adaptation updates.

Covers the reference's rank-0-owned adaptation machinery re-designed for SPMD:

* recursive (Welford) sample covariance (``_updateRecursive``,
  PTMCMCSampler.py:769-803) — here a *batched* Chan/Welford update consuming
  all cold chains per iteration, so every device computes the identical
  covariance with no broadcast (the reference point-to-point sends it, :549);
* the cadenced per-group eigendecomposition refresh (:552-560);
* the DE history ring buffer (``_updateDEbuffer``, :806-817) as a
  device-resident ring written by dynamic-slice every iteration.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import utils
from .config import SamplerConfig
from .state import AdaptState, DEState


def welford_batch_update(adapt: AdaptState, xs: jax.Array) -> AdaptState:
    """Merge a batch of samples ``xs [D, m]`` (chain-minor) into (mean, M2).

    Chan et al. parallel update — exactly equivalent to feeding the ``m``
    samples one-by-one through the reference's sequential recursion
    (PTMCMCSampler.py:785-792), but expressed as one matmul, pinned to full
    float32 precision.
    """
    m = xs.shape[1]
    n = adapt.count
    nf = jnp.asarray(m, jnp.float32)
    batch_mean = jnp.mean(xs, axis=1)
    centered = xs - batch_mean[:, None]
    batch_m2 = jnp.matmul(centered, centered.T, precision=lax.Precision.HIGHEST)  # [D, D]
    delta = batch_mean - adapt.mean
    # Kahan-compensated count increment: exact integer accumulation long
    # after plain f32 would saturate (ulp > batch size near 3e10 samples).
    y = nf - adapt.count_err
    new_count = n + y
    new_err = (new_count - n) - y
    mean = adapt.mean + delta * (nf / new_count)
    m2 = adapt.m2 + batch_m2.astype(adapt.m2.dtype) + jnp.outer(delta, delta) * (
        n * nf / new_count
    ).astype(adapt.m2.dtype)
    return adapt.replace(mean=mean, m2=m2, count=new_count, count_err=new_err)


def _padded_eigh(sub: jax.Array):
    s, u = jnp.linalg.eigh(sub)
    return jnp.maximum(s, 0.0), u


def refresh_factors(config: SamplerConfig, adapt: AdaptState) -> AdaptState:
    """Recompute cov = M2/(n-1) and the per-group/full factorizations.

    Mirrors the covariance publication step (PTMCMCSampler.py:794-803): the
    reference SVDs each group block; eigh of the symmetric block gives the
    same (U, S) up to column order/sign, which none of the proposals depend
    on. The full-dim Cholesky feeds the gradient jumps' whitening
    (nutsjump.py:51-54) when ``mass_adapt`` is on.
    """
    n = jnp.maximum(adapt.count, 2.0)
    cov = (adapt.m2 / (n - 1.0).astype(adapt.m2.dtype)).astype(adapt.cov.dtype)
    group_u, group_s = [], []
    for gi, g in enumerate(config.groups):
        idx = np.asarray(g)
        sub = cov[np.ix_(idx, idx)]
        s, u = _padded_eigh(sub)
        # Guard against a degenerate early covariance (all-zero or NaN): keep
        # the previous factors in that case.
        ok = jnp.all(jnp.isfinite(u)) & (jnp.max(s) > 0)
        group_u.append(jnp.where(ok, u, adapt.group_u[gi]))
        group_s.append(jnp.where(ok, s, adapt.group_s[gi]))
    new = adapt.replace(cov=cov, group_u=tuple(group_u), group_s=tuple(group_s))
    if config.mass_adapt:
        chol = utils.cholesky_psd(cov)
        ok = jnp.all(jnp.isfinite(chol))
        chol = jnp.where(ok, chol, adapt.chol)
        chol_inv = jnp.where(
            ok,
            jax.scipy.linalg.solve_triangular(
                chol, jnp.eye(config.ndim, dtype=chol.dtype), lower=True
            ),
            adapt.chol_inv,
        )
        new = new.replace(chol=chol, chol_inv=chol_inv)
    return new


def de_buffer_push(de: DEState, xs: jax.Array) -> DEState:
    """Append ``xs [D, m]`` columns to the ring buffer (``buf [D, B]``).

    The reference refreshes its DE buffer every ``burn`` iterations by bulk
    shift-and-append of the AM buffer (PTMCMCSampler.py:806-817); the
    device-resident ring achieves the same "recent cold-chain history" pool
    with a rolling write per iteration. The write is expressed as a masked
    roll, not ``.at[idx].set``: roll+select is dense, where a traced-index
    scatter is not (identical values — a roll only repositions).
    """
    rows = de.buf.shape[1]
    m = xs.shape[1]
    start = jnp.mod(de.filled, rows)
    vals = xs.astype(de.buf.dtype)
    if m < rows:
        vals = jnp.pad(vals, ((0, 0), (0, rows - m)))
    # rolled[:, j] = vals[:, (j - start) % rows], so column (start+i) % rows
    # holds xs[:, i] — the ring-write law.
    rolled = jnp.roll(vals, start, axis=1)
    mask = (jnp.arange(rows) - start) % rows < m
    buf = jnp.where(mask, rolled, de.buf)
    return de.replace(buf=buf, filled=de.filled + m)


def de_valid_rows(de: DEState) -> jax.Array:
    return jnp.minimum(de.filled, de.buf.shape[1])
