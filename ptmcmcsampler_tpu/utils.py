"""Small shared utilities for the PTMCMC framework.

This framework is a ground-up JAX/XLA re-design of the capabilities of
nanograv/PTMCMCSampler. Nothing in here is a translation of reference code;
reference citations in docstrings are for behavioral parity only.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = -jnp.inf

#: Root of the source checkout (the directory holding the package).
CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache(root=CHECKOUT_ROOT):
    """Turn on JAX's persistent compilation cache for an entry point.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing. Otherwise the cache goes to ``<root>/.jax_cache``: a fixed
    path, so a later run of the same checkout finds what an earlier one
    compiled. Called by ``chip_smoke.py``, ``bench.py`` and ``tools/``;
    importing the package never calls it. Returns the cache directory.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def tempered_lnprob(lnlike, lnprior, beta):
    """Tempered log-posterior ``beta * lnlike + lnprior``.

    Matches the reference semantics (PTMCMCSampler.py:487, :612, :695) with two
    fixes for XLA numerics:

    * ``beta == 0`` (our encoding of the reference's ``temp = 1e80`` hot chain,
      PTMCMCSampler.py:281-285): ``0 * (-inf)`` would be NaN; the reference's
      ``1e-80 * -inf`` is ``-inf``, so a ``-inf`` likelihood must stay ``-inf``
      at any temperature.
    * ``lnprior == -inf`` dominates regardless of the likelihood value
      (PTMCMCSampler.py:481-484, :607-608).
    """
    tempered = jnp.where(jnp.isneginf(lnlike), NEG_INF, beta * lnlike)
    return jnp.where(jnp.isneginf(lnprior), NEG_INF, tempered + lnprior)


def safe_where_finite(cond, x, fallback):
    """``where`` that never propagates NaN/inf from the unselected branch."""
    return jnp.where(cond, jnp.where(jnp.isfinite(x), x, fallback), fallback)


def cholesky_psd(mat, jitter=1e-10):
    """Cholesky factor of a (possibly barely-) PSD matrix with jitter retry."""
    d = mat.shape[-1]
    eye = jnp.eye(d, dtype=mat.dtype)
    scale = jnp.maximum(jnp.mean(jnp.diag(mat)), jnp.asarray(1.0, mat.dtype))
    chol = jnp.linalg.cholesky(mat + jitter * scale * eye)
    ok = jnp.all(jnp.isfinite(chol))
    bigger = jnp.linalg.cholesky(mat + 1e-4 * scale * eye)
    return jnp.where(ok, chol, bigger)


def as_2d_key(key):
    """Normalize a PRNG key to the old-style uint32[2] representation."""
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        return jax.random.key_data(key)
    return key


def ensure_typed_key(key):
    """Normalize to a typed PRNG key (new-style). Raw uint32 data is wrapped
    with the default impl (threefry2x32), preserving the exact stream. Typed
    keys let the whole sampler run on alternative PRNGs (``rbg`` /
    ``unsafe_rbg``)."""
    if jnp.issubdtype(jnp.asarray(key).dtype, jax.dtypes.prng_key):
        return key
    return jax.random.wrap_key_data(jnp.asarray(key))


def split_grid(key, shape):
    """Split a typed key into a grid of typed keys with the given shape."""
    n = 1
    for s in shape:
        n *= int(s)
    return jax.random.split(key, n).reshape(shape)


def num_thinned_rows(niter, thin):
    """Number of recorded rows for iterations 1..niter at thinning ``thin``.

    The reference records iteration ``i`` when ``i % thin == 0``
    (PTMCMCSampler.py:331-335); iteration 0 (the initial sample) is recorded
    separately.
    """
    return niter // thin


def host_array(x):
    return np.asarray(jax.device_get(x))
