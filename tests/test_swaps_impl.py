"""Bit-identity of the gather-free swap implementations.

Round 5 replaced the fori_loop + take_along_axis sweep and the swap-map
gathers (slow per-element gathers) with unrolled row-exchange
carries and masked row sums. These tests pin the new implementations to the
original formulations (kept here as oracles) bit-for-bit on random inputs,
including -inf likelihood rows (hot prior-sampling chains).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptmcmcsampler_tpu import swaps


def _oracle_sweep_swap_map(key, lnlike, betas):
    """The original fori_loop + take_along_axis sweep."""
    t, c = lnlike.shape
    us = jax.random.uniform(key, (t - 1, c) if t > 1 else (1, c))
    swap_map0 = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32)[:, None], (t, c))
    accepted0 = jnp.zeros((t, c), bool)
    proposed = jnp.arange(t) < (t - 1)

    def body(step, carry):
        m, acc = carry
        i = t - 2 - step
        mi = m[i]
        mi1 = m[i + 1]
        li = jnp.take_along_axis(lnlike, mi[None, :], axis=0)[0]
        li1 = jnp.take_along_axis(lnlike, mi1[None, :], axis=0)[0]
        dll = jnp.where(jnp.isneginf(li1) & jnp.isneginf(li), 0.0, li1 - li)
        log_acc = (betas[i] - betas[i + 1]) * dll
        log_acc = jnp.where(jnp.isnan(log_acc), -jnp.inf, log_acc)
        take = jnp.log(jnp.maximum(us[i], 1e-37)) <= log_acc
        m = m.at[i].set(jnp.where(take, mi1, mi)).at[i + 1].set(
            jnp.where(take, mi, mi1)
        )
        acc = acc.at[i].set(take)
        return m, acc

    m, acc = jax.lax.fori_loop(0, t - 1, body, (swap_map0, accepted0))
    return m, acc, proposed


def _oracle_apply(swap_map, x, lnlike, lnprior):
    xg = jnp.take_along_axis(x, swap_map[:, None, :], axis=0)  # x [T, D, C]
    llg = jnp.take_along_axis(lnlike, swap_map, axis=0)
    lpg = jnp.take_along_axis(lnprior, swap_map, axis=0)
    return xg, llg, lpg


def _random_state(seed, t=6, c=33, d=3, with_neginf=True):
    rng = np.random.default_rng(seed)
    lnlike = rng.normal(size=(t, c)).astype(np.float32)
    if with_neginf:
        lnlike[-1] = -np.inf  # hot chain / rejected rows
        lnlike[2, :5] = -np.inf
    lnprior = rng.normal(size=(t, c)).astype(np.float32)
    x = rng.normal(size=(t, d, c)).astype(np.float32)  # chain-minor
    betas = np.sort(rng.uniform(0.01, 1.0, size=t).astype(np.float32))[::-1].copy()
    return jnp.asarray(x), jnp.asarray(lnlike), jnp.asarray(lnprior), jnp.asarray(betas)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sweep_map_bit_identical(seed):
    x, lnlike, lnprior, betas = _random_state(seed)
    key = jax.random.key(seed)
    m_new, acc_new, prop_new = swaps.sweep_swap_map(key, lnlike, betas)
    m_old, acc_old, prop_old = _oracle_sweep_swap_map(key, lnlike, betas)
    np.testing.assert_array_equal(np.asarray(m_new), np.asarray(m_old))
    np.testing.assert_array_equal(np.asarray(acc_new), np.asarray(acc_old))
    np.testing.assert_array_equal(np.asarray(prop_new), np.asarray(prop_old))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sweep_apply_bit_identical(seed):
    x, lnlike, lnprior, betas = _random_state(seed)
    key = jax.random.key(seed + 100)
    xg, llg, lpg, acc, prop = swaps.sweep_swap_apply(key, x, lnlike, lnprior, betas)
    m_old, acc_old, _ = _oracle_sweep_swap_map(key, lnlike, betas)
    xo, llo, lpo = _oracle_apply(m_old, x, lnlike, lnprior)
    np.testing.assert_array_equal(np.asarray(xg), np.asarray(xo))
    np.testing.assert_array_equal(np.asarray(llg), np.asarray(llo))
    np.testing.assert_array_equal(np.asarray(lpg), np.asarray(lpo))
    np.testing.assert_array_equal(np.asarray(acc), np.asarray(acc_old))


@pytest.mark.parametrize("seed,parity", [(0, 0), (0, 1), (5, 0), (5, 1)])
def test_deo_apply_bit_identical(seed, parity):
    x, lnlike, lnprior, betas = _random_state(seed)
    key = jax.random.key(seed + 200)
    xg, llg, lpg, acc, prop = swaps.deo_swap_apply(key, x, lnlike, lnprior, betas, parity)
    m_old, acc_old, prop_old = swaps.deo_swap_map(key, lnlike, betas, parity)
    xo, llo, lpo = _oracle_apply(m_old, x, lnlike, lnprior)
    np.testing.assert_array_equal(np.asarray(xg), np.asarray(xo))
    np.testing.assert_array_equal(np.asarray(llg), np.asarray(llo))
    np.testing.assert_array_equal(np.asarray(lpg), np.asarray(lpo))
    np.testing.assert_array_equal(np.asarray(acc), np.asarray(acc_old))
    np.testing.assert_array_equal(np.asarray(prop), np.asarray(prop_old))


def test_apply_swap_select_sum_matches_gather():
    x, lnlike, lnprior, betas = _random_state(7, t=8, c=17, d=2)
    rng = np.random.default_rng(7)
    swap_map = jnp.asarray(rng.integers(0, 8, size=(8, 17)), jnp.int32)
    xg, llg, lpg = swaps.apply_swap(swap_map, x, lnlike, lnprior)
    xo, llo, lpo = _oracle_apply(swap_map, x, lnlike, lnprior)
    np.testing.assert_array_equal(np.asarray(xg), np.asarray(xo))
    np.testing.assert_array_equal(np.asarray(llg), np.asarray(llo))
    np.testing.assert_array_equal(np.asarray(lpg), np.asarray(lpo))


def test_single_temp_noop():
    x, lnlike, lnprior, betas = _random_state(3, t=1, c=9, d=2, with_neginf=False)
    key = jax.random.key(0)
    xg, llg, lpg, acc, prop = swaps.sweep_swap_apply(key, x, lnlike, lnprior, betas)
    np.testing.assert_array_equal(np.asarray(xg), np.asarray(x))
    assert not np.any(np.asarray(acc))
    xg, llg, lpg, acc, prop = swaps.deo_swap_apply(key, x, lnlike, lnprior, betas, 0)
    np.testing.assert_array_equal(np.asarray(xg), np.asarray(x))
