"""Replica-exchange (parallel-tempering) swaps, fully on-device.

The reference gathers all chains to rank 0, runs a sequential
hottest-to-coldest sweep through a ``swap_map`` permutation, and scatters the
permuted states back (``PTswap``, PTMCMCSampler.py:631-697). Here the ladder
lives on one (possibly sharded) array axis, so a swap is a permutation of
device-resident rows — no host round-trip and no gather/scatter pair:

* ``sweep``  — statistically identical to the reference: a fori_loop over the
  T-1 adjacent pairs from the hottest pair down, vectorized across the chain
  batch, building the same swap_map permutation with the same acceptance rule
  ``log_acc = (1/T_i - 1/T_{i+1}) * (L[m[i+1]] - L[m[i]])`` (:673-678).
* ``deo``    — the deterministic even/odd scheme: alternating disjoint
  adjacent pairs, each swap local to a pair, which maps onto `ppermute`
  neighbor exchanges when the temperature axis is sharded across chips.

Both swap positions *and* cached log-prior/log-likelihood, so the reference's
post-swap prior re-evaluation (:695) is unnecessary.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pair_uniforms(key, t, c):
    """One uniform row per adjacent-pair index, derived by ``fold_in`` on the
    global pair index. Device-local computable: a shard that owns pair ``g``
    can regenerate exactly the same draw from the replicated key, which is
    what lets the sharded ppermute path below be bit-identical to the
    single-device path (no cross-device randomness exchange needed)."""
    def one(g):
        return jax.random.uniform(jax.random.fold_in(key, g), (c,))

    return jax.vmap(one)(jnp.arange(t))


def _sweep_rows(key, lnlike, betas, payload_rows=()):
    """Run the reference's hottest-first serial sweep over row lists.

    The sweep is unrolled over the (static, small) temperature count and
    carries the *permuted* likelihood rows directly, so no per-chain gather
    (``lnlike[m[i]]``) ever appears: per-element axis-0 gathers cost far more
    than the dense selects that replace them. Any extra ``payload_rows`` (each a list of T arrays with leading chain
    axis) are permuted by the same exchanges.

    Returns (m_rows, acc_rows, ll_rows, payload_rows) with identical values
    to the original fori_loop + take_along_axis formulation.
    """
    t, c = lnlike.shape
    us = jax.random.uniform(key, (t - 1, c) if t > 1 else (1, c))
    log_us = jnp.log(jnp.maximum(us, 1e-37))
    m_rows = [jnp.full((c,), i, jnp.int32) for i in range(t)]
    ll_rows = [lnlike[i] for i in range(t)]
    acc_rows = [jnp.zeros((c,), bool) for _ in range(t)]
    payload_rows = [list(rows) for rows in payload_rows]
    for i in range(t - 2, -1, -1):  # hottest pair first (reference reversed())
        li, li1 = ll_rows[i], ll_rows[i + 1]
        # (1/T_i - 1/T_{i+1}) * (L[m[i+1]] - L[m[i]]), as in :673-676.
        dll = jnp.where(jnp.isneginf(li1) & jnp.isneginf(li), 0.0, li1 - li)
        log_acc = (betas[i] - betas[i + 1]) * dll
        log_acc = jnp.where(jnp.isnan(log_acc), -jnp.inf, log_acc)
        take = log_us[i] <= log_acc
        ll_rows[i] = jnp.where(take, li1, li)
        ll_rows[i + 1] = jnp.where(take, li, li1)
        mi, mi1 = m_rows[i], m_rows[i + 1]
        m_rows[i] = jnp.where(take, mi1, mi)
        m_rows[i + 1] = jnp.where(take, mi, mi1)
        for rows in payload_rows:
            # take [C] broadcasts against chain-minor payload rows ([C] or
            # [D, C]) on trailing axes.
            ri, ri1 = rows[i], rows[i + 1]
            rows[i] = jnp.where(take, ri1, ri)
            rows[i + 1] = jnp.where(take, ri, ri1)
        acc_rows[i] = take
    return m_rows, acc_rows, ll_rows, payload_rows


def sweep_swap_map(key, lnlike, betas):
    """Build the per-chain swap permutation via the reference's serial sweep.

    lnlike: [T, C]; returns (swap_map [T, C] i32, accepted [T, C] bool,
    proposed [T] bool) where ``accepted[i]`` marks pair (i, i+1) swaps and
    ``proposed[i]`` marks that pair (i, i+1) was proposed this event (in a
    sweep: every pair; pair index T-1 is unused — the hottest chain has no
    upper neighbor; reference reports pt_acc = 1 for it,
    PTMCMCSampler.py:737-739).
    """
    t, c = lnlike.shape
    if t <= 1:
        swap_map0 = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32)[:, None], (t, c))
        return swap_map0, jnp.zeros((t, c), bool), jnp.zeros((t,), bool)
    m_rows, acc_rows, _, _ = _sweep_rows(key, lnlike, betas)
    proposed = jnp.arange(t) < (t - 1)
    return jnp.stack(m_rows), jnp.stack(acc_rows), proposed


def sweep_swap_apply(key, x, lnlike, lnprior, betas):
    """Sweep replica exchange applied in one pass (no swap-map gathers).

    Returns (x, lnlike, lnprior, accepted [T, C], proposed [T]) — bit-identical
    to ``apply_swap(sweep_swap_map(...)...)`` but the positions/priors ride the
    sweep's row exchanges directly instead of a final per-chain gather.
    ``x`` is chain-minor [T, D, C].
    """
    t, c = lnlike.shape
    if t <= 1:
        return x, lnlike, lnprior, jnp.zeros((t, c), bool), jnp.zeros((t,), bool)
    if t > 64:  # bound the unrolled program size for unusually tall ladders
        swap_map, accepted, proposed = sweep_swap_map(key, lnlike, betas)
        xg, llg, lpg = apply_swap(swap_map, x, lnlike, lnprior)
        return xg, llg, lpg, accepted, proposed
    _, acc_rows, ll_rows, (x_rows, lp_rows) = _sweep_rows(
        key, lnlike, betas, payload_rows=([x[i] for i in range(t)],
                                          [lnprior[i] for i in range(t)])
    )
    proposed = jnp.arange(t) < (t - 1)
    return (
        jnp.stack(x_rows),
        jnp.stack(ll_rows),
        jnp.stack(lp_rows),
        jnp.stack(acc_rows),
        proposed,
    )


def deo_swap_map(key, lnlike, betas, parity):
    """Even/odd disjoint adjacent-pair swaps (DEO scheme).

    parity 0: pairs (0,1),(2,3),...; parity 1: pairs (1,2),(3,4),...
    Detailed balance holds per pair; alternating parities gives the
    non-reversible DEO scheme with better round-trip rates than the
    stochastic sweep at many temperatures.

    Returns (swap_map [T, C], accepted [T, C], proposed [T]); ``proposed[i]``
    is True only for pairs active at this parity, so per-pair acceptance
    rates (accepted / proposed) are directly comparable between DEO and the
    sweep scheme.
    """
    t, c = lnlike.shape
    swap_map = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32)[:, None], (t, c))
    accepted = jnp.zeros((t, c), bool)
    if t <= 1:
        return swap_map, accepted, jnp.zeros((t,), bool)

    us = pair_uniforms(key, t, c)[:-1]  # [T-1, C]
    idx = jnp.arange(t)
    lo = idx[:-1]
    is_pair_lo = (lo % 2) == (parity % 2)  # [T-1] bool: pair (i, i+1) active
    dll = lnlike[1:] - lnlike[:-1]
    dll = jnp.where(jnp.isneginf(lnlike[1:]) & jnp.isneginf(lnlike[:-1]), 0.0, dll)
    log_acc = (betas[:-1, None] - betas[1:, None]) * dll
    log_acc = jnp.where(jnp.isnan(log_acc), -jnp.inf, log_acc)
    take = is_pair_lo[:, None] & (jnp.log(jnp.maximum(us, 1e-37)) <= log_acc)

    # Build permutation: row i goes up if take[i], row i+1 comes down.
    take_full_lo = jnp.concatenate([take, jnp.zeros((1, c), bool)], axis=0)  # i swaps w/ i+1
    take_full_hi = jnp.concatenate([jnp.zeros((1, c), bool), take], axis=0)  # i swaps w/ i-1
    target = jnp.where(take_full_lo, swap_map + 1, jnp.where(take_full_hi, swap_map - 1, swap_map))
    accepted = accepted.at[:-1].set(take)
    proposed = jnp.concatenate([is_pair_lo, jnp.zeros((1,), bool)])
    return target.astype(jnp.int32), accepted, proposed


def apply_swap(swap_map, x, lnlike, lnprior):
    """Permute replica state rows by the per-chain swap map (x chain-minor
    [T, D, C]).

    For the small static temperature counts PT ladders use, the per-chain
    axis-0 gather is expressed as a masked row sum (T selects per output row)
    — value-identical to ``take_along_axis``, but dense and vectorized.
    """
    t = lnlike.shape[0]
    if t > 16:  # select-sum cost grows as T^2; gathers win for tall ladders
        xg = jnp.take_along_axis(x, swap_map[:, None, :], axis=0)
        llg = jnp.take_along_axis(lnlike, swap_map, axis=0)
        lpg = jnp.take_along_axis(lnprior, swap_map, axis=0)
        return xg, llg, lpg
    x_rows, ll_rows, lp_rows = [], [], []
    for i in range(t):
        sel = swap_map[i]
        xi, lli, lpi = x[i], lnlike[i], lnprior[i]
        for j in range(t):
            if j == i:
                continue
            m = sel == j
            xi = jnp.where(m, x[j], xi)  # m [C] vs x[j] [D, C]: trailing bcast
            lli = jnp.where(m, lnlike[j], lli)
            lpi = jnp.where(m, lnprior[j], lpi)
        x_rows.append(xi)
        ll_rows.append(lli)
        lp_rows.append(lpi)
    return jnp.stack(x_rows), jnp.stack(ll_rows), jnp.stack(lp_rows)


def deo_swap_apply(key, x, lnlike, lnprior, betas, parity):
    """DEO replica exchange applied as neighbor row selects (no gathers).

    Value-identical to ``apply_swap(deo_swap_map(...)...)``: at a given parity
    each row only ever exchanges with one fixed neighbor, so the permute is a
    pair of shifted wheres (the single-device analogue of the sharded
    ppermute body in :func:`make_sharded_deo`).

    Returns (x, lnlike, lnprior, accepted [T, C], proposed [T]).
    """
    t, c = lnlike.shape
    if t <= 1:
        return x, lnlike, lnprior, jnp.zeros((t, c), bool), jnp.zeros((t,), bool)
    us = pair_uniforms(key, t, c)[:-1]  # [T-1, C]
    lo = jnp.arange(t - 1)
    is_pair_lo = (lo % 2) == (parity % 2)
    dll = lnlike[1:] - lnlike[:-1]
    dll = jnp.where(jnp.isneginf(lnlike[1:]) & jnp.isneginf(lnlike[:-1]), 0.0, dll)
    log_acc = (betas[:-1, None] - betas[1:, None]) * dll
    log_acc = jnp.where(jnp.isnan(log_acc), -jnp.inf, log_acc)
    take = is_pair_lo[:, None] & (jnp.log(jnp.maximum(us, 1e-37)) <= log_acc)

    pad = jnp.zeros((1, c), bool)
    take_lo = jnp.concatenate([take, pad], axis=0)  # row i swaps with i+1
    take_hi = jnp.concatenate([pad, take], axis=0)  # row i swaps with i-1
    up = jnp.roll(lnlike, -1, axis=0)
    dn = jnp.roll(lnlike, 1, axis=0)
    new_ll = jnp.where(take_lo, up, jnp.where(take_hi, dn, lnlike))
    up = jnp.roll(lnprior, -1, axis=0)
    dn = jnp.roll(lnprior, 1, axis=0)
    new_lp = jnp.where(take_lo, up, jnp.where(take_hi, dn, lnprior))
    tl3, th3 = take_lo[:, None, :], take_hi[:, None, :]
    new_x = jnp.where(
        tl3, jnp.roll(x, -1, axis=0), jnp.where(th3, jnp.roll(x, 1, axis=0), x)
    )
    accepted = jnp.concatenate([take, pad], axis=0)
    proposed = jnp.concatenate([is_pair_lo, jnp.zeros((1,), bool)])
    return new_x, new_ll, new_lp, accepted, proposed


def make_sharded_deo(mesh, temp_axis, ntemps, parity_fn=None):
    """DEO swaps as neighbor ``ppermute`` exchanges under ``shard_map``.

    The replacement SURVEY §2.3 names for the reference's gather → rank-0
    sweep → scatter (PTMCMCSampler.py:660-691): when the temperature ladder
    is sharded over a mesh axis, a DEO event only ever exchanges *adjacent*
    rows, so the only cross-device traffic is each shard's boundary row
    moving one neighbor over — a ``collective-permute``, never an all-gather
    of the positions.

    Randomness comes from :func:`pair_uniforms`' per-pair ``fold_in`` draws,
    which every shard regenerates locally from the replicated key — the
    result is bit-identical to the single-device ``deo_swap_map`` +
    ``apply_swap`` path (asserted in tests/test_sharding.py).

    Returns ``f(key, x, lnlike, lnprior, betas, parity) ->
    (x, lnlike, lnprior, accepted [T, C] bool, proposed [T] bool)``.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    ndev = mesh.shape[temp_axis]
    assert ntemps % ndev == 0, (ntemps, ndev)
    tl = ntemps // ndev
    up = [(d + 1, d) for d in range(ndev - 1)]  # receive from upper neighbor
    dn = [(d, d + 1) for d in range(ndev - 1)]  # receive from lower neighbor

    def body(key, x, lnlike, lnprior, betas, parity):
        """Shard-local block: x [Tl, C, D], lnlike/lnprior [Tl, C],
        betas [Tl]; key and parity replicated."""
        di = jax.lax.axis_index(temp_axis)
        c = lnlike.shape[1]
        g = di * tl + jnp.arange(tl)  # global row index of each local row

        def pp(v):
            return jax.lax.ppermute(v, temp_axis, up)

        # Upper-partner rows for each local row as the LOW side of its pair:
        # rows 1..Tl-1 locally, plus the upper neighbor's first row.
        nb_ll = pp(lnlike[0])
        nb_lp = pp(lnprior[0])
        nb_x = pp(x[0])
        nb_beta = pp(betas[0])
        hi_ll = jnp.concatenate([lnlike[1:], nb_ll[None]], axis=0)
        hi_lp = jnp.concatenate([lnprior[1:], nb_lp[None]], axis=0)
        hi_x = jnp.concatenate([x[1:], nb_x[None]], axis=0)
        hi_beta = jnp.concatenate([betas[1:], nb_beta[None]])

        active = ((g % 2) == (parity % 2)) & (g <= ntemps - 2)
        # Same per-pair draws as pair_uniforms, regenerated shard-locally.
        us = jax.vmap(
            lambda gi: jax.random.uniform(jax.random.fold_in(key, gi), (c,))
        )(g)
        dll = jnp.where(jnp.isneginf(hi_ll) & jnp.isneginf(lnlike), 0.0, hi_ll - lnlike)
        log_acc = (betas[:, None] - hi_beta[:, None]) * dll
        log_acc = jnp.where(jnp.isnan(log_acc), -jnp.inf, log_acc)
        take_low = active[:, None] & (jnp.log(jnp.maximum(us, 1e-37)) <= log_acc)

        # Each row as the HIGH side of the pair below it: shift take_low down
        # one row; the shard boundary row comes from the lower neighbor.
        def pd(v):
            return jax.lax.ppermute(v, temp_axis, dn)

        below_take = pd(take_low[-1])
        below_ll = pd(lnlike[-1])
        below_lp = pd(lnprior[-1])
        below_x = pd(x[-1])
        take_high = jnp.concatenate([below_take[None], take_low[:-1]], axis=0)
        lo_ll = jnp.concatenate([below_ll[None], lnlike[:-1]], axis=0)
        lo_lp = jnp.concatenate([below_lp[None], lnprior[:-1]], axis=0)
        lo_x = jnp.concatenate([below_x[None], x[:-1]], axis=0)

        # Pairs are disjoint at a given parity, so take_low/take_high never
        # overlap on a row.
        new_ll = jnp.where(take_low, hi_ll, jnp.where(take_high, lo_ll, lnlike))
        new_lp = jnp.where(take_low, hi_lp, jnp.where(take_high, lo_lp, lnprior))
        tl3 = take_low[:, None, :]
        th3 = take_high[:, None, :]
        new_x = jnp.where(tl3, hi_x, jnp.where(th3, lo_x, x))
        return new_x, new_ll, new_lp, take_low, active

    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(),  # key (replicated)
            P(temp_axis, None, None),  # x
            P(temp_axis, None),  # lnlike
            P(temp_axis, None),  # lnprior
            P(temp_axis),  # betas
            P(),  # parity
        ),
        out_specs=(
            P(temp_axis, None, None),
            P(temp_axis, None),
            P(temp_axis, None),
            P(temp_axis, None),
            P(temp_axis),
        ),
    )

    def run(key, x, lnlike, lnprior, betas, parity):
        return sharded(key, x, lnlike, lnprior, betas, jnp.asarray(parity, jnp.int32))

    return run
