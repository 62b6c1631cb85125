"""The per-iteration sampler kernel and the scanned block runner.

This is the replacement for the reference's hot loop
(``sample`` while-loop + ``PTMCMCOneStep``, PTMCMCSampler.py:499-629):
one pure function ``step(state) -> state`` containing

  proposal -> prior/likelihood -> tempered MH accept -> (cadenced) PT swap
  -> history/adaptation updates

for the whole [ntemps, nchains] replica batch at once, wrapped in
``lax.scan`` blocks that emit thinned samples. The reference's per-iteration
``comm.barrier()``/``bcast`` (:501, :523) vanish into SPMD program order, and
the rank-0 covariance/DE broadcasts (:545-576) become redundant because every
device computes identical adaptation state from collective-visible data.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import adaptation, swaps, utils
from .config import KIND_CHEES, SamplerConfig
from .proposals.base import ProposalContext
from .proposals.cycle import build_aux_chain, build_jump_branches, jump_probabilities
from .state import SamplerState


class BlockOutput(NamedTuple):
    """Thinned rows emitted by one scanned block.

    On an unsharded run the scalar-per-chain fields are emitted for chain 0
    only ([rows, T]) — the only column the chain files consume (reference
    writes one chain per rank, PTMCMCSampler.py:722-746) — which halves the
    block's emitted device-memory traffic; sharded runs keep the full [rows, T, C]
    (slicing a sharded chain axis inside the step would insert collectives).
    """

    x: jax.Array  # [rows, T, D, C] (chain-minor, like SamplerState.x)
    lnlike: jax.Array  # [rows, T] (unsharded) or [rows, T, C]
    lnprob: jax.Array  # [rows, T] (unsharded) or [rows, T, C]
    it: jax.Array  # [rows] iteration number of each emitted row
    # Counter snapshots at each row, so chain files can carry per-row
    # cumulative acceptance columns (reference PTMCMCSampler.py:731-745).
    naccepted: jax.Array = None  # [rows, T] (unsharded) or [rows, T, C]
    swaps_accepted: jax.Array = None  # [rows, T] (unsharded) or [rows, T, C]
    swaps_proposed: jax.Array = None  # [rows, T]
    traj: object = None  # TrajCapture rows when config.nuts_trajectory


_SS_FIELDS = (
    "epsilon", "epsilonbar", "hbar", "mu", "ncalls",
    "chees_eps", "chees_epsbar", "chees_hbar", "chees_mu",
    "chees_count", "chees_m", "chees_v", "chees_tlen",
)


def _ss_to_dict(ss):
    return {f: getattr(ss, f) for f in _SS_FIELDS}


def _ss_from_dict(ss, d):
    return ss.replace(**{f: d[f] for f in _SS_FIELDS})


def make_context(state: SamplerState) -> ProposalContext:
    return ProposalContext(
        group_u=state.adapt.group_u,
        group_s=state.adapt.group_s,
        chol=state.adapt.chol,
        chol_inv=state.adapt.chol_inv,
        de_buf=state.de.buf,
        de_valid=adaptation.de_valid_rows(state.de),
    )


def ladder_window_rates(ctr, dtype):
    """Recent-window per-pair swap acceptance rates for ladder adaptation.

    Vousden, Farr & Mandel (2016) adapt on the acceptance observed SINCE the
    previous geometry update; the deltas against the ``*_lad`` snapshots give
    exactly that window (pairs with no proposals in the window are flagged
    invalid so fabricated 0-rates never drive an update).
    Returns ``(rates [T], pair_valid [T] bool)``.
    """
    d_prop = ctr.swaps_proposed - ctr.swaps_proposed_lad
    d_acc = ctr.swaps_accepted - ctr.swaps_accepted_lad
    rates = jnp.mean(d_acc, axis=1) / jnp.maximum(d_prop, 1).astype(dtype)
    return rates.astype(dtype), d_prop > 0


def _accept_logratio(new_ll, new_lp, old_ll, old_lp, qxy, betas):
    """MH log-ratio with the reference's -inf semantics (PTMCMCSampler.py:605-616)."""
    new = utils.tempered_lnprob(new_ll, new_lp, betas)
    old = utils.tempered_lnprob(old_ll, old_lp, betas)
    raw = qxy + new - old
    raw = jnp.where(jnp.isneginf(new), -jnp.inf, raw)  # always reject into -inf
    raw = jnp.where(jnp.isneginf(old) & ~jnp.isneginf(new), jnp.inf, raw)
    return jnp.where(jnp.isnan(raw), -jnp.inf, raw)


def build_step(
    config: SamplerConfig,
    logl: Callable,
    logp: Callable,
    func_grad: Optional[Callable] = None,
    mesh=None,
    temp_axis="temp",
):
    """Build the pure one-iteration kernel.

    ``logl(x[D]) -> scalar`` and ``logp(x[D]) -> scalar`` are single-chain
    JAX-traceable callables (the sampler driver wraps user functions);
    ``func_grad(x[D], beta) -> (val, grad[D])`` is the tempered log-density
    with gradient for the gradient jump family (nutsjump.py:71-76).

    When ``mesh`` shards the temperature axis and ``swap_mode == "deo"``, the
    replica exchange runs as neighbor ``ppermute`` exchanges under
    ``shard_map`` (swaps.make_sharded_deo) — bit-identical results, with no
    all-gather of positions on the swap path.
    """
    t, c, _ = config.ntemps, config.nchains, config.ndim

    sharded_deo = None
    if (
        mesh is not None
        and config.swap_mode == "deo"
        and temp_axis in tuple(getattr(mesh, "axis_names", ()))
        and mesh.shape[temp_axis] > 1
        and t % mesh.shape[temp_axis] == 0
    ):
        sharded_deo = swaps.make_sharded_deo(mesh, temp_axis, t)

    # Chain-minor batching: x is [T, D, C]; the inner vmap maps the minor
    # chain axis, the outer the temperature axis.
    logl_b = jax.vmap(jax.vmap(logl, in_axes=-1))
    logp_b = jax.vmap(jax.vmap(logp, in_axes=-1))

    branches = build_jump_branches(config, func_grad, logp=logp)
    aux_chain = build_aux_chain(config)
    n_aux = len(config.aux_jumps)

    # Optional NUTS trajectory capture for (temp 0, chain 0) — the on-device
    # form of the reference's trajectoryDir facility (nutsjump.py:818-835).
    # The capture kernel re-runs NUTS for that one chain with the same PRNG
    # key as the vmapped branch, so the recorded trajectory is identical.
    capture_kernel = None
    nuts_idx = None
    if config.nuts_trajectory and config.jump_select == "shared" and func_grad is not None:
        from .proposals import nuts as _nuts_mod
        from .trajectory import TrajCapture, empty_capture

        for _i, _sp in enumerate(config.jumps):
            if _sp.kind == "nuts":
                nuts_idx = _i
        if nuts_idx is not None:
            capture_kernel = _nuts_mod.make_nuts(config, func_grad, capture=True)

    # ---- per_chain rotation machinery -------------------------------------
    # The reference's law is a fresh independent kind draw per rank per
    # iteration (PTMCMCSampler.py:1058-1059). Evaluating every branch and
    # masking (the "stacked" fallback below) pays every family's cost each
    # iteration; the rotation scheme instead draws ONE random rotation r
    # per iteration and assigns chain c the kind of slot (c + r) % C in a
    # static weight-proportional layout. Each chain's marginal kind law is
    # the weight distribution (quantized to 1/nchains by largest-remainder
    # rounding), selection is independent of all chain state, and every
    # branch runs once on a contiguous static slice — no gathers, no wasted
    # branch evaluations. Cross-chain correlation of the kind assignment is
    # the same flavor of (valid) deviation as jump_select="shared".
    per_chain_rotation = None
    if (
        config.jump_select == "per_chain"
        and config.per_chain_mode in ("auto", "rotation")
        and (config.per_chain_mode == "rotation" or c >= 128)
    ):
        w_np, act_np = config.weights_and_activation()
        thresholds = sorted({int(a) for a in act_np if int(a) > 0})

        def _partition(crossed):
            active = np.array(
                [(int(a) == 0) or (int(a) in crossed) for a in act_np]
            )
            probs = w_np * active
            if probs.sum() <= 0:  # degenerate: nothing active yet
                probs = np.asarray(w_np, np.float64)
            raw = probs / probs.sum() * c
            counts = np.floor(raw).astype(int)
            frac = raw - counts
            frac[~active] = -1.0
            for k in np.argsort(-frac)[: c - counts.sum()]:
                counts[k] += 1
            return counts

        chees_fields = tuple(f for f in _SS_FIELDS if f.startswith("chees_"))

        def make_phase_fn(counts):
            counts = [int(n) for n in counts]
            offs = np.concatenate([[0], np.cumsum(counts)])
            layout_j = jnp.asarray(
                np.concatenate(
                    [np.full(n, j, np.int32) for j, n in enumerate(counts)]
                    or [np.zeros(0, np.int32)]
                )
            )

            def phase_fn(r, keys, x, betas, it, ctx, ss):
                # chain c sits at slot s = (c + r) % C  =>  slots = roll(., r)
                x_rot = jnp.roll(x, r, axis=-1)
                ss_rot = {f: jnp.roll(v, r, axis=-1) for f, v in ss.items()}
                q_parts, qxy_parts = [], []
                ss_parts = {f: [] for f in _SS_FIELDS}
                chees_update = None
                for j, n in enumerate(counts):
                    if n == 0:
                        continue
                    sl = slice(int(offs[j]), int(offs[j]) + n)
                    ss_j = {f: v[:, sl] for f, v in ss_rot.items()}
                    qj, qxyj, ssj = branches[j](
                        keys[:, sl], x_rot[:, :, sl], betas, it, ctx, ss_j
                    )
                    q_parts.append(qj)
                    qxy_parts.append(qxyj)
                    for f in _SS_FIELDS:
                        ss_parts[f].append(ssj[f])
                    if config.jumps[j].kind == KIND_CHEES:
                        chees_update = ssj
                q_rot = jnp.concatenate(q_parts, axis=-1)
                qxy_rot = jnp.concatenate(qxy_parts, axis=-1)
                new_ss = {
                    f: jnp.roll(jnp.concatenate(ss_parts[f], axis=-1), -r, axis=-1)
                    for f in _SS_FIELDS
                }
                if chees_update is not None:
                    # chees_* entries are per-temperature scalars replicated
                    # over chains; broadcast the ChEES slice's update rowwide.
                    for f in chees_fields:
                        new_ss[f] = jnp.broadcast_to(
                            chees_update[f][:, :1], (t, c)
                        ).astype(ss[f].dtype)
                q = jnp.roll(q_rot, -r, axis=-1)
                qxy = jnp.roll(qxy_rot, -r, axis=-1)
                jidx_full = jnp.broadcast_to(jnp.roll(layout_j, -r)[None, :], (t, c))
                return q, qxy, jidx_full, new_ss

            return phase_fn

        phase_fns = [
            make_phase_fn(_partition(set(thresholds[:pi])))
            for pi in range(len(thresholds) + 1)
        ]

        def per_chain_rotation(k_kind, keys, x, betas, it, ctx, ss):
            r = jax.random.randint(k_kind, (), 0, c)
            if len(phase_fns) == 1:
                return phase_fns[0](r, keys, x, betas, it, ctx, ss)
            phase = jnp.zeros((), jnp.int32)
            for thr in thresholds:
                phase = phase + (it > thr).astype(jnp.int32)
            return jax.lax.switch(phase, phase_fns, r, keys, x, betas, it, ctx, ss)

    def propose(key, state: SamplerState, it):
        """Draw a jump from the cycle and apply it (reference ``_jump``,
        PTMCMCSampler.py:1048-1067)."""
        ctx = make_context(state)
        ss = _ss_to_dict(state.stepsize)
        k_kind, k_jump, k_aux = jax.random.split(key, 3)
        probs = jump_probabilities(config, it).astype(jnp.float32)
        logits = jnp.where(probs > 0, jnp.log(jnp.maximum(probs, 1e-30)), -jnp.inf)
        keys = utils.split_grid(k_jump, (t, c))

        cap = None
        if config.jump_select == "shared":
            jidx = jax.random.categorical(k_kind, logits)
            q, qxy, new_ss = jax.lax.switch(
                jidx, branches, keys, state.x, state.betas, it, ctx, ss
            )
            jidx_full = jnp.broadcast_to(jidx, (t, c))
            if capture_kernel is not None:
                def _do_cap(_):
                    ss00 = {k: v[0, 0] for k, v in ss.items()}
                    _, _, _, cp = capture_kernel(
                        keys[0, 0], state.x[0, :, 0], state.betas[0], it, ctx, ss00
                    )
                    return TrajCapture(**cp)

                cap = jax.lax.cond(
                    jidx == nuts_idx, _do_cap, lambda _: empty_capture(config), None
                )
        elif per_chain_rotation is not None:
            q, qxy, jidx_full, new_ss = per_chain_rotation(
                k_kind, keys, state.x, state.betas, it, ctx, ss
            )
        else:
            jidx_full = jax.random.categorical(k_kind, logits, shape=(t, c))
            # Evaluate every branch and select per chain (small chain counts;
            # gradient branches pay their full cost but the batch is small).
            outs = [b(keys, state.x, state.betas, it, ctx, ss) for b in branches]
            qs = jnp.stack([o[0] for o in outs])  # [J, T, D, C]
            qxys = jnp.stack([o[1] for o in outs])  # [J, T, C]
            q = jnp.take_along_axis(qs, jidx_full[:, None][None], axis=0)[0]
            qxy = jnp.take_along_axis(qxys, jidx_full[None], axis=0)[0]
            # Per-chain step-size state takes the selected branch's update;
            # per-temperature (chees_*) fields take the ChEES branch's update
            # wherever any chain in the row ran ChEES.
            new_ss = dict(ss)
            for j, o in enumerate(outs):
                oss = o[2]
                sel = jidx_full == j
                for f in ss:
                    if oss[f] is ss[f]:
                        continue
                    if f.startswith("chees_"):
                        row_has = jnp.any(sel, axis=1, keepdims=True)
                        new_ss[f] = jnp.where(row_has, oss[f], new_ss[f])
                    else:
                        new_ss[f] = jnp.where(sel, oss[f], new_ss[f])

        if aux_chain is not None:
            aux_keys = utils.split_grid(k_aux, (t, c, n_aux))
            q, qxy = aux_chain(aux_keys, state.x, q, qxy, state.betas, it)

        return q, qxy, jidx_full, _ss_from_dict(state.stepsize, new_ss), cap

    def mh_step(key, state: SamplerState, it):
        k_prop, k_acc = jax.random.split(key)
        q, qxy, jidx, new_sstate, cap = propose(k_prop, state, it)

        # Prior first; likelihood evaluated on a prior-feasible surrogate so
        # -inf-prior proposals never feed NaNs into the likelihood
        # (reference short-circuit, PTMCMCSampler.py:605-612).
        new_lp = logp_b(q)
        feasible = ~jnp.isneginf(new_lp)
        q_safe = jnp.where(feasible[:, None, :], q, state.x)
        new_ll = jnp.where(feasible, logl_b(q_safe), -jnp.inf)

        betas = state.betas[:, None]
        logr = _accept_logratio(new_ll, new_lp, state.lnlike, state.lnprior, qxy, betas)
        u = jax.random.uniform(k_acc, (t, c))
        accept = logr > jnp.log(jnp.maximum(u, 1e-37))

        x = jnp.where(accept[:, None, :], q, state.x)
        lnlike = jnp.where(accept, new_ll, state.lnlike)
        lnprior = jnp.where(accept, new_lp, state.lnprior)

        ctr = state.counters
        one_hot = jax.nn.one_hot(jidx, config.njumps, dtype=jnp.int32)  # [T,C,J]
        proposed = jnp.moveaxis(one_hot, -1, 0)
        ctr = ctr.replace(
            naccepted=ctr.naccepted + accept.astype(jnp.int32),
            jump_proposed=ctr.jump_proposed + proposed,
            jump_accepted=ctr.jump_accepted + proposed * accept.astype(jnp.int32)[None],
        )
        new = state.replace(
            x=x, lnlike=lnlike, lnprior=lnprior, counters=ctr, stepsize=new_sstate
        )
        if cap is not None:
            new = new.replace(traj=cap)
        return new

    def pt_swap(key, state: SamplerState, it):
        """Cadenced replica exchange (PTMCMCSampler.py:624-625, :631-697)."""
        if t <= 1:
            return state

        def do_swap(st):
            if config.swap_mode == "sweep":
                x, ll, lp, accepted, proposed = swaps.sweep_swap_apply(
                    key, st.x, st.lnlike, st.lnprior, st.betas
                )
            elif sharded_deo is not None:
                parity = (it // config.tskip) % 2
                x, ll, lp, accepted, proposed = sharded_deo(
                    key, st.x, st.lnlike, st.lnprior, st.betas, parity
                )
            else:
                parity = (it // config.tskip) % 2
                x, ll, lp, accepted, proposed = swaps.deo_swap_apply(
                    key, st.x, st.lnlike, st.lnprior, st.betas, parity
                )
            ctr = st.counters.replace(
                swaps_proposed=st.counters.swaps_proposed + proposed.astype(jnp.int32),
                swaps_accepted=st.counters.swaps_accepted + accepted.astype(jnp.int32),
            )
            betas = st.betas
            if config.adapt_ladder:
                # Adaptive ladder geometry (Vousden+ 2016) from the
                # RECENT-window per-pair acceptance rates (delta since the
                # last geometry update), burn-in only (the kernel is a fixed
                # Markov kernel afterwards).
                from .ladder import adapt_ladder_betas

                rates, pair_valid = ladder_window_rates(ctr, betas.dtype)
                new_betas = adapt_ladder_betas(
                    betas, rates, it,
                    lag=config.ladder_adapt_lag, time=config.ladder_adapt_time,
                    skip_top=config.ladder_adapt_skip_top,
                    pair_valid=pair_valid,
                )
                # Every spacing update compares ADJACENT pairs, which under
                # DEO have opposite parities — a one-event window only ever
                # holds one parity, so the update must wait until the window
                # covers both (sweep mode proposes every pair every event and
                # updates every event, as before).
                tt = t - (1 if config.ladder_adapt_skip_top else 0)
                have_all = (
                    jnp.all(pair_valid[: tt - 1]) if tt >= 3
                    else jnp.asarray(False)
                )
                applied = (it <= config.burn) & have_all
                betas = jnp.where(applied, new_betas, betas)
                # Advance the window only when an update applied, so the
                # post-burn counters never silently reset the snapshot.
                ctr = ctr.replace(
                    swaps_proposed_lad=jnp.where(
                        applied, ctr.swaps_proposed, ctr.swaps_proposed_lad
                    ),
                    swaps_accepted_lad=jnp.where(
                        applied, ctr.swaps_accepted, ctr.swaps_accepted_lad
                    ),
                )
            return st.replace(x=x, lnlike=ll, lnprior=lp, counters=ctr, betas=betas)

        return jax.lax.cond(it % config.tskip == 0, do_swap, lambda s: s, state)

    def history_updates(state: SamplerState, it):
        """Post-step history: Welford moments, DE ring, cadenced factor refresh
        (reference updateChains :321-339 + _updateRecursive/_updateDEbuffer)."""
        if config.adapt_from == "all":
            # [T, D, C] -> [D, T*C] (one transpose per iteration; non-default)
            xs = jnp.moveaxis(state.x, 1, 0).reshape(config.ndim, t * c)
        else:
            xs = state.x[0]  # [D, C] cold-temperature chains (reference rank 0, :327)
        adapt = adaptation.welford_batch_update(state.adapt, xs)
        de = adaptation.de_buffer_push(state.de, state.x[0])

        # The reference refreshes at the top of iteration k*covUpdate + 1 from
        # the previous covUpdate samples (PTMCMCSampler.py:545-546); refreshing
        # at the end of iteration k*covUpdate consumes the identical sample
        # set, so the factors first apply at the same iteration.
        refresh_due = (it % config.cov_update == 0) & (it > 0)
        adapt = jax.lax.cond(
            refresh_due,
            lambda a: adaptation.refresh_factors(config, a),
            lambda a: a,
            adapt,
        )
        return state.replace(adapt=adapt, de=de)

    def step(state: SamplerState) -> SamplerState:
        it = state.it + 1
        key, k_step, k_swap = jax.random.split(state.key, 3)
        state = state.replace(key=key, it=it)
        state = mh_step(k_step, state, it)
        state = pt_swap(k_swap, state, it)
        state = history_updates(state, it)
        return state

    # Emit only the chain-0 column of the per-chain scalars when unsharded
    # (see BlockOutput docstring).
    slim = mesh is None

    def _col0(a):
        return a[:, 0] if slim else a

    def record_chunk(state: SamplerState, _):
        """Advance ``thin`` iterations and emit one thinned row
        (reference records when iter % thin == 0, PTMCMCSampler.py:331-335)."""
        state = jax.lax.fori_loop(0, config.thin, lambda i, s: step(s), state)
        lnprob = utils.tempered_lnprob(state.lnlike, state.lnprior, state.betas[:, None])
        out = BlockOutput(
            x=state.x,
            lnlike=_col0(state.lnlike),
            lnprob=_col0(lnprob),
            it=state.it,
            naccepted=_col0(state.counters.naccepted),
            swaps_accepted=_col0(state.counters.swaps_accepted),
            swaps_proposed=state.counters.swaps_proposed,
            traj=state.traj,
        )
        return state, out

    @functools.partial(jax.jit, static_argnums=(1,))
    def run_block(state: SamplerState, nrows: int):
        """Run ``nrows * thin`` iterations, returning thinned samples."""
        return jax.lax.scan(record_chunk, state, length=nrows)

    return step, run_block
