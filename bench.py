"""Benchmark: effective samples/sec on the curved-likelihood workload.

The headline metric from BASELINE.json: effective samples/sec/chip on the
curved (banana) likelihood of examples/curved_likelihood.ipynb, with a full
jump cycle (SCAM/AM/DE + a gradient family, MALA off) and an 8-rung
parallel-tempering ladder — the reference's `mpirun -np 8` workload mapped
onto one GPU via vmapped chains and an on-device ladder. The default
gradient family is ChEES-HMC (vmap-friendly adaptive trajectories);
`grad_mode=nuts` runs the reference-parity NUTS/HMC cycle instead.

Run on a GPU: `python bench.py [key=value ...]`. A run that finds no GPU
exits nonzero and prints no result.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Baseline denominator (see tools/measure_baseline.py): the reference sampler
measured on a CPU on the same posterior, single process (one rank's
wall-clock per iteration equals the 8-rank case since ranks step
concurrently). ESS uses the cross-chain (Stan-style) pooled estimator, which
penalizes chains stuck in different modes — no vmap overcounting.
"""

import json
import os
import sys
import time

import numpy as np


def _log(msg):
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)

# The reference sampler's rate on the same posterior, written to
# BASELINE_MEASURED.json by tools/measure_baseline.py.
_BASELINE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "BASELINE_MEASURED.json")


def _baseline():
    if os.path.isfile(_BASELINE_FILE):
        with open(_BASELINE_FILE) as f:
            return json.load(f).get("ess_per_sec", 1.0)
    return 1.0


def require_gpu():
    """Return the first device, or exit when JAX finds no GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r} devices")
    return dev


def main(
    ntemps=8, nchains=16384, burn_iters=3000, timed_iters=12000, with_grads=True,
    block=1000, workload="curved", grad_mode="chees", nuts_max_depth=10,
    rng_impl="rbg", tskip=5, adapt_ladder=0, de_pair="blocked",
):
    # nuts_max_depth=10 matches the sampler default (the reference's doubling
    # loop is unbounded). The chain batch, RNG and tskip defaults come from
    # earlier tuning on another accelerator and are to be re-measured here.
    dev = require_gpu()
    import jax
    import jax.numpy as jnp

    from ptmcmcsampler_tpu.config import SamplerConfig, build_default_jumps
    from ptmcmcsampler_tpu.diagnostics import moment_gate, multichain_ess, split_rhat
    from ptmcmcsampler_tpu.kernel import build_step
    from ptmcmcsampler_tpu.ladder import ladder_betas, temperature_ladder
    from ptmcmcsampler_tpu.models import (
        CorrelatedGaussian,
        CurvedLikelihood,
        HierarchicalGaussian,
        IntervalTransformedGaussian,
    )
    from ptmcmcsampler_tpu.state import init_state
    from ptmcmcsampler_tpu.utils import enable_compile_cache

    enable_compile_cache()
    if workload == "gaussian":
        model = IntervalTransformedGaussian(ndim=40)
        x0 = np.zeros(40)
        metric = "gaussian40_ess_per_sec"
    elif workload == "hierarchical":
        # 50-D linear-Gaussian hierarchy (BASELINE.json config 4): the
        # PTA-scale dimensionality class the reference's real users run.
        model = HierarchicalGaussian()
        x0 = np.zeros(model.ndim)
        metric = "hierarchical50_ess_per_sec"
    elif workload == "gaussian200":
        # 200-D correlated Gaussian: high-dimension evidence point — AM's
        # U@y, the Welford x^T x and the batched gradients are real matmuls
        # at this size.
        model = CorrelatedGaussian(ndim=200, seed=1)
        x0 = model.mu.copy()
        metric = "gaussian200_ess_per_sec"
    else:
        model = CurvedLikelihood()
        x0 = np.array([-0.1, -0.5])
        metric = "curved_likelihood_ess_per_sec"
    ndim = model.ndim

    def func_grad(x, beta):
        ll, gll = model.lnlikefn_grad(x)
        lp, glp = model.lnpriorfn_grad(x)
        return beta * ll + lp, beta * gll + glp

    # The scanned block emits [block, T, C, D] thinned history on device;
    # at high ndim a 1000-iter block alone is gigabytes (50-D x 4096 chains
    # = 6.5 GB -> RESOURCE_EXHAUSTED). Cap the block so the emitted history
    # stays ~1.5 GB and round the iteration counts to the block.
    hist_bytes = ntemps * nchains * ndim * 4
    block = max(50, min(block, int(1.5e9 // max(hist_bytes, 1))))
    burn_iters = max(block, burn_iters // block * block)
    timed_iters = max(block, timed_iters // block * block)

    use_chees = grad_mode == "chees"
    cfg = SamplerConfig(
        ndim=ndim,
        ntemps=ntemps,
        nchains=nchains,
        groups=(tuple(range(ndim)),),
        jumps=build_default_jumps(
            SCAMweight=10, AMweight=10, DEweight=10,
            NUTSweight=(10 if with_grads and not use_chees else 0),
            HMCweight=(10 if with_grads and not use_chees else 0),
            CHEESweight=(20 if with_grads and use_chees else 0),
            MALAweight=0, burn=burn_iters // 2, have_grads=with_grads,
        ),
        # tskip=5: replica exchange every 5 iterations. On this bimodal
        # target the cold-chain tau is dominated by mode exchange through the
        # ladder, and the swap sweep costs little at [8, C].
        tskip=tskip,
        cov_update=1000,
        burn=burn_iters // 2,
        thin=1,
        de_size=2000,
        hmc_stepsize=0.08,
        hmc_nmaxsteps=50,
        nuts_max_depth=nuts_max_depth,
        # adapt_ladder=1 turns on the windowed Vousden+ ladder-geometry
        # adaptation during burn-in (kernel.py pt_swap).
        adapt_ladder=bool(adapt_ladder),
        de_pair=de_pair,
    )
    step, run_block = build_step(
        cfg, model.lnlikefn, model.lnpriorfn, func_grad if with_grads else None
    )

    ladder = temperature_ladder(ndim, ntemps)
    _, betas = ladder_betas(ladder)
    xs = jnp.broadcast_to(jnp.asarray(x0, cfg.dtype), (ntemps, nchains, ndim))
    ll0 = jax.vmap(jax.vmap(model.lnlikefn))(xs)
    lp0 = jax.vmap(jax.vmap(model.lnpriorfn))(xs)
    state = init_state(
        cfg, jax.random.key(7, impl=rng_impl), x0, np.eye(ndim), betas, ll0, lp0
    )

    # Warmup: compile + burn-in/adaptation.
    def sync(arr):
        return float(jax.device_get(jnp.sum(arr)))

    _log("compiling main block...")
    state, out = run_block(state, block)
    sync(out.lnlike)
    _log("main block compiled; burn-in...")
    for _ in range(burn_iters // block - 1):
        state, out = run_block(state, block)
        sync(out.lnlike)
    _log("burn-in done; timing...")

    # Timed window. Double-buffered: the NEXT block is dispatched (async)
    # before syncing the previous one, so the host round-trip between blocks
    # overlaps device compute instead of idling the device.
    #
    # The retained cold-chain window ([timed_iters, D, C] on device) feeds
    # the ESS/moment estimators; at high ndim x nchains it would outgrow
    # device memory, so chains are strided down to a ~4 GB budget. The pooled ESS is then computed over
    # the retained subset ONLY and reported as such (ess_chains_used) — an
    # honest underestimate, never an extrapolation.
    ess_stride = max(1, int(np.ceil(timed_iters * ndim * nchains * 4 / 4e9)))
    csub = len(range(0, nchains, ess_stride))
    if ess_stride > 1:
        _log(f"cold-chain retention strided: {csub}/{nchains} chains kept "
             "for the ESS/moment estimators (device-memory budget)")
    nblocks = timed_iters // block
    t0 = time.time()
    cold_blocks = []
    state, out = run_block(state, block)
    for bi in range(1, nblocks):
        state, out_next = run_block(state, block)  # async dispatch
        cold_blocks.append(out.x[:, 0, :, ::ess_stride])  # [block, D, Csub]
        sync(out.lnlike)
        _log(f"timed block {bi}/{nblocks} at {time.time() - t0:.1f}s")
        out = out_next
    cold_blocks.append(out.x[:, 0, :, ::ess_stride])
    sync(out.lnlike)
    _log(f"timed block {nblocks}/{nblocks} at {time.time() - t0:.1f}s")
    elapsed = time.time() - t0

    cold = np.concatenate([np.asarray(jax.device_get(b)) for b in cold_blocks], axis=0)
    cold = np.moveaxis(cold, 1, 2)  # [timed_iters, D, C] -> [timed_iters, C, D]
    # [timed_iters, C, D] -> chains-major [C, N, D]
    chains = np.moveaxis(cold, 0, 1)
    ess = multichain_ess(chains)
    ess_min = float(np.min(ess))
    ess_per_sec = ess_min / elapsed
    iters_per_sec = timed_iters / elapsed
    # Convergence evidence independent of any closed-form target (the only
    # QA available for workloads like gaussian200 where box truncation
    # leaves no analytic moments): split Gelman-Rubin over the pooled
    # cold-chain batch.
    rhat_max = float(np.nanmax(split_rhat(chains)))

    # Statistical QA: for workloads with closed-form posterior moments, the
    # bench asserts the sampled mean agrees within Monte-Carlo error, so a
    # speedup can never silently come from a wrong kernel (z uses the pooled
    # per-dimension ESS as the effective sample count).
    moments_ok = moments_max_z = None
    target = None
    if workload in ("hierarchical", "curved", "gaussian"):
        # hierarchical: closed form; curved: 2-D quadrature ground truth
        # (bimodal target - the mean checks the PT mass ratio between
        # modes); gaussian: per-dim 1-D quadrature of the logit-transformed
        # truncated normal. The HEADLINE number therefore always ships with
        # an in-run statistical check.
        target, _ = model.posterior_moments()
    # gaussian200 deliberately has NO moment target: its marginal sigmas
    # (~4) rival the [0, 10] box width, so truncation shifts the posterior
    # mean far from the unconstrained mu (z ~ 77 on a correct run) and no
    # closed form exists for the truncated correlated Gaussian.
    if target is not None:
        moments_ok, moments_max_z = moment_gate(cold, ess, target)

    # XLA's own cost model of one iteration (device independent). It counts
    # loop bodies ONCE (reported flops do not depend on the scan length), so
    # lower a LENGTH-1 block: with thin=1 the scanned body is exactly one
    # iteration plus one emission row. "bytes accessed" is the LOGICAL
    # operand traffic of the HLO — an upper bound on device-memory bytes.
    flops_iter = bytes_iter = None
    ca = run_block.lower(state, 1).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    if ca:
        flops_iter = float(ca.get("flops", 0.0))
        bytes_iter = float(ca.get("bytes accessed", 0.0))

    baseline = _baseline() if workload == "curved" else None
    result = {
        "metric": metric,
        "value": ess_per_sec,
        "unit": "eff_samples/s/chip",
        "vs_baseline": ess_per_sec / baseline if baseline else None,
        "iters_per_sec": iters_per_sec,
        "nchains": nchains,
        "ntemps": ntemps,
        "timed_iters": timed_iters,
        "elapsed_sec": elapsed,
        "ess_min_dim": ess_min,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "flops_per_iter": flops_iter,
        "logical_bytes_per_iter": bytes_iter,
        "moments_ok": moments_ok,
        "moments_max_z": moments_max_z,
        "rhat_max": rhat_max,
        "ess_chains_used": csub,
    }
    print(json.dumps(result))
    if moments_ok is False:
        # The QA must FAIL the bench, not just annotate it: a speedup from a
        # wrong kernel would otherwise exit 0 with a headline number.
        raise SystemExit(
            "posterior-moment check FAILED (max z = %s); the speed number "
            "above is not trustworthy" % moments_max_z
        )
    return result


if __name__ == "__main__":
    kwargs = {}
    for arg in sys.argv[1:]:
        k, v = arg.split("=", 1)
        kwargs[k] = int(v) if v.isdigit() else v
    main(**kwargs)
