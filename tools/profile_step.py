#!/usr/bin/env python
"""Per-branch step timing: for each jump family, build a cycle containing only
that family and measure per-iteration wall time at several chain counts.
Gives the perf picture needed to target kernel optimization (which branch
dominates, how cost scales with the vmap batch).

Usage: python tools/profile_step.py [nchains=1024,8192] [iters=2000] [ndim=2]
Output: one JSON line per (branch, nchains) to stdout; progress to stderr.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def log(m):
    print(f"[profile {time.strftime('%H:%M:%S')}] {m}", file=sys.stderr, flush=True)


def run():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ptmcmcsampler_tpu.config import JumpSpec, SamplerConfig
    from ptmcmcsampler_tpu.config import (
        KIND_AM, KIND_CHEES, KIND_DE, KIND_HMC, KIND_NUTS, KIND_SCAM,
    )
    from ptmcmcsampler_tpu.kernel import build_step
    from ptmcmcsampler_tpu.ladder import ladder_betas, temperature_ladder
    from ptmcmcsampler_tpu.models import CurvedLikelihood, IntervalTransformedGaussian
    from ptmcmcsampler_tpu.state import init_state
    from ptmcmcsampler_tpu.utils import enable_compile_cache

    enable_compile_cache()
    kwargs = {}
    for arg in sys.argv[1:]:
        if "=" in arg:
            k, v = arg.split("=", 1)
            kwargs[k] = v
    chain_grid = [int(x) for x in kwargs.get("nchains", "1024,8192").split(",")]
    iters = int(kwargs.get("iters", "2000"))
    ndim = int(kwargs.get("ndim", "2"))
    ntemps = int(kwargs.get("ntemps", "8"))
    rng_impl = kwargs.get("rng_impl", "threefry2x32")

    model = CurvedLikelihood() if ndim == 2 else IntervalTransformedGaussian(ndim=ndim)
    x0 = np.zeros(model.ndim) if ndim != 2 else np.array([-0.1, -0.5])

    def func_grad(x, beta):
        ll, gll = model.lnlikefn_grad(x)
        lp, glp = model.lnpriorfn_grad(x)
        return beta * ll + lp, beta * gll + glp

    branches = [
        ("scam", JumpSpec("S", KIND_SCAM, 1)),
        ("am", JumpSpec("A", KIND_AM, 1)),
        ("de", JumpSpec("D", KIND_DE, 1)),
        ("hmc", JumpSpec("H", KIND_HMC, 1)),
        ("nuts", JumpSpec("N", KIND_NUTS, 1)),
        ("chees", JumpSpec("C", KIND_CHEES, 1)),
        ("mix", None),  # bench-like full cycle
    ]

    results = []
    for name, spec in branches:
        for nc in chain_grid:
            if spec is None:
                jumps = (
                    JumpSpec("S", KIND_SCAM, 10),
                    JumpSpec("A", KIND_AM, 10),
                    JumpSpec("D", KIND_DE, 10),
                    JumpSpec("H", KIND_HMC, 10),
                    JumpSpec("N", KIND_NUTS, 10),
                )
            else:
                jumps = (spec,)
            cfg = SamplerConfig(
                ndim=model.ndim, ntemps=ntemps, nchains=nc,
                groups=(tuple(range(model.ndim)),),
                jumps=jumps, tskip=100, cov_update=1000, burn=500,
                thin=1, de_size=2000, hmc_stepsize=0.08, hmc_nmaxsteps=50,
                nuts_max_depth=8,
            )
            step, run_block = build_step(cfg, model.lnlikefn, model.lnpriorfn, func_grad)
            ladder = temperature_ladder(model.ndim, ntemps)
            _, betas = ladder_betas(ladder)
            xs = jnp.broadcast_to(jnp.asarray(x0, cfg.dtype), (ntemps, nc, model.ndim))
            ll0 = jax.vmap(jax.vmap(model.lnlikefn))(xs)
            lp0 = jax.vmap(jax.vmap(model.lnpriorfn))(xs)
            state = init_state(
                cfg, jax.random.key(1, impl=rng_impl), x0, np.eye(model.ndim),
                betas, ll0, lp0,
            )

            def sync(arr):
                return float(jax.device_get(jnp.sum(arr)))

            log(f"{name} nchains={nc}: compiling...")
            # Warm up with the SAME static nrows as the timed calls — a
            # different scan length would recompile inside the timed window.
            t0 = time.time()
            state, out = run_block(state, iters // 2)
            sync(out.lnlike)
            compile_s = time.time() - t0
            t0 = time.time()
            state, out = run_block(state, iters // 2)
            sync(out.lnlike)
            state, out = run_block(state, iters // 2)
            sync(out.lnlike)
            dt = time.time() - t0
            per_iter_us = dt / iters * 1e6
            r = dict(
                branch=name, nchains=nc, per_iter_us=per_iter_us,
                iters_per_sec=iters / dt, compile_s=compile_s,
                chain_iters_per_sec=iters / dt * nc * ntemps,
                platform=jax.devices()[0].platform,
                device_kind=jax.devices()[0].device_kind,
            )
            results.append(r)
            print(json.dumps(r), flush=True)
    return results


if __name__ == "__main__":
    run()
