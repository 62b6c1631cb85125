#!/usr/bin/env python
"""Dump the optimized HLO of the headline bench block so trace fusion names
can be mapped back to source ops. Run it on the machine whose compiler you
want to read (a GPU run compiles for the GPU).

Usage: python tools/dump_hlo.py [out=chiprun_out/headline_hlo.txt] [nchains=16384]
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def log(m):
    print(f"[hlo {time.strftime('%H:%M:%S')}] {m}", file=sys.stderr, flush=True)


def main():
    kwargs = {}
    for arg in sys.argv[1:]:
        if "=" in arg:
            k, v = arg.split("=", 1)
            kwargs[k] = v
    out = kwargs.get("out", "chiprun_out/headline_hlo.txt")
    nchains = int(kwargs.get("nchains", "16384"))
    iters = int(kwargs.get("iters", "1000"))

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ptmcmcsampler_tpu.config import SamplerConfig, build_default_jumps
    from ptmcmcsampler_tpu.kernel import build_step
    from ptmcmcsampler_tpu.ladder import ladder_betas, temperature_ladder
    from ptmcmcsampler_tpu.models import CurvedLikelihood
    from ptmcmcsampler_tpu.state import init_state
    from ptmcmcsampler_tpu.utils import enable_compile_cache

    enable_compile_cache()
    ntemps, burn_iters = 8, 3000
    model = CurvedLikelihood()
    x0 = np.array([-0.1, -0.5])

    def func_grad(x, beta):
        ll, gll = model.lnlikefn_grad(x)
        lp, glp = model.lnpriorfn_grad(x)
        return beta * ll + lp, beta * gll + glp

    cfg = SamplerConfig(
        ndim=2, ntemps=ntemps, nchains=nchains, groups=((0, 1),),
        jumps=build_default_jumps(
            SCAMweight=10, AMweight=10, DEweight=10, NUTSweight=0, HMCweight=0,
            CHEESweight=20, MALAweight=0, burn=burn_iters // 2, have_grads=True,
        ),
        tskip=5, cov_update=1000, burn=burn_iters // 2, thin=1,
        de_size=2000, hmc_stepsize=0.08, hmc_nmaxsteps=50, nuts_max_depth=10,
    )
    step, run_block = build_step(cfg, model.lnlikefn, model.lnpriorfn, func_grad)
    ladder = temperature_ladder(2, ntemps)
    _, betas = ladder_betas(ladder)
    xs = jnp.broadcast_to(jnp.asarray(x0, cfg.dtype), (ntemps, nchains, 2))
    ll0 = jax.vmap(jax.vmap(model.lnlikefn))(xs)
    lp0 = jax.vmap(jax.vmap(model.lnpriorfn))(xs)
    state = init_state(cfg, jax.random.key(7, impl="rbg"), x0, np.eye(2), betas, ll0, lp0)

    log("lower+compile...")
    t0 = time.time()
    compiled = run_block.lower(state, iters).compile()
    log(f"compiled in {time.time() - t0:.1f}s; writing text...")
    txt = compiled.as_text()
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        f.write(txt)
    log(f"wrote {len(txt) / 1e6:.1f} MB to {out}")


if __name__ == "__main__":
    main()
