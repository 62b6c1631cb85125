#!/usr/bin/env python
"""Run PTSampler's main path once on a GPU and check what comes out.

    python chip_smoke.py               # one GPU: phases 0-4 below
    python chip_smoke.py --four-cards  # four GPUs of one host: the sharded
                                       # headline run and its one-card twin

Phases on one GPU, each printing one line (what ran, wall seconds, checks):

0. device: a GPU or exit, the card's name and power limit, the native
   chain-row formatter built from ``csrc/chainio.cpp``;
1. the headline deployment through ``PTSampler.sample``: curved likelihood,
   [8 temperatures x 16384 chains], the bench's ChEES cycle, chain files,
   the posterior-moment gate and split-R-hat, then ``resume=True`` with a
   profiler trace that must hold device events;
2. the default ``sample()`` cycle with gradients (SCAM/AM/DE/NUTS/MALA/HMC)
   on the 50-D hierarchical Gaussian at [8 x 1024], moment-gated, and the
   NUTS-parity cycle (curved, [8 x 4096], tree depth 10), timed;
3. a numpy likelihood and prior through the host-callback path;
4. the float32 contractions pinned to full precision, against float64 numpy
   at D = 50 and D = 200.

Any failed check or exception exits nonzero before the last line, which is
exactly ``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import glob
import json
import os
import subprocess
import tempfile
import time

import numpy as np


def say(phase, seconds, **checks):
    fields = " ".join(f"{k}={v}" for k, v in checks.items())
    print(f"[{phase}] {seconds:.2f}s {fields}", flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def gpu_devices(count):
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu", f"no GPU: JAX found {devs[0].platform!r} devices")
    check(len(devs) >= count, f"need {count} GPUs, JAX found {len(devs)}")
    return devs


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out


def curved_sampler(out_dir, nchains, seed, resume=False, **kw):
    from ptmcmcsampler_tpu import PTSampler
    from ptmcmcsampler_tpu.models import CurvedLikelihood

    model = CurvedLikelihood()
    s = PTSampler(
        2, model.lnlikefn, model.lnpriorfn, np.eye(2),
        logl_grad=model.lnlikefn_grad, logp_grad=model.lnpriorfn_grad,
        outDir=out_dir, ntemps=8, nchains=nchains, seed=seed, resume=resume,
        rng_impl="rbg", verbose=False, **kw,
    )
    return model, s


# The bench's headline cycle (bench.py, grad_mode=chees).
CHEES_CYCLE = dict(
    Tskip=5, covUpdate=1000, SCAMweight=10, AMweight=10, DEweight=10,
    CHEESweight=20, NUTSweight=0, MALAweight=0, HMCweight=0,
    HMCstepsize=0.08, HMCsteps=50,
)
HEADLINE = dict(nchains=16384, niter=6000, burn=2000, thin=5, isave=1000, resume_extra=1000)
GRADIENTS = dict(nchains=1024, niter=3000, burn=1000, thin=5, isave=500)
NUTS_PARITY = dict(nchains=4096, niter=1000, burn=500, isave=200)
NUMPY = dict(nchains=8, niter=400, burn=100)


def gate(model, s, burn, thin):
    """Moment gate + split-R-hat over the post-burn rows of every cold chain."""
    from ptmcmcsampler_tpu.diagnostics import moment_gate, multichain_ess, split_rhat

    chains = s.chains[:, burn // thin + 1 - s.chains_row0:]  # [C, rows, D]
    ess = multichain_ess(chains)
    ok, max_z = moment_gate(chains, ess, model.posterior_moments()[0])
    rhat = float(np.nanmax(split_rhat(chains)))
    return ok, max_z, rhat, float(np.min(ess))


def seconds_per_iter(s, rows):
    """Time one more block of the sampler's compiled program (no compile)."""
    import jax

    t0 = time.time()
    state, out = s._run_block(s.state, rows)
    jax.block_until_ready((state, out))
    return (time.time() - t0) / (rows * s.config.thin)


def phase_device():
    import jax

    from ptmcmcsampler_tpu.io import build_native, native

    t0 = time.time()
    devs = gpu_devices(1)
    print(card_line(), flush=True)
    built = build_native.build(verbose=False) is not None
    loaded = native._load() is not None
    check(built and loaded, "native chain-row formatter did not build or load")
    say("0 device", time.time() - t0, platform=devs[0].platform,
        kind=repr(devs[0].device_kind), count=len(jax.devices()),
        chainio_built=built, chainio_loaded=loaded)


def phase_headline(tmp):
    import jax
    from jax.profiler import ProfileData

    h = HEADLINE
    out_dir = os.path.join(tmp, "headline")
    t0 = time.time()
    model, s = curved_sampler(out_dir, h["nchains"], seed=11)
    s.sample(np.array([-0.1, -0.5]), h["niter"], burn=h["burn"], thin=h["thin"],
             isave=h["isave"], **CHEES_CYCLE)
    wall = time.time() - t0
    rows = 1 + h["niter"] // h["thin"]
    data = np.loadtxt(os.path.join(out_dir, "chain_1.0.txt"))
    check(data.shape == (rows, 2 + 4), f"chain_1.0.txt shape {data.shape}")
    check(np.isfinite(data).all(), "chain_1.0.txt holds NaN or inf")
    check(s.chains.shape == (h["nchains"], rows, 2), f"s.chains shape {s.chains.shape}")
    ok, max_z, rhat, ess_min = gate(model, s, h["burn"], h["thin"])
    check(ok, f"headline moment gate (max z {max_z})")
    check(rhat < 1.01, f"headline split-R-hat {rhat}")
    sec_it = seconds_per_iter(s, h["isave"] // h["thin"])
    say(f"1 headline curved ChEES [8x{h['nchains']}] sample()", wall, iters=h["niter"],
        rows=rows, moments_ok=ok, moments_max_z=max_z, rhat_max=rhat,
        ess_min=ess_min, s_per_iter=sec_it)

    # Re-enter with resume=True under the profiler: rows must continue.
    prof = os.path.join(tmp, "profile")
    t0 = time.time()
    _, s2 = curved_sampler(out_dir, h["nchains"], seed=11, resume=True)
    total = h["niter"] + h["resume_extra"]
    s2.sample(np.array([-0.1, -0.5]), total, burn=h["burn"], thin=h["thin"],
              isave=h["isave"], profile_dir=prof, **CHEES_CYCLE)
    data = np.loadtxt(os.path.join(out_dir, "chain_1.0.txt"))
    check(data.shape[0] == 1 + total // h["thin"], f"resumed rows {data.shape[0]}")
    check(np.isfinite(data).all(), "resumed chain file holds NaN or inf")
    xplanes = glob.glob(os.path.join(prof, "**", "*.xplane.pb"), recursive=True)
    check(xplanes, "profile_dir holds no trace")
    pd = ProfileData.from_file(xplanes[0])
    dev_events = sum(
        1 for p in pd.planes if p.name.startswith("/device:GPU")
        for line in p.lines for _ in line.events
    )
    check(dev_events > 0, "trace holds no device events")
    say("1 resume + profile_dir", time.time() - t0, rows=data.shape[0],
        device_events=dev_events, jax=jax.__version__)


def phase_gradients(tmp):
    from ptmcmcsampler_tpu import PTSampler
    from ptmcmcsampler_tpu.models import HierarchicalGaussian

    model = HierarchicalGaussian()
    g = GRADIENTS
    niter, burn, thin = g["niter"], g["burn"], g["thin"]
    t0 = time.time()
    s = PTSampler(
        model.ndim, model.lnlikefn, model.lnpriorfn, np.eye(model.ndim) * 0.1,
        logl_grad=model.lnlikefn_grad, logp_grad=model.lnpriorfn_grad,
        outDir=os.path.join(tmp, "hier"), ntemps=8, nchains=g["nchains"], seed=3,
        verbose=False,
    )
    # sample()'s own defaults: SCAM/AM/DE/NUTS/MALA/HMC 20 each, NUTSmaxdepth=10.
    s.sample(np.zeros(model.ndim), niter, burn=burn, thin=thin, isave=g["isave"])
    wall = time.time() - t0
    names = set(s.config.jump_names())
    check({"NUTSJUMP", "MALAJump", "HMCJump"} <= names, f"cycle {sorted(names)}")
    ok, max_z, rhat, ess_min = gate(model, s, burn, thin)
    check(ok, f"hierarchical moment gate (max z {max_z})")
    sec_it = seconds_per_iter(s, g["isave"] // thin)
    say(f"2 default cycle hierarchical50 [8x{g['nchains']}] NUTS/MALA/HMC", wall, iters=niter,
        moments_ok=ok, moments_max_z=max_z, rhat_max=rhat, ess_min=ess_min,
        s_per_iter=sec_it)

    # The bench's NUTS-parity cycle (grad_mode=nuts), timed.
    t0 = time.time()
    n = NUTS_PARITY
    model, s = curved_sampler(os.path.join(tmp, "nuts"), n["nchains"], seed=5)
    s.sample(np.array([-0.1, -0.5]), n["niter"], burn=n["burn"], thin=1,
             isave=n["isave"], Tskip=5,
             covUpdate=1000, SCAMweight=10, AMweight=10, DEweight=10, NUTSweight=10,
             HMCweight=10, MALAweight=0, HMCstepsize=0.08, HMCsteps=50,
             NUTSmaxdepth=10)
    wall = time.time() - t0
    x = s.chains
    check(np.isfinite(x).all(), "NUTS-parity chains hold NaN or inf")
    sec_it = seconds_per_iter(s, n["isave"])
    say(f"2 NUTS-parity curved [8x{n['nchains']}] depth 10", wall, iters=n["niter"],
        s_per_iter=sec_it)


def phase_numpy(tmp):
    from ptmcmcsampler_tpu import PTSampler

    ndim = 20
    rng = np.random.default_rng(0)
    mu = rng.uniform(3.0, 7.0, ndim)
    a = rng.normal(size=(ndim, ndim)) / np.sqrt(ndim)
    cov = 0.09 * (a @ a.T + np.eye(ndim)) / 2.0
    icov = np.linalg.inv(cov)

    def lnlike(x):
        d = np.asarray(x) - mu
        return -0.5 * d @ icov @ d

    def lnprior(x):
        return 0.0 if np.all((np.asarray(x) >= 0) & (np.asarray(x) <= 10)) else -np.inf

    t0 = time.time()
    m = NUMPY
    s = PTSampler(ndim, lnlike, lnprior, cov, outDir=os.path.join(tmp, "numpy"),
                  ntemps=8, nchains=m["nchains"], seed=1, verbose=False)
    check(not s._logl_traceable and not s._logp_traceable, "numpy callables traced")
    niter = m["niter"]
    s.sample(mu, niter, burn=m["burn"], thin=1, isave=m["burn"], covUpdate=m["burn"],
             SCAMweight=20, AMweight=20, DEweight=20)
    rows = np.loadtxt(os.path.join(tmp, "numpy", "chain_1.0.txt"))
    check(rows.shape == (niter + 1, ndim + 4), f"numpy chain file {rows.shape}")
    post = s.chains[:, m["burn"] + 1:].reshape(-1, ndim)
    err = float(np.abs(post.mean(axis=0) - mu).max())
    sd = float(np.sqrt(np.diag(cov)).max())
    check(np.isfinite(post).all() and err < 2.0 * sd, f"numpy mean error {err}")
    say(f"3 numpy likelihood via pure_callback [8x{m['nchains']}]", time.time() - t0, iters=niter,
        max_mean_err=err, max_sd=sd)


def phase_precision():
    """Pinned contractions on the card against float64 numpy.

    One-hot picks and group selections must be bit-exact. Round trips and
    reductions must sit within ``2 * D * eps32`` of the magnitude bound
    ``|A| |B|`` of their operands, D being the contraction length: the
    classical float32 dot-product error bound with a factor two of headroom.
    A TF32 product (10 mantissa bits) misses it by far at these sizes.
    """
    import jax
    import jax.numpy as jnp

    from ptmcmcsampler_tpu.adaptation import welford_batch_update
    from ptmcmcsampler_tpu.config import JumpSpec, SamplerConfig
    from ptmcmcsampler_tpu.models import CorrelatedGaussian
    from ptmcmcsampler_tpu.proposals.am import eigen_pick, make_am
    from ptmcmcsampler_tpu.proposals.base import GroupEmbed, ProposalContext
    from ptmcmcsampler_tpu.proposals.gradient import make_whitened_funcs

    t0 = time.time()
    eps = float(np.finfo(np.float32).eps)
    worst, unpinned_exact = {}, {}
    for d in (50, 200):
        rng = np.random.default_rng(d)
        f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
        u32 = f32(np.linalg.qr(rng.normal(size=(d, d)))[0])
        s32 = f32(rng.uniform(0.1, 4.0, d))
        x32 = f32(rng.normal(size=d) * 3.0)
        u64, x64 = u32.astype(np.float64), x32.astype(np.float64)

        # Bit-exact picks.
        for ind in (0, d // 3, d - 1):
            sval, vec = jax.jit(eigen_pick)(u32, s32, ind)
            check(np.array_equal(np.asarray(vec), u32[:, ind]), f"eigen_pick column D={d}")
            check(np.asarray(sval) == np.sqrt(s32)[ind], f"eigen_pick value D={d}")
        # For the record, not a check: the same pick at default precision.
        oh = np.eye(d, dtype=np.float32)[d // 3]
        unpinned = np.asarray(jax.jit(jnp.dot)(u32, oh))
        unpinned_exact[d] = bool(np.array_equal(unpinned, u32[:, d // 3]))
        g = np.sort(rng.choice(d, d // 2, replace=False))
        emb = GroupEmbed(g, d, np.float32)
        step32 = f32(rng.normal(size=len(g)))
        take = np.asarray(jax.jit(emb.take)(x32))
        set_ = np.asarray(jax.jit(emb.set_at)(x32, step32))
        add = np.asarray(jax.jit(emb.add_at)(x32, step32))
        want_set, want_add = x32.copy(), x32.copy()
        want_set[g] = step32
        want_add[g] = x32[g] + step32
        check(np.array_equal(take, x32[g]), f"GroupEmbed.take D={d}")
        check(np.array_equal(set_, want_set), f"GroupEmbed.set_at D={d}")
        check(np.array_equal(add, want_add), f"GroupEmbed.add_at D={d}")

        def within(name, got, want, bound, n=d):
            """|got - want| <= 2 n eps32 |A||B| for a length-n contraction."""
            ratio = float(np.max(np.abs(np.asarray(got, np.float64) - want) / (2 * n * eps * bound)))
            worst[f"{name}{d}"] = ratio
            check(ratio <= 1.0, f"{name} D={d}: {ratio:.3g} of the float32 bound")

        # AM rotate-and-back, through the real AM proposal with zero
        # eigenvalues (its noise term vanishes, leaving U (U^T x)).
        cfg = SamplerConfig(ndim=d, ntemps=1, nchains=1, groups=(tuple(range(d)),),
                            jumps=(JumpSpec("AM", "am", 1),))
        ctx = ProposalContext(
            group_u=(jnp.asarray(u32),), group_s=(jnp.zeros(d, jnp.float32),),
            chol=jnp.eye(d), chol_inv=jnp.eye(d), de_buf=jnp.zeros((d, 2)),
            de_valid=jnp.asarray(0, jnp.int32),
        )
        q, _ = jax.jit(make_am(cfg))(jax.random.key(0), jnp.asarray(x32), 1.0, 1, ctx)
        within("am_round_trip", q, u64 @ (u64.T @ x64), np.abs(u64) @ (np.abs(u64.T) @ np.abs(x64)))

        # Whitening round trip through a random lower Cholesky factor.
        l64 = np.linalg.cholesky(np.cov(rng.normal(size=(d, 4 * d))))
        l32 = f32(l64)
        li32 = f32(np.linalg.inv(l32.astype(np.float64)))
        fwd, bwd, _ = make_whitened_funcs(lambda x, b: (0.0, x))
        wctx = ctx.replace(chol=jnp.asarray(l32), chol_inv=jnp.asarray(li32))
        qw = np.asarray(jax.jit(fwd)(wctx, jnp.asarray(x32)))
        xb = jax.jit(bwd)(wctx, jnp.asarray(qw))
        l_, li_ = l32.astype(np.float64), li32.astype(np.float64)
        within("whiten_forward", qw, li_.T @ x64, np.abs(li_.T) @ np.abs(x64))
        within("whiten_round_trip", xb, l_.T @ qw.astype(np.float64),
               np.abs(l_.T) @ np.abs(qw.astype(np.float64)))

        # Welford batch update: one batch of 1024 chain-minor samples.
        # The centering runs on the card too; the bound is taken over the
        # float64 centered batch, with the card's mean rounding inside it.
        xs32 = f32(rng.normal(size=(d, 1024)) + 2.0)
        c64 = xs32.astype(np.float64) - xs32.astype(np.float64).mean(axis=1)[:, None]
        got = jax.jit(welford_batch_update)(_welford_state(d), jnp.asarray(xs32))
        within("welford_m2", got.m2, c64 @ c64.T, np.abs(c64) @ np.abs(c64.T), n=1024)

        # Model likelihood: the 20-D example's Gaussian at D.
        model = CorrelatedGaussian(ndim=d, seed=d)
        xm32 = f32(model.mu + rng.normal(size=d) * 0.1)
        got = float(jax.jit(model.lnlikefn)(jnp.asarray(xm32)))
        dm = xm32.astype(np.float64) - f32(model.mu).astype(np.float64)
        ic = f32(model.icov).astype(np.float64)
        within("lnlike", got, -0.5 * dm @ ic @ dm, 0.5 * np.abs(dm) @ (np.abs(ic) @ np.abs(dm)))
    say("4 precision D=50,200", time.time() - t0, picks="bit-exact",
        worst_fraction_of_bound=json.dumps(worst, separators=(",", ":")),
        unpinned_pick_exact=json.dumps(unpinned_exact, separators=(",", ":")))


def _welford_state(d):
    """A fresh adaptation state of width ``d`` (mean/M2 zero, count zero)."""
    import jax

    from ptmcmcsampler_tpu.config import JumpSpec, SamplerConfig
    from ptmcmcsampler_tpu.state import init_state

    cfg = SamplerConfig(ndim=d, ntemps=1, nchains=2, groups=(tuple(range(d)),),
                        jumps=(JumpSpec("AM", "am", 1),), de_size=4)
    st = init_state(cfg, jax.random.key(0), np.zeros(d), np.eye(d), np.ones(1),
                    np.zeros((1, 2)), np.zeros((1, 2)))
    return st.adapt


def four_cards(tmp):
    """The headline deployment on a 4-GPU temperature-sharded mesh against the
    same seed on one GPU (DEO swaps on both)."""
    import jax

    from ptmcmcsampler_tpu.parallel import make_temp_mesh

    devs = gpu_devices(4)
    print(card_line(), flush=True)
    h = HEADLINE
    runs = {}
    for name, kw in (("four", {}), ("one", dict(mesh=make_temp_mesh(1), swap_mode="deo"))):
        t0 = time.time()
        model, s = curved_sampler(os.path.join(tmp, name), h["nchains"], seed=11, **kw)
        s.sample(np.array([-0.1, -0.5]), h["niter"], burn=h["burn"], thin=h["thin"],
                 isave=h["isave"], **CHEES_CYCLE)
        wall = time.time() - t0
        ok, max_z, rhat, ess_min = gate(model, s, h["burn"], h["thin"])
        check(ok, f"{name}-card moment gate (max z {max_z})")
        shards = [(sh.device.id, sh.data.shape) for sh in s.state.x.addressable_shards]
        runs[name] = (s, shards)
        say(f"4cards {name}", wall, swap_mode=s.config.swap_mode, moments_ok=ok,
            moments_max_z=max_z, rhat_max=rhat, ess_min=ess_min,
            s_per_iter=seconds_per_iter(s, h["isave"] // h["thin"]),
            shards=json.dumps(shards, separators=(",", ":")))

    s4, shards = runs["four"]
    check(s4.config.swap_mode == "deo", "sharded run did not auto-select DEO")
    check(len({d for d, _ in shards}) == 4, f"state.x shards {shards}")
    check(all(shp == (2, 2, h["nchains"]) for _, shp in shards), f"shard shapes {shards}")
    hlo = s4._run_block.lower(s4.state, h["isave"] // h["thin"]).compile().as_text()
    permutes = hlo.count("collective-permute-start") or hlo.count("collective-permute(")
    gathers = [ln.strip()[:160] for ln in hlo.splitlines()
               if "all-gather" in ln and "=" in ln and f",{h['nchains']}]" in ln]
    check(permutes > 0, "compiled step has no collective-permute")
    check(not gathers, f"all-gather of positions in the compiled step: {gathers[:3]}")

    s1 = runs["one"][0]
    c4, c1 = s4.chains, s1.chains
    same = c4.shape == c1.shape and np.array_equal(c4, c1)
    diverge, first_diff = "none", 0.0
    if not same:
        diff_rows = np.nonzero(np.any(c4 != c1, axis=(0, 2)))[0]
        diverge = int(diff_rows[0])
        first_diff = float(np.abs(c4[:, diverge] - c1[:, diverge]).max())
    say("4cards compare", 0.0, cold_chains_bit_identical=same,
        first_differing_row=diverge, max_abs_diff_there=first_diff,
        collective_permutes=permutes,
        position_all_gathers=len(gathers), devices=len(devs))
    return len(jax.devices())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU sharded path and its one-GPU twin")
    args = ap.parse_args()

    import jax

    gpu_devices(4 if args.four_cards else 1)  # before anything touches the repo

    from ptmcmcsampler_tpu.utils import enable_compile_cache

    enable_compile_cache()
    with tempfile.TemporaryDirectory() as tmp:
        if args.four_cards:
            count = four_cards(tmp)
        else:
            phase_device()
            phase_headline(tmp)
            phase_gradients(tmp)
            phase_numpy(tmp)
            phase_precision()
            count = len(jax.devices())
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind, "count": count}}))


if __name__ == "__main__":
    main()
