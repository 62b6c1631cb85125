#!/usr/bin/env python
"""Statistical parity check: sample the same posteriors with BOTH the
reference PTMCMCSampler (imported from the checkout named by the
PTMCMC_REFERENCE environment variable, not copied) and this framework, and
compare cold-chain posterior moments.

Trajectory-level comparison is impossible (different RNGs by construction,
SURVEY.md §7 "hard parts"), so parity is defined distributionally: means,
variances, and covariances of the cold chain must agree within Monte-Carlo
error. Writes chiprun_out/parity_measured.json with three records:

  * curved_cheap — the curved/banana posterior, AM/SCAM/DE cycle on both
    sides (reference examples/curved_likelihood.ipynb cell 1);
  * curved_chees — the SAME reference run vs this framework's ChEES-HMC
    gradient cycle (the bench.py configuration), validating that the
    beyond-reference gradient mode targets the identical posterior;
  * gaussian40 — the 40-D interval-transformed Gaussian of the reference's
    gaussian_likelihood.ipynb / tests/test_nuts.py, gradient jumps on both
    sides (reference NUTS+HMC vs framework NUTS).

Usage: PTMCMC_REFERENCE=<reference checkout> \
       python tools/compare_reference.py [niter_ref] [niter_jax]
"""

import json
import os
import sys
import time
import types

import numpy as np

sys.path.insert(0, os.environ["PTMCMC_REFERENCE"])
_v = types.ModuleType("PTMCMCSampler.version")
_v.version = "0.0.0-local"
sys.modules["PTMCMCSampler.version"] = _v
from PTMCMCSampler import PTMCMCSampler as RefSampler  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _log(m):
    print(f"[parity {time.strftime('%H:%M:%S')}] {m}", file=sys.stderr, flush=True)


# --------------------------------------------------------------- reference


def ref_curved(niter=200000, outdir="/tmp/ref_parity_curved"):
    """Reference sampler (AM/SCAM/DE cycle) on the curved target."""
    pmin = np.array([-10.0, -10.0])
    pmax = np.array([10.0, 10.0])

    def lnlike(x):
        ll = np.exp(-x[0] ** 2 - (9 + 4 * x[0] ** 2 + 9 * x[1]) ** 2) + 0.5 * np.exp(
            -8 * x[0] ** 2 - 8 * (x[1] - 2) ** 2
        )
        with np.errstate(divide="ignore"):
            return np.log(ll)

    def lnprior(x):
        if np.all(pmin < x) and np.all(x < pmax):
            return 0.0
        return -np.inf

    s = RefSampler.PTSampler(
        2, lnlike, lnprior, np.eye(2) * 0.1**2,
        outDir=outdir, verbose=False,
    )
    t0 = time.time()
    s.sample(
        np.array([-0.1, -0.5]), niter, burn=10000, thin=1, covUpdate=500,
        SCAMweight=20, AMweight=20, DEweight=20, NUTSweight=0, HMCweight=0,
        MALAweight=0,
    )
    dt = time.time() - t0
    chain = np.loadtxt(os.path.join(outdir, "chain_1.txt"))
    x = chain[niter // 5 :, :2]
    return x, dt


def _interval_gauss_np(ndim=40, pmin=0.0, pmax=10.0):
    """Numpy (reference-callable) version of the interval-transformed
    standard normal (reference tests/test_nuts.py:50-162 semantics)."""
    a = np.full(ndim, float(pmin))
    b = np.full(ndim, float(pmax))

    def backward(p):
        s = 1.0 / (1.0 + np.exp(-p))
        return (b - a) * s + a

    def lnlike(p):
        x = backward(p)
        lj = np.sum(np.log(b - a) + p - 2.0 * np.log1p(np.exp(p)))
        return float(-0.5 * np.sum(x**2) - ndim * 0.5 * np.log(2 * np.pi) + lj)

    def lnlike_grad(p):
        s = 1.0 / (1.0 + np.exp(-p))
        x = (b - a) * s + a
        dxdp = (b - a) * s * (1.0 - s)
        g = -x * dxdp + 1.0 - 2.0 * s
        return lnlike(p), g

    def lnprior(p):
        return 0.0

    def lnprior_grad(p):
        return 0.0, np.zeros(ndim)

    return lnlike, lnlike_grad, lnprior, lnprior_grad


def ref_gaussian40(niter=30000, outdir="/tmp/ref_parity_gauss40"):
    """Reference sampler with gradient jumps (NUTS/HMC + cheap cycle) on the
    40-D interval-transformed Gaussian (gaussian_likelihood.ipynb cell 8)."""
    ndim = 40
    lnlike, lnlike_grad, lnprior, lnprior_grad = _interval_gauss_np(ndim)
    p0 = np.full(ndim, -2.0)
    s = RefSampler.PTSampler(
        ndim, lnlike, lnprior, np.eye(ndim) * 0.1,
        logl_grad=lnlike_grad, logp_grad=lnprior_grad,
        outDir=outdir, verbose=False,
    )
    t0 = time.time()
    s.sample(
        p0, niter, burn=3000, thin=1, covUpdate=1000,
        SCAMweight=10, AMweight=10, DEweight=10, NUTSweight=10, HMCweight=10,
        MALAweight=0,
    )
    dt = time.time() - t0
    chain = np.loadtxt(os.path.join(outdir, "chain_1.txt"))
    x = chain[niter // 5 :, :ndim]
    return x, dt


# --------------------------------------------------------------- framework


def jax_curved(niter=20000, nchains=512, chees=False, outdir=None):
    import jax

    from ptmcmcsampler_tpu import PTSampler
    from ptmcmcsampler_tpu.models import CurvedLikelihood

    outdir = outdir or f"/tmp/jax_parity_curved{'_chees' if chees else ''}"
    cl = CurvedLikelihood()
    kw = {}
    if chees:
        kw = dict(logl_grad=cl.lnlikefn_grad, logp_grad=cl.lnpriorfn_grad)
    s = PTSampler(
        2, cl.lnlikefn, cl.lnpriorfn, np.eye(2) * 0.1**2,
        outDir=outdir, verbose=False, ntemps=4, nchains=nchains, seed=1234, **kw,
    )
    t0 = time.time()
    s.sample(
        np.array([-0.1, -0.5]), niter, burn=niter // 5, thin=1, isave=niter,
        covUpdate=500, SCAMweight=20, AMweight=20, DEweight=20, NUTSweight=0,
        HMCweight=0, MALAweight=0, CHEESweight=(40 if chees else 0), Tskip=100,
        HMCstepsize=0.08,
    )
    dt = time.time() - t0
    # Pool the post-burn thinned history of ALL cold chains.
    x = s.chains[:, niter // 4 :, :].reshape(-1, 2)
    del jax
    return x, dt


def jax_gaussian40(niter=6000, nchains=64, outdir="/tmp/jax_parity_gauss40"):
    from ptmcmcsampler_tpu import PTSampler
    from ptmcmcsampler_tpu.models import IntervalTransformedGaussian

    ndim = 40
    m = IntervalTransformedGaussian(ndim=ndim)
    s = PTSampler(
        ndim, m.lnlikefn, m.lnpriorfn, np.eye(ndim) * 0.1,
        logl_grad=m.lnlikefn_grad, logp_grad=m.lnpriorfn_grad,
        outDir=outdir, verbose=False, ntemps=2, nchains=nchains, seed=77,
    )
    t0 = time.time()
    s.sample(
        np.full(ndim, -2.0), niter, burn=niter // 5, thin=1, isave=niter,
        covUpdate=1000, SCAMweight=10, AMweight=10, DEweight=10, NUTSweight=10,
        HMCweight=0, MALAweight=0, Tskip=100,
    )
    dt = time.time() - t0
    x = s.chains[:, niter // 4 :, :].reshape(-1, ndim)
    return x, dt


# ------------------------------------------------------------------ compare


def stats(x):
    return dict(
        mean=x.mean(axis=0).tolist(),
        var=x.var(axis=0).tolist(),
        cov01=float(np.cov(x.T)[0, 1]),
        n=int(len(x)),
    )


def compare(xr, xt, tau_ref):
    """Moment comparison with MC-error tolerances derived from the reference
    chain's integrated autocorrelation time."""
    sr, st = stats(xr), stats(xt)
    se = np.sqrt(np.array(sr["var"]) * tau_ref / len(xr))
    dmean = np.abs(np.array(sr["mean"]) - np.array(st["mean"]))
    scale = np.sqrt(np.array(sr["var"]))
    ok_mean = bool(np.all(dmean < 6 * se + 0.05 * np.maximum(scale, 1.0)))
    ok_var = bool(
        np.all(
            np.abs(np.array(sr["var"]) - np.array(st["var"]))
            < 0.35 * np.array(sr["var"]) + 0.02
        )
    )
    return dict(
        reference=sr,
        jax=st,
        mean_abs_diff=dmean.tolist(),
        mean_tolerance=(6 * se + 0.05 * np.maximum(scale, 1.0)).tolist(),
        ok_mean=ok_mean,
        ok_var=ok_var,
        ok=ok_mean and ok_var,
    )


def main():
    niter_ref = int(sys.argv[1]) if len(sys.argv) > 1 else 200000
    niter_jax = int(sys.argv[2]) if len(sys.argv) > 2 else 20000

    records = {}

    _log(f"reference curved x{niter_ref}...")
    xr, t_ref = ref_curved(niter_ref)
    _log(f"reference curved done in {t_ref:.1f}s; framework cheap cycle...")
    xt, t_jax = jax_curved(niter_jax)
    rec = compare(xr, xt, tau_ref=400.0)
    rec.update(ref_seconds=t_ref, jax_seconds=t_jax)
    records["curved_cheap"] = rec

    _log("framework ChEES cycle (bench configuration)...")
    xt2, t_jax2 = jax_curved(niter_jax, chees=True)
    rec2 = compare(xr, xt2, tau_ref=400.0)
    rec2.update(ref_seconds=t_ref, jax_seconds=t_jax2)
    records["curved_chees"] = rec2

    _log("reference gaussian40 (NUTS/HMC)...")
    xr3, t_ref3 = ref_gaussian40()
    _log(f"reference gaussian40 done in {t_ref3:.1f}s; framework NUTS...")
    xt3, t_jax3 = jax_gaussian40()
    rec3 = compare(xr3, xt3, tau_ref=30.0)
    rec3.update(ref_seconds=t_ref3, jax_seconds=t_jax3)
    records["gaussian40"] = rec3

    import jax

    dev = jax.devices()[0]
    out = dict(
        records=records,
        ok=all(r["ok"] for r in records.values()),
        measured=time.strftime("%Y-%m-%d"),
        platform=dev.platform,
        device_kind=dev.device_kind,
    )
    path = os.path.join(os.path.dirname(__file__), "..", "chiprun_out", "parity_measured.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
