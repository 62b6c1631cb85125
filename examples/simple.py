#!/usr/bin/env python
"""20-D correlated-Gaussian example — the reference's examples/simple.py
workload on this sampler, with a custom uniform jump.

Run: python examples/simple.py
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from ptmcmcsampler_tpu import PTSampler
from ptmcmcsampler_tpu.models import CorrelatedGaussian

ndim = 20
pmin, pmax = 0.0, 10.0
glo = CorrelatedGaussian(ndim=ndim, pmin=pmin, pmax=pmax)

p0 = np.random.default_rng(0).uniform(pmin, pmax, ndim)
cov = np.eye(ndim) * 0.1**2

sampler = PTSampler(
    ndim,
    glo.lnlikefn,
    glo.lnpriorfn,
    np.copy(cov),
    outDir=str(Path(__file__).parent / "chains"),
    ntemps=1,
    nchains=64,  # 64 chains per temperature in one program
    seed=0,
)


class UniformJump:
    """Custom jump, JAX-native protocol (key, x, iter, beta) -> (q, lqxy)."""

    def __init__(self, pmin, pmax):
        self.pmin, self.pmax = pmin, pmax

    def jump(self, key, x, it, beta):
        q = jax.random.uniform(key, x.shape, x.dtype, self.pmin, self.pmax)
        return q, jnp.zeros((), x.dtype)


sampler.addProposalToCycle(UniformJump(pmin, pmax).jump, 5, name="UniformJump")

sampler.sample(p0, 10000, burn=500, thin=1, covUpdate=500, SCAMweight=20, AMweight=20, DEweight=20)

chain = sampler.chain[1000:]
print("\nposterior mean error:", np.abs(chain.mean(axis=0) - glo.mu).max())
