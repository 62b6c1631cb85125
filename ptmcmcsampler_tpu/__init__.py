"""ptmcmcsampler_tpu — a parallel-tempering MCMC framework for accelerators.

Ground-up JAX/XLA re-design with the capabilities of nanograv/PTMCMCSampler:
the full adaptive jump zoo (SCAM/AM/DE/MALA/HMC/NUTS + custom/aux jumps),
parallel tempering with on-device replica exchange, covariance/step-size
adaptation, reference-compatible chain-file output and resume — expressed as
one scannable device program vmapped over chains and shardable over a
temperature mesh axis.
"""

from .config import JumpSpec, SamplerConfig, build_default_jumps  # noqa: F401
from .ladder import ladder_betas, temperature_ladder  # noqa: F401
from .sampler import PTSampler  # noqa: F401

__version__ = "0.1.0"
