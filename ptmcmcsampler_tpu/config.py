"""Static sampler configuration.

Everything in here is trace-time constant: shapes, cadences, the jump cycle
layout, and parameter-group structure. The dynamic quantities (positions,
covariance, step sizes, counters) live in :mod:`ptmcmcsampler_tpu.state`.

Reference default-parity notes:
  * ``sample()`` defaults in the reference are SCAM/AM/DE/NUTS/MALA/HMC = 20
    each, burn=10000, thin=10, Tskip=100, isave=1000, covUpdate=1000
    (PTMCMCSampler.py:374-398). ``initialize()`` has different defaults but
    ``sample`` always forwards explicitly (:446-469), so the ``sample``
    defaults are the effective ones.
  * MALA is registered but known-broken in the reference (warning at
    PTMCMCSampler.py:230-231); we implement it faithfully-in-behavior but it
    also defaults to weight 0 wherever the reference examples do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np

# Jump kinds implemented natively by the framework.
KIND_SCAM = "scam"
KIND_AM = "am"
KIND_DE = "de"
KIND_MALA = "mala"
KIND_HMC = "hmc"
KIND_NUTS = "nuts"
KIND_CHEES = "chees"
KIND_CUSTOM = "custom"
KIND_PRIOR = "prior_draw"

GRADIENT_KINDS = (KIND_MALA, KIND_HMC, KIND_NUTS, KIND_CHEES)


@dataclasses.dataclass(frozen=True)
class JumpSpec:
    """One entry of the weighted proposal cycle.

    Mirrors ``addProposalToCycle`` (PTMCMCSampler.py:988-1014): a proposal with
    weight ``w`` is drawn with probability ``w / sum(weights)`` among the
    active proposals. ``activate_after`` delays activation until a given
    iteration — the DE jump enters the cycle only after burn-in
    (PTMCMCSampler.py:579-585).
    """

    name: str
    kind: str
    weight: float
    activate_after: int = 0
    # Kind-specific static parameters:
    params: Tuple[Tuple[str, Any], ...] = ()
    # For custom jumps: the user callable and its calling protocol.
    fn: Optional[Callable] = None
    protocol: str = "jax"  # "jax" (key, x, iter, beta) or "legacy" (x, iter, beta)

    def param(self, name, default=None):
        for k, v in self.params:
            if k == name:
                return v
        return default


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Trace-time constants for one compiled sampler program."""

    ndim: int
    ntemps: int
    nchains: int
    groups: Tuple[Tuple[int, ...], ...]  # parameter groups (PTMCMCSampler.py:129-131)
    jumps: Tuple[JumpSpec, ...]
    aux_jumps: Tuple[JumpSpec, ...] = ()

    # Cadences (reference names kept).
    tskip: int = 100  # iterations between swap sweeps (PTMCMCSampler.py:624)
    cov_update: int = 1000  # iterations between covariance refreshes (:545)
    burn: int = 10000  # DE activation + NUTS dual-averaging window (:579, nutsjump.py:809)
    thin: int = 10
    de_size: int = 10000  # DE history ring-buffer rows (reference: burn, :221)

    # Behavior switches (extensions beyond the reference).
    jump_select: str = "shared"  # "shared": one kind/iteration; "per_chain"
    # per_chain implementation: "auto" uses the rotation scheme (random
    # rotation into a static weight-proportional slot layout; every branch
    # runs once on a contiguous chain slice) for nchains >= 128 and the
    # stacked evaluate-all-branches fallback below that; "rotation"/"stacked"
    # force one. Rotation quantizes weights to the nearest 1/nchains.
    per_chain_mode: str = "auto"
    # DE pair selection: "blocked" (default; independent ordered-distinct
    # pairs per de_block-chain group — per-chain marginal law identical to
    # the reference, gather cost /de_block), "iid" (reference-literal
    # independent pairs per chain), or "rolled" (fully shared shifts:
    # gather-free but synchronizes mode jumps across chains on multimodal
    # targets — see proposals/de.py warning).
    de_pair: str = "blocked"
    de_block: int = 8  # chains per shared DE pair in "blocked" mode
    swap_mode: str = "sweep"  # "sweep" (reference parity) or "deo" (even/odd)
    adapt_from: str = "cold"  # covariance data source: "cold" chain or "all"
    # Adaptive temperature-ladder geometry (Vousden+ 2016; beyond-reference,
    # BASELINE.json config 5). Updates during burn-in only; endpoints fixed.
    adapt_ladder: bool = False
    ladder_adapt_lag: float = 10000.0
    ladder_adapt_time: float = 100.0
    ladder_adapt_skip_top: bool = False  # True when the top rung is beta=0 (hot chain)
    dtype: Any = np.float32

    # Gradient-jump statics.
    hmc_stepsize: float = 0.1
    hmc_nminsteps: int = 2
    hmc_nmaxsteps: int = 300
    nuts_delta: float = 0.6  # dual-averaging target (nutsjump.py:410)
    nuts_max_depth: int = 10
    nuts_force_epsilon: Optional[float] = None
    nuts_force_trajlen: Optional[int] = None
    nuts_trajectory: bool = False  # capture (T0, C0) trajectories (nutsjump.py:818-835)
    # ChEES-HMC statics (beyond-reference vmap-friendly gradient mode).
    chees_max_steps: int = 256
    chees_delta: float = 0.651
    chees_lr: float = 0.025
    mass_adapt: bool = False  # reference keeps the initial mass matrix (nutsjump.py:210-215)

    def __post_init__(self):
        assert self.ndim >= 1 and self.ntemps >= 1 and self.nchains >= 1
        seen = set()
        for g in self.groups:
            for i in g:
                assert 0 <= i < self.ndim, f"group index {i} out of range"
            seen.update(g)
        if not self.jumps:
            raise ValueError("No jump proposals specified!")  # PTMCMCSampler.py:267-268
        if self.jump_select not in ("shared", "per_chain"):
            raise ValueError(f"unknown jump_select {self.jump_select!r}")
        if self.swap_mode not in ("sweep", "deo"):
            raise ValueError(f"unknown swap_mode {self.swap_mode!r}")
        if self.de_pair not in ("blocked", "rolled", "iid"):
            raise ValueError(f"unknown de_pair {self.de_pair!r}")
        if self.de_block < 1:
            raise ValueError("de_block must be >= 1")
        if self.per_chain_mode not in ("auto", "rotation", "stacked"):
            raise ValueError(f"unknown per_chain_mode {self.per_chain_mode!r}")
        if self.jump_select == "per_chain":
            for j in self.jumps:
                if j.protocol == "legacy":
                    # The stacked fallback evaluates EVERY branch each
                    # iteration; a host-callback branch would do
                    # ntemps*nchains host round-trips per iteration.
                    raise ValueError(
                        f"per_chain jump selection cannot include the "
                        f"host-callback (numpy) jump {j.name!r}; pass a "
                        f"JAX-traceable jump or use jump_select='shared'"
                    )
            if self.nuts_trajectory:
                raise ValueError(
                    "NUTS trajectory capture requires jump_select='shared'"
                )

    @property
    def njumps(self):
        return len(self.jumps)

    @property
    def has_gradient_jumps(self):
        return any(j.kind in GRADIENT_KINDS for j in self.jumps)

    def jump_names(self):
        return tuple(j.name for j in self.jumps)

    def weights_and_activation(self):
        """(weights[J], activate_after[J]) as numpy arrays."""
        w = np.array([j.weight for j in self.jumps], dtype=np.float32)
        act = np.array([j.activate_after for j in self.jumps], dtype=np.int32)
        return w, act


def default_groups(ndim):
    return (tuple(range(ndim)),)


def build_default_jumps(
    SCAMweight=20,
    AMweight=20,
    DEweight=20,
    NUTSweight=0,
    MALAweight=0,
    HMCweight=0,
    CHEESweight=0,
    burn=10000,
    have_grads=False,
):
    """Reference-default jump cycle (PTMCMCSampler.py:226-264).

    Gradient jumps are only registered when gradient functions are available;
    zero-weight jumps are dropped (PTMCMCSampler.py:1001-1004). The DE jump is
    registered up-front but activates after ``burn`` (:579-585).
    """
    jumps = []
    if have_grads:
        if MALAweight:
            jumps.append(JumpSpec("MALAJump", KIND_MALA, MALAweight))
        if HMCweight:
            jumps.append(JumpSpec("HMCJump", KIND_HMC, HMCweight))
        if NUTSweight:
            jumps.append(JumpSpec("NUTSJUMP", KIND_NUTS, NUTSweight))
        if CHEESweight:
            jumps.append(JumpSpec("ChEESHMCJump", KIND_CHEES, CHEESweight))
    if SCAMweight:
        jumps.append(JumpSpec("covarianceJumpProposalSCAM", KIND_SCAM, SCAMweight))
    if AMweight:
        jumps.append(JumpSpec("covarianceJumpProposalAM", KIND_AM, AMweight))
    if DEweight:
        jumps.append(JumpSpec("DEJump", KIND_DE, DEweight, activate_after=burn))
    return tuple(jumps)
