"""The user-facing PTSampler driver.

API-compatible with the reference ``PTSampler`` (PTMCMCSampler.py:40-528):
same constructor and ``sample()`` keywords, same chain-file outputs, same
proposal-cycle semantics — but the whole [ntemps, nchains] replica system
advances inside one jitted ``lax.scan`` program per output block, and
multi-device runs shard the temperature axis of the same program over a
``jax.sharding.Mesh`` instead of MPI ranks.

Key differences from the reference (all capability supersets):
  * ``ntemps`` is an explicit argument (the reference derives one chain per
    MPI rank, PTMCMCSampler.py:96-97); ``comm`` is accepted and ignored.
  * ``nchains`` vmaps many independent chains per temperature (absent in the
    reference, the main throughput axis on the accelerator).
  * user logl/logp callables that are JAX-traceable run fused on device;
    plain-numpy callables still work through a host-callback fallback.
  * full-state checkpointing (adaptation, RNG, step sizes) in addition to the
    reference's chain-file resume.
"""

from __future__ import annotations

import inspect
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from . import diagnostics, utils
from .config import (
    KIND_CUSTOM,
    KIND_PRIOR,
    JumpSpec,
    SamplerConfig,
    build_default_jumps,
    default_groups,
)
from .io.chainfile import ChainWriter
from .io.checkpoint import load_checkpoint, save_checkpoint
from .kernel import build_step
from .ladder import ladder_betas, temperature_ladder
from .parallel.mesh import (
    host_local_block,
    make_temp_mesh,
    shard_state,
    shard_state_global,
)
from .state import init_state


def _wrap_scalar_fn(f, args, kwargs, ndim, dtype, out_shape=()):
    """Wrap a user log-density into a single-x JAX callable.

    Mirrors ``_function_wrapper`` (PTMCMCSampler.py:1072-1086) and adds the
    traceable/host-callback split: traceable functions compile into the device
    program; numpy functions round-trip through ``pure_callback``.
    """

    def call(x):
        return f(x, *args, **kwargs)

    try:
        jax.eval_shape(call, jax.ShapeDtypeStruct((ndim,), dtype))

        def traced(x):
            v = jnp.asarray(call(x), dtype)
            # No-op reshapes are elided: the wrapper adds no ops to a
            # callable that already returns the right shape.
            return v if v.shape == tuple(out_shape) else v.reshape(out_shape)

        return traced, True
    except Exception:
        def host(x):
            return np.asarray(call(np.asarray(x, np.float64)), np.float64).astype(dtype).reshape(out_shape)

        def cb(x):
            return jax.pure_callback(
                host, jax.ShapeDtypeStruct(out_shape, dtype), x, vmap_method="sequential"
            )

        return cb, False


def _wrap_grad_fn(f, args, kwargs, ndim, dtype):
    """Wrap a reference-style ``f(x) -> (value, grad)`` callable."""

    def call(x):
        return f(x, *args, **kwargs)

    try:
        jax.eval_shape(call, jax.ShapeDtypeStruct((ndim,), dtype))

        def traced(x):
            v, g = call(x)
            v = jnp.asarray(v, dtype)
            g = jnp.asarray(g, dtype)
            # No-op reshapes elided (see _wrap_scalar_fn).
            v = v if v.shape == () else v.reshape(())
            g = g if g.shape == (ndim,) else g.reshape((ndim,))
            return v, g

        return traced, True
    except Exception:
        def host(x):
            v, g = call(np.asarray(x, np.float64))
            return (
                np.asarray(v, np.float64).astype(dtype).reshape(()),
                np.asarray(g, np.float64).astype(dtype).reshape((ndim,)),
            )

        out_shapes = (
            jax.ShapeDtypeStruct((), dtype),
            jax.ShapeDtypeStruct((ndim,), dtype),
        )

        def cb(x):
            return jax.pure_callback(host, out_shapes, x, vmap_method="sequential")

        return cb, False


class PTSampler:
    """Parallel-Tempering MCMC sampler on an accelerator.

    Drop-in constructor signature for the reference (PTMCMCSampler.py:75-93)
    plus extensions (``ntemps``, ``nchains``, ``dtype``, ``jump_select``,
    ``per_chain_mode``, ``swap_mode``, ``adapt_from``, ``mesh``,
    ``rng_impl``, ``de_pair``, ``de_block``); see MIGRATION.md for the
    kwarg-by-kwarg map.
    """

    def __init__(
        self,
        ndim,
        logl,
        logp,
        cov,
        groups=None,
        loglargs=None,
        loglkwargs=None,
        logpargs=None,
        logpkwargs=None,
        logl_grad=None,
        logp_grad=None,
        comm=None,
        outDir="./chains",
        verbose=True,
        resume=False,
        seed=None,
        ntemps=1,
        nchains=1,
        dtype=np.float32,
        jump_select="shared",
        swap_mode=None,
        adapt_from="cold",
        mesh=None,
        temp_axis="temp",
        chain_axis="chain",
        rng_impl="threefry2x32",
        host_history_bytes=2 * 1024**3,
        de_pair="blocked",
        de_block=8,
        per_chain_mode="auto",
    ):
        del comm  # MPI compat shim: distribution is mesh-based here.
        self.ndim = int(ndim)
        self.ntemps = int(ntemps)
        self.nchains = int(nchains)
        self.dtype = np.dtype(dtype)
        self.outDir = outDir
        self.verbose = verbose
        self.resume = resume
        self.mesh = mesh
        self.temp_axis = temp_axis
        self.chain_axis = chain_axis
        self.jump_select = jump_select
        # DE pair selection ("blocked" | "iid" | "rolled") and the blocked
        # group width; per_chain rotation/stacked selection — see
        # config.SamplerConfig for the trade-offs.
        self.de_pair = de_pair
        self.de_block = int(de_block)
        self.per_chain_mode = per_chain_mode
        # None = auto: "deo" when the temperature axis ends up sharded over
        # >1 device (neighbor ppermute exchanges, no GSPMD gathers on the
        # swap path), "sweep" (reference-parity serial sweep) otherwise.
        # Resolved per-run in sample() once the mesh is known.
        self.swap_mode = swap_mode
        self.adapt_from = adapt_from

        self._logl_fn, self._logl_traceable = _wrap_scalar_fn(
            logl, loglargs or [], loglkwargs or {}, self.ndim, self.dtype
        )
        self._logp_fn, self._logp_traceable = _wrap_scalar_fn(
            logp, logpargs or [], logpkwargs or {}, self.ndim, self.dtype
        )
        if not self._logl_traceable:
            self._warn_host_callback("logl")
        if not self._logp_traceable:
            self._warn_host_callback("logp")
        if logl_grad is not None and logp_grad is not None:
            self._logl_grad_fn, gl_traceable = _wrap_grad_fn(
                logl_grad, loglargs or [], loglkwargs or {}, self.ndim, self.dtype
            )
            self._logp_grad_fn, gp_traceable = _wrap_grad_fn(
                logp_grad, logpargs or [], logpkwargs or {}, self.ndim, self.dtype
            )
            if not gl_traceable:
                self._warn_host_callback("logl_grad")
            if not gp_traceable:
                self._warn_host_callback("logp_grad")
        else:
            self._logl_grad_fn = None
            self._logp_grad_fn = None

        self.groups = (
            tuple(tuple(int(i) for i in g) for g in groups)
            if groups is not None
            else default_groups(self.ndim)
        )
        self.cov0 = np.array(cov, dtype=np.float64)

        if seed is None:
            seed = int(np.random.SeedSequence().generate_state(1)[0])
        # Typed key with a selectable PRNG: "threefry2x32" (JAX default,
        # reproducible under any sharding) or "rbg"/"unsafe_rbg" (XLA's
        # RngBitGenerator; its stream may depend on how the program is
        # partitioned).
        self._key = jax.random.key(seed, impl=rng_impl)

        self._custom_jumps = []
        self._aux_jumps = []
        self.state = None
        self.ladder = None
        self._chain_host = []  # cold chain 0 thinned history ([rows, D] blocks)
        # ALL cold chains ([rows, C, D] blocks) — a bounded in-RAM window of
        # the most recent thinned rows (the full history lives on disk in the
        # chain_all_<T>.bin sidecar). `_chains_host_row0` is the global
        # thinned-row index of the window's first retained row.
        self._chains_host = []
        self._chains_host_row0 = 0
        self._host_history_bytes = int(host_history_bytes)
        self._lnlike_host = []
        self._lnprob_host = []

        os.makedirs(self.outDir, exist_ok=True)

    # ---------------------------------------------------------------- jumps

    def _warn_host_callback(self, what):
        """One loud line when a user callable falls back to the sequential
        host callback — correct but a performance cliff: every iteration pays
        ntemps x nchains host round-trips (the whole point of the vmapped
        chain axis is lost). Verbose-gated like the reference's warnings."""
        if not self.verbose:
            return
        print(
            "WARNING: %s is not JAX-traceable; it will run through a "
            "sequential host callback - every iteration pays up to "
            "ntemps*nchains = %d host round-trips. Rewrite it with "
            "jax.numpy for compiled-speed sampling." % (what, self.ntemps * self.nchains)
        )

    def addProposalToCycle(self, func, weight, name=None):
        """Register a custom jump (reference PTMCMCSampler.py:988-1014).

        Supported protocols:
          * JAX-native: ``func(key, x, iter, beta) -> (q, log_qxy)``;
          * reference/legacy: ``func(x, iter, beta) -> (q, log_qxy)`` —
            traceable functions compile in; numpy ones run via host callback.
        """
        if weight == 0:
            return
        name = name or getattr(func, "__name__", f"custom{len(self._custom_jumps)}")
        nparams = None
        try:
            nparams = len(inspect.signature(func).parameters)
        except (TypeError, ValueError):
            pass
        if nparams is not None and nparams >= 4:
            spec = JumpSpec(name, KIND_CUSTOM, weight, fn=func, protocol="jax")
        else:
            traceable = True
            try:
                jax.eval_shape(
                    lambda x: func(x, 0, 1.0),
                    jax.ShapeDtypeStruct((self.ndim,), self.dtype),
                )
            except Exception:
                traceable = False
            if traceable:
                def adapted(key, x, it, beta, _f=func):
                    del key
                    return _f(x, it, beta)

                spec = JumpSpec(name, KIND_CUSTOM, weight, fn=adapted, protocol="jax")
            else:
                self._warn_host_callback("custom jump %r" % name)
                spec = JumpSpec(name, KIND_CUSTOM, weight, fn=func, protocol="legacy")
        self._custom_jumps.append(spec)

    def addPriorDrawToCycle(self, draw, weight, name="DrawFromPrior"):
        """Register a prior-draw (independence) jump: propose ``q ~ prior``.

        ``draw`` is either JAX-native ``draw(key) -> q[ndim]`` or a legacy
        numpy callable ``draw(rng) -> q[ndim]`` taking a numpy Generator.
        The Hastings correction ``logp(x) - logp(q)`` assumes ``draw``
        samples the density of the sampler's ``logp`` (up to a constant).
        BASELINE.json config 4; the reference has no built-in — users there
        hand-roll it as a custom jump.
        """
        if weight == 0:
            return
        is_jax = True
        try:
            jax.eval_shape(draw, jax.random.key(0))
        except Exception:
            is_jax = False
        if not is_jax:
            self._warn_host_callback("prior draw %r" % name)
        self._custom_jumps.append(
            JumpSpec(
                name, KIND_PRIOR, weight, fn=draw,
                protocol="jax" if is_jax else "legacy",
            )
        )

    def addAuxilaryJump(self, func, name=None):
        """Register an auxiliary jump applied after every proposal
        (reference PTMCMCSampler.py:1017-1028). Protocols:
          * JAX-native: ``func(key, x, q, iter, beta) -> (q, log_qxy)``;
          * legacy: ``func(x, q, iter, beta) -> (q, log_qxy)``.
        """
        name = name or getattr(func, "__name__", f"aux{len(self._aux_jumps)}")
        nparams = None
        try:
            nparams = len(inspect.signature(func).parameters)
        except (TypeError, ValueError):
            pass
        if nparams is not None and nparams >= 5:
            spec = JumpSpec(name, KIND_CUSTOM, 1, fn=func, protocol="jax")
        else:
            traceable = True
            try:
                jax.eval_shape(
                    lambda x: func(x, x, 0, 1.0),
                    jax.ShapeDtypeStruct((self.ndim,), self.dtype),
                )
            except Exception:
                traceable = False
            if traceable:
                def adapted(key, x, q, it, beta, _f=func):
                    del key
                    return _f(x, q, it, beta)

                spec = JumpSpec(name, KIND_CUSTOM, 1, fn=adapted, protocol="jax")
            else:
                self._warn_host_callback("auxiliary jump %r" % name)
                spec = JumpSpec(name, KIND_CUSTOM, 1, fn=func, protocol="legacy")
        self._aux_jumps.append(spec)

    def randomizeProposalCycle(self):  # noqa: N802 (reference casing)
        """Drop-in no-op (reference PTMCMCSampler.py:1031-1045): the
        reference shuffles ``propCycle`` into ``randomizedPropCycle`` but
        its ``_jump`` draws a uniform index into the *unshuffled* cycle
        (:1058-1059), so the shuffle is distributionally irrelevant. Here
        the weighted categorical draw in the compiled cycle plays that
        role directly (proposals/cycle.py)."""

    # --------------------------------------------------------------- sample

    def _build_config(
        self, weights, burn, tskip, cov_update, thin, hmc_kwargs,
        nuts_trajectory=False, ladder_kwargs=None, mass_adapt=False,
        nuts_max_depth=10,
    ):
        have_grads = self._logl_grad_fn is not None
        jumps = list(
            build_default_jumps(
                SCAMweight=weights["SCAM"],
                AMweight=weights["AM"],
                DEweight=weights["DE"],
                NUTSweight=weights["NUTS"] if have_grads else 0,
                MALAweight=weights["MALA"] if have_grads else 0,
                HMCweight=weights["HMC"] if have_grads else 0,
                CHEESweight=weights.get("CHEES", 0) if have_grads else 0,
                burn=burn,
                have_grads=have_grads,
            )
        )
        jumps.extend(self._custom_jumps)
        return SamplerConfig(
            ndim=self.ndim,
            ntemps=self.ntemps,
            nchains=self.nchains,
            groups=self.groups,
            jumps=tuple(jumps),
            aux_jumps=tuple(self._aux_jumps),
            tskip=tskip,
            cov_update=cov_update,
            burn=burn,
            thin=thin,
            de_size=max(burn, self.nchains),
            nuts_max_depth=nuts_max_depth,
            jump_select=self.jump_select,
            per_chain_mode=self.per_chain_mode,
            de_pair=self.de_pair,
            de_block=self.de_block,
            swap_mode=self._resolved_swap_mode(),
            adapt_from=self.adapt_from,
            dtype=self.dtype,
            hmc_stepsize=hmc_kwargs.get("stepsize", 0.1),
            hmc_nminsteps=hmc_kwargs.get("nminsteps", 2),
            hmc_nmaxsteps=hmc_kwargs.get("nmaxsteps", 300),
            nuts_trajectory=nuts_trajectory,
            mass_adapt=mass_adapt,
            **(ladder_kwargs or {}),
        )

    def _func_grad(self):
        if self._logl_grad_fn is None:
            return None
        llg, lpg = self._logl_grad_fn, self._logp_grad_fn

        def func_grad(x, beta):
            """Tempered log-density + gradient (nutsjump.py:71-76)."""
            ll, gll = llg(x)
            lp, glp = lpg(x)
            return beta * ll + lp, beta * gll + glp

        return func_grad

    def sample(
        self,
        p0,
        Niter,
        ladder=None,
        Tmin=1,
        Tmax=None,
        Tskip=100,
        isave=1000,
        covUpdate=1000,
        SCAMweight=20,
        AMweight=20,
        DEweight=20,
        NUTSweight=20,
        MALAweight=20,
        HMCweight=20,
        CHEESweight=0,
        burn=10000,
        HMCstepsize=0.1,
        HMCsteps=300,
        maxIter=None,
        thin=10,
        i0=0,
        neff=None,
        writeHotChains=False,
        hotChain=False,
        trajectoryDir=None,
        write_burnin=False,
        profile_dir=None,
        adaptLadder=False,
        ladderAdaptLag=10000.0,
        ladderAdaptTime=100.0,
        massAdapt=False,
        NUTSmaxdepth=10,
    ):
        """Run PTMCMC sampling (reference ``sample``, PTMCMCSampler.py:374-528)."""
        if (maxIter is not None or i0 != 0) and self.verbose:
            # In the reference these size per-rank in-memory histories
            # (PTMCMCSampler.py:205-212, :419-421); blocks here are drained
            # to disk every isave, so there is nothing for them to size.
            print(
                "NOTE: maxIter/i0 are accepted for signature parity but have "
                "no effect (history is block-drained; see MIGRATION.md)"
            )
        del maxIter, i0
        Niter = int(Niter)
        if isave % thin != 0:
            raise ValueError(
                "isave = %d is not a multiple of thin =  %d" % (isave, thin)
            )
        if Niter % thin != 0 and self.verbose:
            print(
                "Niter = %d is not a multiple of thin = %d.  The last %d samples will be lost"
                % (Niter, thin, Niter % thin)
            )

        # Temperature ladder (reference :699-720).
        if ladder is not None:
            ladder = np.asarray(ladder, dtype=np.float64)
            self.ntemps = len(ladder)
        else:
            ladder = temperature_ladder(self.ndim, self.ntemps, tmin=Tmin, tmax=Tmax)
        self.ladder, betas = ladder_betas(ladder, hot_chain=hotChain)

        weights = dict(
            SCAM=SCAMweight, AM=AMweight, DE=DEweight, NUTS=NUTSweight,
            MALA=MALAweight, HMC=HMCweight, CHEES=CHEESweight,
        )
        # Mesh first: swap_mode=None auto-selects DEO when the temperature
        # axis is sharded, so the default multi-device configuration rides the
        # ppermute swap path instead of the serial sweep's fori_loop +
        # take_along_axis, which GSPMD lowers to cross-device gathers every
        # tskip (the on-host analogue it replaces: gather -> rank-0 sweep ->
        # scatter, PTMCMCSampler.py:660-691).
        mesh = self._resolve_mesh()
        config = self._build_config(
            weights, burn, Tskip, covUpdate,
            thin, dict(stepsize=HMCstepsize, nminsteps=2, nmaxsteps=HMCsteps),
            nuts_trajectory=trajectoryDir is not None,
            # massAdapt=True refreshes the gradient jumps' whitening
            # (mass-matrix) Cholesky from the adapted covariance at every
            # covUpdate — the working version of the reference's dormant
            # ``update_cf`` (nutsjump.py:56-69, calls commented out at
            # :210-215, :261-265, :684-688).
            mass_adapt=bool(massAdapt),
            # Tree-depth cap (the reference's doubling loop is unbounded,
            # nutsjump.py:716; a cap is required for compiled control flow).
            nuts_max_depth=int(NUTSmaxdepth),
            ladder_kwargs=dict(
                adapt_ladder=bool(adaptLadder),
                ladder_adapt_lag=float(ladderAdaptLag),
                ladder_adapt_time=float(ladderAdaptTime),
                ladder_adapt_skip_top=bool(hotChain),
            ),
        )
        if trajectoryDir is not None:
            from .trajectory import TrajectoryWriter

            self._traj_writer = TrajectoryWriter(trajectoryDir, burn, write_burnin)
        else:
            self._traj_writer = None
        self.config = config
        if MALAweight and self._logl_grad_fn is not None and self.verbose:
            # The reference warns "MALA jumps are not working properly yet"
            # (:230-231) because its qxy misses the Gaussian normalization;
            # this implementation uses the corrected density ratio
            # (tests/test_gradient_jumps.py proves N(0,1) stationarity).
            print("NOTE: using corrected MALA density ratio "
                  "(reference MALA is known-broken)")

        step, run_block = build_step(
            config, self._logl_fn, self._logp_fn, self._func_grad(),
            mesh=mesh, temp_axis=self.temp_axis,
        )
        self._step_fn = step
        self._run_block = run_block

        # Initial state.
        p0 = np.asarray(p0, dtype=np.float64)
        x0 = np.broadcast_to(p0, (self.ntemps, self.nchains, self.ndim))
        eval_init = jax.jit(
            lambda xs: (
                jax.vmap(jax.vmap(self._logl_fn))(xs),
                jax.vmap(jax.vmap(self._logp_fn))(xs),
            )
        )
        lp_arr = None

        self._key, init_key = jax.random.split(self._key)
        # Multi-process run (the reference's ``mpirun -np N`` launch model,
        # README.md:40-46): every process executes this same driver; file
        # creation/truncation happens on process 0 only (shared outDir, like
        # the reference's rank-0-managed files), then all processes sync
        # before appending to the files whose (temperature, chain-0) block
        # they own.
        self._multi = jax.process_count() > 1
        # Whether THIS process has drained (temp 0, chain 0) history; set on
        # first multi-process drain, gates the neff vote (see _neff_value).
        self._owns_cold = not self._multi
        pid = jax.process_index()
        if self._multi and self._traj_writer is not None:
            # _drain_block_multi has no trajectory handling; failing loudly
            # beats a silently empty trajectoryDir after a long multi-process run.
            raise NotImplementedError(
                "trajectoryDir capture is not supported in multi-process "
                "runs; capture trajectories in a single-process run"
            )
        writer = ChainWriter(
            self.outDir, self.ladder, hot_chain=hotChain,
            write_hot_chains=writeHotChains,
            resume=self.resume or (self._multi and pid != 0),
        )
        writer.init_jump_files(
            config.jump_names(), resume=self.resume or (self._multi and pid != 0)
        )
        if self._multi:
            from jax.experimental import multihost_utils

            multihost_utils.sync_global_devices("ptmcmc-writer-init")
        self._writer = writer
        self._sidecar_reset = set()

        ckpt_path = os.path.join(self.outDir, "checkpoint.npz")
        start_iter = 0
        state = None
        # Drains completed so far (one <name>_jump.txt entry is appended per
        # drain); persisted in the checkpoint meta so torn-run resume can
        # truncate the series exactly. _try_resume overwrites it.
        self._drain_count = 0

        if self.resume:
            state, start_iter = self._try_resume(
                config, ckpt_path, writer, betas, x0, eval_init, init_key, isave, thin
            )
        # Resumed runs report "percent of new work" in the progress line
        # (reference PTMCMCSampler.py:358-366).
        self._resume_start_iter = start_iter if state is not None else 0

        if state is None:
            xs = jnp.asarray(x0, dtype=self.dtype)
            ll0, lp0 = eval_init(xs)
            # Reference: -inf prior short-circuits the likelihood (:481-487).
            ll0 = jnp.where(jnp.isneginf(lp0), -jnp.inf, ll0)
            state = init_state(config, init_key, x0, self.cov0, betas, ll0, lp0)
            start_iter = 0
            self._drain_count = 0
            # Record + write the initial sample (reference :489-491).
            lnprob0 = utils.host_array(state.lnprob)
            x_host = np.moveaxis(utils.host_array(state.x), 1, 2)  # [T, C, D]
            self._chain_host = [x_host[0, 0][None]]
            # Multi-process: drains append only the LOCAL chain block of the
            # cold temperature ([rows, len(cids), D], _drain_block_multi), so
            # a global-width [1, C, D] seed row would make the later
            # np.concatenate (neff check, ``chains`` accessor) raise on
            # mismatched widths — the all-chain window starts at the first
            # drained block instead (matching the part-file sidecars, which
            # also start there).
            self._chains_host = [] if self._multi else [x_host[0][None]]
            if self._multi:
                self._chains_host_row0 = 1  # window starts after the initial row
            self._lnlike_host = [utils.host_array(state.lnlike[0, 0])[None]]
            self._lnprob_host = [lnprob0[0, 0][None]]
            for ti in range(self.ntemps):
                if self._multi:
                    # Sidecars become per-process part files, reset lazily by
                    # their owners at the first drain; process 0 writes the
                    # initial text row (reference :489-491) for every temp,
                    # and clears stale sidecars from any previous run in this
                    # outDir (they would shadow the new part files in
                    # load_all). No other process can reach its first drain
                    # before process 0 joins the first collective step, so
                    # the clear strictly precedes every part-file write.
                    if pid == 0:
                        writer.clear_stale_sidecars(ti)
                        writer.append(
                            ti,
                            x_host[ti, 0][None],
                            np.array([lnprob0[ti, 0]]),
                            np.array([utils.host_array(state.lnlike[ti, 0])]),
                            np.array([0.0]),
                            np.array([1.0]),
                        )
                    continue
                writer.reset_all(ti, self.nchains, self.ndim)
                writer.append(
                    ti,
                    x_host[ti, 0][None],
                    np.array([lnprob0[ti, 0]]),
                    np.array([utils.host_array(state.lnlike[ti, 0])]),
                    np.array([0.0]),
                    np.array([1.0]),
                )
                writer.append_all(ti, x_host[ti][None])

        state = self._place_on_mesh(state)
        if self._multi:
            from jax.sharding import NamedSharding, PartitionSpec as P

            rep = NamedSharding(self.mesh, P())
            # Replicated-output reductions for pooled statistics and the
            # full-state checkpoint: compiled once per run, executed
            # collectively by every process each drain (the SPMD analogue of
            # the reference's gathers to rank 0, PTMCMCSampler.py:660-661).
            self._pooled_stats_fn = jax.jit(
                lambda s: (
                    s.counters.jump_proposed[:, 0, :].sum(axis=1),
                    s.counters.jump_accepted[:, 0, :].sum(axis=1),
                    s.counters.naccepted[0].astype(jnp.float32).mean(),
                ),
                out_shardings=(rep, rep, rep),
            )
            self._replicate_fn = jax.jit(
                lambda s: s,
                out_shardings=jax.tree_util.tree_map(lambda _: rep, state),
            )
        self.state = state
        self.Niter = Niter
        tstart = time.time()
        it = start_iter
        rows_per_block = isave // thin
        run_complete = it >= Niter
        message = ""

        # Tracing/profiling (SURVEY §5: the reference has none; here the
        # sampling loop can be captured with the XLA profiler and viewed in
        # TensorBoard/Perfetto).
        if profile_dir is not None:
            jax.profiler.start_trace(profile_dir)

        def _save_ckpt(st, it_now):
            save_checkpoint(
                ckpt_path, st,
                meta=dict(iter=int(it_now), niter=int(Niter), thin=int(thin),
                          isave=int(isave), drains=int(self._drain_count),
                          swap_mode=config.swap_mode),
            )

        # Double-buffered dispatch for the common single-process fixed-Niter
        # case: the next block is dispatched (async) before the previous one
        # is drained, so host-side I/O and the device->host sync round-trip
        # overlap device compute instead of idling the device. neff termination
        # and multi-process runs keep the serial loop (their stop decision
        # must see the freshly drained history each block).
        if (
            not self._multi and neff is None and not run_complete
            and it < Niter - (Niter % thin)
        ):
            pending = None
            while it < Niter - (Niter % thin):
                todo_iters = Niter - it
                rows = min(rows_per_block, max(todo_iters // thin, 1))
                state, out = run_block(state, rows)  # async dispatch
                it += rows * thin
                if pending is not None:
                    p_state, p_out, p_it = pending
                    self._drain_block(p_state, p_out, p_it, tstart, Niter, writer, config)
                    self._drain_count += 1
                    _save_ckpt(p_state, p_it)
                pending = (state, out, it)
                self.state = state
            p_state, p_out, p_it = pending
            self._drain_block(p_state, p_out, p_it, tstart, Niter, writer, config)
            self._drain_count += 1
            _save_ckpt(p_state, p_it)
            run_complete = True
            message = "\nRun Complete"

        while not run_complete:
            todo_iters = Niter - it
            rows = min(rows_per_block, max(todo_iters // thin, 1))
            state, out = run_block(state, rows)
            it += rows * thin
            self._drain_block(state, out, it, tstart, Niter, writer, config)
            self._drain_count += 1
            self.state = state

            if it >= Niter - (Niter % thin):
                message = "\nRun Complete"
                run_complete = True
            elif neff is not None and it > 2 * burn:
                n_eff = self._neff_value(burn // thin, it)
                if int(n_eff) >= neff:
                    message = "\nRun Complete with {0} effective samples".format(int(n_eff))
                    run_complete = True

            if self._multi:
                from jax.experimental import multihost_utils

                # The neff decision is made from host history only the
                # (temp 0, chain 0)-owning process holds; agree on the stop
                # flag collectively (reference ``comm.bcast(runComplete)``,
                # PTMCMCSampler.py:523) so no process keeps issuing the
                # collective step program alone.
                flags = multihost_utils.process_allgather(
                    np.asarray([bool(run_complete)])
                )
                run_complete = bool(np.any(flags))
                # Checkpoint: all-gather the sharded leaves into a replicated
                # copy (collective, so every process participates), then only
                # process 0 writes the file on the shared outDir.
                rep_state = self._replicate_fn(state)
                if jax.process_index() == 0:
                    save_checkpoint(
                        ckpt_path, rep_state,
                        meta=dict(iter=int(it), niter=int(Niter), thin=int(thin),
                                  isave=int(isave),
                                  drains=int(self._drain_count),
                                  swap_mode=config.swap_mode),
                    )
            else:
                _save_ckpt(state, it)

        if profile_dir is not None:
            jax.profiler.stop_trace()
        if self.verbose:
            print(message)
        del lp_arr
        return state

    # ------------------------------------------------------------ internals

    def _neff_value(self, burn_rows, it):
        """Effective-sample-size estimate for the neff termination check
        (reference PTMCMCSampler.py:510-521, iter/tau on the rank-0 chain).

        With nchains > 1, every vmapped chain is pooled with the cross-chain
        (Stan-style) ESS — the whole point of the nchains axis: neff grows
        ~linearly with chains. Multi-process: only the process holding drained
        cold-chain history may vote to stop — on every other process the host
        history is just the 1-row seed, whose tau=1.0 would make n_eff = it
        and falsely signal completion everywhere (the stop flag is OR-reduced
        across processes).
        """
        if self.nchains > 1 and self._chains_host:
            arr = np.concatenate(self._chains_host, axis=0)  # [rows, C, D]
            # The in-RAM window may start after row 0 (bounded
            # retention / resume): slice in GLOBAL row coordinates.
            start = max(0, burn_rows - self._chains_host_row0)
            post = arr[start:]
            if post.shape[0] >= 8:
                chains = np.moveaxis(post, 0, 1)  # [C, rows, D]
                return float(np.min(diagnostics.multichain_ess(chains)))
            return 0.0
        if getattr(self, "_multi", False) and not getattr(self, "_owns_cold", False):
            return 0.0
        chain = np.concatenate(self._chain_host, axis=0)
        tau = diagnostics.max_autocorr_time(chain[burn_rows:])
        return it / max(1.0, tau)

    def _resolved_swap_mode(self):
        """Effective swap mode for this run (requires the mesh resolved).

        ``swap_mode=None`` (the default) auto-selects: "deo" when the
        temperature axis is sharded over >1 device — the even/odd neighbor
        exchanges then run as ``ppermute`` under shard_map, with no
        cross-device gathers on the swap path — and "sweep" (reference-parity
        hottest-first serial sweep, PTMCMCSampler.py:672-686) otherwise. An
        explicit "sweep"/"deo" always wins.
        """
        if self.swap_mode is not None:
            return self.swap_mode
        # Resuming under auto-selection: the replica-exchange law (sweep vs
        # DEO) is part of the sampler's statistical behavior, so a run resumed
        # on a different device topology (e.g. a multi-device checkpoint resumed
        # on one device) must keep the mode it started with, not silently switch
        # mid-run. The resolved mode is persisted in the checkpoint meta.
        if self.resume:
            ckpt_mode = self._checkpoint_meta_value("swap_mode")
            if ckpt_mode in ("sweep", "deo"):
                return ckpt_mode
        mesh = self.mesh
        temp_sharded = (
            mesh is not None
            and self.temp_axis in tuple(getattr(mesh, "axis_names", ()))
            and mesh.shape[self.temp_axis] > 1
            and self.ntemps > 1
        )
        if temp_sharded:
            if self.verbose:
                print(
                    "NOTE: temperature axis is sharded over %d devices; "
                    "auto-selecting swap_mode='deo' (ppermute replica "
                    "exchange). Pass swap_mode='sweep' to force the "
                    "reference-parity serial sweep." % mesh.shape[self.temp_axis]
                )
            return "deo"
        return "sweep"

    def _checkpoint_meta_value(self, key):
        """Read one field from the checkpoint meta sidecar, if present."""
        path = os.path.join(self.outDir, "checkpoint.npz.json")
        try:
            with open(path) as f:
                return json.load(f).get(key)
        except (OSError, ValueError):
            return None

    def _resolve_mesh(self):
        """Pick the device mesh for this run (or None for unsharded).

        The counterpart of the reference's ``mpirun -np N`` launch
        model (README.md:40-46; one MPI rank per temperature,
        PTMCMCSampler.py:94-105): the same jitted step program runs SPMD over
        the mesh and GSPMD/shard_map insert the collectives. An explicit
        ``mesh=`` constructor argument wins; otherwise, when more than one
        device is visible, a 1-D mesh is built automatically over the
        temperature axis (or over the chain axis when ``ntemps`` doesn't tile
        the devices).
        """
        if self.mesh is None:
            ndev = len(jax.devices())
            if ndev <= 1:
                return None
            if self.ntemps % ndev == 0:
                self.mesh = make_temp_mesh(ndev, axis=self.temp_axis)
            elif self.nchains % ndev == 0:
                self.mesh = make_temp_mesh(ndev, axis=self.chain_axis)
        return self.mesh

    def _place_on_mesh(self, state):
        """Distribute the sampler state over the resolved mesh."""
        mesh = self.mesh
        if mesh is None:
            return state
        axes = tuple(getattr(mesh, "axis_names", ()))
        t_ax = self.temp_axis if self.temp_axis in axes else None
        c_ax = self.chain_axis if self.chain_axis in axes else None
        if t_ax is None and c_ax is None:
            raise ValueError(
                f"mesh axes {axes} contain neither temp_axis="
                f"{self.temp_axis!r} nor chain_axis={self.chain_axis!r}"
            )
        if t_ax is not None and self.ntemps % mesh.shape[t_ax] != 0:
            raise ValueError(
                f"ntemps={self.ntemps} must be a multiple of mesh axis "
                f"{t_ax!r} size {mesh.shape[t_ax]}"
            )
        if c_ax is not None and self.nchains % mesh.shape[c_ax] != 0:
            raise ValueError(
                f"nchains={self.nchains} must be a multiple of mesh axis "
                f"{c_ax!r} size {mesh.shape[c_ax]}"
            )
        if jax.process_count() > 1:
            # device_put cannot target non-addressable devices; build each
            # leaf from the (identical) host copy instead.
            return shard_state_global(state, mesh, axis=t_ax, chain_axis=c_ax)
        return shard_state(state, mesh, axis=t_ax, chain_axis=c_ax)

    def _drain_block_multi(self, state, out, it, tstart, Niter, writer, config):
        """Multi-process block drain: each process writes the files for the
        (temperature, chain) block its addressable shards own — the analogue
        of one chain file per MPI rank (PTMCMCSampler.py:341-372) — and
        pooled statistics come from collective replicated-output reductions.
        """
        x, (_, tids, _, cids) = host_local_block(out.x)  # [rows, Tl, D, Cl]
        x = np.moveaxis(x, 2, 3)  # host convention [rows, Tl, Cl, D]
        lnlike, _ = host_local_block(out.lnlike)
        lnprob, _ = host_local_block(out.lnprob)
        nacc, _ = host_local_block(out.naccepted)
        sacc, _ = host_local_block(out.swaps_accepted)
        sprop, _ = host_local_block(out.swaps_proposed)  # [rows, Tl]
        its = np.asarray(jax.device_get(out.it)).astype(np.int64)  # replicated
        rows = x.shape[0]
        denom = np.maximum(its, 1).astype(np.float64)
        cpos = {int(g): k for k, g in enumerate(cids)}
        own_chain0 = 0 in cpos
        c0 = cpos.get(0, 0)
        full_c = len(cids) == self.nchains
        cstart = None if full_c else int(cids[0])

        if own_chain0 and 0 in {int(t) for t in tids}:
            self._owns_cold = True
            lt0 = [int(t) for t in tids].index(0)
            self._chain_host.append(x[:, lt0, c0, :])
            self._chains_host.append(x[:, lt0, :, :])
            self._lnlike_host.append(lnlike[:, lt0, c0])
            self._lnprob_host.append(lnprob[:, lt0, c0])
            cap_rows = max(
                1, self._host_history_bytes // max(1, len(cids) * self.ndim * 4)
            )
            total_rows = sum(b.shape[0] for b in self._chains_host)
            while total_rows > cap_rows and len(self._chains_host) > 1:
                dropped = self._chains_host.pop(0)
                self._chains_host_row0 += dropped.shape[0]
                total_rows -= dropped.shape[0]

        for lt, ti in enumerate(int(t) for t in tids):
            if own_chain0:
                acc_rate = nacc[:, lt, c0] / denom
                if ti < self.ntemps - 1:
                    pt_acc = np.where(
                        sprop[:, lt] > 0,
                        sacc[:, lt, c0] / np.maximum(sprop[:, lt], 1),
                        1.0,
                    )
                else:
                    pt_acc = np.ones(rows)
                writer.append(
                    ti, x[:, lt, c0, :], lnprob[:, lt, c0], lnlike[:, lt, c0],
                    acc_rate, pt_acc,
                )
            if ti not in self._sidecar_reset:
                self._sidecar_reset.add(ti)
                if not self.resume:
                    writer.reset_all(
                        ti, len(cids), self.ndim, cstart=cstart,
                        nchains_total=self.nchains,
                    )
            writer.append_all(
                ti, x[:, lt, :, :], cstart=cstart, nchains_total=self.nchains
            )

        # Collective pooled statistics (every process must execute this).
        jp, ja, mean_acc = self._pooled_stats_fn(state)
        if jax.process_index() == 0:
            writer.write_cov(np.asarray(jax.device_get(state.adapt.cov)))
            w, _ = config.weights_and_activation()
            writer.write_jump_stats(
                config.jump_names(), w,
                np.asarray(jax.device_get(jp)), np.asarray(jax.device_get(ja)),
            )
            if self.verbose:
                sys.stdout.write("\r")
                percent = it / Niter * 100
                acceptance = float(jax.device_get(mean_acc)) / max(it, 1)
                elapsed = time.time() - tstart
                start = int(getattr(self, "_resume_start_iter", 0) or 0)
                if start > 0 and Niter > start:
                    percentnew = (it - start) / (Niter - start) * 100
                    sys.stdout.write(
                        "Finished %2.2f percent (%2.2f percent of new work) "
                        "in %f s Acceptance rate = %g"
                        % (percent, percentnew, elapsed, acceptance)
                    )
                else:
                    sys.stdout.write(
                        "Finished %2.2f percent in %f s Acceptance rate = %g"
                        % (percent, elapsed, acceptance)
                    )
                sys.stdout.flush()

    def _drain_block(self, state, out, it, tstart, Niter, writer, config):
        """Host-side block drain: chain files, jump stats, progress line."""
        if getattr(self, "_multi", False):
            return self._drain_block_multi(
                state, out, it, tstart, Niter, writer, config
            )
        # Device emission is chain-minor [rows, T, D, C]; host convention
        # stays [rows, T, C, D].
        x = np.moveaxis(utils.host_array(out.x), 2, 3)

        def col0(a):
            """Chain-0 column: slim ([rows, T]) and full ([rows, T, C]) blocks."""
            a = utils.host_array(a)
            return a[:, :, 0] if a.ndim == 3 else a

        lnlike = col0(out.lnlike)  # [rows, T]
        lnprob = col0(out.lnprob)  # [rows, T]
        its = utils.host_array(out.it).astype(np.int64)  # [rows]
        nacc = col0(out.naccepted)  # [rows, T]
        sacc = col0(out.swaps_accepted)  # [rows, T]
        sprop = utils.host_array(out.swaps_proposed)  # [rows, T]
        ctr = jax.device_get(state.counters)
        rows = x.shape[0]

        self._chain_host.append(x[:, 0, 0, :])
        self._chains_host.append(x[:, 0, :, :])
        self._lnlike_host.append(lnlike[:, 0])
        self._lnprob_host.append(lnprob[:, 0])
        # Bound the all-chain in-RAM window (the full history is on disk in
        # chain_all_<T>.bin); drop oldest blocks past the byte budget.
        cap_rows = max(
            1, self._host_history_bytes // max(1, self.nchains * self.ndim * 4)
        )
        total_rows = sum(b.shape[0] for b in self._chains_host)
        while total_rows > cap_rows and len(self._chains_host) > 1:
            dropped = self._chains_host.pop(0)
            self._chains_host_row0 += dropped.shape[0]
            total_rows -= dropped.shape[0]

        if getattr(self, "_traj_writer", None) is not None and out.traj is not None:
            tr = jax.device_get(out.traj)
            for r in range(rows):
                self._traj_writer.write(
                    int(its[r]),
                    dict(
                        plus=tr.plus[r], minus=tr.minus[r],
                        ind_plus=tr.ind_plus[r], ind_minus=tr.ind_minus[r],
                        len_plus=tr.len_plus[r], len_minus=tr.len_minus[r],
                        used_ind=tr.used_ind[r], active=tr.active[r],
                    ),
                )

        denom = np.maximum(its, 1).astype(np.float64)
        for ti in range(self.ntemps):
            # Per-row cumulative rates, as the reference writes them
            # (PTMCMCSampler.py:731-745), from the per-row counter snapshots.
            acc_rate = nacc[:, ti] / denom
            if ti < self.ntemps - 1:
                pt_acc = np.where(
                    sprop[:, ti] > 0,
                    sacc[:, ti] / np.maximum(sprop[:, ti], 1),
                    1.0,
                )
            else:
                pt_acc = np.ones(rows)  # reference :737-739
            writer.append(
                ti,
                x[:, ti, 0, :],
                lnprob[:, ti],
                lnlike[:, ti],
                acc_rate,
                pt_acc,
            )
            writer.append_all(ti, x[:, ti, :, :])

        writer.write_cov(jax.device_get(state.adapt.cov))
        w, _ = config.weights_and_activation()
        # Per-jump rates pooled over ALL cold chains (every chain at beta=1
        # targets the same distribution, so the pooled rate is the same
        # statistic the reference's rank-0 file reports but computed from
        # nchains x more data; reference format unchanged).
        writer.write_jump_stats(
            config.jump_names(), w,
            np.asarray(ctr.jump_proposed)[:, 0, :].sum(axis=1),
            np.asarray(ctr.jump_accepted)[:, 0, :].sum(axis=1),
        )

        if self.verbose:
            sys.stdout.write("\r")
            percent = it / Niter * 100
            acceptance = float(np.asarray(ctr.naccepted)[0].mean()) / max(it, 1)
            elapsed = time.time() - tstart
            start = int(getattr(self, "_resume_start_iter", 0) or 0)
            if start > 0 and Niter > start:
                # Resumed run: also report the percent of NEW work, as the
                # reference does (PTMCMCSampler.py:358-366).
                percentnew = (it - start) / (Niter - start) * 100
                sys.stdout.write(
                    "Finished %2.2f percent (%2.2f percent of new work) in "
                    "%f s Acceptance rate = %g"
                    % (percent, percentnew, elapsed, acceptance)
                )
            else:
                sys.stdout.write(
                    "Finished %2.2f percent in %f s Acceptance rate = %g"
                    % (percent, elapsed, acceptance)
                )
            sys.stdout.flush()

    def _try_resume(self, config, ckpt_path, writer, betas, x0, eval_init, init_key, isave, thin):
        """Resume from a full checkpoint, else from reference chain files."""
        if os.path.isfile(ckpt_path):
            xs = jnp.asarray(x0, dtype=self.dtype)
            ll0, lp0 = eval_init(xs)
            template = init_state(config, init_key, x0, self.cov0, betas, ll0, lp0)
            try:
                state, meta = load_checkpoint(ckpt_path, template)
            except (ValueError, KeyError):
                # Structure mismatch (e.g. a checkpoint from an older state
                # layout): fall through to chain-file resume.
                state, meta = None, None
            if state is not None:
                it = int(meta["iter"]) if meta else int(jax.device_get(state.it))
                if self.verbose:
                    print(f"Resuming from checkpoint at iteration {it}")
                # Torn-run cleanup: a kill between a drain and its checkpoint
                # leaves files a block ahead of the checkpoint; resume re-runs
                # that block, so rows past the checkpoint must be dropped or
                # they are duplicated (and part-sidecar merges are offset
                # forever — the merge aligns on a common row index).
                thin_ck = int(meta.get("thin", thin)) if meta else thin
                isave_ck = int(meta.get("isave", isave)) if meta else isave
                drained = it // max(thin_ck, 1)
                drains_ck = int(meta.get("drains", it // max(isave_ck, 1))) \
                    if meta else it // max(isave_ck, 1)
                self._drain_count = drains_ck
                if (not self._multi) or jax.process_index() == 0:
                    for ti in range(self.ntemps):
                        writer.truncate_text(ti, 1 + drained)
                        writer.truncate_all(ti, 1 + drained, drained)
                    # The per-jump acceptance series gain one entry per
                    # drain; drop entries past the checkpoint too, or every
                    # torn resume leaves a duplicate row in <name>_jump.txt.
                    writer.truncate_jump_files(config.jump_names(), drains_ck)
                if self._multi:
                    from jax.experimental import multihost_utils

                    # Reads of the (shared) files below must see the
                    # truncation; no process may append before every process
                    # has joined the first collective block anyway.
                    multihost_utils.sync_global_devices("ptmcmc-resume-trunc")
                self._reload_host_history()
                return state, it

        data = writer.existing_rows(0)
        if data is None or len(data) == 0:
            return None, 0
        rows = data.shape[0]
        # Warm-start the proposal covariance from the cov.npy the previous
        # run wrote at every drain (io/chainfile.py:320) — the reference
        # writes the same file but never reloads it (PTMCMCSampler.py:349-351,
        # :290-319), so its resumes always re-burn the proposal scales.
        cov_res = self.cov0
        cov_warm = False
        cov_path = os.path.join(self.outDir, "cov.npy")
        if os.path.isfile(cov_path):
            try:
                cov_cand = np.load(cov_path)
                if cov_cand.shape == (self.ndim, self.ndim) and np.all(
                    np.isfinite(cov_cand)
                ):
                    cov_res = cov_cand
                    cov_warm = True
            except (OSError, ValueError):
                pass
        if self.verbose:
            print("Resuming run from chain file {0}".format(writer.fnames[0]))
            if cov_warm:
                print(
                    "NOTE: no usable full-state checkpoint found - proposal "
                    "covariance warm-started from cov.npy; other adaptive "
                    "state (DE buffer, step sizes, ladder) restarts from its "
                    "initial values."
                )
            else:
                print(
                    "WARNING: no usable full-state checkpoint found - adaptive "
                    "state (covariance, DE buffer, step sizes, ladder) restarts "
                    "from its initial values and will re-burn in."
                )
        if isave != thin and rows % (isave / thin) != 1:  # reference :301-309
            raise RuntimeError(
                "Old chain has {0} rows, which is not the initial sample plus "
                "a multiple of isave/thin = {1}".format(rows, isave // thin)
            )
        # Rebuild per-temperature positions: every chain's own last position
        # from the chain_all sidecar when present (so a resumed vmapped batch
        # restarts non-degenerate); otherwise broadcast the text file's last
        # row (the reference-format-only fallback, one chain of data).
        x_res = np.array(np.broadcast_to(x0, (self.ntemps, self.nchains, self.ndim)))
        for ti in range(self.ntemps):
            tail = writer.load_all(ti, tail_rows=1)
            if tail is not None and tail.shape[1] == self.nchains:
                x_res[ti, :, :] = tail[-1]
                continue
            d = writer.existing_rows(ti)
            if d is not None and len(d):
                x_res[ti, :, :] = d[-1, : self.ndim]
        xs = jnp.asarray(x_res, dtype=self.dtype)
        ll0, lp0 = eval_init(xs)
        ll0 = jnp.where(jnp.isneginf(lp0), -jnp.inf, ll0)
        state = init_state(config, init_key, x_res, cov_res, betas, ll0, lp0)
        it = (rows - 1) * thin
        self._drain_count = (rows - 1) // max(isave // thin, 1)
        # Restore the acceptance counter from the file column (reference :599).
        naccepted = int(data[-1, -2] * it)
        ctr = state.counters
        state = state.replace(
            it=jnp.asarray(it, jnp.int32),
            counters=ctr.replace(
                naccepted=jnp.full_like(ctr.naccepted, naccepted)
            ),
        )
        self._reload_host_history(data)
        return state, it

    def _reload_host_history(self, data=None):
        if data is None:
            data = self._writer.existing_rows(0)
        if data is None or len(data) == 0:
            return
        self._chain_host = [data[:, : self.ndim]]
        self._lnprob_host = [data[:, -4]]
        self._lnlike_host = [data[:, -3]]
        cap_rows = max(
            1, self._host_history_bytes // max(1, self.nchains * self.ndim * 4)
        )
        total_rows = self._writer.all_rows_count(0)
        if getattr(self, "_multi", False):
            # Multi-process drains append LOCAL-width blocks
            # [rows, len(cids), D] (per-process part sidecars), so seeding the
            # window with the GLOBAL-width merge from load_all would make the
            # later np.concatenate raise on mismatched widths. Restart the
            # window at the resume point; +1 because the part files start
            # after the seed row (global thinned row 0 lives only in the text
            # chain file).
            self._chains_host = []
            self._chains_host_row0 = total_rows + 1
            return
        all_rows = self._writer.load_all(0, tail_rows=cap_rows)
        if all_rows is not None and all_rows.shape[1] == self.nchains:
            self._chains_host = [all_rows]
            self._chains_host_row0 = total_rows - all_rows.shape[0]
        else:
            # No usable sidecar: the window restarts at the resume point.
            self._chains_host = []
            self._chains_host_row0 = data.shape[0]

    # ------------------------------------------------------------ accessors

    @property
    def chain(self):
        """Thinned cold-chain history [rows, ndim] for chain index 0
        (reference self._chain, one chain per rank)."""
        if not self._chain_host:
            return np.zeros((0, self.ndim))
        return np.concatenate(self._chain_host, axis=0)

    @property
    def chains(self):
        """ALL vmapped cold chains, chains-major [nchains, rows, ndim] —
        the throughput axis the reference cannot have. Feed directly to
        :func:`ptmcmcsampler_tpu.diagnostics.multichain_ess`.

        This is the bounded in-RAM window of the most recent rows (see
        ``host_history_bytes``, default 2 GiB); ``chains_row0`` gives the
        window start's global thinned-row index, and the complete history is
        on disk in ``chain_all_<T>.bin`` (``ChainWriter.load_all``)."""
        if not self._chains_host:
            return np.zeros((self.nchains, 0, self.ndim))
        return np.moveaxis(np.concatenate(self._chains_host, axis=0), 0, 1)

    @property
    def chains_row0(self):
        """Global thinned-row index of ``chains``' first retained row."""
        return self._chains_host_row0

    @property
    def pooled_chain(self):
        """All cold-chain samples pooled into one [rows * nchains, ndim]
        (same retention window as :attr:`chains`)."""
        return self.chains.reshape(-1, self.ndim)

    @property
    def lnprob_chain(self):
        return np.concatenate(self._lnprob_host, axis=0) if self._lnprob_host else np.zeros(0)

    @property
    def lnlike_chain(self):
        return np.concatenate(self._lnlike_host, axis=0) if self._lnlike_host else np.zeros(0)

    @property
    def cov(self):
        if self.state is None:
            return self.cov0
        return utils.host_array(self.state.adapt.cov)

    # Reference counter attribute parity (PTMCMCSampler.py:214-216): scalars
    # for the cold chain 0, as analysis scripts read them.

    @property
    def naccepted(self):
        if self.state is None:
            return 0
        return int(utils.host_array(self.state.counters.naccepted)[0, 0])

    @property
    def swapProposed(self):  # noqa: N802 (reference casing)
        if self.state is None:
            return 0
        return int(utils.host_array(self.state.counters.swaps_proposed)[0])

    @property
    def nswap_accepted(self):
        if self.state is None:
            return 0
        return int(utils.host_array(self.state.counters.swaps_accepted)[0, 0])
