"""Multi-device sharding tests on the virtual 8-device CPU mesh.

The JAX analogue of the reference's (untested-in-CI) multi-rank MPI paths
(SURVEY.md §4): the temperature-sharded step program must compile, execute,
and produce the same results as the unsharded program.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptmcmcsampler_tpu.config import SamplerConfig, build_default_jumps
from ptmcmcsampler_tpu.kernel import build_step
from ptmcmcsampler_tpu.ladder import ladder_betas, temperature_ladder
from ptmcmcsampler_tpu.parallel import make_temp_mesh, shard_state
from ptmcmcsampler_tpu.state import init_state


def build(ntemps=8, nchains=4, ndim=3, swap_mode="sweep"):
    def logl(x):
        return -0.5 * jnp.sum(x**2)

    def logp(x):
        return jnp.where(jnp.all(jnp.abs(x) < 20.0), 0.0, -jnp.inf)

    cfg = SamplerConfig(
        ndim=ndim, ntemps=ntemps, nchains=nchains,
        groups=(tuple(range(ndim)),),
        jumps=build_default_jumps(burn=20),
        tskip=5, cov_update=20, burn=20, thin=1, de_size=50,
        swap_mode=swap_mode,
    )
    step, run_block = build_step(cfg, logl, logp)
    ladder = temperature_ladder(ndim, ntemps)
    _, betas = ladder_betas(ladder)
    xs = jnp.zeros((ntemps, nchains, ndim)) + 0.3
    ll0 = jax.vmap(jax.vmap(logl))(xs)
    lp0 = jax.vmap(jax.vmap(logp))(xs)
    state = init_state(
        cfg, jax.random.PRNGKey(0), np.zeros(ndim) + 0.3, np.eye(ndim) * 0.1,
        betas, ll0, lp0,
    )
    return cfg, step, run_block, state


@pytest.mark.parametrize("swap_mode", ["sweep", "deo"])
def test_sharded_step_matches_unsharded(swap_mode):
    assert len(jax.devices()) >= 8, "conftest must provide 8 cpu devices"
    cfg, step, run_block, state = build(swap_mode=swap_mode)

    # Unsharded result.
    ref_state, ref_out = run_block(state, 10)

    # Temperature-sharded over an 8-device mesh.
    mesh = make_temp_mesh(8)
    sstate = shard_state(state, mesh)
    sh_state, sh_out = run_block(sstate, 10)

    np.testing.assert_allclose(
        np.asarray(ref_out.x), np.asarray(jax.device_get(sh_out.x)), rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(ref_state.adapt.cov),
        np.asarray(jax.device_get(sh_state.adapt.cov)),
        rtol=2e-3, atol=2e-4,
    )
    np.testing.assert_array_equal(
        np.asarray(ref_state.counters.naccepted),
        np.asarray(jax.device_get(sh_state.counters.naccepted)),
    )


def test_sharded_swaps_mix_temperatures():
    cfg, step, run_block, state = build(swap_mode="deo")
    mesh = make_temp_mesh(8)
    sstate = shard_state(state, mesh)
    sstate, _ = run_block(sstate, 50)
    acc = np.asarray(jax.device_get(sstate.counters.swaps_accepted))
    assert acc[:-1].sum() > 0


def test_chain_axis_sharding_compiles():
    # Shard chains instead of temperatures (dp-style axis).
    cfg, step, run_block, state = build(ntemps=2, nchains=8)
    mesh = make_temp_mesh(4, axis="chain")
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharded = jax.tree_util.tree_map(
        lambda leaf: jax.device_put(
            leaf,
            NamedSharding(
                mesh,
                P(None, "chain") if (np.ndim(leaf) >= 2 and np.shape(leaf)[1] == 8) else P(),
            ),
        ),
        state,
    )
    out_state, out = run_block(sharded, 5)
    assert np.all(np.isfinite(np.asarray(jax.device_get(out.x))))


def test_2d_pt_mesh_temp_and_chain():
    """2-D (temp x chain) mesh: both axes sharded, results match unsharded."""
    from ptmcmcsampler_tpu.parallel import make_pt_mesh, shard_state

    cfg, step, run_block, state = build(ntemps=4, nchains=8)
    ref_state, ref_out = run_block(state, 10)

    mesh = make_pt_mesh(ntemp_devices=2, nchain_devices=4)
    assert mesh.shape == {"temp": 2, "chain": 4}
    sstate = shard_state(state, mesh, axis="temp", chain_axis="chain")
    sh_state, sh_out = run_block(sstate, 10)

    np.testing.assert_allclose(
        np.asarray(ref_out.x), np.asarray(jax.device_get(sh_out.x)),
        rtol=2e-4, atol=2e-4,
    )
    np.testing.assert_array_equal(
        np.asarray(ref_state.counters.naccepted),
        np.asarray(jax.device_get(sh_state.counters.naccepted)),
    )


class TestShardedDeoSwaps:
    """ppermute-based DEO replica exchange under shard_map (SURVEY §2.3's
    target for the reference's gather->sweep->scatter,
    PTMCMCSampler.py:660-691)."""

    def _inputs(self, ntemps=8, nchains=4, ndim=3, seed=0):
        key = jax.random.key(seed)
        kx, kl = jax.random.split(key)
        x = jax.random.normal(kx, (ntemps, ndim, nchains))  # chain-minor
        lnlike = -0.5 * jnp.sum(x**2, axis=1)
        lnprior = jnp.zeros((ntemps, nchains))
        betas = jnp.asarray(np.geomspace(1.0, 0.1, ntemps), jnp.float32)
        return key, x, lnlike, lnprior, betas

    @pytest.mark.parametrize("parity", [0, 1])
    def test_bit_identical_to_single_device(self, parity):
        from ptmcmcsampler_tpu import swaps

        key, x, lnlike, lnprior, betas = self._inputs()
        mesh = make_temp_mesh(8)
        sharded = swaps.make_sharded_deo(mesh, "temp", 8)

        swap_map, acc_ref, prop_ref = swaps.deo_swap_map(key, lnlike, betas, parity)
        x_ref, ll_ref, lp_ref = swaps.apply_swap(swap_map, x, lnlike, lnprior)

        xs = shard_state  # noqa: F841  (sharding the inputs by hand below)
        from jax.sharding import NamedSharding, PartitionSpec as P

        put = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))  # noqa: E731
        x_s, ll_s, lp_s, acc_s, prop_s = jax.jit(sharded)(
            key,
            put(x, P("temp")),
            put(lnlike, P("temp")),
            put(lnprior, P("temp")),
            put(betas, P("temp")),
            parity,
        )
        np.testing.assert_array_equal(np.asarray(jax.device_get(x_s)), np.asarray(x_ref))
        np.testing.assert_array_equal(np.asarray(jax.device_get(ll_s)), np.asarray(ll_ref))
        np.testing.assert_array_equal(np.asarray(jax.device_get(lp_s)), np.asarray(lp_ref))
        np.testing.assert_array_equal(np.asarray(jax.device_get(acc_s)), np.asarray(acc_ref))
        np.testing.assert_array_equal(np.asarray(jax.device_get(prop_s)), np.asarray(prop_ref))

    def test_hlo_has_no_all_gather_on_swap_path(self):
        """The compiled sharded swap must move state with collective-permute
        only — no all-gather of the positions (the whole point vs GSPMD's
        lowering of take_along_axis)."""
        from ptmcmcsampler_tpu import swaps

        key, x, lnlike, lnprior, betas = self._inputs(nchains=16, ndim=8)
        mesh = make_temp_mesh(8)
        sharded = swaps.make_sharded_deo(mesh, "temp", 8)
        from jax.sharding import NamedSharding, PartitionSpec as P

        put = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))  # noqa: E731
        args = (
            key, put(x, P("temp")), put(lnlike, P("temp")),
            put(lnprior, P("temp")), put(betas, P("temp")), 1,
        )
        compiled = jax.jit(sharded).lower(*args).compile()
        hlo = compiled.as_text()
        assert "collective-permute" in hlo
        assert "all-gather" not in hlo
        assert "all-to-all" not in hlo

    def test_kernel_uses_sharded_deo_and_matches(self):
        """build_step(mesh=...) in deo mode produces the same sampling results
        as the unsharded deo program (same keys, bit-comparable)."""
        cfg, step, run_block, state = build(swap_mode="deo")
        ref_state, ref_out = run_block(state, 30)

        from ptmcmcsampler_tpu.kernel import build_step as bs

        def logl(x):
            return -0.5 * jnp.sum(x**2)

        def logp(x):
            return jnp.where(jnp.all(jnp.abs(x) < 20.0), 0.0, -jnp.inf)

        mesh = make_temp_mesh(8)
        _, run_block_sh = bs(cfg, logl, logp, mesh=mesh, temp_axis="temp")
        sstate = shard_state(state, mesh)
        sh_state, sh_out = run_block_sh(sstate, 30)
        np.testing.assert_allclose(
            np.asarray(ref_out.x), np.asarray(jax.device_get(sh_out.x)),
            rtol=2e-4, atol=2e-4,
        )
        np.testing.assert_array_equal(
            np.asarray(ref_state.counters.swaps_accepted),
            np.asarray(jax.device_get(sh_state.counters.swaps_accepted)),
        )
        np.testing.assert_array_equal(
            np.asarray(ref_state.counters.swaps_proposed),
            np.asarray(jax.device_get(sh_state.counters.swaps_proposed)),
        )


class TestPTSamplerOnMesh:
    """The user-facing sampler places its state on a mesh (the
    reference's whole launch model is `mpirun -np N`; here `PTSampler`
    itself must produce sharded execution, not just the internals)."""

    def _make(self, tmp_path, **kw):
        from ptmcmcsampler_tpu import PTSampler

        defaults = dict(
            outDir=str(tmp_path / "chains"), verbose=False, seed=7,
            ntemps=8, nchains=8,
        )
        defaults.update(kw)
        return PTSampler(
            3,
            lambda x: -0.5 * jnp.sum(x**2),
            lambda x: jnp.where(jnp.all(jnp.abs(x) < 20.0), 0.0, -jnp.inf),
            np.eye(3) * 0.1,
            **defaults,
        )

    def test_explicit_mesh_shards_state(self, tmp_path):
        from jax.sharding import NamedSharding

        mesh = make_temp_mesh(8)
        s = self._make(tmp_path, mesh=mesh)
        s.sample(np.zeros(3), 200, burn=50, thin=1, isave=100,
                 SCAMweight=20, AMweight=20, DEweight=20)
        sh = s.state.x.sharding
        assert isinstance(sh, NamedSharding)
        assert sh.spec[0] == "temp"  # temperature axis is sharded
        assert len(s.state.x.sharding.mesh.devices.ravel()) == 8
        assert s.chain.shape[0] == 201

    def test_auto_mesh_when_devices_visible(self, tmp_path):
        from jax.sharding import NamedSharding

        s = self._make(tmp_path)
        assert s.mesh is None
        s.sample(np.zeros(3), 100, burn=20, thin=1, isave=50,
                 SCAMweight=20, AMweight=20, DEweight=20)
        # 8 CPU devices visible, ntemps=8 tiles them -> auto temp mesh.
        assert s.mesh is not None
        assert isinstance(s.state.x.sharding, NamedSharding)
        assert s.state.x.sharding.spec[0] == "temp"

    def test_auto_mesh_falls_back_to_chain_axis(self, tmp_path):
        from jax.sharding import NamedSharding

        s = self._make(tmp_path, ntemps=3, nchains=16)
        s.sample(np.zeros(3), 100, burn=20, thin=1, isave=50,
                 SCAMweight=20, AMweight=20, DEweight=20)
        assert isinstance(s.state.x.sharding, NamedSharding)
        assert s.state.x.sharding.spec[0] is None
        # x is chain-minor [T, D, C]: the chain axis is the last dim
        assert s.state.x.sharding.spec[2] == "chain"

    def test_auto_swap_mode_routes_sharded_temp_axis_to_deo(self, tmp_path):
        """The default multi-device configuration must
        not run the serial sweep over a sharded temperature axis (GSPMD
        lowers its gathers every tskip). swap_mode=None auto-selects DEO
        exactly when the temp axis is sharded; an explicit mode always wins.
        """
        s = self._make(tmp_path / "a")  # default swap_mode=None
        s.sample(np.zeros(3), 100, burn=20, thin=1, isave=50,
                 SCAMweight=20, AMweight=20, DEweight=20)
        assert s.state.x.sharding.spec[0] == "temp"
        assert s.config.swap_mode == "deo"

        # Chain-sharded mesh (temp axis unsharded) -> reference-parity sweep.
        s2 = self._make(tmp_path / "b", ntemps=2, nchains=16)
        s2.sample(np.zeros(3), 100, burn=20, thin=1, isave=50,
                  SCAMweight=20, AMweight=20, DEweight=20)
        assert s2.state.x.sharding.spec[0] is None
        assert s2.config.swap_mode == "sweep"

        # Explicit sweep wins even on a temp-sharded mesh.
        s3 = self._make(tmp_path / "c", swap_mode="sweep")
        s3.sample(np.zeros(3), 100, burn=20, thin=1, isave=50,
                  SCAMweight=20, AMweight=20, DEweight=20)
        assert s3.state.x.sharding.spec[0] == "temp"
        assert s3.config.swap_mode == "sweep"

    def test_bad_mesh_divisibility_raises(self, tmp_path):
        mesh = make_temp_mesh(8)
        s = self._make(tmp_path, mesh=mesh, ntemps=6)
        with pytest.raises(ValueError, match="multiple of mesh axis"):
            s.sample(np.zeros(3), 50, burn=20, thin=1, isave=50,
                     SCAMweight=20, AMweight=20, DEweight=20)


def test_initialize_distributed_serial_noop():
    from ptmcmcsampler_tpu.parallel import initialize_distributed

    # Single-process: must be a no-op (the MPIDummy analogue), twice.
    initialize_distributed()
    initialize_distributed()


def test_pt_mesh_rejects_bad_chain_split(monkeypatch):
    from ptmcmcsampler_tpu.parallel import distributed as dist

    monkeypatch.setattr(dist.jax, "process_count", lambda: 3)
    import pytest as _pytest

    with _pytest.raises(ValueError, match="multiple of the"):
        dist.make_pt_mesh(ntemp_devices=2, nchain_devices=4)
