"""What the GPU bring-up fixed, checked on the CPU.

* the options of the removed Pallas kernels are gone (passing one is an error);
* the compile-cache helper honours ``JAX_COMPILATION_CACHE_DIR`` and
  otherwise uses one fixed directory in the checkout;
* ``chip_smoke.py`` and ``bench.py`` refuse to run without a GPU and print
  no result;
* ``make_pt_mesh`` in one process is a plain reshape of the devices;
* the float32 contractions that must be exact carry
  ``precision=HIGHEST`` (read from their jaxprs);
* the moment gate and the native chain-row formatter.

Checks that need the card itself run in ``chip_smoke.py``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from ptmcmcsampler_tpu import PTSampler, utils
from ptmcmcsampler_tpu.config import JumpSpec, SamplerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ removed options


def _sampler(**kw):
    return PTSampler(
        2, lambda x: -0.5 * jnp.sum(x**2), lambda x: jnp.zeros(()), np.eye(2),
        outDir=kw.pop("outDir"), verbose=False, **kw,
    )


@pytest.mark.parametrize(
    "kwarg", [("use_pallas", True), ("nuts_impl", "xla"), ("nuts_pass1_depth", 4)]
)
def test_removed_sampler_kwargs_raise(tmp_path, kwarg):
    with pytest.raises(TypeError):
        _sampler(outDir=str(tmp_path), **dict([kwarg]))


@pytest.mark.parametrize(
    "kwarg",
    [("use_pallas", True), ("nuts_impl", "auto"), ("pallas_nuts_block_n", 128),
     ("nuts_pass1_depth", 4), ("verbose", True)],
)
def test_removed_config_fields_raise(kwarg):
    with pytest.raises(TypeError):
        SamplerConfig(
            ndim=2, ntemps=1, nchains=1, groups=((0, 1),),
            jumps=(JumpSpec("AM", "am", 1),), **dict([kwarg]),
        )


# ---------------------------------------------------------------- compile cache


def test_compile_cache_env_set_is_left_to_jax(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert utils.enable_compile_cache() == str(tmp_path / "cc")
    assert calls == []  # nothing is set in code


def test_compile_cache_env_unset_uses_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = utils.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def test_compile_cache_path_is_fixed(monkeypatch, tmp_path):
    """No pid, time or temporary name in the path: a later process of the
    same checkout must find the same directory."""
    import time

    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = utils.enable_compile_cache(str(tmp_path))
    monkeypatch.setattr(os, "getpid", lambda: 424242)
    monkeypatch.setattr(time, "time", lambda: 1.0)
    assert utils.enable_compile_cache(str(tmp_path)) == first
    assert first == os.path.join(str(tmp_path), ".jax_cache")
    assert str(os.getpid()) not in first


# ---------------------------------------------------------- no GPU, no result


@pytest.mark.parametrize("args", [[], ["--four-cards"]])
def test_chip_smoke_fails_without_gpu(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr + r.stdout


def test_bench_refuses_cpu():
    sys.path.insert(0, ROOT)
    try:
        import bench
    finally:
        sys.path.remove(ROOT)
    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.main()


# ------------------------------------------------------------------- meshes


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_make_pt_mesh_is_plain_reshape(shape):
    from ptmcmcsampler_tpu.parallel import make_pt_mesh

    mesh = make_pt_mesh(ntemp_devices=shape[0], nchain_devices=shape[1])
    want = np.asarray(jax.devices()[: shape[0] * shape[1]]).reshape(shape)
    assert mesh.axis_names == ("temp", "chain")
    assert mesh.devices.shape == shape
    assert all(a is b for a, b in zip(mesh.devices.ravel(), want.ravel()))


# ---------------------------------------------------------- precision pins


def _dot_precisions(closed):
    """Every dot_general's precision in a closed jaxpr, sub-jaxprs included."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (tuple, list)) else (v,):
                    inner = getattr(sub, "jaxpr", None)
                    if inner is not None:
                        walk(getattr(inner, "jaxpr", inner))

    walk(closed.jaxpr)
    return found


def _ctx(d):
    from ptmcmcsampler_tpu.proposals.base import ProposalContext

    return ProposalContext(
        group_u=(jnp.eye(d),), group_s=(jnp.ones(d),), chol=jnp.eye(d),
        chol_inv=jnp.eye(d), de_buf=jnp.zeros((d, 2)), de_valid=jnp.asarray(0, jnp.int32),
    )


def _cfg(d, kind):
    return SamplerConfig(ndim=d, ntemps=1, nchains=1, groups=(tuple(range(d)),),
                         jumps=(JumpSpec("J", kind, 1),))


def _site(name):
    """(function, example args) for each contraction that must be exact."""
    d = 4
    x = jnp.arange(d, dtype=jnp.float32)
    key = jax.random.key(0)
    if name == "am.eigen_pick":
        from ptmcmcsampler_tpu.proposals.am import eigen_pick

        return eigen_pick, (jnp.eye(d), jnp.ones(d), 1)
    if name in ("am.make_scam", "am.make_am"):
        from ptmcmcsampler_tpu.proposals import am

        kern = getattr(am, name.split(".")[1])(_cfg(d, name.split("_")[1]))
        return kern, (key, x, 1.0, 1, _ctx(d))
    if name.startswith("GroupEmbed."):
        from ptmcmcsampler_tpu.proposals.base import GroupEmbed

        emb = GroupEmbed(np.array([0, 2]), d, np.float32)
        fn = getattr(emb, name.split(".")[1])
        return (fn, (x,)) if name.endswith("take") else (fn, (x, jnp.ones(2)))
    if name.startswith("whiten."):
        from ptmcmcsampler_tpu.proposals.gradient import make_whitened_funcs

        fwd, bwd, fgw = make_whitened_funcs(lambda xx, b: (jnp.sum(xx), xx))
        fn = dict(forward=fwd, backward=bwd, func_grad_white=fgw)[name.split(".")[1]]
        return (fn, (_ctx(d), x, 1.0)) if name.endswith("white") else (fn, (_ctx(d), x))
    if name == "welford_batch_update":
        from ptmcmcsampler_tpu.adaptation import welford_batch_update
        from ptmcmcsampler_tpu.state import init_state

        cfg = SamplerConfig(ndim=d, ntemps=1, nchains=2, groups=(tuple(range(d)),),
                            jumps=(JumpSpec("AM", "am", 1),), de_size=4)
        st = init_state(cfg, key, np.zeros(d), np.eye(d), np.ones(1),
                        np.zeros((1, 2)), np.zeros((1, 2)))
        return welford_batch_update, (st.adapt, jnp.ones((d, 8)))
    if name == "CorrelatedGaussian.lnlikefn":
        from ptmcmcsampler_tpu.models import CorrelatedGaussian

        return CorrelatedGaussian(ndim=d).lnlikefn, (x,)
    raise KeyError(name)


@pytest.mark.parametrize(
    "site",
    ["am.eigen_pick", "am.make_scam", "am.make_am", "GroupEmbed.take",
     "GroupEmbed.add_at", "GroupEmbed.set_at", "whiten.forward", "whiten.backward",
     "whiten.func_grad_white", "welford_batch_update", "CorrelatedGaussian.lnlikefn"],
)
def test_exact_contractions_pin_highest_precision(site):
    fn, args = _site(site)
    found = _dot_precisions(jax.make_jaxpr(fn)(*args))
    assert found, f"{site} has no dot_general"
    hi = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
    assert all(p == hi for p in found), (site, found)


# --------------------------------------------------------------- moment gate


def test_moment_gate_passes_draws_from_the_target():
    from ptmcmcsampler_tpu.diagnostics import moment_gate

    x = np.random.default_rng(0).normal(size=(20000, 3)) * [1.0, 2.0, 0.5] + [1, -1, 0]
    ok, z = moment_gate(x, np.full(3, 20000.0), [1.0, -1.0, 0.0])
    assert ok and z < 5


def test_moment_gate_fails_a_shifted_mean():
    from ptmcmcsampler_tpu.diagnostics import moment_gate

    x = np.random.default_rng(1).normal(size=(20000, 2))
    ok, z = moment_gate(x, np.full(2, 20000.0), [0.0, 0.2])
    assert not ok and z > 8


# --------------------------------------------------------- native formatter


@pytest.mark.parametrize("scale", [1.0, 1e3])
def test_native_formatter_matches_numpy_bytes(monkeypatch, tmp_path, scale):
    """The C++ formatter, built from csrc/chainio.cpp into a private
    directory, writes byte-identical rows to the numpy formatter."""
    from ptmcmcsampler_tpu.io import build_native, chainfile, native

    lib = build_native.build(out=str(tmp_path / "libchainio.so"), verbose=False)
    if lib is None:
        pytest.fail("g++ could not build csrc/chainio.cpp")
    rng = np.random.default_rng(3)
    rows = (rng.normal(size=(7, 5)) * scale, rng.normal(size=7) * scale,
            rng.normal(size=7), rng.uniform(size=7), rng.uniform(size=7))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)  # numpy path
    want = chainfile.format_rows(*rows)
    monkeypatch.setattr(native, "_lib_path", lambda: lib)
    monkeypatch.setattr(native, "_TRIED", False)  # load the private build
    got = native.format_rows_native(*rows)
    assert got is not None
    assert got.encode() == want.encode()
