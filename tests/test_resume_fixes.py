"""Resume hardening: checkpoint leaf backfill, swap-mode
persistence, and cov.npy warm-start on chain-file-only resume."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from ptmcmcsampler_tpu import PTSampler
from ptmcmcsampler_tpu.io.checkpoint import load_checkpoint, save_checkpoint


def _logl(x):
    return -0.5 * jnp.sum(x**2)


def _logp(x):
    return jnp.where(jnp.all(jnp.abs(x) < 10.0), 0.0, -jnp.inf)


def _run(outdir, niter=200, resume=False, swap_mode=None, **kw):
    s = PTSampler(
        2, _logl, _logp, np.eye(2), outDir=outdir, ntemps=3, nchains=4,
        seed=2, resume=resume, swap_mode=swap_mode, **kw,
    )
    s.sample(np.zeros(2), niter, burn=50, thin=1, isave=100, Tskip=10,
             SCAMweight=20, AMweight=20, DEweight=20)
    return s


def test_lad_counter_leaves_backfill_from_cumulative(tmp_path):
    """A checkpoint written before the *_lad snapshot counters existed must
    still load, with the snapshots backfilled from the cumulative counters
    (ADVICE r4: rejecting it silently discarded all adaptive state)."""
    out = str(tmp_path / "chains")
    s = _run(out)
    path = os.path.join(out, "checkpoint.npz")
    data = dict(np.load(path))
    # Simulate the pre-upgrade layout: drop the snapshot leaves.
    dropped = {
        k: v for k, v in data.items()
        if not k.endswith("swaps_proposed_lad") and not k.endswith("swaps_accepted_lad")
    }
    np.savez(path, **dropped)

    template = s.state
    loaded, _ = load_checkpoint(path, template)
    np.testing.assert_array_equal(
        np.asarray(loaded.counters.swaps_proposed_lad),
        np.asarray(loaded.counters.swaps_proposed),
    )
    np.testing.assert_array_equal(
        np.asarray(loaded.counters.swaps_accepted_lad),
        np.asarray(loaded.counters.swaps_accepted),
    )
    # And the rest of the adaptive state came from the file, not defaults.
    np.testing.assert_array_equal(
        np.asarray(loaded.adapt.cov), np.asarray(s.state.adapt.cov)
    )


def test_auto_swap_mode_persisted_and_reused(tmp_path):
    """swap_mode=None auto-selection must not silently switch the
    replica-exchange law on resume (ADVICE r4): the resolved mode is stored
    in the checkpoint meta and reused."""
    out = str(tmp_path / "chains")
    _run(out, swap_mode="deo")  # explicit DEO run writes meta
    meta = json.load(open(os.path.join(out, "checkpoint.npz.json")))
    assert meta["swap_mode"] == "deo"

    # Resume with auto selection on a single-device topology (which would
    # resolve to "sweep"): the checkpointed law must win.
    s2 = PTSampler(2, _logl, _logp, np.eye(2), outDir=out, ntemps=3,
                   nchains=4, seed=2, resume=True, swap_mode=None)
    assert s2._resolved_swap_mode() == "deo"


def test_chain_file_resume_warm_starts_cov(tmp_path, capsys):
    """Without a usable checkpoint, resume reloads cov.npy (which the run
    itself wrote) instead of re-burning the proposal covariance from its
    initial value."""
    out = str(tmp_path / "chains")
    s = _run(out, niter=300)
    cov_written = np.load(os.path.join(out, "cov.npy"))
    # Drop the full-state checkpoint to force the chain-file path.
    os.remove(os.path.join(out, "checkpoint.npz"))
    os.remove(os.path.join(out, "checkpoint.npz.json"))

    s2 = _run(out, niter=400, resume=True)
    text = capsys.readouterr().out
    assert "warm-started from cov.npy" in text
    # The restored state's proposal covariance seeded from the file: the
    # adapted covariance at the first post-resume drain evolved from it,
    # not from the tiny initial eye — check the resume state's factors by
    # rebuilding: easiest observable is that the warning about re-burn-in
    # did NOT fire.
    assert "will re-burn in" not in text
    assert np.all(np.isfinite(cov_written))


def test_chain_file_resume_without_cov_warns(tmp_path, capsys):
    out = str(tmp_path / "chains")
    _run(out, niter=300)
    os.remove(os.path.join(out, "checkpoint.npz"))
    os.remove(os.path.join(out, "checkpoint.npz.json"))
    os.remove(os.path.join(out, "cov.npy"))
    _run(out, niter=400, resume=True)
    text = capsys.readouterr().out
    assert "will re-burn in" in text


def test_old_layout_checkpoint_transposes_on_load(tmp_path):
    """Older checkpoints stored x as [T, C, D] and the DE ring as
    [B, D]; they must load losslessly into the chain-minor layout."""
    out = str(tmp_path / "chains")
    s = _run(out)
    path = os.path.join(out, "checkpoint.npz")
    data = dict(np.load(path))
    fmt = data.pop("__format__")
    data["x"] = np.moveaxis(data["x"], 1, 2)  # back to the old [T, C, D]
    data["de/buf"] = data["de/buf"].T  # old [B, D]
    np.savez(path, __format__=fmt, **data)
    loaded, _ = load_checkpoint(path, s.state)
    np.testing.assert_array_equal(np.asarray(loaded.x), np.asarray(s.state.x))
    np.testing.assert_array_equal(
        np.asarray(loaded.de.buf), np.asarray(s.state.de.buf)
    )
