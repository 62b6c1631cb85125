"""Real multi-process jax.distributed coverage.

The reference's multi-rank code paths are never exercised by its CI — it
installs OpenMPI only so mpi4py builds, then runs single-process
(SURVEY.md §4, .github/workflows/ci_test.yml:30-46). Here we do strictly
better: launch TWO actual OS processes, join them through
``initialize_distributed`` (the ``mpirun`` analogue), build the
(temp x chain) mesh of ``make_pt_mesh`` with the chain axis tiling the
processes, and run the jitted sampler step program collectively
(parallel/distributed.py).
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_distributed_worker.py")
_SAMPLER_WORKER = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "_distributed_sampler_worker.py"
)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_mesh_step():
    port = _free_port()
    env = dict(os.environ)
    # The worker pins its own platform/device-count flags.
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=420)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, acc, swaps, covtr, beta1 = line.split()
                results[int(pid)] = (int(acc), int(swaps), float(covtr), float(beta1))
    assert set(results) == {0, 1}, results
    # Both processes computed the identical global result (SPMD lockstep —
    # the reference needed explicit barriers/bcast for this).
    assert results[0] == results[1], results
    acc, swaps, covtr, beta1 = results[0]
    assert acc > 0  # the collective program actually sampled
    assert swaps > 0  # ppermute DEO exchanges happened across the mesh
    assert covtr > 0
    assert 0 < beta1 < 1  # adaptive sharded ladder stayed ordered (also
    # asserted in-worker, including that it moved off the geometric start)


@pytest.mark.slow
def test_two_process_ptsampler_sample_and_resume(tmp_path):
    """`PTSampler.sample()` itself (not just the kernel) across two real
    processes: per-process chain files, pooled replicated statistics,
    multi-process checkpoint + resume (the
    reference's whole launch model is ``mpirun -np N``, README.md:40-46)."""
    import json

    import numpy as np

    port = _free_port()
    outdir = str(tmp_path / "chains")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, _SAMPLER_WORKER, str(pid), "2", str(port), outdir],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    phase1, phase2 = {}, {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("PHASE1"):
                parts = line.split()
                phase1[int(parts[1])] = tuple(parts[2:])
            elif line.startswith("PHASE2"):
                parts = line.split()
                phase2[int(parts[1])] = tuple(parts[2:])
    assert set(phase1) == {0, 1}, outs
    assert set(phase2) == {0, 1}, outs
    # Replicated pooled statistics identical across processes (SPMD lockstep).
    assert phase1[0] == phase1[1], phase1
    assert phase2[0] == phase2[1], phase2
    assert int(phase1[0][0]) > 0  # proposals actually counted

    # Reference-format cold chain file: initial row + 120 thinned rows, then
    # the resumed run extends it to 240 iterations total.
    chain0 = np.loadtxt(os.path.join(outdir, "chain_1.0.txt"), ndmin=2)
    assert chain0.shape == (241, 2 + 4), chain0.shape
    assert int(phase2[0][0]) == 240  # state.it after resume completes

    # Per-process all-chain part sidecars cover all chains between them.
    parts = sorted(
        f for f in os.listdir(outdir)
        if f.startswith("chain_all_1.0.c") and f.endswith(".json")
    )
    assert len(parts) == 2, os.listdir(outdir)
    covered = []
    for f in parts:
        with open(os.path.join(outdir, f)) as fh:
            meta = json.load(fh)
        assert meta["nchains_total"] == 8
        covered.extend(range(meta["chain_offset"], meta["chain_offset"] + meta["nchains"]))
    assert sorted(covered) == list(range(8)), covered

    # Checkpoint written by process 0 with full (replicated) state.
    assert os.path.isfile(os.path.join(outdir, "checkpoint.npz"))


_TEMPSHARD_WORKER = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "_distributed_tempshard_worker.py"
)


@pytest.mark.slow
def test_two_process_temperature_sharded_sample(tmp_path):
    """`PTSampler.sample()` with the TEMPERATURE axis spanning two real
    processes (the pod layout where replica exchange crosses the process
    boundary): swap_mode auto-routes to the ppermute DEO exchange, swaps
    actually cross the boundary, pooled statistics stay replicated, and only
    the cold-chain-owning process may vote in the neff stop decision."""
    import numpy as np

    port = _free_port()
    outdir = str(tmp_path / "chains")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, _TEMPSHARD_WORKER, str(pid), "2", str(port), outdir],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                parts = line.split()
                results[int(parts[1])] = parts[2:]
    assert set(results) == {0, 1}, outs
    it0, swaps0, jp0, acc0, owns0 = results[0]
    it1, swaps1, jp1, acc1, owns1 = results[1]
    assert (it0, swaps0, jp0, acc0) == (it1, swaps1, jp1, acc1), results
    assert int(it0) == 160
    assert int(swaps0) > 0  # cross-process ppermute exchanges happened
    assert (int(owns0), int(owns1)) == (1, 0)  # only process 0 owns the cold chain

    # The cold chain file is written by its owning process in reference format.
    chain0 = np.loadtxt(os.path.join(outdir, "chain_1.0.txt"), ndmin=2)
    assert chain0.shape == (161, 2 + 4), chain0.shape
