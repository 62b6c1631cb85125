"""Multi-process distribution helpers.

The reference distributes with ``mpirun -np N`` over mpi4py (README.md:40-46,
PTMCMCSampler.py:9-13); the equivalent here is one SPMD program over a device
mesh. On one host a single process drives every card: GPUs of a host are
joined all to all (NVLink), so the mesh is a plain reshape of
``jax.devices()`` and follows the algorithm alone. Several processes (one
per host, or the CPU test harness) join with :func:`initialize_distributed`
and lay the chain axis across processes.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

_initialized = False


def initialize_distributed(
    coordinator_address=None, num_processes=None, process_id=None, **kwargs
):
    """Join the multi-process group (idempotent).

    Pass ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id``. Called without them it is a single-process no-op,
    mirroring the reference's ``nompi4py.MPIDummy`` serial fallback
    (nompi4py.py:1-37).
    """
    global _initialized
    if _initialized or (coordinator_address is None and num_processes is None):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )
    _initialized = True


def make_pt_mesh(ntemp_devices=None, nchain_devices=1, devices=None,
                 temp_axis="temp", chain_axis="chain"):
    """2-D (temp, chain) device mesh.

    ``temp`` is the replica-exchange axis: adjacent temperatures exchange
    state every ``tskip`` iterations. ``chain`` is embarrassingly parallel
    (only the psum'd covariance moments cross it). In one process the mesh
    is a plain reshape of ``devices``. With several processes the chain axis
    tiles the processes and each process's own devices fill the temp axis,
    so replica exchange never leaves a process.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if ntemp_devices is None:
        ntemp_devices = n // nchain_devices
    assert ntemp_devices * nchain_devices <= n, (
        f"mesh {ntemp_devices}x{nchain_devices} needs more than {n} devices"
    )
    shape = (ntemp_devices, nchain_devices)
    nproc = jax.process_count()
    if nproc == 1:
        dmesh = np.asarray(devices[: ntemp_devices * nchain_devices]).reshape(shape)
        return Mesh(dmesh, (temp_axis, chain_axis))
    if nchain_devices % nproc != 0:
        raise ValueError(
            f"nchain_devices={nchain_devices} must be a multiple of the "
            f"process count {nproc} so the chain axis tiles across processes"
        )
    local_chain = nchain_devices // nproc
    per_proc = ntemp_devices * local_chain
    dmesh = np.empty(shape, dtype=object)
    procs = sorted({d.process_index for d in devices})
    if len(procs) < nproc:
        raise ValueError(f"devices span {len(procs)} processes; mesh needs {nproc}")
    for ci, p in enumerate(procs[:nproc]):
        local = [d for d in devices if d.process_index == p][:per_proc]
        if len(local) < per_proc:
            raise ValueError(
                f"process {p} has {len(local)} devices; mesh needs "
                f"{per_proc} per process"
            )
        block = np.asarray(local, dtype=object).reshape(ntemp_devices, local_chain)
        dmesh[:, ci * local_chain : (ci + 1) * local_chain] = block
    return Mesh(dmesh, (temp_axis, chain_axis))


def process_local_block(sampler_state):
    """Addressable (this-host) shards of the sharded positions — the
    analogue of an MPI rank's local chain for host-side I/O."""
    return [s.data for s in sampler_state.x.addressable_shards]
