"""Device-mesh sharding of the sampler state.

Replacement for the reference's MPI distribution model
(one rank per temperature, PTMCMCSampler.py:94-105 + mpi4py collectives,
SURVEY.md §2.1 C13): the temperature axis of every state array is sharded
over a ``jax.sharding.Mesh`` axis and the *same* jitted step program runs on
every device. GSPMD inserts the collectives the reference did by hand:

  * the swap permutation (gather/sweep/scatter, :660-691) becomes a
    take-along-axis over the sharded temperature axis -> all-to-all /
    collective-permute between devices;
  * the rank-0 covariance & DE-buffer broadcasts (:545-576) vanish — the
    Welford moments are computed from the (replicated-output) cold-chain rows
    and every device derives identical adaptation state;
  * the per-iteration barrier/bcast (:501, :523) is implicit in SPMD program
    order.

Chains-per-temperature is the embarrassingly parallel axis and can optionally
be sharded too (axis ``chain``) for very large chain counts.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..state import SamplerState


def make_temp_mesh(n_devices=None, devices=None, axis="temp"):
    """1-D mesh over the temperature axis."""
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.asarray(devices), (axis,))


def state_sharding(state: SamplerState, mesh: Mesh, axis="temp", chain_axis=None):
    """Build a NamedSharding pytree matching the SamplerState structure.

    Arrays with a leading temperature dimension shard on ``axis``; adaptation
    and DE-history state is replicated (every device computes it identically);
    scalars are replicated.
    """
    t = state.x.shape[0]
    c = state.x.shape[2]  # x is chain-minor [T, D, C]

    def spec_for(path, leaf):
        names = [getattr(p, "name", str(p)) for p in path]
        field = names[-1] if names else ""
        shape = np.shape(leaf)
        if field in ("x",):
            return P(axis, None, chain_axis)
        # swaps_accepted_lad is the ladder-adaptation snapshot of
        # swaps_accepted and must share its [T, C] placement (a replicated
        # snapshot would force GSPMD reshards on every windowed-rate delta);
        # swaps_proposed(_lad) [T] stays replicated like every
        # deterministically-updated counter.
        if field in ("lnlike", "lnprior", "naccepted", "swaps_accepted",
                     "swaps_accepted_lad"):
            return P(axis, chain_axis)
        if field == "betas":
            return P(axis)
        if field in ("jump_proposed", "jump_accepted"):
            return P(None, axis, chain_axis)
        if "stepsize" in names and shape == (t, c):
            return P(axis, chain_axis)
        return P()  # replicated: adapt, de, key, scalars

    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, spec_for(path, leaf)), state
    )


def shard_state(state: SamplerState, mesh: Mesh, axis="temp", chain_axis=None):
    """Place a (host or single-device) state onto the mesh."""
    sharding = state_sharding(state, mesh, axis=axis, chain_axis=chain_axis)
    return jax.device_put(state, sharding)


def host_local_block(arr):
    """Assemble this process's addressable region of a sharded array.

    Returns ``(block, index)`` where ``index`` is a list of sorted global
    index arrays, one per dimension; the local region is their cartesian
    product (true for any NamedSharding grid over a mesh: each process's
    shards tile a sub-box of the global array). The multi-process analogue of
    an MPI rank's local chain for host-side I/O (PTMCMCSampler.py:341-372 —
    each rank writes the rows it owns).
    """
    shards = arr.addressable_shards
    nd = arr.ndim
    sets = [set() for _ in range(nd)]
    for s in shards:
        for d, sl in enumerate(s.index):
            start = sl.start if sl.start is not None else 0
            stop = sl.stop if sl.stop is not None else arr.shape[d]
            sets[d].update(range(start, stop))
    index = [np.array(sorted(si), dtype=np.int64) for si in sets]
    offsets = [{int(g): k for k, g in enumerate(i)} for i in index]
    block = np.empty([len(i) for i in index], dtype=arr.dtype)
    for s in shards:
        data = np.asarray(s.data)
        starts = []
        for d, sl in enumerate(s.index):
            start = sl.start if sl.start is not None else 0
            starts.append(offsets[d][int(start)])
        block[tuple(slice(st, st + data.shape[d]) for d, st in enumerate(starts))] = data
    return block, index


def shard_state_global(state: SamplerState, mesh: Mesh, axis="temp", chain_axis=None):
    """Place host-replicated state onto a (possibly multi-process) mesh.

    Unlike :func:`shard_state` (plain ``device_put``), this works when the
    mesh spans processes and most devices are not addressable — the SPMD
    analogue of the reference scattering initial state from rank 0
    (PTMCMCSampler.py:99-105): every process supplies the identical full host
    array and materializes only its addressable shards.
    """
    import jax.numpy as jnp

    sharding = state_sharding(state, mesh, axis=axis, chain_axis=chain_axis)

    def place(leaf, sh):
        is_key = jnp.issubdtype(jnp.asarray(leaf).dtype, jax.dtypes.prng_key)
        if is_key:
            impl = jax.random.key_impl(leaf)
            data = np.asarray(jax.device_get(jax.random.key_data(leaf)))
        else:
            data = np.asarray(jax.device_get(leaf))
        arr = jax.make_array_from_callback(data.shape, sh, lambda idx: data[idx])
        if is_key:
            return jax.random.wrap_key_data(arr, impl=impl)
        return arr

    return jax.tree_util.tree_map(place, state, sharding)
