"""NUTS trajectory capture and dump facility.

Parity target: the reference's ``Trajectory`` buffer (nutsjump.py:294-376) and
the ``trajectoryDir`` / ``write_burnin`` dump mechanism (nutsjump.py:400-433,
:818-835), which write every NUTS trajectory's plus branch, minus branch, and
the used (start -> chosen sample) path to text files for debugging and
visualization.

Design: the reference grows numpy buffers imperatively inside the
recursion; here the capture kernel (``proposals.nuts.make_nuts(capture=True)``)
fills fixed-size device buffers for the designated chain (temperature 0,
chain 0) inside the jitted program, and the host-side :class:`TrajectoryWriter`
formats them into files with the reference's exact naming scheme. The
:class:`Trajectory` class mirrors the reference buffer API for users who drove
it directly.

Positions are recorded in the whitened coordinate system, as in the reference
(nutsjump.py:523-527 stores ``thetaprime``, the whitened leapfrog position).
"""

from __future__ import annotations

import os

import chex
import jax
import jax.numpy as jnp
import numpy as np


@chex.dataclass
class TrajCapture:
    """Device-side capture of one NUTS trajectory for one designated chain.

    ``ind`` values are the global leapfrog-step indices of the reference
    (nutsjump.py:713-714, :522-527): the start sample has index 0 on the plus
    buffer, and every subsequent leaf increments a global counter regardless of
    branch.
    """

    plus: jax.Array  # [L, D] whitened positions, plus branch
    minus: jax.Array  # [L, D] whitened positions, minus branch
    ind_plus: jax.Array  # [L] global step index per plus row
    ind_minus: jax.Array  # [L] global step index per minus row
    len_plus: jax.Array  # scalar i32
    len_minus: jax.Array  # scalar i32
    used_ind: jax.Array  # scalar i32: global index of the chosen sample
    active: jax.Array  # scalar bool: a NUTS jump ran this iteration


def empty_capture(config) -> TrajCapture:
    leaves = 1 << config.nuts_max_depth
    d, dt = config.ndim, config.dtype
    return TrajCapture(
        plus=jnp.zeros((leaves, d), dt),
        minus=jnp.zeros((leaves, d), dt),
        ind_plus=jnp.zeros((leaves,), jnp.int32),
        ind_minus=jnp.zeros((leaves,), jnp.int32),
        len_plus=jnp.zeros((), jnp.int32),
        len_minus=jnp.zeros((), jnp.int32),
        used_ind=jnp.zeros((), jnp.int32),
        active=jnp.zeros((), bool),
    )


class Trajectory:
    """Host-side view over one captured trajectory.

    Provides the query surface users of the reference's trajectory buffer
    relied on — ``get_trajectory(which)`` and ``get_used_trajectory(ind)``
    (behavioral target: nutsjump.py:294-376) — but is a completely different
    structure: the device capture kernel already produced the full branch
    arrays, so this class is just two append-only sample lists with the
    lookups computed on demand. There is no preallocated/growable buffer
    machinery; incremental ``add_sample`` exists only for host-side users who
    assemble a trajectory by hand.
    """

    def __init__(self, ndim, bufsize=None):
        del bufsize  # accepted for signature compatibility; lists self-grow
        self.ndim = int(ndim)
        self._branches = {"plus": [], "minus": []}  # lists of (theta, ind)

    def reset(self):
        self._branches = {"plus": [], "minus": []}

    def add_sample(self, theta, ind, which="plus"):
        self._branches[which].append((np.asarray(theta, np.float64), int(ind)))

    def length(self):
        return len(self._branches["plus"]) + len(self._branches["minus"])

    def _stack(self, which):
        samples = self._branches[which]
        if not samples:
            return np.zeros((0, self.ndim)), np.zeros((0,))
        thetas = np.stack([t for t, _ in samples])
        inds = np.asarray([i for _, i in samples], np.float64)
        return thetas, inds

    def get_trajectory(self, which="both"):
        """Branch positions + global step indices; ``both`` orders the minus
        branch outward-end-first so the rows trace the full path left→right."""
        if which in ("plus", "minus"):
            return self._stack(which)
        plus, ip = self._stack("plus")
        minus, im = self._stack("minus")
        return (
            np.concatenate([minus[::-1], plus], axis=0),
            np.concatenate([im[::-1], ip]),
        )

    def get_used_trajectory(self, ind):
        """Leapfrog path from the start point to the sample with global step
        index ``ind``. The start sample lives at the head of the plus branch,
        so a minus-branch target is reached via start -> minus prefix."""
        plus, ip = self._stack("plus")
        minus, im = self._stack("minus")
        hits_p = np.flatnonzero(ip == ind)
        if hits_p.size:
            return plus[: hits_p[0] + 1]
        hits_m = np.flatnonzero(im == ind)
        if hits_m.size:
            return np.concatenate([plus[:1], minus[: hits_m[0] + 1]], axis=0)
        raise ValueError("Index not found")


def capture_to_trajectory(cap: dict, ndim: int) -> Trajectory:
    """Materialize a host :class:`Trajectory` from device capture arrays."""
    tr = Trajectory(ndim)
    plus = np.asarray(cap["plus"], np.float64)
    minus = np.asarray(cap["minus"], np.float64)
    ip = np.asarray(cap["ind_plus"])
    im = np.asarray(cap["ind_minus"])
    tr._branches["plus"] = [
        (plus[i], int(ip[i])) for i in range(int(cap["len_plus"]))
    ]
    tr._branches["minus"] = [
        (minus[i], int(im[i])) for i in range(int(cap["len_minus"]))
    ]
    return tr


class TrajectoryWriter:
    """Writes captured trajectories with the reference's file layout
    (nutsjump.py:818-835): during burn-in (and only if ``write_burnin``)
    ``burnin-{plus,minus,used}-NNNNNN.txt``, afterwards
    ``{plus,minus,used}-NNNNNN.txt`` numbered from the end of burn-in."""

    def __init__(self, trajectory_dir, nburn, write_burnin=False):
        if os.path.isfile(trajectory_dir):
            raise IOError("Not a directory: {0}".format(trajectory_dir))
        os.makedirs(trajectory_dir, exist_ok=True)
        self.dir = trajectory_dir
        self.nburn = nburn
        self.write_burnin = write_burnin

    def write(self, it, cap):
        """``cap``: host-side dict of TrajCapture leaves for one iteration."""
        if not bool(cap["active"]):
            return
        if it <= self.nburn and not self.write_burnin:
            return
        if it <= self.nburn:
            names = ["burnin-plus", "burnin-minus", "burnin-used"]
            num = it
        else:
            names = ["plus", "minus", "used"]
            num = it - self.nburn
        tr = capture_to_trajectory(cap, cap["plus"].shape[-1])
        paths = [
            os.path.join(self.dir, "{0}-{1:06d}.txt".format(n, num)) for n in names
        ]
        np.savetxt(paths[0], tr.get_trajectory("plus")[0])
        np.savetxt(paths[1], tr.get_trajectory("minus")[0])
        np.savetxt(paths[2], tr.get_used_trajectory(int(cap["used_ind"])))
