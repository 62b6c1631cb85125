"""Full-state structured checkpointing.

The reference's only recovery story is re-reading chain text files, which
loses all adaptation state (covariance, DE buffer, NUTS step size, RNG) —
SURVEY.md §5 / PTMCMCSampler.py:290-319. Here the complete
:class:`SamplerState` pytree round-trips through one ``.npz`` plus a small
JSON sidecar, so a resumed run continues *exactly* (same RNG stream, same
adaptation trajectory).

Leaves are keyed by their **pytree path** (``"adapt/cov"``, ``"x"``, ...),
not by flatten order, so any evolution of the state layout — reordered,
added, or removed fields — fails loudly with a named mismatch instead of
silently loading a shifted same-shape array into the wrong slot.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np

_FORMAT_KEY = "__format__"
_FORMAT = "ptmcmc-ckpt-v2-pathkeys"


def _is_typed_key(leaf):
    try:
        import jax.numpy as jnp

        return jnp.issubdtype(jnp.asarray(leaf).dtype, jax.dtypes.prng_key)
    except TypeError:
        return False


def _path_name(path):
    """Render a jax key path as a stable 'a/b/0' string."""
    parts = []
    for p in path:
        if hasattr(p, "name"):  # GetAttrKey / DictKey(name=...)
            parts.append(str(p.name))
        elif hasattr(p, "key"):  # DictKey
            parts.append(str(p.key))
        elif hasattr(p, "idx"):  # SequenceKey
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts) if parts else "<root>"


def save_checkpoint(path, state, meta=None):
    flat = jax.tree_util.tree_flatten_with_path(state)[0]
    arrays = {_FORMAT_KEY: np.asarray(_FORMAT)}
    for leaf_path, leaf in flat:
        name = _path_name(leaf_path)
        if _is_typed_key(leaf):
            # Typed PRNG keys serialize as their raw uint32 data.
            leaf = jax.random.key_data(leaf)
        arrays[name] = np.asarray(jax.device_get(leaf))
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    if meta is not None:
        with open(path + ".json", "w") as f:
            json.dump(meta, f)


def load_checkpoint(path, template_state):
    """Restore a state pytree saved by :func:`save_checkpoint`.

    ``template_state`` provides the tree structure (build it with the same
    config used originally). Every template leaf must find a same-named,
    same-shaped array in the file; anything else raises ``ValueError`` so
    callers can fall back to the chain-file resume path.
    """
    flat, treedef = jax.tree_util.tree_flatten_with_path(template_state)
    with np.load(path) as data:
        if _FORMAT_KEY not in data or str(data[_FORMAT_KEY]) != _FORMAT:
            raise ValueError(
                "checkpoint uses an unrecognized (or legacy index-keyed) "
                "layout; refusing to guess leaf assignment"
            )
        stored = {k: data[k] for k in data.files if k != _FORMAT_KEY}
    loaded = []
    for leaf_path, tpl in flat:
        name = _path_name(leaf_path)
        if name not in stored:
            # Forward compatibility for the ladder-window snapshot counters:
            # a ``<counter>_lad`` leaf added after a checkpoint was written
            # backfills from its cumulative counter — "snapshot taken at
            # resume" is exactly the right window semantics — instead of
            # rejecting the whole checkpoint and silently discarding every
            # piece of adaptive state via the chain-file fallback.
            base = name[: -len("_lad")] if name.endswith("_lad") else None
            if base is not None and base in stored:
                stored[name] = stored[base]
            else:
                raise ValueError(f"checkpoint is missing state leaf {name!r}")
        new = stored[name]
        if _is_typed_key(tpl):
            # Restore the typed key with the template's PRNG impl.
            impl = jax.random.key_impl(tpl)
            if jax.random.key_data(tpl).shape != new.shape:
                raise ValueError(
                    f"checkpoint leaf {name!r} (PRNG key) shape {new.shape} "
                    f"does not match current impl {impl}"
                )
            loaded.append(jax.random.wrap_key_data(new, impl=impl))
            continue
        if np.shape(tpl) != new.shape:
            # Layout migration: positions went chain-minor
            # ([T, C, D] -> [T, D, C]) and the DE ring [B, D] -> [D, B].
            # Old checkpoints transpose losslessly.
            if name == "x" and new.ndim == 3 and np.shape(tpl) == (
                new.shape[0], new.shape[2], new.shape[1]
            ):
                new = np.moveaxis(new, 2, 1)
            elif name == "de/buf" and new.ndim == 2 and np.shape(tpl) == (
                new.shape[1], new.shape[0]
            ):
                new = new.T
            else:
                raise ValueError(
                    f"checkpoint leaf {name!r} shape {new.shape} does not "
                    f"match current config {np.shape(tpl)}"
                )
        loaded.append(new)
    meta = None
    if os.path.isfile(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return jax.tree_util.tree_unflatten(treedef, loaded), meta
