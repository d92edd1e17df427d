"""Checkpoint / resume.

The reference has no checkpointing — its nearest analogue is DiffEq's
in-memory ``saveat`` snapshots (SURVEY.md §5).  This package checkpoints
``(Y, t, step)`` between scan segments; resume re-enters the loop at the
saved state.  The default format is a plain ``.npz`` that round-trips any
dict-of-arrays pytree and needs nothing beyond numpy.  ``use_orbax=True``
writes with orbax-checkpoint instead (sharded-array aware: each process
writes its own shards, which a multi-process run needs); orbax is then
imported on demand.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import jax
import numpy as np


def _flatten_with_paths(tree) -> dict:
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(
            str(getattr(p, "key", getattr(p, "idx", p))) for p in path
        )
        flat[key] = np.asarray(leaf)
    return flat


def _unflatten_like(template, flat: dict):
    leaves_paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for path, leaf in leaves_paths:
        key = "/".join(
            str(getattr(p, "key", getattr(p, "idx", p))) for p in path
        )
        arr = flat[key]
        leaves.append(jax.numpy.asarray(arr, dtype=leaf.dtype))
    return jax.tree_util.tree_unflatten(treedef, leaves)


class CheckpointManager:
    """Directory of numbered checkpoints with ``save``/``restore``/``latest``.

    ``save(step, Y, t)`` writes atomically (tmp + rename).  ``restore(Y_like,
    step=None)`` returns ``(Y, t, step)`` with arrays cast to the template's
    dtypes (so an f64-written checkpoint restores cleanly into an f32 run
    and vice versa).
    """

    def __init__(self, directory: str, use_orbax: bool = False):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.use_orbax = use_orbax

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:012d}")

    def save(self, step: int, Y: dict, t: float) -> str:
        path = self._path(step)
        if self.use_orbax:
            import orbax.checkpoint as ocp

            ckptr = ocp.StandardCheckpointer()
            # sharded jax.Arrays are passed through as-is: orbax writes each
            # device's shards directly (no gather-to-host / full
            # replication on a mesh); host leaves are materialized
            Y_save = jax.tree_util.tree_map(
                lambda x: x if isinstance(x, jax.Array) else np.asarray(x), Y
            )
            ckptr.save(
                os.path.abspath(path) + ".orbax",
                {"Y": Y_save, "t": float(t)},
                force=True,
            )
            ckptr.wait_until_finished()
            return path + ".orbax"
        flat = _flatten_with_paths(Y)
        tmp = path + ".tmp.npz"
        np.savez(tmp, __t=float(t), **flat)
        os.replace(tmp, path + ".npz")
        return path + ".npz"

    def steps(self):
        out = []
        for name in os.listdir(self.directory):
            # only completed checkpoints count — an interrupted save leaves
            # a .tmp.npz that must not be selected by latest()/restore()
            if name.startswith("step_") and (
                name.endswith(".npz") and not name.endswith(".tmp.npz")
                or name.endswith(".orbax")
            ):
                out.append(int(name.split("_")[1].split(".")[0]))
        return sorted(set(out))

    def latest(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    @staticmethod
    def _dtypes_differ(orbax_path: str, Y_template: dict) -> bool:
        """True when any checkpointed 'Y' leaf dtype differs from the
        template's (the one condition under which the host-side cast
        fallback is the right move).  Conservative: if the metadata itself
        cannot be read, report False so the original error propagates."""
        try:
            import orbax.checkpoint as ocp

            ckptr = ocp.StandardCheckpointer()
            meta = ckptr.metadata(os.path.abspath(orbax_path))
            tree = getattr(meta, "item_metadata", meta)
            if isinstance(tree, dict) and "Y" in tree:
                tree = tree["Y"]
            def _dtype_by_key(t):
                return {
                    "/".join(
                        str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path
                    ): getattr(leaf, "dtype", None)
                    for path, leaf in jax.tree_util.tree_flatten_with_path(
                        t, is_leaf=lambda x: hasattr(x, "dtype")
                    )[0]
                }

            saved = _dtype_by_key(tree)
            tmpl = _dtype_by_key(Y_template)
            common = set(saved) & set(tmpl)
            if not common:
                return False
            return any(
                saved[k] is not None
                and tmpl[k] is not None
                and np.dtype(saved[k]) != np.dtype(tmpl[k])
                for k in common
            )
        except Exception:
            return False

    def restore(self, Y_template: dict, step: Optional[int] = None) -> Tuple:
        step = self.latest() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._path(step)
        if os.path.exists(path + ".orbax"):
            import orbax.checkpoint as ocp

            ckptr = ocp.StandardCheckpointer()

            def _abstract(x):
                # sharded template leaves restore straight onto their mesh
                # shardings (per-shard reads, no full host replication)
                if isinstance(x, jax.Array):
                    return jax.ShapeDtypeStruct(
                        x.shape, x.dtype, sharding=x.sharding
                    )
                return np.asarray(x)

            target = {
                "Y": jax.tree_util.tree_map(_abstract, Y_template),
                "t": 0.0,
            }
            try:
                restored = ckptr.restore(
                    os.path.abspath(path) + ".orbax", target
                )
            except Exception as err:
                # Only a dtype-mismatched checkpoint (e.g. f64-written ->
                # f32 run) justifies the host-replicated fallback restore;
                # anything else (corrupt file, missing key, mesh mismatch)
                # must surface, not be masked by a retry that defeats the
                # per-shard-read memory benefit.
                if not self._dtypes_differ(path + ".orbax", Y_template):
                    raise RuntimeError(
                        f"orbax restore of {path}.orbax failed and the "
                        "checkpoint dtypes match the template (not a cast "
                        "issue) — see the underlying error"
                    ) from err
                # dtype-mismatched checkpoint: fall back to host-side
                # restore + cast + re-placement
                restored = ckptr.restore(
                    os.path.abspath(path) + ".orbax",
                    {
                        "Y": jax.tree_util.tree_map(np.asarray, Y_template),
                        "t": 0.0,
                    },
                )
                Y = jax.tree_util.tree_map(
                    lambda tmpl, v: (
                        jax.device_put(
                            np.asarray(v, dtype=tmpl.dtype), tmpl.sharding
                        )
                        if isinstance(tmpl, jax.Array)
                        else jax.numpy.asarray(v, dtype=tmpl.dtype)
                    ),
                    Y_template,
                    restored["Y"],
                )
                return Y, float(restored["t"]), step
            Y = jax.tree_util.tree_map(
                lambda tmpl, v: (
                    v
                    if isinstance(v, jax.Array)
                    and v.dtype == getattr(tmpl, "dtype", None)
                    else jax.numpy.asarray(v, dtype=tmpl.dtype)
                ),
                Y_template,
                restored["Y"],
            )
            return Y, float(restored["t"]), step
        data = np.load(path + ".npz")
        t = float(data["__t"])
        flat = {k: data[k] for k in data.files if k != "__t"}
        return _unflatten_like(Y_template, flat), t, step
