"""Checkpoint save/load for fusion state and pose graphs.

First-class replacement for the reference's unreachable
``GlobalCache::SaveToFile/ReadFromFile`` raw-fwrite path
(reference: tfusion/include/tfusion/GlobalCache.hpp:79-110, never called
because swapping is off at tfusion/src/topfu.cpp:67).  Any NamedTuple
state (DenseState, BlockState, PoseGraph) round-trips through a single
compressed ``.npz`` file; trajectories export in TUM format for ATE
tooling.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Sequence, Type, TypeVar

import jax
import jax.numpy as jnp
import numpy as np

T = TypeVar("T")


def save_state(path: str, state: Any) -> None:
    """Serialize a flat NamedTuple-of-arrays (tuples of arrays allowed)."""
    leaves, treedef = jax.tree.flatten(state)
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, __treedef__=str(treedef), **arrays)


def load_state(path: str, like: T) -> T:
    """Restore a state saved by save_state; ``like`` supplies the pytree
    structure and dtypes (shapes must match the saved config)."""
    data = np.load(path, allow_pickle=False)
    leaves, treedef = jax.tree.flatten(like)
    loaded = []
    for i, ref in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        if arr.shape != tuple(np.shape(ref)):
            raise ValueError(
                f"checkpoint leaf {i} shape {arr.shape} != expected "
                f"{np.shape(ref)} — config mismatch"
            )
        loaded.append(jnp.asarray(arr, dtype=ref.dtype))
    return jax.tree.unflatten(treedef, loaded)


def save_run(
    out_dir: str,
    state: Any,
    odom_poses: Sequence[np.ndarray],
    optimized_poses: Sequence[np.ndarray] | None = None,
    timestamps: Sequence[float] | None = None,
    metrics: dict | None = None,
) -> None:
    """Persist a full run: map/pose state + TUM trajectories + metrics."""
    from topfusion.io.trajectory import save_tum_trajectory

    os.makedirs(out_dir, exist_ok=True)
    save_state(os.path.join(out_dir, "state.npz"), state)
    save_tum_trajectory(
        os.path.join(out_dir, "trajectory_odom.txt"), odom_poses, timestamps
    )
    if optimized_poses is not None:
        save_tum_trajectory(
            os.path.join(out_dir, "trajectory_opt.txt"),
            optimized_poses,
            timestamps,
        )
    if metrics is not None:
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
