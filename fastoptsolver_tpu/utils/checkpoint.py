"""Checkpoint / resume for solver state pytrees.

The reference has no persistence at all (SURVEY.md §5 — its only 'state' is
in-memory history lists). This framework's solver states are immutable
pytrees, so checkpointing is generic: flatten any state (``FISTAState``,
``LBFGSState``, a ``GramBatch``, a batched ``SolveResult``…) to one ``.npz``
plus a structure manifest, and restore it into an example pytree of the same
structure. Long batched solves resume exactly: ``fista_gram_batch``,
``solve_gram_batch`` and ``solve_lasso_batch`` (on one device or a mesh)
accept a saved ``BatchState`` as ``state0``; the state carries every
per-instance row the recurrence needs (momentum, step, iteration counter).

Format: ``<path>.npz`` holding leaves keyed ``leaf_000…``; structure is
validated on restore (leaf count + shapes), so mismatched checkpoints fail
loudly instead of silently transposing state.
"""
from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp


def save_pytree(path: str, tree) -> str:
    """Serialize a pytree of arrays to ``path`` (``.npz`` appended if
    missing). Returns the file path written."""
    leaves, _ = jax.tree_util.tree_flatten(tree)
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {f"leaf_{i:03d}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic: a crash never leaves a torn checkpoint
    return path


def restore_pytree(path: str, example):
    """Restore a pytree saved by :func:`save_pytree` into the structure of
    ``example`` (same treedef; leaf shapes/dtypes validated)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    leaves, treedef = jax.tree_util.tree_flatten(example)
    with np.load(path) as data:
        keys = sorted(data.files)
        if len(keys) != len(leaves):
            raise ValueError(
                f"checkpoint {path} has {len(keys)} leaves; example pytree has "
                f"{len(leaves)}"
            )
        restored = []
        for key, ex in zip(keys, leaves):
            arr = data[key]
            ex_arr = np.asarray(ex)
            if arr.shape != ex_arr.shape:
                raise ValueError(
                    f"checkpoint leaf {key} shape {arr.shape} != example "
                    f"{ex_arr.shape}"
                )
            restored.append(jnp.asarray(arr, ex_arr.dtype))
    return jax.tree_util.tree_unflatten(treedef, restored)
