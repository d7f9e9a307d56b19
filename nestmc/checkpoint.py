"""Checkpoint / resume: serialize the scan carry, continue the scan.

The entire sampler state is one pytree (positions, proposal scales,
preconditioner moments, acceptance counters, RNG key, sweep counter), so a
checkpoint is "flatten the carry to npz". A resumed run continues bitwise-
identically to an uninterrupted one: the RNG is counter-based and keyed from
the carry, not from host state. Restart-based recovery is the idiomatic
accelerator batch-job failure-handling model (no elastic rescaling; chain count is fixed per run).

Format: <dir>/carry_<tag>.npz (leaves in tree-flatten order) +
<dir>/meta_<tag>.json (config + phase + leaf count for validation).
No orbax in the environment — plain npz is sufficient and dependency-free.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np


def save_checkpoint(directory: str, tag: str, carry, meta: dict) -> str:
    os.makedirs(directory, exist_ok=True)
    leaves, treedef = jax.tree_util.tree_flatten(carry)

    def to_host(leaf):
        if hasattr(leaf, "dtype") and jax.dtypes.issubdtype(
            leaf.dtype, jax.dtypes.prng_key
        ):
            return np.asarray(jax.random.key_data(leaf))
        return np.asarray(leaf)

    host = [to_host(leaf) for leaf in leaves]
    path = os.path.join(directory, f"carry_{tag}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{f"leaf_{i}": a for i, a in enumerate(host)})
    os.replace(tmp, path)
    meta = dict(meta)
    meta["num_leaves"] = len(host)
    meta["treedef"] = str(treedef)
    mpath = os.path.join(directory, f"meta_{tag}.json")
    with open(mpath + ".tmp", "w") as f:
        json.dump(meta, f, indent=2, default=str)
    os.replace(mpath + ".tmp", mpath)
    return path


def load_checkpoint(directory: str, tag: str, template):
    """Rebuild a carry from npz using ``template``'s tree structure.

    The treedef is NOT serialized executably (no pickle); the caller
    reconstructs the template from (model, config) and we validate leaf
    count + shapes against it.
    """
    with open(os.path.join(directory, f"meta_{tag}.json")) as f:
        meta = json.load(f)
    npz = np.load(os.path.join(directory, f"carry_{tag}.npz"))
    leaves, treedef = jax.tree_util.tree_flatten(template)
    if len(leaves) != meta["num_leaves"]:
        raise ValueError(
            f"checkpoint has {meta['num_leaves']} leaves, "
            f"template has {len(leaves)}; model/config mismatch"
        )
    new_leaves = []
    for i, ref in enumerate(leaves):
        arr = npz[f"leaf_{i}"]
        is_key = hasattr(ref, "dtype") and jax.dtypes.issubdtype(
            ref.dtype, jax.dtypes.prng_key
        )
        # PRNG keys round-trip through their uint32 key-data representation,
        # whose shape carries an extra trailing impl dimension.
        expected = (
            jax.random.key_data(ref).shape if is_key else np.shape(ref)
        )
        if tuple(arr.shape) != tuple(expected):
            raise ValueError(
                f"leaf {i} shape {arr.shape} != template {tuple(expected)}"
            )
        if is_key:
            arr = jax.random.wrap_key_data(arr.astype(np.uint32))
        new_leaves.append(arr)
    carry = jax.tree_util.tree_unflatten(treedef, new_leaves)
    return carry, meta


def latest_tag(directory: str) -> str | None:
    tags = []
    if not os.path.isdir(directory):
        return None
    for fn in os.listdir(directory):
        if fn.startswith("meta_") and fn.endswith(".json"):
            tags.append(fn[len("meta_"):-len(".json")])
    if not tags:
        return None
    # tags are zero-padded "<phase>_<segment>" strings; lexicographic works
    # within a phase; prefer sample-phase over warmup-phase checkpoints.
    def rank(t):
        phase = 0 if t.startswith("warmup") else 1
        return (phase, t)
    return sorted(tags, key=rank)[-1]
