"""Reader for the JAX package's npz + meta.json checkpoint layout
(port of the read half of ``repro.checkpoint.ckpt``; numpy only).

Layout:   <dir>/step_<n>/arrays.npz  +  meta.json
"""

from __future__ import annotations

import json
import os

import numpy as np


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "meta.json"))]
    return max(steps) if steps else None


def read_meta(directory: str, step: int) -> dict:
    """Load a checkpoint's meta.json (step, keys, and any extra_meta)."""
    with open(os.path.join(directory, f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)


def load_flat(directory: str, step: int) -> dict[str, np.ndarray]:
    """Load the raw 'path/to/leaf' -> array mapping of one checkpoint."""
    path = os.path.join(directory, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def tuple_paths(tree) -> list[str]:
    """'/'-joined paths of every sequence container in ``tree``."""
    out: list[str] = []

    def walk(node, prefix):
        if isinstance(node, (tuple, list)):
            out.append("/".join(prefix))
            for i, v in enumerate(node):
                walk(v, prefix + (str(i),))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (str(k),))

    walk(tree, ())
    return out


def unflatten(flat: dict[str, np.ndarray], seq_paths: list[str] | None = None):
    """Rebuild a tree from '/'-joined keys.  ``seq_paths`` says which
    containers are tuples; without it, containers keyed exactly 0..n-1
    become tuples and everything else a dict."""
    root: dict = {}
    for key, arr in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    seq_set = None if seq_paths is None else set(seq_paths)

    def _finalize(node, prefix):
        if not isinstance(node, dict):
            return node
        out = {k: _finalize(v, prefix + (k,)) for k, v in node.items()}
        if seq_set is not None:
            if "/".join(prefix) not in seq_set:
                return out
        elif not (out and all(k.isdigit() for k in out)):
            return out
        idx = sorted(out, key=int)
        if [int(k) for k in idx] == list(range(len(idx))):
            return tuple(out[k] for k in idx)
        return out

    return _finalize(root, ())
