"""The JAX package's npz + meta.json checkpoint layout, read and written
(port of ``repro.checkpoint.ckpt``'s synchronous save and its readers;
numpy only).

Layout:   <dir>/step_<n>/arrays.npz  +  meta.json

A save writes into a temporary directory and moves it into place with
``os.replace``, so a crashed writer never corrupts the latest step.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np


def _flatten(tree, prefix=()) -> dict[str, np.ndarray]:
    """'/'-joined paths (dict keys, sequence indices) -> numpy leaves, as
    the JAX package's ``tree_flatten_with_path`` names them."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (str(i),)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def save(directory: str, step: int, tree, *, keep_last: int = 3,
         extra_meta: dict | None = None) -> None:
    """Write ``tree`` (nested dicts / tuples of numpy leaves) under
    <directory>/step_<step>, atomically; ``extra_meta`` is merged into
    meta.json.  Keeps the ``keep_last`` newest steps (0 keeps all)."""
    os.makedirs(directory, exist_ok=True)
    host = _flatten(tree)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp.{os.getpid()}.{time.time_ns()}"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **host)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({**(extra_meta or {}), "step": step, "keys": sorted(host)}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _trim(directory, keep_last)


def _trim(directory: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


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
