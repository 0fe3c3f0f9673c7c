"""Atomic, async checkpointing in the JAX package's npz + meta.json
layout (port of ``repro.checkpoint.ckpt``; numpy only).

Layout:   <dir>/step_<n>/arrays.npz  +  meta.json

A save writes into a temporary directory and moves it into place with
``os.replace``, so a crashed writer never corrupts the latest step.  An
async save snapshots every leaf to host memory first (copies), so
training updates its tensors in place while the writer thread runs.
``restore`` rebuilds a target tree's structure from disk, checking every
leaf's presence and shape, as the JAX package's does (it places nothing
on a device: the caller converts, e.g. with ``params_from_jax``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
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
         async_: bool = False,
         extra_meta: dict | None = None) -> threading.Thread | None:
    """Write ``tree`` (nested dicts / tuples of numpy leaves) under
    <directory>/step_<step>, atomically; ``extra_meta`` is merged into
    meta.json.  Keeps the ``keep_last`` newest steps (0 keeps all).
    With ``async_`` the leaves are copied to host first and a writer
    thread is returned (join it to guarantee durability)."""
    os.makedirs(directory, exist_ok=True)
    host = _flatten(tree)
    if async_:    # a snapshot: the caller goes on updating its tensors
        host = {k: np.array(v) for k, v in host.items()}

    def _write():
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

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


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


def _cast(arr: np.ndarray, like: np.ndarray) -> np.ndarray:
    """``arr`` in ``like``'s dtype; bfloat16 travels as its raw 2-byte
    pattern (an npz stores ml_dtypes' bfloat16 as void), reinterpreted,
    not converted."""
    two_byte = lambda a: a.dtype.kind == "V" or a.dtype.name == "bfloat16"
    if two_byte(arr) or two_byte(like):
        if not (two_byte(arr) and two_byte(like)):
            raise ValueError(f"cannot restore a {arr.dtype} leaf as {like.dtype}")
        return arr.view(like.dtype)
    return arr.astype(like.dtype, copy=False)


def restore(directory: str, step: int, target_tree):
    """Rebuild ``target_tree``'s structure (nested dicts / tuples of numpy
    leaves) from step ``step`` on disk, each leaf in the target leaf's
    dtype.  A missing leaf raises KeyError, a shape mismatch ValueError."""
    path = os.path.join(directory, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as data:
        def build(node, prefix):
            if isinstance(node, dict):
                return {k: build(v, prefix + (str(k),)) for k, v in node.items()}
            if isinstance(node, (tuple, list)):
                return type(node)(build(v, prefix + (str(i),))
                                  for i, v in enumerate(node))
            key = "/".join(prefix)
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr, ref = data[key], np.asarray(node)
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{key}: shape {arr.shape} != {ref.shape}")
            return _cast(arr, ref)

        return build(target_tree, ())
