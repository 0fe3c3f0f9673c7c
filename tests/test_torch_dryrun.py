"""The port's per-rank memory report (``repro_torch.launch.dryrun``) against
the JAX package: every arch x ``SHAPES`` cell x mesh ((16, 16) and
(2, 16, 16) with a "pod" axis), its per-rank bytes of params, moments,
residual, batch and decode caches equal to the bytes JAX's own specs give
(``jax.eval_shape`` trees under ``AbstractMesh``, the JAX dry-run's cell
configs; a ring's positions counted at the port's int64), and its copies
of ``microbatches_for``, ``moment_dtype_for``, ``model_flops`` and the
param counts equal to JAX's, read from one
subprocess that imports ``repro.launch.dryrun`` (whose first line sets
512 host devices, so it never runs in a test process)."""

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.sharding import rules as JR
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun as D

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.ShapeDtypeStruct((2,), jnp.uint32)
JMESH = {"16x16": ((16, 16), ("data", "model")),
         "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

_HELPERS = r"""
import json
import jax.numpy as jnp
from repro.configs import ARCHS, SHAPES, get_config
from repro.launch import dryrun as D
out = {}
for arch in ARCHS:
    cfg = get_config(arch)
    out[arch] = {"params": cfg.param_count(), "active": cfg.active_param_count(),
                 "moment": jnp.dtype(D.moment_dtype_for(cfg)).name,
                 "micro": {s: D.microbatches_for(cfg, b) for s, (_, b, _) in SHAPES.items()},
                 "flops": {s: D.model_flops(cfg, s) for s in SHAPES}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_helpers():
    """JAX's dry-run helpers for every arch, from a subprocess."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", _HELPERS], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _bytes(leaf, spec, sizes) -> int:
    n = math.prod(leaf.shape)
    for entry in tuple(spec):
        for axis in (() if entry is None else (entry,) if isinstance(entry, str)
                     else tuple(entry)):
            n //= sizes[axis]
    return n * jnp.dtype(leaf.dtype).itemsize


def _tree_bytes(tree, specs, sizes) -> int:
    from jax.sharding import PartitionSpec as P
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return sum(_bytes(a, s, sizes) for a, s in zip(leaves, spec_leaves))


@functools.lru_cache(maxsize=None)
def _jax_cell_cfg(arch, shape_name):
    """The JAX dry-run's ``run_cell`` config for a cell."""
    kind = jconfigs.SHAPES[shape_name][2]
    latent = kind != "train" and jconfigs.RECALKV_APPLICABLE[arch]
    cfg = jconfigs.get_config(arch, recalkv_ratio=0.5 if latent else None)
    if kind == "decode":
        cfg = dataclasses.replace(cfg, scan_layers=False)
    return cfg


def _jax_cell(arch, shape_name, mesh_name, moment_dtype):
    """Per-rank bytes of one cell from JAX's specs."""
    seq, batch, kind = jconfigs.SHAPES[shape_name]
    cfg = _jax_cell_cfg(arch, shape_name)
    shape, names = JMESH[mesh_name]
    mesh, sizes = AbstractMesh(shape, names), dict(zip(names, shape))
    p = jax.eval_shape(functools.partial(JT.init_params, cfg), KEY)
    out = {"params_bytes": _tree_bytes(p, JR.param_specs(p, mesh), sizes)}
    i32 = jnp.int32
    if kind == "decode":
        inputs = {"tokens": jax.ShapeDtypeStruct((batch,), i32),
                  "cur": jax.ShapeDtypeStruct((batch,), i32)}
        caches = jax.eval_shape(functools.partial(JT.init_decode_cache, cfg, batch, seq))
        # the port keeps a ring's positions as int64 (JAX: int32)
        caches = jax.tree_util.tree_map_with_path(
            lambda path, s: jax.ShapeDtypeStruct(s.shape, jnp.int64)
            if getattr(path[-1], "key", None) == "pos" else s, caches)
        out["cache_bytes"] = _tree_bytes(caches, JR.cache_specs(caches, mesh), sizes)
    else:
        inputs = {"tokens": jax.ShapeDtypeStruct((batch, seq), i32)}
        if kind == "train":
            inputs["labels"] = jax.ShapeDtypeStruct((batch, seq), i32)
        else:
            inputs["lengths"] = jax.ShapeDtypeStruct((batch,), i32)
        if cfg.cross_source_len:
            inputs["source"] = jax.ShapeDtypeStruct(
                (batch, cfg.cross_source_len, cfg.d_model), cfg.dtype)
    out["batch_bytes"] = _tree_bytes(inputs, JR.batch_specs(inputs, mesh), sizes)
    if kind == "train":
        st = jax.eval_shape(functools.partial(JA.init_state, cfg=JA.AdamWConfig(
            moment_dtype=moment_dtype)), p)
        st["residual"] = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), p)
        specs = JR.opt_specs(st, None, mesh)
        for k in ("mu", "nu", "residual"):
            out[f"{k}_bytes"] = _tree_bytes(st[k], specs[k], sizes)
    return out


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_memory_report_equals_jax_specs(arch, jax_helpers):
    """Every cell of ``arch``: the report's per-rank bytes equal those of
    JAX's specs on the same trees, its cell list and skips equal the JAX
    dry-run's (``shape_applicable``), and its helpers equal JAX's."""
    want_h = jax_helpers[arch]
    cfg = tconfigs.get_config(arch)
    assert D.param_count(cfg) == want_h["params"]
    assert D.active_param_count(cfg) == want_h["active"]
    assert str(D.moment_dtype_for(cfg))[6:] == want_h["moment"]
    for shape_name, (_, batch, kind) in tconfigs.SHAPES.items():
        assert D.microbatches_for(cfg, batch) == want_h["micro"][shape_name]
        assert tconfigs.shape_applicable(arch, shape_name) == \
            jconfigs.shape_applicable(arch, shape_name)
        for mesh_name in D.MESHES:
            rec = D.report(arch, shape_name, mesh_name)
            if rec["status"] == "skipped":
                assert not jconfigs.shape_applicable(arch, shape_name)[0]
                continue
            assert rec["model_flops"] == want_h["flops"][shape_name]
            mdt = jnp.bfloat16 if want_h["moment"] == "bfloat16" else jnp.float32
            want = _jax_cell(arch, shape_name, mesh_name, mdt)
            got = {k: rec[k] for k in want}
            assert got == want, (arch, shape_name, mesh_name)
            assert rec["gather_bytes"] == rec["params_full_bytes"] - rec["params_bytes"]
            assert (kind == "train") == ("microbatches" in rec)


def test_memory_report_cli_prints_every_cell(capsys):
    """``python -m repro_torch.launch.dryrun --arch qwen3-4b`` prints one
    JSON line a shape and mesh (``--all`` adds every arch); the pod mesh
    halves a rank's batch; a skipped cell says why."""
    recs = D.main(["--arch", "qwen3-4b"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines == recs and len(recs) == len(tconfigs.SHAPES) * len(D.MESHES)
    by = {(r["shape"], r["mesh"]): r for r in recs}
    assert by[("long_500k", "16x16")]["status"] == "skipped"
    assert by[("train_4k", "2x16x16")]["batch_bytes"] * 2 == \
        by[("train_4k", "16x16")]["batch_bytes"]
