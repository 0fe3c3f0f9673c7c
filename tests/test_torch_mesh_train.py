"""Training on a mesh in the port (``runtime.make_train_step(..., mesh=)``,
``train_loop(..., mesh=)``, ``launch.train --mesh``) against the
single-device steps: the port's and the JAX package's jitted one.

One spawn of four gloo ranks, a (2, 2) mesh over a ``FileStore`` under the
test's temporary directory (no TCP port), runs every case for three steps
on the float32 smoke configs at the batches of
``test_torch_train.py`` (4 x 32), each rank from the same params (JAX's
seed-0 init, carried by ``params_from_jax``); rank 0 writes the metrics
and the gathered params.  The cases, qwen3-4b: plain, accum
(``microbatches=2``), compress (accum with int8 error feedback), fsdp
(compress with the FSDP threshold lowered so every matrix also splits
over "data": the smoke leaves are below 16 MiB), bf16 moments, and a
batch of 3 rows, which "data" does not divide (replicated: every data
rank runs it whole); qwen3-moe-235b-a22b with accum (capacity, drops and
aux over the global microbatch).  Each is held to the port's
single-device step and to JAX's at ``test_train_steps_match_jax``'s
tolerances.  A mutant control takes the data shard before the microbatch
and must fail the MoE case.  A checkpoint written on the mesh restores on
one device (the port) and in JAX's ``train_loop``, with leaves equal to
the mesh's; one written by JAX resumes on the mesh.  The CLI's ``--mesh``
runs on the ranks (the process group already made) and equals the
single-device CLI.  The spawn joins under a time limit of its own, so a
hung collective fails the test, not the suite.
"""

import dataclasses
import functools
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro import checkpoint as jckpt
from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import make_train_step as j_make_train_step
from repro.runtime import train_loop as j_train_loop
from repro_torch import checkpoint as ckpt
from repro_torch.data import DataConfig, batch as data_batch
from repro_torch.launch import train as launch
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import map_tree, params_from_jax, params_to_jax
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.optim.adamw import zeros_like_tree
from repro_torch.runtime import TrainConfig, make_train_step, train_loop
from repro_torch.runtime.train_loop import restore_state

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

TIME_LIMIT_S = 240
SHAPE = (2, 2)
QWEN, MOE = "qwen3-4b", "qwen3-moe-235b-a22b"
# case -> (arch, TrainConfig keywords, rows, moment dtype, FSDP threshold)
CASES = {
    "plain": (QWEN, dict(microbatches=1), 4, "float32", None),
    "accum": (QWEN, dict(microbatches=2), 4, "float32", None),
    "compress": (QWEN, dict(microbatches=2, grad_compress=True), 4, "float32", None),
    "fsdp": (QWEN, dict(microbatches=2, grad_compress=True), 4, "float32", 1024),
    "bf16_moments": (QWEN, dict(microbatches=1), 4, "bfloat16", None),
    "rows3": (QWEN, dict(microbatches=1), 3, "float32", None),
    "moe_accum": (MOE, dict(microbatches=2), 4, "float32", None),
}
CLI = ["--arch", "qwen3-4b", "--smoke", "--batch", "4", "--seq", "32", "--steps", "3",
       "--grad-compress", "--microbatches", "2", "--device", "cpu"]
CKPT_TC = dict(warmup_steps=1, ckpt_every=2)
_RUNS = {}


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(JAX cfg, JAX params, port cfg) of the float32 smoke config, JAX's
    seed-0 init."""
    cfg = dataclasses.replace(jget(arch, smoke=True), dtype=jnp.float32)
    params = jax.jit(JT.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    return cfg, params, ModelConfig.from_dict(cfg.to_dict())


def _batch(cfg, step, rows=4):
    return data_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=32), "train", step, rows)


def _tc(case):
    return TrainConfig(warmup_steps=0, total_steps=5, **CASES[case][1])


def _opt(case):
    return AdamWConfig(moment_dtype=getattr(torch, CASES[case][3]))


def _state(params, case):
    st = init_state(params, _opt(case))
    if _tc(case).grad_compress:
        st["residual"] = zeros_like_tree(params, torch.float32)
    return st


def _clone(tree):
    return map_tree(tree, lambda t: t.clone())


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _mutant_rows(batch, i, k, mesh):
    """The data shard first, then the microbatch of it: other rows per
    microbatch than JAX's."""
    TL = sys.modules["repro_torch.runtime.train_loop"]    # the module, not the function
    return TL._slice(batch, i, k), TL._slice(TL._data_rows(batch, mesh), i, k)


def _run_case(case, models, mesh):
    from repro_torch.runtime import gather_train_state, shard_train_state
    from repro_torch.sharding import rules as R
    arch, _, rows, _, threshold = CASES[case]
    pcfg, params = models[arch]
    params = _clone(params)
    old = R.FSDP_THRESHOLD_BYTES
    if threshold is not None:
        R.FSDP_THRESHOLD_BYTES = threshold
    try:
        mp_, st = shard_train_state(pcfg, params, _state(params, case), mesh)
    finally:
        R.FSDP_THRESHOLD_BYTES = old
    step = make_train_step(pcfg, _opt(case), _tc(case), mesh=mesh)
    metrics = []
    for i in range(3):
        _, st, m = step(mp_, st, _batch(pcfg, i, rows))
        metrics.append({k: float(v) for k, v in m.items()})
    full, _ = gather_train_state(mp_, st)
    split = sorted({a for s in jax.tree.leaves(mp_.specs, is_leaf=lambda x: isinstance(
        x, tuple)) for e in s for a in ((e,) if isinstance(e, str) else e or ())})
    return {"metrics": metrics, "params": _leaves(params_to_jax(pcfg, full)),
            "step": int(st["step"]), "split_axes": split,
            "residual": "residual" in st}


def _rank_main(rank, world, folder):
    """One gloo rank: every case, the mutant, the checkpoints and the CLI;
    rank 0 saves the results to ``folder/result.pt``."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime import gather_train_state
    TL = sys.modules["repro_torch.runtime.train_loop"]
    mesh = make_test_mesh(*SHAPE, store=dist.FileStore(os.path.join(folder, "store"), world),
                          rank=rank, world_size=world)
    models = torch.load(os.path.join(folder, "models.pt"), weights_only=False)
    out = {case: _run_case(case, models, mesh) for case in CASES}
    good = TL._rows
    TL._rows = _mutant_rows
    try:
        out["mutant"] = _run_case("moe_accum", models, mesh)
    finally:
        TL._rows = good
    # a checkpoint written on the mesh (steps 0-1), and JAX's resumed here
    pcfg, params = models[QWEN]
    quiet = dict(logger=lambda *_: None)
    batch_fn = lambda s: _batch(pcfg, s)     # noqa: E731
    a = train_loop(pcfg, AdamWConfig(), TrainConfig(
        total_steps=2, ckpt_dir=os.path.join(folder, "ckpt_mesh"), **CKPT_TC), batch_fn,
        params=_clone(params), opt_state=init_state(_clone(params), AdamWConfig()),
        mesh=mesh, **quiet)
    full, _ = gather_train_state(a["params"], a["opt_state"])
    out["ckpt_mesh"] = {"losses": a["losses"], "params": _leaves(params_to_jax(pcfg, full))}
    b = train_loop(pcfg, AdamWConfig(), TrainConfig(
        total_steps=4, ckpt_dir=os.path.join(folder, "ckpt_jax"), **CKPT_TC), batch_fn,
        params=_clone(params), opt_state=init_state(_clone(params), AdamWConfig()),
        mesh=mesh, **quiet)
    out["ckpt_jax"] = {"losses": b["losses"]}
    out["cli"] = launch.main(CLI + ["--mesh", "2,2", "--dist-backend", "gloo"])["losses"]
    out["stats"] = dict(mesh.stats)
    dist.destroy_process_group()
    if rank == 0:
        torch.save(out, os.path.join(folder, "result.pt"))


def _spawn(folder):
    world = SHAPE[0] * SHAPE[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, folder)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIME_LIMIT_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"mesh {SHAPE}: ranks still running after {TIME_LIMIT_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return torch.load(os.path.join(folder, "result.pt"), weights_only=False)


def _jax_straight():
    """JAX's train loop over 4 steps from the seed-0 model, no checkpoint
    (the reference of every resumed run)."""
    if "straight" not in _RUNS:
        cfg, params, _ = _model(QWEN)
        _RUNS["straight"] = j_train_loop(
            cfg, JA.AdamWConfig(), JTrainConfig(warmup_steps=1, total_steps=4),
            lambda s: {k: jnp.asarray(v) for k, v in _batch(cfg, s).items()},
            params=params, opt_state=JA.init_state(params, JA.AdamWConfig()),
            logger=lambda *_: None)
    return _RUNS["straight"]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The spawn's results; JAX's step-2 checkpoint written first, for the
    ranks to resume."""
    folder = str(tmp_path_factory.mktemp("mesh_train"))
    models = {}
    for arch in (QWEN, MOE):
        _, jp, pcfg = _model(arch)
        models[arch] = (pcfg, params_from_jax(pcfg, jax.tree.map(np.asarray, jp),
                                              device="cpu"))
    torch.save(models, os.path.join(folder, "models.pt"))
    cfg, params, _ = _model(QWEN)
    j_train_loop(cfg, JA.AdamWConfig(), JTrainConfig(
        total_steps=2, ckpt_dir=os.path.join(folder, "ckpt_jax"), **CKPT_TC),
        lambda s: {k: jnp.asarray(v) for k, v in _batch(cfg, s).items()}, params=params,
        opt_state=JA.init_state(params, JA.AdamWConfig()), logger=lambda *_: None)
    out = _spawn(folder)
    out["folder"] = folder
    return out


# ---------------------------------------------------------------------------
# the references
# ---------------------------------------------------------------------------

def _jax_steps(case, n=3):
    """JAX's jitted ``make_train_step`` for ``case``: (params leaves,
    metrics per step); once per case (fsdp's math is compress's)."""
    key = "compress" if case == "fsdp" else case
    if key not in _RUNS:
        arch, kw, rows, mdt, _ = CASES[key]
        cfg, params, _ = _model(arch)
        opt = JA.AdamWConfig(moment_dtype=getattr(jnp, mdt))
        tc = JTrainConfig(warmup_steps=0, total_steps=5, **kw)
        st = JA.init_state(params, opt)
        if tc.grad_compress:
            st["residual"] = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        step = jax.jit(j_make_train_step(cfg, opt, tc))
        ms = []
        for i in range(n):
            params, st, m = step(params, st, {k: jnp.asarray(v)
                                              for k, v in _batch(cfg, i, rows).items()})
            ms.append({k: float(v) for k, v in m.items()})
        _RUNS[key] = (_leaves(params), ms)
    return _RUNS[key]


def _port_steps(case, n=3):
    """The port's single-device step for ``case``: (params leaves, metrics)."""
    if ("port", case) not in _RUNS:
        arch, _, rows, _, _ = CASES[case]
        _, jp, pcfg = _model(arch)
        params = params_from_jax(pcfg, jax.tree.map(np.asarray, jp), device="cpu")
        st = _state(params, case)
        step = make_train_step(pcfg, _opt(case), _tc(case))
        ms = []
        for i in range(n):
            params, st, m = step(params, st, _batch(pcfg, i, rows))
            ms.append({k: float(v) for k, v in m.items()})
        _RUNS[("port", case)] = (_leaves(params_to_jax(pcfg, params)), ms)
    return _RUNS[("port", case)]


def _close(case, got, want):
    """``test_train_steps_match_jax``'s limits: loss, grad_norm and lr each
    step within 1e-5 relative (compressed: grad_norm past the first step
    1e-4); params to their leaf's norm within 1e-5 and their max within
    1e-4, or, where an element one rounding apart turns into a full Adam
    step of it, within 1e-3 of the norm.  Such rounding is int8
    compression's (a gradient element within an ulp of a tie) and bf16
    moments' (a moment within an ulp of a stochastic-rounding boundary:
    the mesh sums a gradient in another order).  Returns the first miss,
    or None."""
    tc = _tc(case)
    rounding = tc.grad_compress or CASES[case][3] == "bfloat16"
    (gp, gm), (wp, wm) = got, want
    for i, (g, w) in enumerate(zip(gm, wm, strict=True)):
        for k in ("loss", "grad_norm", "lr"):
            rel = 1e-4 if tc.grad_compress and k == "grad_norm" and i else 1e-5
            if abs(g[k] - w[k]) > rel * abs(w[k]):
                return f"step {i} {k}: {g[k]} vs {w[k]}"
    norm_tol = 1e-3 if rounding else 1e-5
    for j, (a, b) in enumerate(zip(wp, gp, strict=True)):
        if np.linalg.norm(b - a) > norm_tol * max(np.linalg.norm(a), 1e-30):
            return f"leaf {j}: {np.linalg.norm(b - a) / np.linalg.norm(a):.3e} of its norm"
        if not rounding and np.abs(b - a).max() > 1e-4 * np.abs(a).max():
            return f"leaf {j}: max {np.abs(b - a).max():.3e}"
    return None


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_mesh_steps_match_single_device(case, mesh_runs):
    """Three mesh steps of ``case`` against the port's single-device step
    and JAX's jitted step on the same batches (``_close``)."""
    got = mesh_runs[case]
    pair = (got["params"], got["metrics"])
    assert _close(case, pair, _port_steps(case)) is None, _close(case, pair, _port_steps(case))
    assert _close(case, pair, _jax_steps(case)) is None, _close(case, pair, _jax_steps(case))
    assert got["step"] == 3 and got["residual"] == _tc(case).grad_compress
    if case == "fsdp":
        assert got["split_axes"] == ["data", "model"]
    elif case in ("plain", "moe_accum"):      # smoke leaves stay below the threshold
        assert got["split_axes"] == ["model"]


def test_mutant_data_shard_first_fails_moe(mesh_runs):
    """Taking each data rank's rows before the microbatch gives the MoE
    other row sets a microbatch, so other capacity drops and aux: the
    control must miss the single-device step that the real order meets."""
    got = mesh_runs["mutant"]
    assert _close("moe_accum", (got["params"], got["metrics"]),
                  _port_steps("moe_accum")) is not None


def test_checkpoints_cross_mesh_device_and_jax(mesh_runs, tmp_path):
    """Mesh -> one device -> JAX and back: the step-2 checkpoint the mesh
    wrote holds the mesh's gathered leaves bit for bit, restores on one
    device in the port and in JAX's ``train_loop``, each of which resumes
    to JAX's straight 4-step run (losses 1e-5, params 1e-5 of their norm);
    JAX's step-2 checkpoint resumed on the mesh gives the same losses."""
    cfg, params, pcfg = _model(QWEN)
    want = _jax_straight()
    folder = mesh_runs["folder"]
    src = os.path.join(folder, "ckpt_mesh")
    assert ckpt.latest_step(src) == 2
    np.testing.assert_allclose(mesh_runs["ckpt_mesh"]["losses"], want["losses"][:2], rtol=1e-5)
    flat = ckpt.load_flat(src, 2)
    tree = params_to_jax(pcfg, params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                               device="cpu"))
    stored = _leaves(jax.tree_util.tree_map_with_path(
        lambda path, _: flat["params/" + "/".join(
            str(getattr(p, "key", getattr(p, "idx", p))) for p in path)], tree))
    for a, b in zip(mesh_runs["ckpt_mesh"]["params"], stored, strict=True):
        np.testing.assert_array_equal(a, b)
    # one device, the port
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    for d in (port_dir, jax_dir):
        shutil.copytree(src, d)
    pp = params_from_jax(pcfg, jax.tree.map(np.asarray, params), device="cpu")
    rp, _ = restore_state(pcfg, port_dir, 2, pp, init_state(pp, AdamWConfig()))
    for a, b in zip(stored, _leaves(params_to_jax(pcfg, rp)), strict=True):
        np.testing.assert_array_equal(a, b)
    quiet = dict(logger=lambda *_: None)
    out = train_loop(pcfg, AdamWConfig(), TrainConfig(
        total_steps=4, ckpt_dir=port_dir, **CKPT_TC), lambda s: _batch(pcfg, s),
        params=pp, opt_state=init_state(pp, AdamWConfig()), **quiet)
    np.testing.assert_allclose(out["losses"], want["losses"][2:], rtol=1e-5)
    # JAX
    back = jckpt.restore(jax_dir, 2, {"params": params,
                                      "opt": JA.init_state(params, JA.AdamWConfig())})
    for a, b in zip(stored, _leaves(back["params"]), strict=True):
        np.testing.assert_array_equal(a, b)
    jout = j_train_loop(cfg, JA.AdamWConfig(), JTrainConfig(
        total_steps=4, ckpt_dir=jax_dir, **CKPT_TC),
        lambda s: {k: jnp.asarray(v) for k, v in _batch(cfg, s).items()}, params=params,
        opt_state=JA.init_state(params, JA.AdamWConfig()), **quiet)
    np.testing.assert_allclose(jout["losses"], want["losses"][2:], rtol=1e-5)
    for a, b in zip(_leaves(want["params"]), _leaves(jout["params"]), strict=True):
        assert np.linalg.norm(b - a) <= 1e-5 * max(np.linalg.norm(a), 1e-30)
    # JAX's checkpoint resumed on the mesh
    np.testing.assert_allclose(mesh_runs["ckpt_jax"]["losses"], want["losses"][2:], rtol=1e-5)
    assert ckpt.latest_step(os.path.join(folder, "ckpt_jax")) == 4


def test_train_cli_mesh_equals_one_device(mesh_runs):
    """``launch.train --mesh 2,2 --dist-backend gloo`` on the ranks (their
    process group made before) against the same CLI on one device: the
    same seeded model and batches, losses within 1e-5."""
    want = launch.main(CLI)["losses"]
    np.testing.assert_allclose(mesh_runs["cli"], want, rtol=1e-5)
    assert len(want) == 3
    assert mesh_runs["stats"]["all_reduce_bytes"] > 0
    assert mesh_runs["stats"]["all_gather_bytes"] > 0
