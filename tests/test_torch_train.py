"""The port's training substrate (``optim``, ``runtime``, the training
forward and ``launch.train``) against the JAX package, float32 with TF32
off, on numpy-seeded inputs and params carried by ``params_from_jax``:

* exact: the schedules, ``quantize_leaf``, the
  stochastic rounding of bf16 moments, and ``apply_updates`` on seeded
  grads (3 steps; float32 and bf16 moments; ``scan_layers`` True and
  False; clipping off and on) with params, moments and step equal to
  JAX's eager ones to 1 ulp — the weight decay follows the JAX leaf's
  rank (stacked norms decayed), the noise the JAX leaf's index and
  stacked shape, ``with_error_feedback`` the stacked leaf's amax;
* 1e-5: ``loss_fn`` and its aux; autograd against ``jax.grad`` per leaf
  (1e-4 of the leaf's max |g|) for qwen3-4b, qwen3-moe (aux through the
  router), deepseek, whisper (a source) and falcon-mamba smoke configs,
  remat on and off equal; ``chunked_xent`` per chunk vs one pass;
* 3 ``train_step``s against JAX's jitted step: plain, ``microbatches=2``
  and ``grad_compress`` (losses, grad norms and lrs 1e-5; params, see
  the test); one microbatch keeps bf16 gradients, two accumulate in
  float32;
* checkpoints: a run resumed in one package from the other's
  checkpoint equals going straight through; the optimizer-state bridges
  both ways bit for bit; ``restore``'s refusals; the watchdog firing;
* the CLI (``python -m repro_torch.launch.train --grad-compress``)
  against JAX's, ``--mesh`` asking for torchrun and a three-axis mesh
  refused, and the two training examples on the CPU;
* ``compressed_psum`` on 2 and 4 stacked shards against JAX's under
  ``jax.vmap`` with an axis name, bit for bit in float32 and bf16.

One JAX reference run per flag set is shared through a module cache.
"""

import dataclasses
import functools
import importlib
import os
import runpy
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config
from repro.launch import train as jlaunch
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.optim import grad_compress as JG
from repro.optim import schedule as JS
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import Watchdog as JWatchdog  # noqa: F401  (the JAX twin)
from repro.runtime import make_train_step as j_make_train_step
from repro.runtime import train_loop as j_train_loop
from repro_torch import checkpoint as ckpt
from repro_torch.data import DataConfig, batch as data_batch
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import (leaves_in_jax_order, map_tree, opt_state_from_jax,
                                        opt_state_to_jax, params_from_jax, params_to_jax)
from repro_torch.optim import adamw as A
from repro_torch.optim import grad_compress as G
from repro_torch.optim import schedule as S
from repro_torch.runtime import (TrainConfig, Watchdog, WatchdogTimeout,
                                 make_train_step, train_loop)
from repro_torch.serving import prng

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

torch.backends.cuda.matmul.allow_tf32 = False
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RUNS = {}


@functools.lru_cache(maxsize=None)
def _model(arch, scan=True, seed=0):
    """(JAX cfg, JAX params, port cfg, port params) of the float32 smoke
    config; the port's params are fresh copies for each caller."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=jnp.float32,
                              scan_layers=scan)
    params = jax.jit(JT.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(seed))
    return cfg, params, ModelConfig.from_dict(cfg.to_dict())


def _port(pcfg, tree):
    return params_from_jax(pcfg, jax.tree.map(np.asarray, tree), device="cpu")


def _ulps(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
    view = np.int32 if a.dtype.itemsize == 4 else np.int16
    return int(np.abs(a.view(view).astype(np.int64) - b.view(view).astype(np.int64)).max(
        initial=0))


def _max_ulps(want_tree, got_tree) -> int:
    want = jax.tree.leaves(jax.tree.map(np.asarray, want_tree))
    got = jax.tree.leaves(got_tree)
    assert len(want) == len(got)
    return max(_ulps(a, b) for a, b in zip(want, got))


def _batch(cfg, step, rows=4, seq=32):
    b = data_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq), "train", step, rows)
    if cfg.cross_source_len:
        b["source"] = np.random.default_rng(100 + step).normal(
            size=(rows, cfg.cross_source_len, cfg.d_model)).astype(np.float32)
    return b


# ---------------------------------------------------------------------------
# exact pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cosine", "wsd"])
def test_schedules_equal_jax(name):
    """The float32 scale at every step of short and long schedules equals
    JAX's bit for bit (cosine's cos through libm's ``cosf``, XLA's CPU
    call; PyTorch's own float32 cos rounds 29 of these 1,005 arguments of
    the 1,000-step schedule one ulp apart)."""
    for warmup, total in ((0, 3), (1, 5), (3, 10), (10, 10), (2, 7), (100, 1000)):
        steps = np.arange(total + 5, dtype=np.int32)
        want = np.asarray(JS.SCHEDULES[name](jnp.asarray(steps), warmup=warmup, total=total))
        got = np.array([S.SCHEDULES[name](torch.tensor(int(s)), warmup=warmup,
                                          total=total).numpy() for s in steps])
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            S.SCHEDULES[name](torch.as_tensor(steps), warmup=warmup, total=total).numpy(),
            want)


def test_quantize_leaf_and_stochastic_round_exact():
    """``quantize_leaf`` / ``dequantize_leaf`` bit for bit on seeded f32 and
    bf16 leaves (and an all-zero one); ``_stochastic_round`` of f32 to
    bf16 with the port's threefry noise over an n-D shape equals JAX's
    ``uniform`` over that shape bit for bit."""
    g = np.random.default_rng(11)
    for x in (g.normal(size=(7, 33)).astype(np.float32) * 3,
              np.zeros((4, 4), np.float32), g.normal(size=(5,)).astype(np.float32) * 1e-20):
        q, s = G.quantize_leaf(torch.as_tensor(x))
        jq, js = JG.quantize_leaf(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy() == np.asarray(js)
        np.testing.assert_array_equal(G.dequantize_leaf(q, s).numpy(),
                                      np.asarray(JG.dequantize_leaf(jq, js)))
    xb = torch.as_tensor(g.normal(size=(3, 6)).astype(np.float32)).to(torch.bfloat16)
    q, s = G.quantize_leaf(xb)
    jq, js = JG.quantize_leaf(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    for shape in ((5, 7, 3), (64,)):
        x = (g.normal(size=shape) * 10.0 ** g.integers(-6, 6, size=shape)).astype(np.float32)
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 9), 4)
        want = JA._stochastic_round(jnp.asarray(x), jnp.bfloat16, key)
        k = prng.fold_in(prng.fold_in(prng.prng_key(0), 9), 4)
        noise = prng.uniform(k, x.size).view(shape) - 0.5
        got = A._stochastic_round(torch.as_tensor(x), torch.bfloat16, noise)
        assert _ulps(want.view(jnp.int16), got.view(torch.int16).numpy()) == 0


UPDATE_CASES = [(scan, mdt, scale) for scan in (True, False)
                for mdt in ("float32", "bfloat16") for scale in (1e-3, 1e-1)]


@pytest.mark.parametrize("scan,mdt,scale", UPDATE_CASES)
def test_apply_updates_equals_jax(scan, mdt, scale):
    """Three AdamW steps on seeded grads (norm 0.36 unclipped, 36 clipped)
    at lr scale 0.5 against JAX's eager ``apply_updates``: params within 1
    ulp (exact unclipped), moments and step equal; the decay follows the
    JAX leaf's rank: with ``scan_layers`` the stacked ``ln1`` moves with the
    weight decay (a port that decayed by its own per-layer rank would not),
    without it ``ln1`` does not, and ``final_norm`` never does."""
    cfg, params, pcfg = _model("qwen3-4b", scan)
    g = np.random.default_rng(1)
    grads = jax.tree.map(lambda p: jnp.asarray(
        g.normal(size=p.shape).astype(np.float32) * scale), params)
    jcfg = JA.AdamWConfig(moment_dtype=getattr(jnp, mdt))
    tcfg = A.AdamWConfig(moment_dtype=getattr(torch, mdt))
    jp, jst = params, JA.init_state(params, jcfg)
    pp, pg = _port(pcfg, params), _port(pcfg, grads)
    pst = opt_state_from_jax(pcfg, jax.tree.map(np.asarray, jst), device="cpu")
    no_decay = map_tree(pp, lambda t: t.clone())
    ncfg = dataclasses.replace(tcfg, weight_decay=0.0)
    nst = A.init_state(no_decay, ncfg)
    for _ in range(3):
        jp, jst, jm = JA.apply_updates(jp, grads, jst, jcfg, 0.5)
        pp, pst, m = A.apply_updates(pp, pg, pst, tcfg, 0.5, model=pcfg)
        if mdt == "float32":
            no_decay, nst, _ = A.apply_updates(no_decay, pg, nst, ncfg, 0.5, model=pcfg)
    limit = 0 if scale < 1e-2 else 1
    assert _max_ulps(jp, params_to_jax(pcfg, pp)) <= limit
    back = opt_state_to_jax(pcfg, pst)
    for k in ("mu", "nu"):
        assert _max_ulps(jst[k], back[k]) <= limit
    assert int(back["step"]) == int(jst["step"]) == 3 and back["step"].dtype == np.int32
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    assert float(m["lr"]) == float(jm["lr"])
    if mdt == "float32":
        got, bare = params_to_jax(pcfg, pp), params_to_jax(pcfg, no_decay)
        where = "blocks" if scan else "prefix"
        moved = np.abs(got[where][0]["ln1"] - bare[where][0]["ln1"]).max()
        assert (moved > 0) == scan
        np.testing.assert_array_equal(got["final_norm"], bare["final_norm"])


@pytest.mark.parametrize("scan", [True, False])
def test_error_feedback_equals_jax(scan):
    """``with_error_feedback`` on seeded grads and residual: decompressed
    grads and new residual bit for bit; with ``scan_layers`` the scale is
    the stacked leaf's amax (per-layer scales would differ); ``None``
    residual starts from zeros; ``compressed_psum`` reduces over a mesh
    (``test_compressed_psum_equals_jax_under_vmap``)."""
    cfg, params, pcfg = _model("qwen3-4b", scan)
    g = np.random.default_rng(2)
    grads = jax.tree.map(lambda p: jnp.asarray(g.normal(size=p.shape).astype(np.float32)),
                         params)
    res = jax.tree.map(lambda p: jnp.asarray(
        g.normal(size=p.shape).astype(np.float32) * 1e-2), params)
    for r in (res, None):
        jd, jr = JG.with_error_feedback(grads, r)
        td, tr = G.with_error_feedback(_port(pcfg, grads),
                                       None if r is None else _port(pcfg, r), model=pcfg)
        assert _max_ulps(jd, params_to_jax(pcfg, td)) == 0
        assert _max_ulps(jr, params_to_jax(pcfg, tr)) == 0
    if scan:    # the layer of least amax, on its own scale, is on another grid
        layers = _port(pcfg, grads)["layers"]
        i = min(range(len(layers)), key=lambda i: float(layers[i]["attn"]["wq"].abs().max()))
        own = G.dequantize_leaf(*G.quantize_leaf(layers[i]["attn"]["wq"]))
        assert not torch.equal(own, td["layers"][i]["attn"]["wq"])
    assert G.compressed_psum({}, "data", Mesh(1, 1)) == {}


class _ThreadMesh:
    """Rank ``rank`` of ``n`` threads of one process, one axis: the
    reductions of ``launch.mesh.Mesh`` over the threads' tensors, in
    rank order (int32 sums and maxima are exact in any order)."""

    def __init__(self, shared, rank):
        self.shared, self.rank = shared, rank

    def axis_size(self, axis):
        return len(self.shared["slots"])

    def all_reduce(self, t, axis, op="sum"):
        sh = self.shared
        sh["slots"][self.rank] = t
        sh["barrier"].wait()
        st = torch.stack(sh["slots"])
        out = st.amax(0) if op == "max" else st.sum(0)
        sh["barrier"].wait()
        return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_psum_equals_jax_under_vmap(n, dtype):
    """``compressed_psum`` on ``n`` shards, run as ``n`` threads of one
    process over a mesh of threads, against JAX's under ``jax.vmap(...,
    axis_name="data")`` (``pmax`` / ``psum`` over the mapped axis) on
    seeded leaves of unequal scales: every shard's tree bit for bit (each
    shard quantized on its own scale, the scales max-reduced, int32 sums,
    then q32 * scale / n).  ``test_torch_mesh_train.py`` runs the port's
    gloo mesh."""
    import threading
    g = np.random.default_rng(7 + n)
    leaves = {"a": g.normal(size=(n, 5, 7)) * np.arange(1, n + 1)[:, None, None],
              "b": g.normal(size=(n, 33)) * 1e-3, "z": np.zeros((n, 4))}
    jdt = getattr(jnp, dtype)
    jin = {k: jnp.asarray(v, jnp.float32).astype(jdt) for k, v in leaves.items()}
    want = jax.vmap(lambda t: JG.compressed_psum(t, "data"), axis_name="data")(jin)
    tin = {k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(getattr(torch, dtype))
           for k, v in jin.items()}
    shared = {"slots": [None] * n, "barrier": threading.Barrier(n)}
    got = [None] * n

    def rank(i):
        got[i] = G.compressed_psum({k: v[i] for k, v in tin.items()}, "data",
                                   _ThreadMesh(shared, i))

    threads = [threading.Thread(target=rank, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for i in range(n):
        for k in tin:
            assert got[i][k].dtype == tin[k].dtype
            np.testing.assert_array_equal(got[i][k].float().numpy(),
                                          np.asarray(want[k][i].astype(jnp.float32)))


# ---------------------------------------------------------------------------
# the training forward and its gradients
# ---------------------------------------------------------------------------

GRAD_ARCHS = ["qwen3-4b", "qwen3-moe-235b-a22b", "deepseek-v3-671b", "whisper-small",
              "falcon-mamba-7b"]


def _port_grads(pcfg, pp, batch):
    leaves = [t for _, ts, _ in leaves_in_jax_order(None, pp) for t in ts]
    for t in leaves:
        t.requires_grad_(True)
    loss, aux = T.loss_fn(pcfg, pp, batch)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    for t in leaves:
        t.requires_grad_(False)
    by_id = {id(t): (torch.zeros_like(t) if g is None else g) for t, g in zip(leaves, gs)}
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, map_tree(
        pp, lambda t: by_id[id(t)])


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_grads_match_jax(arch):
    """``loss_fn`` (xent + the MoE aux) within 1e-5 relative and every
    leaf's gradient within 1e-4 of its max |g| against ``jax.grad``
    (scanned layout: the stacked leaves compared whole); remat on and off
    give the same gradients bit for bit (the recomputed routing included);
    an MoE router's gradient is not zero."""
    cfg, params, pcfg = _model(arch)
    batch = _batch(cfg, 0, rows=2, seq=16)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(cfg, p, b),
                                              has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    assert pcfg.remat
    loss, m, grads = _port_grads(pcfg, _port(pcfg, params), batch)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    for k in ("xent", "aux", "tokens"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-7)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jg))
    got = jax.tree.leaves(params_to_jax(pcfg, grads))
    for a, b in zip(want, got, strict=True):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * max(np.abs(a).max(), 1e-30))
    _, _, plain = _port_grads(dataclasses.replace(pcfg, remat=False), _port(pcfg, params),
                              batch)
    for (_, (a,), _), (_, (b,), _) in zip(leaves_in_jax_order(None, grads), leaves_in_jax_order(None, plain)):
        assert torch.equal(a, b)
    if pcfg.moe is not None:
        routed = [layer["mlp"]["router"] for layer in grads["layers"] if "router" in layer["mlp"]]
        assert routed and all(float(r.abs().max()) > 0 for r in routed)


def test_chunked_xent_chunks_match_one_pass():
    """T a multiple of the chunk runs per chunk (float32 sums in order),
    otherwise one pass, as JAX: both within 1e-5 of JAX's, and the
    chunked sum of a masked batch (labels -1) counts only the rest."""
    cfg, params, pcfg = _model("qwen3-4b")
    pp = _port(pcfg, params)
    g = np.random.default_rng(3)
    for Tn, chunk in ((32, 8), (30, 8), (8, 8)):
        h = g.normal(size=(2, Tn, cfg.d_model)).astype(np.float32)
        lab = g.integers(-1, cfg.vocab_size, (2, Tn)).astype(np.int32)
        wt, wc = JT.chunked_xent(cfg, params, jnp.asarray(h), jnp.asarray(lab), chunk)
        gt, gc_ = T.chunked_xent(pcfg, pp, torch.as_tensor(h), torch.as_tensor(lab), chunk)
        assert float(gt) == pytest.approx(float(wt), rel=1e-5)
        assert float(gc_) == float(wc) == float((lab >= 0).sum())


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

STEP_CASES = {"plain": dict(microbatches=1), "accum": dict(microbatches=2),
              "compress": dict(microbatches=2, grad_compress=True)}


def _jax_steps(case, n=3):
    """JAX's jitted ``make_train_step`` for ``case`` over n steps from the
    seed-0 smoke model: (params, opt state, metrics per step); once per
    case."""
    key = ("steps", case)
    if key not in _RUNS:
        cfg, params, pcfg = _model("qwen3-4b")
        tc = JTrainConfig(warmup_steps=0, total_steps=5, **STEP_CASES[case])
        st = JA.init_state(params, JA.AdamWConfig())
        if tc.grad_compress:
            st["residual"] = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        step = jax.jit(j_make_train_step(cfg, JA.AdamWConfig(), tc))
        ms = []
        for i in range(n):
            params, st, m = step(params, st, {k: jnp.asarray(v)
                                              for k, v in _batch(cfg, i).items()})
            ms.append({k: float(v) for k, v in m.items()})
        _RUNS[key] = (params, st, ms)
    return _RUNS[key]


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_jax(case):
    """Three steps of the port's ``make_train_step`` against JAX's jitted
    one on the same batches: loss, grad_norm and lr each step within 1e-5
    relative (with compression, grad_norm past the first step 1e-4).  Params: without compression every leaf within 1e-5 of its
    norm (and 1e-4 of its max elementwise; XLA fuses the update as
    m / (bc1 * (sqrt(v / bc2) + eps)), so ulps differ).  With int8
    compression a gradient element that lands within an ulp of a rounding
    tie quantizes one level apart in the two packages, and Adam turns
    that level into a full step of that element: leaves within 1e-3 of
    their norm (measured 4.9e-5), the error feedback exact on equal
    inputs (``test_error_feedback_equals_jax``)."""
    cfg, params, pcfg = _model("qwen3-4b")
    want_p, want_st, want_m = _jax_steps(case)
    tc = TrainConfig(warmup_steps=0, total_steps=5, **STEP_CASES[case])
    pp = _port(pcfg, params)
    st = A.init_state(pp, A.AdamWConfig())
    if tc.grad_compress:
        st["residual"] = A.zeros_like_tree(pp, torch.float32)
    step = make_train_step(pcfg, A.AdamWConfig(), tc)
    for i, wm in enumerate(want_m):
        pp, st, m = step(pp, st, _batch(cfg, i))
        for k in ("loss", "grad_norm", "lr"):
            # compressed: the norm of the int8 grads after the first step
            # moves by the levels the flips below move (measured 2.6e-5)
            rel = 1e-4 if tc.grad_compress and k == "grad_norm" and i else 1e-5
            assert float(m[k]) == pytest.approx(wm[k], rel=rel), (i, k)
    assert not any(t.requires_grad for _, ts, _ in leaves_in_jax_order(None, pp) for t in ts)
    norm_tol = 1e-3 if tc.grad_compress else 1e-5
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, want_p)),
                    jax.tree.leaves(params_to_jax(pcfg, pp)), strict=True):
        assert np.linalg.norm(b - a) <= norm_tol * max(np.linalg.norm(a), 1e-30)
        if not tc.grad_compress:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * np.abs(a).max())
    assert int(st["step"]) == 3 and ("residual" in st) == tc.grad_compress


# ---------------------------------------------------------------------------
# checkpoints and the watchdog
# ---------------------------------------------------------------------------

class _Crash(Exception):
    pass


def _crashing(batch_fn, at):
    def fn(step):
        if step == at:
            raise _Crash
        return batch_fn(step)
    return fn


def _wait_for(directory, step, timeout=30.0):
    t0 = time.monotonic()
    while ckpt.latest_step(directory) != step:
        assert time.monotonic() - t0 < timeout, f"no checkpoint {step} in {directory}"
        time.sleep(0.05)


def _straight(cfg):
    """JAX's train loop over 4 steps from the seed-0 model, no checkpoint."""
    if "straight" not in _RUNS:
        _, params, _ = _model("qwen3-4b")
        tc = JTrainConfig(warmup_steps=1, total_steps=4)
        st = JA.init_state(params, JA.AdamWConfig())
        out = j_train_loop(cfg, JA.AdamWConfig(), tc, lambda s: {
            k: jnp.asarray(v) for k, v in _batch(cfg, s).items()},
            params=params, opt_state=st, logger=lambda *_: None)
        _RUNS["straight"] = out
    return _RUNS["straight"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_from_the_other_package(writer, tmp_path):
    """A 4-step run with a checkpoint every 2 steps crashes at step 2 in
    one package; the other restores the step-2 checkpoint and finishes:
    the resumed steps' losses and the final params equal JAX's straight
    run within 1e-5 (relative; params to their leaf's norm), and the last
    checkpoint it writes restores in the first package."""
    cfg, params, pcfg = _model("qwen3-4b")
    want = _straight(cfg)
    d = str(tmp_path / "run")
    jtc = JTrainConfig(warmup_steps=1, total_steps=4, ckpt_dir=d, ckpt_every=2)
    tc = TrainConfig(warmup_steps=1, total_steps=4, ckpt_dir=d, ckpt_every=2)
    jbatch = lambda s: {k: jnp.asarray(v) for k, v in _batch(cfg, s).items()}
    pbatch = lambda s: _batch(cfg, s)
    pp = _port(pcfg, params)
    pst = A.init_state(pp, A.AdamWConfig())
    quiet = dict(logger=lambda *_: None)
    with pytest.raises(_Crash):
        if writer == "jax":
            j_train_loop(cfg, JA.AdamWConfig(), jtc, _crashing(jbatch, 2), params=params,
                         opt_state=JA.init_state(params, JA.AdamWConfig()), **quiet)
        else:
            train_loop(pcfg, A.AdamWConfig(), tc, _crashing(pbatch, 2), params=pp,
                       opt_state=pst, **quiet)
    _wait_for(d, 2)
    if writer == "jax":
        out = train_loop(pcfg, A.AdamWConfig(), tc, pbatch, params=_port(pcfg, params),
                         opt_state=A.init_state(_port(pcfg, params), A.AdamWConfig()),
                         **quiet)
        got_p = params_to_jax(pcfg, out["params"])
    else:
        out = j_train_loop(cfg, JA.AdamWConfig(), jtc, jbatch, params=params,
                           opt_state=JA.init_state(params, JA.AdamWConfig()), **quiet)
        got_p = jax.tree.map(np.asarray, out["params"])
    np.testing.assert_allclose(out["losses"], want["losses"][2:], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, want["params"])),
                    jax.tree.leaves(got_p), strict=True):
        assert np.linalg.norm(b - a) <= 1e-5 * max(np.linalg.norm(a), 1e-30)
    assert ckpt.latest_step(d) == 4
    meta = ckpt.read_meta(d, 4)
    assert "opt/step" in meta["keys"] and "params/embed" in meta["keys"]
    if writer == "jax":   # the port's final checkpoint restores in JAX
        target = {"params": params, "opt": JA.init_state(params, JA.AdamWConfig())}
        back = jckpt.restore(d, 4, target)
        assert int(back["opt"]["step"]) == 4


def test_opt_state_bridges_and_restore_refusals(tmp_path):
    """``opt_state_from_jax`` / ``opt_state_to_jax`` round-trip bit for
    bit (stacked and unrolled, bf16 moments, a residual); ``restore``
    raises JAX's KeyError for a missing leaf and ValueError for a shape;
    an async save returns its writer thread and keeps the last 2."""
    for scan in (True, False):
        cfg, params, pcfg = _model("qwen3-4b", scan)
        st = JA.init_state(params, JA.AdamWConfig(moment_dtype=jnp.bfloat16))
        g = np.random.default_rng(5)
        st = jax.tree.map(lambda x: (jnp.asarray(g.normal(size=x.shape)).astype(x.dtype)
                                     if x.ndim else jnp.int32(7)), st)
        st["residual"] = jax.tree.map(lambda p: jnp.asarray(
            g.normal(size=p.shape).astype(np.float32)), params)
        port = opt_state_from_jax(pcfg, jax.tree.map(np.asarray, st), device="cpu")
        assert port["mu"]["layers"][0]["ln1"].dtype == torch.bfloat16
        assert port["step"].dtype == torch.int32 and int(port["step"]) == 7
        back = opt_state_to_jax(pcfg, port)
        assert _max_ulps(st, back) == 0
    d = str(tmp_path / "c")
    threads = [ckpt.save(d, s, {"a": np.arange(3.0), "b": (np.ones(2),)}, keep_last=2,
                         async_=True) for s in (1, 2, 3)]
    for t in threads:
        t.join()
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]
    out = ckpt.restore(d, 3, {"a": np.zeros(3, np.float32), "b": (np.zeros(2),)})
    assert out["a"].dtype == np.float32 and isinstance(out["b"], tuple)
    with pytest.raises(KeyError, match="missing leaf 'c'"):
        ckpt.restore(d, 3, {"c": np.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, 3, {"a": np.zeros(4)})


def test_watchdog_fires():
    """A step past its deadline raises ``WatchdogTimeout`` at disarm, as
    JAX's; a fast one records its time; a train loop whose batch takes
    longer than ``step_deadline_s`` raises it."""
    wd = Watchdog(0.05)
    wd.arm("fast")
    wd.disarm()
    assert len(wd.step_times) == 1 and wd.straggler_score() == 1.0
    wd.arm("slow")
    time.sleep(0.2)
    with pytest.raises(WatchdogTimeout, match="slow"):
        wd.disarm()
    cfg, params, pcfg = _model("qwen3-4b")
    tc = TrainConfig(warmup_steps=1, total_steps=2, step_deadline_s=0.01)

    def slow(step):
        time.sleep(0.1)
        return _batch(cfg, step)

    with pytest.raises(WatchdogTimeout):
        train_loop(pcfg, A.AdamWConfig(), tc, slow, params=_port(pcfg, params),
                   opt_state=A.init_state(_port(pcfg, params), A.AdamWConfig()),
                   logger=lambda *_: None)


# ---------------------------------------------------------------------------
# the CLI and the examples
# ---------------------------------------------------------------------------

def test_train_cli_matches_jax(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch qwen3-4b --smoke
    --grad-compress --microbatches 2`` on the CPU against JAX's CLI with the
    same flags (the plain step is ``test_train_steps_match_jax``'s).  The two draw their random
    init from different generators, so both resume JAX's 3-step checkpoint
    (``--ckpt-dir``) and run to step 6: the port's losses within 1e-5 of
    JAX's.  ``--mesh`` without a process group asks for torchrun (the mesh
    runs in ``test_torch_mesh_train.py``), a three-axis spec is refused
    with its ROADMAP item (5f); an unknown arch is refused."""
    argv = ["--arch", "qwen3-4b", "--smoke", "--batch", "4", "--seq", "32",
            "--grad-compress", "--microbatches", "2"]
    jlaunch.main(argv + ["--steps", "3", "--ckpt-dir", str(tmp_path / "j")])
    for d in ("a", "b"):
        os.makedirs(tmp_path / d)
        os.symlink(tmp_path / "j" / "step_00000003", tmp_path / d / "step_00000003")
    want = jlaunch.main(argv + ["--steps", "6", "--ckpt-dir", str(tmp_path / "a")])
    got = launch.main(argv + ["--steps", "6", "--ckpt-dir", str(tmp_path / "b"),
                              "--device", "cpu"])
    assert len(got["losses"]) == len(want["losses"]) == 3
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    out = capsys.readouterr().out
    assert "restored step 3" in out and "final loss" in out
    with pytest.raises(RuntimeError, match="torchrun"):
        launch.main(argv + ["--device", "cpu", "--mesh", "2x4"])
    with pytest.raises(ValueError, match="Queue 1 item 5f"):
        launch.main(argv + ["--device", "cpu", "--mesh", "2x2x2"])
    with pytest.raises(SystemExit):
        launch.main(["--arch", "no-such-arch", "--device", "cpu"])
    plain = launch.main(argv[:7] + ["--steps", "2", "--device", "cpu"])
    assert len(plain["losses"]) == 2 and np.isfinite(plain["losses"]).all()


def test_training_examples_run_on_cpu(tmp_path, capsys):
    """``examples/train_small_torch.py`` trains and resumes from its own
    checkpoint; ``examples/serve_compressed_torch.py --use-fisher`` trains,
    compresses with Fisher ranks (not uniform), saves, loads and serves
    dense and compressed engines (both through their ``main``, on the CPU,
    at a few steps)."""
    train = runpy.run_path(os.path.join(REPO, "examples", "train_small_torch.py"))["main"]
    args = ["--device", "cpu", "--seq", "32", "--batch", "4", "--dmodel", "64",
            "--layers", "2", "--heads", "4", "--ckpt-dir", str(tmp_path / "ck")]
    first = train(args + ["--steps", "4"])
    assert len(first["losses"]) == 4 and ckpt.latest_step(str(tmp_path / "ck")) == 4
    again = train(args + ["--steps", "6"])
    assert len(again["losses"]) == 2 and "restored step 4" in capsys.readouterr().out
    serve = runpy.run_path(os.path.join(REPO, "examples", "serve_compressed_torch.py"))["main"]
    out = serve(["--device", "cpu", "--train-steps", "8", "--requests", "2",
                 "--new-tokens", "4", "--use-fisher", "--artifact-dir", str(tmp_path / "art"),
                 "--ckpt-dir", str(tmp_path / "ck2")])
    assert len({tuple(x) for x in out["ranks"]}) > 1
    assert "greedy agreement" in capsys.readouterr().out
    assert out["compressed"]["cache_mb"] < out["dense"]["cache_mb"]


def test_microbatch_grads_keep_or_accumulate(monkeypatch):
    """JAX's two branches: one microbatch hands AdamW the gradients in the
    params' dtype as they come (bf16 here), two accumulate them in
    float32 and divide by 2, the mean of each half's gradient."""
    TL = importlib.import_module("repro_torch.runtime.train_loop")
    cfg, params, pcfg = _model("qwen3-4b")
    bcfg = dataclasses.replace(pcfg, dtype=torch.bfloat16)
    seen = []
    real = TL.apply_updates

    def spy(p, grads, *a, **k):
        seen.append(map_tree(grads, lambda g: g.clone()))
        return real(p, grads, *a, **k)

    monkeypatch.setattr(TL, "apply_updates", spy)
    batch = _batch(cfg, 0)
    for k in (1, 2):
        pp = params_from_jax(bcfg, jax.tree.map(np.asarray, params), device="cpu")
        make_train_step(bcfg, A.AdamWConfig(), TrainConfig(microbatches=k))(
            pp, A.init_state(pp, A.AdamWConfig()), batch)
    one, two = seen
    assert one["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert two["layers"][0]["attn"]["wq"].dtype == torch.float32
    pp = params_from_jax(bcfg, jax.tree.map(np.asarray, params), device="cpu")
    halves = [_port_grads(bcfg, pp, {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()})[2]
              for i in range(2)]
    want = (halves[0]["layers"][1]["mlp"]["wo"].float()
            + halves[1]["layers"][1]["mlp"]["wo"].float()) / 2
    assert torch.equal(two["layers"][1]["mlp"]["wo"], want)
