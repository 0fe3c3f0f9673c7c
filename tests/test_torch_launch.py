"""The port's serving CLI, ``repro_torch.launch.serve``, on the CPU.

``main`` builds the smoke model from ``init_params`` on a seeded
``torch.Generator`` and serves the JAX CLI's synthetic prompts
(``np.random.default_rng(1)``); its streams must equal those of the port's
``Engine`` built directly with the same flags and fed the same prompts,
``--continuous`` must return the streams of ``--no-overlap``, and the
flags the port does not serve yet raise, naming their ROADMAP item
(``--recalkv`` on deepseek raises the JAX CLI's ValueError).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.weights import init_params
from repro_torch.serving import Engine, Request

torch.set_num_threads(1)   # one thread a test worker: the suite's workers share the cores (README)

BASE = ["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--requests", "6",
        "--slots", "2", "--max-len", "48", "--new-tokens", "5", "--recalkv", "0.5"]


def _streams(finished):
    return {r.uid: [int(t) for t in r.out_tokens] for r in finished}


def _direct(**engine_kw):
    """The CLI's model, prompts and defaults through ``Engine`` itself."""
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True, recalkv_ratio=0.5),
                              attn_backend="kernel")
    params = init_params(cfg, torch.Generator(device="cpu").manual_seed(0), device="cpu")
    eng = Engine(cfg, params, max_slots=2, max_len=48, device="cpu", **engine_kw)
    g = np.random.default_rng(1)
    for i in range(6):
        plen = int(g.integers(4, 48 // 3))
        eng.submit(Request(uid=i, prompt=g.integers(0, cfg.vocab_size, plen).astype(np.int32),
                           max_new_tokens=5))
    done = eng.run()
    eng.close()
    return _streams(done)


def test_cli_equals_engine_built_directly(capsys):
    """``--backend pallas --continuous --aot`` (the kernel backend's plain
    versions on the CPU; aot captures nothing here) equals the Engine with
    those flags, and the report names the mode and the swaps."""
    got = _streams(serve.main(BASE + ["--backend", "pallas", "--continuous", "--aot"]))
    want = _direct(overlap=True, pipeline_depth=3, continuous=True, aot=True)
    assert got == want
    assert len(got) == 6 and all(len(v) == 5 for v in got.values())
    out = capsys.readouterr().out
    assert "overlapped x3, continuous, aot" in out and "in-scan swaps" in out
    assert "device cpu" in out


def test_cli_continuous_equals_sync():
    """``--continuous`` (overlapped, staged installs) returns the streams of
    ``--no-overlap`` (the sync engine), with the paged pool too."""
    sync = _streams(serve.main(BASE + ["--no-overlap"]))
    assert _streams(serve.main(BASE + ["--continuous"])) == sync
    assert _streams(serve.main(BASE + ["--continuous", "--cache-layout", "paged",
                                       "--staging-depth", "1"])) == sync


def test_cli_refusals():
    """What the port does not serve yet raises with its ROADMAP item (a
    mesh with the overlapped or continuous engine: item 5c); a mesh needs
    a process group (torchrun's); a one-device mesh is the port's own
    layout; ``--recalkv`` where ReCalKV does not apply (falcon-mamba,
    deepseek) raises with the JAX CLI's words; an unregistered arch raises
    KeyError."""
    with pytest.raises(ValueError, match="Queue 1 item 5c"):
        serve.main(BASE + ["--mesh", "2,4", "--continuous"])
    with pytest.raises(ValueError, match="Queue 1 item 5c"):
        serve.main(BASE + ["--mesh", "2x4", "--overlap"])
    with pytest.raises(RuntimeError, match="torchrun"):
        serve.main(BASE + ["--mesh", "2,4"])
    with pytest.raises(ValueError, match="ReCalKV inapplicable to falcon-mamba-7b"):
        serve.main(["--arch", "falcon-mamba-7b", "--smoke", "--device", "cpu",
                    "--recalkv", "0.5"])
    with pytest.raises(KeyError, match="unknown arch 'mamba-2'"):
        serve.main(["--arch", "mamba-2", "--smoke", "--device", "cpu"])
    with pytest.raises(ValueError, match="ReCalKV inapplicable to deepseek-v3-671b"):
        serve.main(["--arch", "deepseek-v3-671b", "--smoke", "--device", "cpu",
                    "--recalkv", "0.5"])
    assert len(serve.main(BASE + ["--mesh", "1,1", "--requests", "1"])) == 1


@pytest.mark.parametrize("arch", ["gemma3-12b", "minicpm-2b", "h2o-danube-1.8b",
                                  "qwen3-moe-235b-a22b", "deepseek-v3-671b",
                                  "llama-3.2-vision-11b", "whisper-small",
                                  "falcon-mamba-7b", "recurrentgemma-9b"])
def test_cli_serves_the_families_on_cpu(arch):
    """The families registered beside qwen3-4b serve through the CLI on the
    CPU (smoke sizes, window 16 for the local families; qwen3-moe's MoE
    FFN; deepseek's MLA, its ``attn_dense`` prefix and shared expert;
    llama-vision's cross layers and whisper's encoder on the CLI's seeded
    source; falcon-mamba's and recurrentgemma's recurrent state), dense and
    at ``--recalkv 0.5`` (deepseek and falcon-mamba dense only: ReCalKV does
    not apply to MLA or to an attention-free stack), overlapped with
    continuous batching; every request finishes with its budget and the
    streams equal ``--no-overlap``'s.  Under MoE a call's rows share the
    experts' capacity, a cross model's wave row i reads source row i, and a
    recurrent layer's state runs over its wave's pads, so both engines must
    prefill the same rows together: four slots and inline admission make
    one wave of all four requests in each."""
    same_waves = arch in ("qwen3-moe-235b-a22b", "deepseek-v3-671b",
                          "llama-3.2-vision-11b", "whisper-small",
                          "falcon-mamba-7b", "recurrentgemma-9b")
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "4",
            "--slots", "4" if same_waves else "2", "--max-len", "48",
            "--new-tokens", "4"]
    continuous = ["--continuous"] + (["--no-admission-thread"] if same_waves else [])
    ratios = ([[]] if arch in ("deepseek-v3-671b", "falcon-mamba-7b")
              else [[], ["--recalkv", "0.5"]])
    for extra in ratios:
        got = _streams(serve.main(args + extra + continuous))
        assert len(got) == 4 and all(len(v) == 4 for v in got.values())
        assert got == _streams(serve.main(args + extra + ["--no-overlap"]))


def test_quickstart_runs_on_cpu():
    """``examples/quickstart_torch.py --device cpu``: compresses the smoke
    qwen3-4b to about half its cache bytes, compares the forwards, round-
    trips the artifact and decodes 4 tokens for both rows."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu"])
    assert 0.4 < out["recalkv_bytes"] / out["dense_bytes"] < 0.6
    assert 0.0 <= out["agree"] <= 1.0 and out["tokens"].shape == (2,)
