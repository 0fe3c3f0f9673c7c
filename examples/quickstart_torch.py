"""Quickstart on the PyTorch / CUDA port: compress a model's KV cache
through repro_torch.api (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain PyTorch

Builds a small dense transformer, picks a strategy from the registry
(``recalkv`` = CKA->HSR grouping for keys, calibrated SVD + fused W~_o for
values), and shows the cache-size / output-fidelity trade-off plus the
durable-artifact round trip and a decode through the loaded latent cache.
"""

import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch.api import (CompressionSpec, RankPolicy, compress, list_strategies,
                             load_artifact, save_artifact)
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.models.weights import init_params


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    dev = torch.device(ap.parse_args(argv).device)

    # 1. a dense model (any HF-style GQA/MHA checkpoint would slot in here)
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True), dtype=torch.float32,
                              scan_layers=False)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

    # 2. calibration: a handful of batches through the model, second moments only
    g = np.random.default_rng(0)
    batches = [{"tokens": g.integers(0, cfg.vocab_size, (4, 64))} for _ in range(4)]

    # 3. pick a strategy (paper Algorithm 1) at 50% cache compression
    print("registered strategies:", ", ".join(list_strategies()))
    spec = CompressionSpec("recalkv", rank_policy=RankPolicy(keep_ratio=0.5, group_size=2))
    artifact = compress(cfg, params, spec, batches)
    ccfg, cparams = artifact.cfg, artifact.params

    # 4. compare: cache bytes + greedy agreement of the full forward
    toks = torch.from_numpy(g.integers(0, cfg.vocab_size, (2, 32))).to(dev)
    size = lambda c: sum(x.numel() * x.element_size()
                         for x in T.cache_leaves(T.init_decode_cache(c, 2, 64, dev)))
    with torch.no_grad():
        l_d = T.logits_for(cfg, params, T.forward_hidden(cfg, params, toks)[0])
        l_c = T.logits_for(ccfg, cparams, T.forward_hidden(ccfg, cparams, toks)[0])
    agree = float((l_d.argmax(-1) == l_c.argmax(-1)).float().mean())
    print(f"cache bytes/slot : dense {size(cfg):,} -> recalkv {size(ccfg):,} "
          f"({size(ccfg) / size(cfg):.0%})")
    print(f"greedy agreement : {agree:.0%} of positions (random init — trained "
          f"checkpoints do much better)")

    # 5. the artifact is durable: save, load (either package reads it), decode
    with tempfile.TemporaryDirectory() as d:
        save_artifact(artifact, d)
        art2 = load_artifact(d, device=dev)
    print(f"artifact round-trip: method={art2.method} "
          f"ranks={art2.provenance['ranks_by_layer']}")
    with torch.no_grad():
        logits, cache = T.prefill(art2.cfg, art2.params, toks,
                                  torch.full((2,), 32, device=dev), max_len=64)
        nxt = logits.argmax(-1)
        for t in range(32, 36):
            logits, cache = T.decode_step(art2.cfg, art2.params, cache, nxt,
                                          torch.full((2,), t, device=dev))
            nxt = logits.argmax(-1)
    print("decoded 4 tokens through the loaded latent cache:", nxt.cpu().numpy())
    return {"dense_bytes": size(cfg), "recalkv_bytes": size(ccfg), "agree": agree,
            "tokens": nxt.cpu().numpy()}


if __name__ == "__main__":
    main()
