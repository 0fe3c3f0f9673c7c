"""Serving launcher: a continuous-batching demo over a (compressed) model
on one card (port of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch qwen3-4b --recalkv 0.5
--continuous --aot`` builds the engine on the card, feeds it synthetic
prompts and reports throughput, host syncs, slot occupancy and queue
depth, with the cache's footprint.  ``--device cpu`` runs the plain
PyTorch path (smoke configs).  The weights are random, from
``init_params`` on a seeded ``torch.Generator``.  A model with
cross-attention layers (llama-3.2-vision, whisper) reads a source as the
JAX CLI builds it, ``np.random.default_rng(0).normal(size=(rows,
cross_source_len, d_model))`` in the model dtype, with rows = ``--slots``
(and, overlapped, at least the staging depth: an admission wave of W rows
reads source rows 0..W-1, and the first ``--slots`` rows are the JAX
CLI's).

Every registered ``--arch`` serves, the recurrent falcon-mamba and
recurrentgemma too (their state's bytes are reported apart from the self
ring's).  ``--mesh DATA,MODEL`` serves on a mesh of that many ranks, one
process a rank under ``torchrun`` (rank and world size from its
environment): ``torchrun --nproc-per-node N -m repro_torch.launch.serve
--mesh D,M`` with N = D * M, each rank on ``cuda:LOCAL_RANK`` over
``nccl``; ``--dist-backend gloo`` runs the collectives through the host
(two ranks may then share one card, ``--device cuda:0``).  A mesh
serves every registered ``--arch``, ``--draft layers:K``, ``--backend
einsum``, the overlapped engine (``--overlap``, on by default there as
off a mesh, ``--pipeline-depth``, the admission thread) and
``--continuous`` too, and slot counts, ``--max-len`` and page sizes
the mesh does not split (they stay whole); ``--aot`` is refused with
ROADMAP.md Queue 1 item 5e (CUDA graphs cannot capture gloo's host
collectives).  Every rank serves the same requests.  Rank 0 prints.  ``--recalkv`` on an arch ReCalKV does not
apply to (deepseek's MLA, falcon-mamba's attention-free stack) raises
ValueError with the JAX CLI's words, "ReCalKV inapplicable to <arch>".  ``--backend pallas`` names the
port's CUDA kernels, as ``ModelConfig.from_dict`` reads it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_from_spec, parse_mesh_spec
from repro_torch.models.weights import init_params
from repro_torch.serving import Engine, Request, SamplingParams

MESH_NO_AOT = ("--aot is not ported to a mesh yet (ROADMAP.md Queue 1 item 5e): CUDA "
               "graphs cannot capture gloo's host collectives, and NCCL will not run "
               "two ranks on one card")


def cache_bytes(caches, part: str = "self") -> int:
    """Bytes of the engine's cache tensors of one part of each layer's
    cache: its self-attention ring ("self"), its cross cache ("cross") or
    its recurrent state ("state")."""
    return sum(leaf.numel() * leaf.element_size()
               for c in caches for leaf in c.get(part, {}).values())


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--recalkv", type=float, default=None,
                    help="keep ratio, e.g. 0.5")
    ap.add_argument("--backend", choices=("einsum", "kernel", "pallas"), default=None,
                    help="attention backend (kernel = the CUDA kernels, plain "
                         "PyTorch versions on the CPU; pallas is its alias)")
    ap.add_argument("--sync-every", type=int, default=8,
                    help="decode tokens per host sync (window size)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="admit prompts in chunks of this many tokens")
    ap.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0, help="0 = disabled")
    ap.add_argument("--top-p", type=float, default=1.0, help="1 = disabled")
    ap.add_argument("--seed", type=int, default=0, help="sampling PRNG seed")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="serve on a (data, model) mesh, one rank a process "
                         "under torchrun (default: one device)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="the mesh's collectives (default nccl on a card, "
                         "gloo on the CPU)")
    ap.add_argument("--spec-depth", type=int, default=0,
                    help="speculative decoding: draft tokens verified per "
                         "window iteration (0 disables; streams are "
                         "invariant to this knob)")
    ap.add_argument("--draft", default=None,
                    help="draft proposer for --spec-depth > 0: 'ngram' "
                         "(prompt lookup, default) or 'layers:K' (self-"
                         "draft from the target's first K layers)")
    ap.add_argument("--cache-layout", choices=("ring", "paged"), default="ring",
                    help="'paged' pools cache pages across slots with "
                         "copy-on-write prompt-prefix sharing; token "
                         "streams are identical to 'ring'")
    ap.add_argument("--page-size", type=int, default=None,
                    help="positions per cache page (paged layout only; "
                         "default: largest of 16/8/4/2/1 dividing --max-len)")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="physical pool pages incl. the null page (paged "
                         "only; default: ring-equivalent capacity)")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction, default=None,
                    help="overlapped pipeline: decode windows in flight, token "
                         "handling on a backlog thread (--no-overlap for the "
                         "blocking step loop; streams are identical either way; "
                         "default on)")
    ap.add_argument("--aot", action="store_true",
                    help="capture the window iteration as CUDA graphs at boot "
                         "(a card only), so a window is graph replays")
    ap.add_argument("--pipeline-depth", type=int, default=3,
                    help="in-flight decode windows under --overlap")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: staged requests install into "
                         "freed slots inside the window; streams are "
                         "identical to the sync engine")
    ap.add_argument("--admission-thread", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="stage admission prefill on a worker thread "
                         "(default: on whenever --overlap is)")
    ap.add_argument("--policy", default=None,
                    choices=("fifo", "prefix-affinity", "reach-packing"),
                    help="admission policy (prefix-affinity: paged only)")
    ap.add_argument("--lazy-pages", action="store_true",
                    help="lazy page reservation with preemption (paged only; "
                         "streams are identical)")
    ap.add_argument("--staging-depth", type=int, default=None,
                    help="max requests staged ahead by admission "
                         "(default 2x --slots)")
    ap.add_argument("--pin-prefixes", type=int, default=0,
                    help="pin the K hottest registered prefix pages against "
                         "pool recycling (paged layout only)")
    ap.add_argument("--adaptive-spec", action="store_true",
                    help="degrade cold-draft slots to plain decode at window "
                         "boundaries (needs --spec-depth > 0; streams are "
                         "invariant)")
    ap.add_argument("--profile", action="store_true",
                    help="record the host-boundary stage timeline "
                         "(metrics()['profile'])")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    on_mesh = parse_mesh_spec(args.mesh) != (1, 1)
    if on_mesh and args.aot:
        raise ValueError(f"--mesh {args.mesh}: {MESH_NO_AOT}")
    if args.overlap is None:
        args.overlap = True
    device = args.device
    if on_mesh and device == "cuda" and (args.dist_backend or "nccl") == "nccl":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    mesh = None
    if on_mesh:
        mesh = mesh_from_spec(args.mesh, backend=args.dist_backend or (
            "nccl" if resolve_device(device).type == "cuda" else "gloo"))
    dev = resolve_device(device)
    rank0 = mesh is None or mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    cfg = get_config(args.arch, smoke=args.smoke, recalkv_ratio=args.recalkv)
    if args.backend is not None:
        cfg = dataclasses.replace(
            cfg, attn_backend="kernel" if args.backend == "pallas" else args.backend)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    source = None
    if any(k in ("cross", "attn_cross") for k in cfg.expanded_layers()):
        rows = args.slots
        if args.overlap:
            rows = max(rows, args.staging_depth or 2 * args.slots)
        source = torch.from_numpy(np.random.default_rng(0).normal(
            size=(rows, cfg.cross_source_len, cfg.d_model))).to(dev, cfg.dtype)
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p, seed=args.seed)
    eng = Engine(cfg, params, max_slots=args.slots, max_len=args.max_len,
                 source=source, sampling=sampling, sync_every=args.sync_every,
                 prefill_chunk=args.prefill_chunk, spec_depth=args.spec_depth,
                 draft=args.draft, cache_layout=args.cache_layout,
                 page_size=args.page_size, n_pages=args.n_pages,
                 overlap=args.overlap, aot=args.aot,
                 pipeline_depth=args.pipeline_depth if args.overlap else 2,
                 continuous=args.continuous, admission_thread=args.admission_thread,
                 pin_prefixes=args.pin_prefixes, policy=args.policy,
                 lazy_pages=args.lazy_pages, staging_depth=args.staging_depth,
                 adaptive_spec=args.adaptive_spec, profile=args.profile, device=dev,
                 mesh=mesh)
    spec = (f", spec_depth={args.spec_depth} ({eng.metrics()['draft']})"
            if args.spec_depth else "")
    layout = ("" if args.cache_layout == "ring" else
              f", paged (page_size={eng.page_size}, {eng.n_pages} pages)")
    mode = ((f"overlapped x{args.pipeline_depth}" if args.overlap else "sync")
            + (f", mesh {eng.mesh_str} ({mesh.backend})" if mesh is not None else "")
            + (", continuous" if args.continuous else "")
            + (", aot" if args.aot else ""))
    cross = ("" if source is None else
             f", cross cache {cache_bytes(eng.cache, 'cross') / 2**20:.1f} MiB "
             f"(source {tuple(source.shape)})")
    state = cache_bytes(eng.cache, "state")
    state = "" if not state else f", recurrent state {state / 2**20:.1f} MiB"
    say(f"[serve] {cfg.name}: cache {cache_bytes(eng.cache) / 2**20:.1f} MiB "
          f"({args.slots} slots x {args.max_len} positions){cross}{state}, "
          f"sync_every={args.sync_every}, device {_device_name(dev)}, "
          f"{mode}{spec}{layout}")

    g = np.random.default_rng(1)
    for i in range(args.requests):
        plen = int(g.integers(4, args.max_len // 3))
        eng.submit(Request(
            uid=i, prompt=g.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=args.new_tokens))
    finished = eng.run()
    eng.close()
    m = eng.metrics()
    say(f"[serve] {len(finished)} requests, {m['tokens']} tokens in "
          f"{m['run_seconds']:.1f}s ({m['tokens_per_s']:.1f} tok/s), "
          f"ttft {m['ttft_s'] * 1e3:.1f}ms")
    say(f"[serve] host syncs/token {m['host_syncs_per_token']:.3f} "
          f"(decode windows: {m['decode_syncs_per_token']:.3f}), "
          f"occupancy {m['occupancy_mean']:.2f}/{args.slots}, "
          f"queue depth {m['queue_depth_mean']:.2f}")
    if args.overlap:
        say(f"[serve] overlap: {m['window_overlap']:.2f} of windows "
              f"dispatched before the prior completed, "
              f"{m['windows_idle']} idle windows, "
              f"device occupancy {m['occupancy_device_mean']:.2f}/{args.slots}"
              + (f", {m['slot_swaps']} in-scan swaps" if args.continuous else ""))
    if args.spec_depth:
        say(f"[serve] speculation: accept rate {m['accept_rate']:.2f} "
              f"({m['draft_accepted']}/{m['draft_proposed']} draft tokens accepted)")
    if args.cache_layout == "paged":
        say(f"[serve] pages: peak {m['pages_peak']}/{m['pages_total']}, "
              f"{m['pages_shared']} shares, {m['cow_forks']} COW forks, "
              f"{m['prefix_resurrections']} prefix resurrections")
        say(f"[serve] admission: policy={m['policy']}, "
              f"{m['prefill_calls']} prefill calls "
              f"({m['prefill_calls_saved']} saved), "
              f"{m['preemptions']} preemptions"
              + (f", {m['pages_parked']} pages parked" if m['pages_parked'] else ""))
    if eng.unfinished["queued"] or eng.unfinished["in_flight"]:
        say(f"[serve] WARNING unfinished: {eng.unfinished}")
    return finished


if __name__ == "__main__":
    main()
