#!/usr/bin/env python3
"""Where the dense verify kernel's time goes, at chip_smoke.py's shapes.

    python3 benchmarks_torch/dense_verify_probe.py [--out FILE]

Builds ``csrc/dense_verify.cu`` as the tree has it and two variants of it
under ``build/dense_verify_probe/`` (gitignored): ``skip``, the same
kernels with the per-tile compute skipped (the prologue, the loads, the
waits and barriers, the epilogue and the chunk merge stay), and
``heads``, the grid with the kv head fastest instead of the chunk.  Then,
in bf16 on ring operands at chip_smoke's dense shapes (qwen3-4b's heads
at nq 4 / 9 / 16: 16 / 36 / 64 rows a kv head; qwen3-moe-235b-a22b's at
nq 1 / 4 / 16: 16 / 64 / 256 rows), it times with device events
(``chip_smoke.cuda_ms``):

* the tree's kernel, the two variants and the tree's kernel again, and
  checks that ``heads`` gives the tree's bits;
* the tree's kernel at forced chunk lengths of 4-32 tiles beside the
  wrapper's own plan (``dense_decode._mq_plan``), with each length's
  blocks an SM from the card and its waves.

Prints one line per measurement and the card's name and power limit;
``--out`` also writes them to FILE.  Needs a CUDA card and ``nvcc``;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SHAPES = [(16, "qwen3-4b"), (9, "qwen3-4b"), (4, "qwen3-4b"),
          (1, "qwen3-moe-235b-a22b"), (4, "qwen3-moe-235b-a22b"),
          (16, "qwen3-moe-235b-a22b")]


def variants(src: str) -> dict[str, str]:
    """The ``skip`` and ``heads`` sources (``EXP_SKIP`` is defined 1)."""
    skip = src
    for a, b in [("    const bool next = i + 1 < n_live;\n",
                  "    const bool next = i + 1 < n_live;\n    if (EXP_SKIP) continue;\n"),
                 ("    float s[4][4];\n    tile_scores<T, DH>(s, my_ring",
                  "    if (EXP_SKIP) {\n      tc::cp_async_wait<STAGES - 2>();\n      __syncwarp();\n"
                  "      if (2 * i + STAGES < total) issue(2 * i + STAGES);\n"
                  "      tc::cp_async_commit();\n      continue;\n    }\n"
                  "    float s[4][4];\n    tile_scores<T, DH>(s, my_ring")]:
        assert a in skip, a
        skip = skip.replace(a, b)
    heads = src
    for a, b in [("  const int c = blockIdx.x / n_mt, r0 = (blockIdx.x % n_mt) * MT;\n"
                  "  const int h = blockIdx.y, b = blockIdx.z;",
                  "  const int c = blockIdx.y / n_mt, r0 = (blockIdx.y % n_mt) * MT;\n"
                  "  const int h = blockIdx.x, b = blockIdx.z;"),
                 ("  const int c = blockIdx.x / n_g, r0 = (blockIdx.x % n_g) * RG;\n"
                  "  const int h = blockIdx.y, b = blockIdx.z;",
                  "  const int c = blockIdx.y / n_g, r0 = (blockIdx.y % n_g) * RG;\n"
                  "  const int h = blockIdx.x, b = blockIdx.z;"),
                 ("dim3(a.n_chunks * n_blk, a.Hkv, a.B)", "dim3(a.Hkv, a.n_chunks * n_blk, a.B)")]:
        assert a in heads, a
        heads = heads.replace(a, b)
    return {"skip": skip, "heads": heads}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("dense_verify_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.kernels import build
    from repro_torch.kernels import dense_decode as KD

    lines = []

    def say(line):
        print(line, flush=True)
        lines.append(line)

    say(C.card_line())
    real = KD._lib("dense_verify")
    exp = ROOT / "build" / "dense_verify_probe"
    exp.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in variants((build.CSRC / "dense_verify.cu").read_text()).items():
        (exp / f"{name}.cu").write_text(src)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-DEXP_SKIP=1",
               "-o", str(exp / f"{name}.so"), str(exp / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        lib = ctypes.CDLL(str(exp / f"{name}.so"))
        for entry in (*KD._TC_ENTRIES, *KD._MQ_ENTRIES, "recalkv_dense_decode_mq_smem",
                      "recalkv_dense_decode_mq_blocks_per_sm"):
            getattr(lib, entry).argtypes = getattr(real, entry).argtypes
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib

    lib_of, plan = KD._lib, KD._mq_plan

    def timed(fn, variant=None, forced=None):
        KD._lib = (lambda n: libs[variant] if n == "dense_verify" else lib_of(n)) \
            if variant else lib_of
        KD._mq_plan = (lambda *a: forced) if forced else plan
        plan.cache_clear()
        try:
            return C.cuda_ms(fn, iters=50), fn()
        finally:
            KD._lib, KD._mq_plan = lib_of, plan
            plan.cache_clear()

    gen = torch.Generator(device="cuda").manual_seed(C.SEED)
    for nq, arch in SHAPES:
        a = C.ring_inputs(torch, gen, nq, dense=True, arch=arch)
        B, S, G, Hg, dh, _, _, _ = a["shape"]
        dt = torch.bfloat16
        q, k, v = a["q"].to(dt), a["zk"].to(dt), a["zv"].to(dt)
        if nq == 1:
            bias = a["bias"][:, 0, :S].contiguous()
            sk, sv = a["self_zk"][:, 0].to(dt), a["self_zv"][:, 0].to(dt)
            fn = lambda: KD.launch(q, k, v, bias, dh ** -0.5, sk, sv, body="tensor_core")
        else:
            bias, sk, sv = a["bias"], a["self_zk"].to(dt), a["self_zv"].to(dt)
            fn = lambda: KD.launch(q, k, v, bias, dh ** -0.5, sk, sv, nq=nq)
        tag = f"{arch} nq {nq} ({nq * Hg} rows a kv head), B {B}, S {S}, Hkv {G}, dh {dh}"
        ms, ref = timed(fn)
        skip_ms, _ = timed(fn, "skip")
        heads_ms, heads_out = timed(fn, "heads")
        again, _ = timed(fn)
        say(f"{tag}: kernel {ms:.4f} ms, compute skipped {skip_ms:.4f} ms, kv head fastest "
            f"{heads_ms:.4f} ms (same bits: {torch.equal(ref, heads_out)}), kernel again "
            f"{again:.4f} ms")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        chosen = plan(real, 1, dh, B, G, nq, Hg, S, 1 if nq == 1 else None, sms)
        s_ext = S + nq
        for tiles in (4, 6, 8, 11, 13, 15, 17, 20, 24, 28, 32):
            cl = tiles * 32
            if real.recalkv_dense_decode_mq_smem(1, dh, nq, Hg, cl) > KD._SMEM_LIMIT:
                continue
            nc = -(-s_ext // cl)
            per_sm = real.recalkv_dense_decode_mq_blocks_per_sm(1, dh, nq, Hg, cl)
            blocks = B * G * KD.row_blocks(nq * Hg)[1] * nc
            ms, _ = timed(fn, forced=(cl, nc))
            say(f"{tag}: chunk {cl}{' (the plan)' if (cl, nc) == chosen else ''}, "
                f"{nc} chunks, {blocks} blocks, {per_sm} an SM, {blocks / (per_sm * sms):.2f} "
                f"waves: {ms:.4f} ms")
        say(f"{tag}: the plan's chunk {chosen[0]} ({chosen[1]} chunks)")
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
