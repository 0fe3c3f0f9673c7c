#!/usr/bin/env python3
"""What the bf16 P split costs K2: csrc/flash_prefill.cu against a copy
that multiplies P by V once, as one bf16 operand.

    python3 benchmarks_torch/k2_ablate.py

Builds the committed ``src/repro_torch/csrc/flash_prefill.cu`` and the copy
(the two ``pl`` wgmma lines removed), each with ``nvcc`` into its own library
under ``build/k2_ablate/`` (sources written there, headers from ``csrc``),
then times both bf16 kernels at chip_smoke.py's K2 shape (B=8, T=2048,
H=32, Hkv=8, Hv=2, dh=128, dv=256, causal) over 50 launches, twice, in
turns, on one card.  Each line gives the build's worst |err| / (2e-2
|plain| + 1e-2 rms(plain)) against the f32 plain version, its ptxas
registers and spills, and its times.  The copy misses that limit; it exists
only to be timed.  Needs a card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(B=8, T=2048, H=32, Hkv=8, Hv=2, dh=128, dv=256)

# P V on hi only: one bf16 rounding of P
LO_LINES = ("        wg::wgmma_rs_n256_tb(o, pl[kk], vd);\n",
            "        wg::wgmma_rs_n64_tb(o, pl[kk], vd);\n")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k2_ablate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_prefill import flash_prefill_attention_plain

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    src = (build.CSRC / "flash_prefill.cu").read_text()
    one = src
    for line in LO_LINES:
        if one.count(line) != 1:
            raise RuntimeError(f"{line.strip()!r} is not in flash_prefill.cu once")
        one = one.replace(line, "")
    out = ROOT / "build" / "k2_ablate"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in {"kernel": src, "p_one_bf16": one}.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(out / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs[name] = [e for e in build.ptxas_summary(log) if "flash_prefill_tc<128, 256>" in e["kernel"]]
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.recalkv_flash_prefill.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p])
        libs[name] = lib

    s = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16)
               for sh in ((s["B"], s["T"], s["H"], s["dh"]), (s["B"], s["T"], s["Hkv"], s["dh"]),
                          (s["B"], s["T"], s["Hv"], s["dv"])))
    want = flash_prefill_attention_plain(q, k, v).float()
    limit = 2e-2 * want.abs() + 1e-2 * want.square().mean().sqrt()
    outs, calls = {}, {}
    for name, lib in libs.items():
        o = torch.empty((s["B"], s["T"], s["H"], s["dv"]), device="cuda", dtype=torch.bfloat16)
        outs[name] = o
        calls[name] = (lambda lib=lib, o=o: lib.recalkv_flash_prefill(
            1, s["dh"], s["dv"], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            s["B"], s["T"], s["H"], s["Hkv"], s["Hv"], 1, 0, s["dh"] ** -0.5,
            torch.cuda.current_stream().cuda_stream))
    times = {name: [] for name in libs}
    for _ in range(2):                       # in turns: every build, then again
        for name, fn in calls.items():
            if fn() != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            for _ in range(3):
                fn()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(50):
                fn()
            b.record()
            torch.cuda.synchronize()
            times[name].append(a.elapsed_time(b) / 50)
    for name in libs:
        worst = ((outs[name].float() - want).abs() / limit).max().item()
        r = regs[name][0] if regs[name] else {}
        print(f"{name:13s} worst err/limit {worst:.3f}  registers {r.get('registers')} "
              f"spills {r.get('spill_stores')}/{r.get('spill_loads')} B  ms "
              + " ".join(f"{t:.4f}" for t in times[name]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
