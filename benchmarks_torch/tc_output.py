#!/usr/bin/env python3
"""Output and time of a bf16 kernel (K1-K7), to hold two versions of it to
the same bits and time them in one call.

    python3 benchmarks_torch/tc_output.py --kernel k4 --src DIR --out FILE [--no-self]
    python3 benchmarks_torch/tc_output.py --compare FILE_A FILE_B

``--src`` imports ``repro_torch`` from DIR (the ``src`` of this checkout,
or of an older commit unpacked with ``git archive``; each tree builds its
own kernels), runs the kernel in bf16 on operands made on the CPU from
seed 0 at chip_smoke.py's shapes, saves the output with ``torch.save`` and
prints the kernel's time (CUDA events, mean of 50 launches after 5):

  k1  ``latent_decode_attention``: B=8, a full 4096-token ring, G=2,
      Hg=16, dh=128, r=256, k-norm and the self column;
  k4  ``latent_decode_attention_paged``: the same widths over 16-token
      pages at shuffled physical pages, rows of 1024..4096 tokens;
  k3  ``latent_decode_attention_quant``: k1's ring and self column as
      int8 latents with f32 scales;
  k6  ``latent_decode_attention_mq_quant``: k1's ring as int8 latents with
      f32 scales, nq=4 verify queries and their 4 self columns;
  k5  ``latent_decode_attention_mq``: k1's ring (bf16 latents), nq=4 verify
      queries and their 4 self columns;
  k7  ``latent_decode_attention_mq_paged``: k4's pool, nq=4 verify queries
      and their 4 self columns;
  k2  ``flash_prefill_attention``: B=8, T=2048, H=32, Hkv=8, latent values
      Hv=2, dv=256, causal.

``--no-self`` leaves the self columns out (their operands, and k6's last
nq bias columns): the time saved is what the chunk that holds only them
costs.  ``--compare`` prints the max |a - b| of two such files and exits
1 unless they are equal bit for bit.  Needs a card for ``--src``; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys

B, S, G, HG, DH, R, SLOTS, PAGE, NQ = 8, 4096, 2, 16, 128, 256, 4, 16, 4


def _rope(pos, torch):
    ang = pos.float()[..., None] * 1e6 ** (-torch.arange(0, DH, 2).float() / DH)
    return ang.cos(), ang.sin()


def _quant(z, torch):
    """int8 latents and f32 scales, one per row of the last axis."""
    s = z.abs().amax(-1).clamp_min(1e-8) / 127
    return torch.round(z / s[..., None]).clamp(-127, 127).to(torch.int8), s


def operands(kernel: str, torch):
    """Seeded float32 operands on the CPU (the same on every tree):
    (positional args, keyword args) of the kernel's wrapper."""
    g = torch.Generator().manual_seed(0)
    rn = lambda *sh: torch.randn(sh, generator=g)
    if kernel == "k2":
        return (rn(B, 2048, 32, DH), rn(B, 2048, 8, DH), rn(B, 2048, G, R)), {}
    r_k = rn(G, R, SLOTS * DH) * R ** -0.5
    kw = dict(scale=DH ** -0.5, k_norm=0.1 * rn(DH))
    if kernel in ("k4", "k7"):
        nq = NQ if kernel == "k7" else 1
        n_sp = S // PAGE
        lens = torch.randint(1024, S + 1, (B,), generator=g)
        used = (lens + PAGE - 1) // PAGE
        n_pages = int(used.sum()) + 1
        perm = (torch.randperm(n_pages - 1, generator=g) + 1).tolist()
        ptab = torch.zeros(B, n_sp, dtype=torch.int32)
        for b in range(B):
            ptab[b, :used[b]] = torch.tensor(perm[:used[b]], dtype=torch.int32)
            perm = perm[used[b]:]
        t = torch.arange(S)
        pos = torch.where(t[None] < lens[:, None], t[None], -1)
        cos, sin = _rope(pos, torch)
        bias = torch.where(pos >= 0, 0.0, -1e30)
        self_cos, self_sin = _rope(lens[:, None] + torch.arange(nq), torch)
        sel = (lambda x: x[:, 0]) if nq == 1 else (lambda x: x)
        if kernel == "k7":   # the verify window is causal among its self columns
            causal = torch.triu(torch.full((nq, nq), -1e30), 1)
            bias = torch.cat([bias[:, None].expand(B, nq, S), causal.expand(B, nq, nq)], 2)
        kw.update(self_zk=sel(rn(B, nq, G, R)), self_zv=sel(rn(B, nq, G, R)),
                  self_cos=sel(self_cos), self_sin=sel(self_sin))
        return (ptab, rn(B, G, nq * HG, DH), rn(n_pages, PAGE, G, R),
                rn(n_pages, PAGE, G, R), r_k, cos, sin, bias), kw
    nq = NQ if kernel in ("k5", "k6") else 1
    cos, sin = _rope(torch.arange(S).expand(B, S), torch)
    self_cos, self_sin = _rope(S + torch.arange(nq).expand(B, nq), torch)
    zk, zv = rn(B, S, G, R), rn(B, S, G, R)
    szk, szv = rn(B, nq, G, R), rn(B, nq, G, R)
    q = rn(B, G, nq * HG, DH)
    if kernel == "k1":
        kw.update(self_zk=szk[:, 0], self_zv=szv[:, 0], self_cos=self_cos[:, 0],
                  self_sin=self_sin[:, 0])
        return (q, zk, zv, r_k, cos, sin, torch.zeros(B, S)), kw
    causal = torch.triu(torch.full((nq, nq), -1e30), 1)   # the verify window
    bias = torch.cat([torch.zeros(B, nq, S), causal.expand(B, nq, nq)], dim=2)
    if kernel == "k5":
        kw.update(self_zk=szk, self_zv=szv, self_cos=self_cos, self_sin=self_sin)
        return (q, zk, zv, r_k, cos, sin, bias), kw
    q8 = [t for z in (zk, zv, szk, szv) for t in _quant(z, torch)]
    if kernel == "k3":
        kw.update(self_zk_q=q8[4][:, 0], self_zk_s=q8[5][:, 0], self_zv_q=q8[6][:, 0],
                  self_zv_s=q8[7][:, 0], self_cos=self_cos[:, 0], self_sin=self_sin[:, 0])
        return (q, *q8[:4], r_k, cos, sin, torch.zeros(B, S)), kw
    kw.update(self_zk_q=q8[4], self_zk_s=q8[5], self_zv_q=q8[6], self_zv_s=q8[7],
              self_cos=self_cos, self_sin=self_sin)
    return (q, *q8[:4], r_k, cos, sin, bias), kw


def run(kernel: str, src: str, out: str, no_self: bool) -> int:
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import flash_prefill as K2
    from repro_torch.kernels import latent_decode as K
    from repro_torch.kernels import latent_decode_q as KQ
    fn = {"k1": K.latent_decode_attention, "k2": K2.flash_prefill_attention,
          "k3": KQ.latent_decode_attention_quant, "k4": K.latent_decode_attention_paged,
          "k5": K.latent_decode_attention_mq, "k6": KQ.latent_decode_attention_mq_quant,
          "k7": K.latent_decode_attention_mq_paged}[kernel]
    args, kw = operands(kernel, torch)
    if no_self:
        kw = {k: v for k, v in kw.items() if not k.startswith("self_")}
        args = (*args[:-1], args[-1][..., :S].contiguous())
    bf16 = lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t
    # q, r_k and float latents (k2: q, k, v) in bf16; tables, bias, scales
    # and k_norm f32
    lat = {"k1": (0, 1, 2, 3), "k2": (0, 1, 2), "k3": (0, 5), "k4": (1, 2, 3, 4),
           "k5": (0, 1, 2, 3), "k6": (0, 5), "k7": (1, 2, 3, 4)}[kernel]
    args = [bf16(a).cuda() if i in lat else a.cuda() for i, a in enumerate(args)]
    kw = {k: (bf16(v) if k in ("self_zk", "self_zv") else v).cuda()
          if hasattr(v, "cuda") else v for k, v in kw.items()}
    got = fn(*args, **kw)
    for _ in range(5):
        fn(*args, **kw)
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(50):
        fn(*args, **kw)
    t1.record()
    torch.cuda.synchronize()
    torch.save(got.cpu(), out)
    print(f"{kernel} bf16{' without self columns' if no_self else ''} from "
          f"{fn.__module__} in {src}: {tuple(got.shape)}, finite "
          f"{bool(torch.isfinite(got.float()).all())}, {t0.elapsed_time(t1) / 50:.4f} ms, "
          f"saved to {out}")
    return 0


def compare(path_a: str, path_b: str) -> int:
    import torch
    a, b = torch.load(path_a), torch.load(path_b)
    diff = (a.float() - b.float()).abs().max().item()
    same = a.dtype == b.dtype and torch.equal(a, b)
    print(f"{path_a} vs {path_b}: max |diff| {diff:.3e}, bit for bit "
          f"{'equal' if same else 'DIFFERENT'}")
    return 0 if same else 1


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--kernel", choices=("k1", "k2", "k3", "k4", "k5", "k6", "k7"),
                   default="k4")
    p.add_argument("--src")
    p.add_argument("--out")
    p.add_argument("--no-self", action="store_true")
    p.add_argument("--compare", nargs=2)
    args = p.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not (args.src and args.out):
        p.error("give --src and --out, or --compare")
    return run(args.kernel, args.src, args.out, args.no_self)


if __name__ == "__main__":
    sys.exit(main())
