#!/usr/bin/env python3
"""Time variants of the dK/dV kernel (K2) and the int4 matmul (K4) beside
the kernels as they are, on one H100, in one process per kernel.

    python3 scripts/kernel_ablations.py      # from the repository root

Each variant is the kernel's source with one edit (below), built with the
same nvcc flags into build/navillm_tpu_torch/ablations/ and bound in place
of the real library; the times alternate base, variants, variants
reversed, base, so drift in the card's clock shows. K2 runs at B=16,
T=1024, 32 heads of 128, causal, full masks; K4 at m=4096, h=4096,
o=11008 (the w_gate shape) in w4 and w4a8. K4's ablations drop one part of
the work to show what its time is made of; their outputs are wrong by
design, and only K2's variants are checked against the plain version.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from navillm_tpu_torch.ops import _build  # noqa: E402

OUT = _build.BUILD_DIR / "ablations"

K2 = {
    "2-stage ring": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
    # the next tile's S^T / dP^T issued right behind this tile's dV / dK
    # product, waiting only for the latter
    "pipelined": [
        ("  mbar_wait(kv_bar, 0);\n",
         "  mbar_wait(kv_bar, 0);\n  float s[BQ / 2];\n"),
        ("    mbar_wait(&full[stage], (it / STAGES) & 1);\n",
         "    if (it == 0) mbar_wait(&full[0], 0);\n"),
        ("""    float s[BQ / 2];
    fence_regs(s);
    wgmma_fence();
    gemm_ss<BQ, D>(s, smem + (dv_side ? L::k : L::v), BK, dv_side ? sq : sdo);
    wgmma_commit();
    wgmma_wait<0>();""", """    if (it == 0) {
      fence_regs(s);
      wgmma_fence();
      gemm_ss<BQ, D>(s, smem + (dv_side ? L::k : L::v), BK,
                     dv_side ? sq : sdo);
      wgmma_commit();
    }
    wgmma_wait<0>();"""),
        ("""    gemm_rs<D, BQ>(acc, a, dv_side ? sdo : sq);
    wgmma_commit();
    wgmma_wait<0>();""", """    gemm_rs<D, BQ>(acc, a, dv_side ? sdo : sq);
    wgmma_commit();
    if (it + 1 < n_iters) {
      const int nx = (it + 1) % STAGES;
      mbar_wait(&full[nx], ((it + 1) / STAGES) & 1);
      fence_regs(s);
      wgmma_fence();
      gemm_ss<BQ, D>(s, smem + (dv_side ? L::k : L::v), BK,
                     smem + (dv_side ? L::q : L::dout) + nx * BQ * D * 2);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }"""),
    ],
}

K4 = {
    "no unpack": [("  const int item = u % ITEMS, part = u / ITEMS;",
                   "  if (u >= 0) return;\n"
                   "  const int item = u % ITEMS, part = u / ITEMS;")],
    "no rescale": [("          acc[i] = __fadd_rn(acc[i], __fmul_rn("
                    "static_cast<float>(part[i]),\n"
                    "                                               (e & 1) ? "
                    "s2.y : s2.x));",
                    "          acc[i] += (e & 1) ? 0.f : 1e-30f * i;")],
    "no products": [('''        if constexpr (INT8)
          wgmma_ss_n128_s8(part, da, db, kk > gi * spg);
        else
          wgmma_ss_n128(part, da, db, kk > gi * spg);''',
                     "        (void)da;\n        (void)db;")],
}


def build(source: str, variants):
    """{name: path of the built library}; "base" is the source as it is."""
    OUT.mkdir(parents=True, exist_ok=True)
    for h in _build.CSRC.glob("*.cuh"):
        (OUT / h.name).write_text(h.read_text())
    text = (_build.CSRC / f"{source}.cu").read_text()
    procs = {}
    for name, edits in {"base": [], **variants}.items():
        t = text
        for old, new in edits:
            if t.count(old) != 1:
                raise RuntimeError(f"{source} / {name}: the edit's anchor is "
                                   f"not in the source once")
            t = t.replace(old, new)
        f = OUT / f"{source}_{re.sub(r'[^a-z0-9]+', '_', name)}.cu"
        f.write_text(t)
        procs[name] = (f.with_suffix(".so"), subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
             str(f.with_suffix(".so")), str(f)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {source} / {name}:\n{log}")
        spills = sorted({int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                                    log)})
        print(f"{source} / {name}: spill stores {spills} bytes")
        libs[name] = str(so)
    return libs


def main():
    import torch
    from navillm_tpu_torch.models.llama import _act_q
    from navillm_tpu_torch.models.quant import _quant_one4
    from navillm_tpu_torch.ops import attention as A
    from navillm_tpu_torch.ops import matmul_q4 as M
    from navillm_tpu_torch.testing import attn_excess

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the ablations run on an H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    current = {}
    real = _build.load
    _build.load = lambda name: (_build.Built(current[name], Path(name), 0.0,
                                             "")
                                if name in current else real(name))

    def ms(fn, iters=30):
        for _ in range(3):
            fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    def run(source, libs, measure):
        names = list(libs)
        for name in names + names[::-1]:
            current[source] = ctypes.CDLL(libs[name])
            print(f"{source} / {name}: {measure()}", flush=True)
        del current[source]

    g = torch.Generator(device="cuda").manual_seed(0)
    b, t, nh, d = 16, 1024, 32, 128
    sc = d ** -0.5
    q, k, v, do = (torch.randn((b, t, nh, d), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    mask = torch.ones((b, t), dtype=torch.bool, device="cuda")
    o, lse = A.flash_attention_fwd(q, k, v, mask, causal=True, scale=sc)
    delta = A.flash_attention_bwd_dq(q, k, v, mask, lse, o, do, causal=True,
                                     scale=sc)[1]
    want = A.flash_attention_bwd_dkv_reference(q, k, v, mask, lse, delta, do,
                                               True, sc)

    def k2():
        def call():
            return A.flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do,
                                             causal=True, scale=sc)
        got = call()
        ex = max(attn_excess(x, w, mask) for x, w in zip(got, want))
        return f"{ms(call):.4f} ms (gate excess {ex:.3f})"

    run("flash_attn_bwd", build("flash_attn_bwd", K2), k2)
    del want

    m, h, n = 4096, 4096, 11008
    w = torch.randn((h, n), generator=g, device="cuda") * h ** -0.5
    q4p, s = _quant_one4(w.to(torch.bfloat16))
    x = torch.randn((m, h), generator=g, device="cuda").to(torch.bfloat16)
    xq = _act_q(x)[0]

    def k4():
        return (f"w4 {ms(lambda: M.matmul_q4(x, q4p, s)):.4f} ms, w4a8 "
                f"{ms(lambda: M.matmul_q4(xq, q4p, s)):.4f} ms")

    run("matmul_q4", build("matmul_q4", K4), k4)


if __name__ == "__main__":
    main()
