"""Where the flash backward's time goes at head dim 256, on one H100.

Builds variants of ``src/repro_torch/csrc/flash_attention_bwd.cu``, each
the source with one part changed by a text substitution (an anchor that
is no longer found stops the script), and times ``flash_attention_bwd_op``
through a CUDA graph (``chip_smoke.graph_ms``) on each, at the bf16
D = 256 shapes of ``chip_smoke.FLASH_BWD_CASES`` and at qwen2.5-3b's
D = 128 train shape.  Variants:

* ``kernel``: the source as it is;
* ``branch_per_element``: the D = 256 consumers form P with the mask test
  and the exponential in one branch per element, the first form of the
  one-worker kernel (exact);
* ``overlap``: the D = 256 dK/dV warpgroups issue the next iteration's
  first product before waiting for the current second one (exact);
* ``no_loads``: the producer copies nothing and only signals the stages
  (every head dim);
* ``no_products``: the D = 256 consumers issue no ``wgmma``;
* ``no_exp``: the D = 256 consumers leave the exponentials out.

An exact variant must give the kernel's bits at every shape (checked);
the others compute something else and are timed only.  ``kernel`` runs
first and last, the variants named on the command line (all by default)
between, each a JSON line with its graph ms per shape and the spill
bytes nvcc reports for its D = 256 entry; the card's ``nvidia-smi`` line
prints first.

Run on a card:  python3 flash_bwd_probe.py
                python3 flash_bwd_probe.py no_exp branch_per_element
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "src/repro_torch/csrc/flash_attention_bwd.cu"
BUILD = ROOT / "build" / "flash_bwd_probe"

# the D = 256 consumers' P, as the kernel forms it and with a branch per element
P_DKDV = """          if (!all_kept(qlo, k_lo, s)) {
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const int col = (i / 4) * 8 + c0 + (i & 1);  // query in the tile
              x[i] = kept(qlo + col, k_lo + r0 + 8 * ((i >> 1) & 1), s) ? x[i] : -INFINITY;
            }
          }
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 l2 = *reinterpret_cast<const float2*>(f + jj * 8 + c0);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              x[4 * jj + e] = exp2f(fmaf(x[4 * jj + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
          }
"""
P_DKDV_BRANCH = """          const bool mask = !all_kept(qlo, k_lo, s);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 l2 = *reinterpret_cast<const float2*>(f + jj * 8 + c0);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * jj + e;
              const int col = jj * 8 + c0 + (e & 1);
              x[i] = !mask || kept(qlo + col, k_lo + r0 + 8 * (e >> 1), s)
                         ? exp2f(fmaf(x[i], scale_log2, -((e & 1) ? l2.y : l2.x)))
                         : 0.f;
            }
          }
"""
P_DQ = """          if (!all_kept(q_lo, kv_lo, s)) {
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const int key = kv_lo + (i / 4) * 8 + c0 + (i & 1);
              x[i] = kept(q_lo + r0 + 8 * ((i >> 1) & 1), key, s) ? x[i] : -INFINITY;
            }
          }
#pragma unroll
          for (int i = 0; i < 32; ++i)
            x[i] = exp2f(fmaf(x[i], scale_log2, -lse2[(i >> 1) & 1]));  // P
"""
P_DQ_BRANCH = """          const bool mask = !all_kept(q_lo, kv_lo, s);
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1;
            const int key = kv_lo + (i / 4) * 8 + c0 + (i & 1);
            x[i] = !mask || kept(q_lo + r0 + 8 * r, key, s)
                       ? exp2f(fmaf(x[i], scale_log2, -lse2[r]))
                       : 0.f;
          }
"""
FIRST_DKDV = "wgmma_abt<D>(x, g == 0 ? fa : fbt, g == 0 ? sq : sdo);"
FIRST_DQ = "wgmma_abt<D>(x, g == 0 ? fa : fbt, g == 0 ? sk : sv);"
SECOND_DKDV = "wgmma_ab<D>(acc, a, g == 0 ? sdo : sq);"
SECOND_DQ = "wgmma_ab<D / 2>(acc, a, sk + g * (D / 128) * C::BOX);"
NO_FIRST = "for (int i = 0; i < 32; ++i) x[i] = __int_as_float(0x3f000000 - i);"
NO_SECOND = "acc[0] += __uint_as_float(a[0][0] ^ a[3][3]);"

# (exact, [(anchor, replacement), ...]) per variant
VARIANTS = {
    "kernel": (True, []),
    "branch_per_element": (True, [(P_DKDV, P_DKDV_BRANCH), (P_DQ, P_DQ_BRANCH)]),
    "overlap": (True, [
        ("""      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      for (int it = j.it0; it < j.it1; ++it, ++n) {""",
         """      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      int prev = -1;  // the stage whose second product is in flight
      for (int it = j.it0; it < j.it1; ++it, ++n) {"""),
        (FIRST_DKDV + """  // S^T = K Q^T, dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<0>();""", FIRST_DKDV + """
        wgmma_commit();
        wgmma_wait<1>();
        if (prev >= 0) mbar_arrive(bar.empty(prev));
        wgmma_wait<0>();"""),
        (SECOND_DKDV + """  // dV += P^T dO, dK += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(bar.empty(st));
      }""", SECOND_DKDV + """
        wgmma_commit();
        prev = st;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0) mbar_arrive(bar.empty(prev));""")]),
    "no_loads": (False, [
        ("""        mbar_expect_tx(bar.fixed_full(fb), C::FIXED);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(fixed + c * C::BOX, ma, bar.fixed_full(fb), c * 64, row, j.head, j.b);
          tma_load_4d(fixed + C::TILE_BYTES + c * C::BOX, mb, bar.fixed_full(fb), c * 64, row,
                      j.head, j.b);
        }""", """        (void)fixed, (void)ma, (void)mb, (void)row;
        mbar_arrive(bar.fixed_full(fb));"""),
        ("""          mbar_expect_tx(bar.full(st), C::STAGE + 512);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(dst + c * C::BOX, &tmq, bar.full(st), c * 64, qlo, h, j.b);
            tma_load_4d(dst + C::TILE_BYTES + c * C::BOX, &tmdo, bar.full(st), c * 64, qlo, h,
                        j.b);
          }
          bulk_load(f, lse2p + prow, 256, bar.full(st));
          bulk_load(f + 256, deltap + prow, 256, bar.full(st));""", """          (void)dst, (void)prow, (void)f;
          mbar_arrive(bar.full(st));"""),
        ("""          mbar_expect_tx(bar.full(st), C::STAGE);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(dst + c * C::BOX, &tmk, bar.full(st), c * 64, it * TILE, kvh, j.b);
            tma_load_4d(dst + C::TILE_BYTES + c * C::BOX, &tmv, bar.full(st), c * 64,
                        it * TILE, kvh, j.b);
          }""", """          (void)dst, (void)kvh;
          mbar_arrive(bar.full(st));""")]),
    "no_products": (False, [(FIRST_DKDV, NO_FIRST), (FIRST_DQ, NO_FIRST),
                            (SECOND_DKDV, NO_SECOND), (SECOND_DQ, NO_SECOND)]),
    "no_exp": (False, [
        ("x[4 * jj + e] = exp2f(fmaf(x[4 * jj + e], scale_log2, -((e & 1) ? l2.y : l2.x)));",
         "x[4 * jj + e] = fmaf(x[4 * jj + e], scale_log2, -((e & 1) ? l2.y : l2.x));"),
        ("x[i] = exp2f(fmaf(x[i], scale_log2, -lse2[(i >> 1) & 1]));",
         "x[i] = fmaf(x[i], scale_log2, -lse2[(i >> 1) & 1]);")]),
}


def variant_source(name: str) -> str:
    text = SOURCE.read_text()
    for anchor, replacement in VARIANTS[name][1]:
        if text.count(anchor) != 1:
            raise SystemExit(f"flash_bwd_probe: {name}: an anchor is not found once in "
                             f"{SOURCE.name}:\n{anchor}")
        text = text.replace(anchor, replacement)
    return text


def build(names, common, cs) -> dict:
    """Each variant's library under build/flash_bwd_probe/, nvcc's all at
    once; returns the spill store bytes of each one's D = 256 entry."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = BUILD / f"{name}.cu"
        src.write_text(variant_source(name))
        procs[name] = subprocess.Popen(
            [common.nvcc_path(), *common.NVCC_FLAGS, "-o", str(BUILD / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    spills = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"flash_bwd_probe: nvcc failed for {name}:\n{text[-4000:]}")
        spills[name] = sum(e["spill_store_bytes"] for e in cs.ptxas_summary(text)
                           if "bwd_dq_dkdv_tcILi256E" in e["entry"])
    return spills


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import ops

    names = argv or [n for n in VARIANTS if n != "kernel"]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"flash_bwd_probe: unknown variants {unknown}; "
                         f"known: {sorted(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_probe: no CUDA device is available")
    print(cs.nvidia_smi_line(), flush=True)
    spills = build(sorted(set(names) | {"kernel"}), common, cs)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [c for c in cs.FLASH_BWD_CASES if c[4] == 256 and c[6] == "bfloat16"]
    cases.append(cs.FLASH_BWD_CASES[0])
    inputs = []
    for B, S, H, KV, D, window, _dtype, *rest in cases:
        Sk, causal = rest if rest else (S, True)
        q, k, v, do = ((torch.randn(*shape, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
                       for shape in ((B, S, H, D), (B, Sk, KV, D), (B, Sk, KV, D), (B, S, H, D)))
        out, lse = ops.flash_attention_fwd_lse(q, k, v, window=window, causal=causal)
        tag = f"B{B}_S{S}x{Sk}_H{H}_KV{KV}_D{D}_w{window}{'' if causal else '_full'}"
        inputs.append((tag, (q, k, v, out, do, lse), dict(window=window, causal=causal)))
    library_path = common.library_path
    truth = {}
    for name in ["kernel", *names, "kernel"]:
        common.library_path = (lambda lib, name=name: BUILD / f"{name}.so"
                               if lib == "flash_attention_bwd" else library_path(lib))
        common._libs.pop("flash_attention_bwd", None)
        row = {"variant": name, "spill_store_bytes_d256": spills[name]}
        exact = VARIANTS[name][0]
        for tag, args, kwargs in inputs:
            def call(args=args, kwargs=kwargs):
                return ops.flash_attention_bwd_op(*args, **kwargs)
            grads = call()
            torch.cuda.synchronize()
            if name == "kernel" and tag not in truth:
                truth[tag] = grads
            elif exact:
                row[f"{tag}_bit_equal"] = all(torch.equal(a, b) for a, b in zip(grads, truth[tag]))
            row[tag] = cs.graph_ms(torch, call)
        print(json.dumps(row), flush=True)
        if exact and not all(v for k, v in row.items() if k.endswith("_bit_equal")):
            raise SystemExit(f"flash_bwd_probe: {name} does not give the kernel's bits")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
