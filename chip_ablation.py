#!/usr/bin/env python3
"""Where a flash kernel's time goes, by ablation, on one NVIDIA card.

    python3 chip_ablation.py --kernel fwd              # every variant
    python3 chip_ablation.py --kernel bwd base exp2f   # only these
    python3 chip_ablation.py --kernel fwd --rounds 3 base no_mask
    python3 chip_ablation.py --kernel fwd_f32 | bwd_f32   # the 3xTF32 ones
    python3 chip_ablation.py --kernel bwd_f32 --rounds 1 --seeds 42 43 44

Builds landiff_tpu_torch/ops/csrc/flash_fwd.cu, flash_bwd.cu or
flash_f32.cu as it is ("base") and variants of it that each change one
piece of the kernel by an exact text substitution (a substitution that
does not match the source exactly once fails the run;
tests/test_torch_port_attention.py, tests/test_torch_port_flash_bwd.py
and tests/test_torch_port_f32_variants.py check each table on the CPU),
binds each in place of the port's library for that kernel, and times the
wrapper with CUDA events, variants in turns, two rounds by default:

- fwd: attention.flash_fwd_exact and flash_fwd_int8, also with int8_pv (K
  (and V) quantization included) at the DiT shape (B=2 S=17,776 H=30
  D=64, unmasked), the exact form at the TiTok decoder shape (B=1
  S=18,768 H=12, video-decoder mask), and the int8 wrapper's K
  quantization (quantize_k_positions) alone;
- bwd: attention.flash_bwd (prologue and dq cast included) at the
  training shape (B=1 S=17,776 H=30 D=64, unmasked) and the TiTok decoder
  shape;
- fwd_f32 / bwd_f32: the f32 exact forward / the f32 backward (split
  prologues included) at the same shapes in f32, each variant also with
  its error against the plain version in float64 (max |err| over the
  largest |plain|, relative RMS): the passes (one or two TF32 passes
  against three: timed only, never a valid result), the k8 slices per fresh
  accumulator (kFwdGroup, kBwdGroup), the forward's ring depth, the
  backward's dV^T / dK^T adds, dq product and reduce-add.

A variant that drops work computes wrong outputs: its time says what that
work costs in the kernel as scheduled, not what it would cost alone.
Prints one JSON line per (round, variant), then the card's name and power
limit. Needs nvcc (as ops/kernels.py finds it) and a card.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "landiff_tpu_torch" / "ops" / "csrc"
SOURCES = {"fwd": "flash_fwd.cu", "bwd": "flash_bwd.cu",
           "fwd_f32": "flash_f32.cu", "bwd_f32": "flash_f32.cu"}

# one TF32 pass (hi.hi) instead of three (csrc/flash_f32.cu mma3, both
# kernels): the two small passes dropped, hi.hi overwriting on its first
# slice
_DROP_HI_LO = ("    for (int i = 0; i < kGroup; ++i) {         // hi.lo",
               "    for (int i = 0; i < 0; ++i) {")
_ONE_PASS = [
    ("    if constexpr (kALo) {                      // lo.hi",
     "    if constexpr (false) {"),
    _DROP_HI_LO,
    ("      wgmma_rs_n64_tf32(tmp, ah[i], bh + slice_step(g0 + i), 1);",
     "      wgmma_rs_n64_tf32(tmp, ah[i], bh + slice_step(g0 + i), i > 0);")]
# two passes (lo.hi + hi.hi; hi.lo dropped), where A has a lo part
_TWO_PASS = [_DROP_HI_LO]


def _slice_adds(acc: str, a_frags: str):
    """The backward's dV^T or dK^T product adding each slice into the
    running sum (base: the tile's slices summed afresh, added once)."""
    return (f"    mma3<kBwdGroup, true, false>(part, tmp, {a_frags}, "
            f"tile_desc(pd_hi),\n"
            f"                                 tile_desc(pd_lo));\n"
            f"#pragma unroll\n"
            f"    for (int i = 0; i < 32; ++i) {acc}[i] = "
            f"__fadd_rn({acc}[i], part[i]);\n",
            f"    mma3<kBwdGroup, true, true>({acc}, tmp, {a_frags}, "
            f"tile_desc(pd_hi),\n"
            f"                                tile_desc(pd_lo));\n")


# kernel: {name: [(text in its source, the replacement), ...]}
VARIANTS = {
    "fwd": {
        "base": [],
        # the accurate exp2f in place of ex2.approx.ftz for p
        "exp2f": [("const float pe = exp2_sfu(S.get(n * 4 + e) - mu[e >> 1]);",
                   "const float pe = exp2f(S.get(n * 4 + e) - mu[e >> 1]);")],
        # no exp2 for p at all: p = s - m
        "no_exp2": [("const float pe = exp2_sfu(S.get(n * 4 + e) - "
                     "mu[e >> 1]);",
                     "const float pe = S.get(n * 4 + e) - mu[e >> 1];")],
        # int8 scores: converted, but neither scale applied
        "no_int8_scale": [(
            "          S.set(i, __fmul_rn(__fmul_rn(c, sqr[e >> 1]),\n"
            "                             (e & 1) ? sk2.y : sk2.x));",
            "          S.set(i, c);")],
        # the softmax of tile j waits for P_{j-1}.V_{j-1} too, not only S_j
        "no_overlap": [("    wgmma_wait<1>();\n    reg_fence(S.v);",
                        "    wgmma_wait<0>();\n    reg_fence(S.v);")],
        # O rescaled on every tile, whether the running max moved or not
        "always_rescale": [("    if (__any_sync(0xffffffffu, alpha[0] != 1.f "
                            "|| alpha[1] != 1.f)) {", "    {")],
        # a K/V ring of two or four stages, not three
        "stages_2": [("constexpr int kFwdStages = 3;",
                      "constexpr int kFwdStages = 2;")],
        "stages_4": [("constexpr int kFwdStages = 3;",
                      "constexpr int kFwdStages = 4;")],
        # partial tiles: no mask and no Skv bound evaluated
        "no_mask": [("    if (partial) {   // masked scores and kv >= Skv: "
                     "-inf, so p = 0",
                     "    if (partial && p.B < 0) {")],
    },
    "bwd": {
        "base": [],
        # the accurate exp2f in place of ex2.approx.ftz
        "exp2f": [("const float pe = exp2_sfu(", "const float pe = exp2f(")],
        # no exp2 at all: p = s - lse
        "no_exp2": [("const float pe = exp2_sfu(st[n * 4 + e] - "
                     "((e & 1) ? l2.y : l2.x));",
                     "const float pe = st[n * 4 + e] - "
                     "((e & 1) ? l2.y : l2.x);")],
        # no bulk reduce-add of dq (the boxes are still written)
        "no_reduce": [("    tma_reduce_add_2d(&tm_dq, box, cw * 32, row);",
                       "    if (row < 0) "
                       "tma_reduce_add_2d(&tm_dq, box, cw * 32, row);")],
        # no dq product (the drain still stores and reduces the registers)
        "no_dq_product": [("    wgmma_ss_n32<1, 1>(dq,",
                           "    if (j < 0) wgmma_ss_n32<1, 1>(dq,")],
        # no store of ds^T to shared memory (the fence and mbarriers stay)
        "no_ds_store": [("        *reinterpret_cast<uint32_t*>(dsb + swz(",
                         "        if (p.B < 0) *reinterpret_cast<uint32_t*>"
                         "(dsb + swz(")],
        # partial tiles of the video masks: bounds only, no mask algebra
        "no_video_mask": [("    if (partial && kVideo) {",
                           "    if (partial && kVideo && p.B < 0) {")],
    },
    "fwd_f32": {
        "base": [],
        "one_pass": _ONE_PASS,
        "two_pass": _TWO_PASS,
        # k8 slices per fresh tensor-core accumulator: four or two (base:
        # a whole 64-wide contraction, eight)
        "group_4": [("constexpr int kFwdGroup = 8;",
                     "constexpr int kFwdGroup = 4;")],
        "group_2": [("constexpr int kFwdGroup = 8;",
                     "constexpr int kFwdGroup = 2;")],
        # a K / V^T ring of two stages, not three
        "stages_2": [("constexpr int kFwdStages = 3;",
                      "constexpr int kFwdStages = 2;")],
    },
    "bwd_f32": {
        "base": [],
        "one_pass": _ONE_PASS,
        "two_pass": _TWO_PASS,
        # the accurate exp2f in place of ex2.approx.ftz for p
        "exp2f": [("? exp2_sfu(__fsub_rn(S[i], lse[(i >> 1) & 1])) : 0.f;",
                   "? exp2f(__fsub_rn(S[i], lse[(i >> 1) & 1])) : 0.f;")],
        # dV^T and dK^T: each k8 slice added into the running sum
        "slice_adds": [_slice_adds("dv", "do_across"),
                       _slice_adds("dk", "q_across")],
        # k8 slices per fresh tensor-core accumulator (base: one)
        "group_4": [("constexpr int kBwdGroup = 1;",
                     "constexpr int kBwdGroup = 4;")],
        "group_2": [("constexpr int kBwdGroup = 1;",
                     "constexpr int kBwdGroup = 2;")],
        # no bulk reduce-add of dq (the box is still written)
        "no_reduce": [("      bulk_reduce_add_f64(",
                       "      if (q0 < 0) bulk_reduce_add_f64(")],
        # no dq product (the box is written and reduced from stale
        # registers)
        "no_dq_product": [("    mma3<kBwdGroup, true, false>(\n"
                           "        dq,",
                           "    if (q0 < 0) mma3<kBwdGroup, true, false>(\n"
                           "        dq,")],
    },
}


def variant_source(kernel: str, name: str) -> str:
    """The text of the kernel's source with the edits of its variant
    `name`."""
    source = SOURCES[kernel]
    src = (CSRC / source).read_text()
    for old, new in VARIANTS[kernel][name]:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} is not in "
                             f"{source} exactly once")
        src = src.replace(old, new)
    return src.replace('#include "', f'#include "{CSRC}/')


def build(kernel: str, names, out: Path) -> dict[str, Path]:
    """One nvcc per variant, started together, into `out`; {name: library
    path}. ptxas serializing a wgmma in a variant is printed."""
    from landiff_tpu_torch.ops import kernels

    procs = {}
    for name in names:
        cu = out / f"{name}.cu"
        cu.write_text(variant_source(kernel, name))
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
             str(out / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{report}")
        if "Performance Loss" in report:
            print(json.dumps({"variant": name, "ptxas": "wgmma serialized"}),
                  flush=True)
        spills = sorted({line.strip() for line in report.splitlines()
                         if "spill stores" in line
                         and not line.strip().startswith("0 bytes")})
        if spills:
            print(json.dumps({"variant": name, "ptxas_spills": spills}),
                  flush=True)
    return {name: out / f"{name}.so" for name in names}


def _qkv(B, S, H, seed, n, f32=False):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda: torch.randn((B, S, H, 64), generator=g, device="cuda")
    cast = (lambda t: t) if f32 else (lambda t: t.bfloat16())
    return (cast(r() * 1.5),) + tuple(cast(r()) for _ in range(n - 1))


def _f32_cases(kernel: str, titok, seeds=None):
    """[(case, call, error)] of the f32 kernel: error(output) is its
    distance from the plain version in float64 (attention.f64_reference),
    computed once here. Also prints, once per case, the distance of the
    plain version in f32 from it: an f32 evaluation's own error at that
    shape. `seeds` (a list) makes each shape a case per seed."""
    from landiff_tpu_torch.ops import attention as A

    cases = []
    shapes = (("dit_train", 1, 17776, 30, None, 41),
              ("titok_dec", 1, 18768, 12, titok, 42))
    if seeds:
        shapes = tuple((f"{name}_{seed}", B, S, H, mask, seed)
                       for name, B, S, H, mask, _ in shapes for seed in seeds)
    for case, B, S, H, mask, seed in shapes:
        if kernel == "fwd_f32":
            q, k, v = _qkv(B, S, H, seed, 3, f32=True)
            plain = functools.partial(A.flash_exact_plain, mask_fn=mask,
                                      block_kv=A.F32_BLOCK_KV)
            ref = A.f64_reference(plain, q, k, v)[0]
            f32_err = A.kernel_error_rel(plain(q, k, v)[0], ref)
            call = lambda a=(q, k, v), m=mask: A.flash_fwd_exact(*a, mask_fn=m)
            err = lambda out, r=ref: A.kernel_error_rel(out[0], r)
        else:
            q, k, v, do = _qkv(B, S, H, seed, 4, f32=True)
            out, lse = A.flash_fwd_exact(q, k, v, mask_fn=mask)
            args = (q, k, v, out, lse, do)
            ref = A.f64_reference(A.flash_bwd_plain, *args, mask_fn=mask)
            f32_err = {n: A.kernel_error_rel(x, y) for n, x, y in zip(
                ("dq", "dk", "dv"),
                A.flash_bwd_plain(*args, mask_fn=mask), ref)}
            call = lambda a=args, m=mask: A.flash_bwd(*a, mask_fn=m)
            err = lambda got, r=ref: {n: A.kernel_error_rel(x, y) for n, x, y
                                      in zip(("dq", "dk", "dv"), got, r)}
        print(json.dumps({"case": case, "plain_f32_vs_f64": f32_err}),
              flush=True)
        cases.append((case, call, err))
    return cases


def _cases(kernel: str, seeds=None):
    """[(case, call, error or None)] for the kernel, on inputs made
    once."""
    import chip_smoke
    from landiff_tpu_torch.ops import attention as A

    titok = chip_smoke.titok_decoder_mask()
    if kernel.endswith("_f32"):
        return _f32_cases(kernel, titok, seeds)
    if kernel == "fwd":
        dit = _qkv(2, 17776, 30, 1, 3)
        tk = _qkv(1, 18768, 12, 2, 3)
        pv = functools.partial(A.flash_fwd_int8, int8_pv=True)
        return [("dit_exact", lambda: A.flash_fwd_exact(*dit), None),
                ("dit_int8", lambda: A.flash_fwd_int8(*dit), None),
                ("dit_int8_pv", lambda: pv(*dit), None),
                ("titok_exact", lambda: A.flash_fwd_exact(*tk, mask_fn=titok),
                 None)]
    cases = []
    for case, B, S, H, mask, seed in (("dit_train", 1, 17776, 30, None, 21),
                                      ("titok_dec", 1, 18768, 12, titok, 22)):
        q, k, v, do = _qkv(B, S, H, seed, 4)
        out, lse = A.flash_fwd_exact(q, k, v, mask_fn=mask)
        args = (q, k, v, out, lse, do)
        cases.append((case, lambda a=args, m=mask: A.flash_bwd(*a, mask_fn=m),
                      None))
    return cases


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(SOURCES), required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seeds", type=int, nargs="+",
                    help="fwd_f32 / bwd_f32: inputs from each of these "
                         "seeds at each shape (default one fixed seed)")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args()
    table = VARIANTS[args.kernel]
    names = args.variants or list(table)
    unknown = set(names) - set(table)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; "
                         f"known: {list(table)}")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_ablation: needs an NVIDIA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from landiff_tpu_torch.ops import attention as A
    from landiff_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions
    lib_attr = {"fwd": "flash_library", "bwd": "flash_bwd_library",
                "fwd_f32": "flash_f32_library",
                "bwd_f32": "flash_f32_library"}[args.kernel]
    bind = {"fwd": kernels.bind_flash_fwd, "bwd": kernels.bind_flash_bwd,
            "fwd_f32": kernels.bind_flash_f32,
            "bwd_f32": kernels.bind_flash_f32}[args.kernel]
    with tempfile.TemporaryDirectory(prefix="ablation_") as tmp:
        libs = {name: bind(path)
                for name, path in build(args.kernel, names, Path(tmp)).items()}
        cases = _cases(args.kernel, args.seeds)
        real = getattr(kernels, lib_attr)
        try:
            for rnd in range(args.rounds):
                for name in names:
                    setattr(kernels, lib_attr, lambda lib=libs[name]: lib)
                    row = {"variant": name, "round": rnd}
                    for case, call, err in cases:
                        row[f"{case}_ms"] = chip_smoke.cuda_ms(call, 3)
                        if err is not None and rnd == 0:
                            row[f"{case}_err"] = err(call())
                    print(json.dumps(row), flush=True)
                if args.kernel == "fwd":   # the wrapper's K quantization
                    k = _qkv(2, 17776, 30, 1, 2)[1]
                    print(json.dumps({"round": rnd, "quantize_k_ms":
                                      chip_smoke.cuda_ms(
                                          lambda: A.quantize_k_positions(k),
                                          3)}), flush=True)
        finally:
            setattr(kernels, lib_attr, real)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)


if __name__ == "__main__":
    main()
