#!/usr/bin/env python3
"""Where the flash backward's time goes, by ablation, on one NVIDIA card.

    python3 chip_bwd_ablation.py               # every variant, two rounds
    python3 chip_bwd_ablation.py base exp2f    # only these

Builds landiff_tpu_torch/ops/csrc/flash_bwd.cu as it is ("base") and
variants of it that each change one piece of the kernel by an exact text
substitution (a substitution that does not match the source exactly once
fails the run, and tests/test_torch_port_flash_bwd.py checks each on the
CPU), binds each in place of the port's backward library, and times
attention.flash_bwd (prologue and dq cast included) with CUDA events at the
training shape (B=1 S=17,776 H=30 D=64, unmasked) and the TiTok decoder
shape (B=1 S=18,768 H=12, video-decoder mask), variants in turns, two
rounds. A variant that drops work computes wrong gradients: its time says
what that work costs in the kernel as scheduled, not what it would cost
alone. Prints one JSON line per (round, variant), then the card's name and
power limit. Needs nvcc (as ops/kernels.py finds it) and a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "landiff_tpu_torch" / "ops" / "csrc"

# name: [(text in flash_bwd.cu, its replacement), ...]
VARIANTS = {
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
}


def variant_source(name: str) -> str:
    src = (CSRC / "flash_bwd.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} is not in "
                             "flash_bwd.cu exactly once")
        src = src.replace(old, new)
    return src.replace('#include "', f'#include "{CSRC}/')


def build(names, out: Path) -> dict[str, Path]:
    from landiff_tpu_torch.ops import kernels

    procs = {}
    for name in names:
        cu = out / f"{name}.cu"
        cu.write_text(variant_source(name))
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
             str(out / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{report}")
    return {name: out / f"{name}.so" for name in names}


def main():
    names = sys.argv[1:] or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; "
                         f"known: {list(VARIANTS)}")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_bwd_ablation: needs an NVIDIA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from landiff_tpu_torch.ops import attention as A
    from landiff_tpu_torch.ops import kernels

    with tempfile.TemporaryDirectory(prefix="bwd_ablation_") as tmp:
        libs = {name: kernels.bind_flash_bwd(path)
                for name, path in build(names, Path(tmp)).items()}
        cases = []
        for case, B, S, H, mask, seed in (
                ("dit_train", 1, 17776, 30, None, 21),
                ("titok_dec", 1, 18768, 12,
                 chip_smoke.titok_decoder_mask(), 22)):
            g = torch.Generator(device="cuda").manual_seed(seed)
            r = lambda: torch.randn((B, S, H, 64), generator=g,
                                    device="cuda")
            q, k, v, do = ((r() * 1.5).bfloat16(), r().bfloat16(),
                           r().bfloat16(), r().bfloat16())
            out, lse = A.flash_fwd_exact(q, k, v, mask_fn=mask)
            cases.append((case, (q, k, v, out, lse, do), mask))
        real = kernels.flash_bwd_library
        try:
            for rnd in range(2):
                for name in names:
                    kernels.flash_bwd_library = lambda lib=libs[name]: lib
                    row = {"variant": name, "round": rnd}
                    for case, args, mask in cases:
                        call = lambda: A.flash_bwd(*args, mask_fn=mask)
                        row[f"{case}_ms"] = chip_smoke.cuda_ms(call, 3)
                    print(json.dumps(row), flush=True)
        finally:
            kernels.flash_bwd_library = real
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)


if __name__ == "__main__":
    main()
