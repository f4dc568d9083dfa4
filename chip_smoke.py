#!/usr/bin/env python3
"""Drive the PyTorch port (landiff_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # 4 denoise steps per request
    python3 chip_smoke.py --steps 50   # the released sampler's 50 steps
    python3 chip_smoke.py --only flash_bwd   # build, then that kernel's
                                             # cases alone (flash_fwd:
                                             # with the drift gates;
                                             # flash_bwd; no last line)
    python3 chip_smoke.py --only stage1_batch  # batched decoding against
                                               # single calls at full
                                               # width, bf16 and f32
    python3 chip_smoke.py --only f32 | ckpt | long_video | train
                                       # one of the phases 3c, 8d, 8c, 9

Phases, in order; any failure exits nonzero before the last line:
  1. device:  the card's name and power limit; TF32 off for matmuls and
              convolutions, printed.
  2. build:   nvcc builds every kernel from the checkout's sources, one
              process per source, started together.
  3. kernels: ptxas's report of every forward instance (no spills but
              int8_pv's, no serialized wgmma); the SFU's exp2 rate in f32
              and bf16x2 (a probe, for the bounds); each flash kernel
              against its plain PyTorch version (the int8 forms' K
              quantization prologue too, exactly)
              at the two main-path shapes (DiT: B=2 S=17,776 H=30 D=64 unmasked;
              TiTok decoder: B=1 S=18,768 H=12 D=64, video-decoder mask),
              with times, bounds and the SDPA yardstick, and so each
              variant of the forward (int8_pv, int8_pv + exp_bf16, int8 +
              exp_bf16, exact + exp_bf16); the direct entry
              flash_attention under the three knobs at both shapes (the
              path of the exp_bf16 variants, which the dispatcher never
              takes); the flash
              backward at the training shape (B=1) and the TiTok shape,
              from the forward kernel's own out and lse, beside the SDPA
              backward, with its prologue against the prologue's plain
              version, the run-to-run spread of dq (dk, dv must not
              move), ptxas's registers, spills and shared memory, and a
              small case whose masked rows must give exactly 0; the fused
              adaLN
              kernel against its plain version at the DiT shape
              (2, 17,776, 1,920) bf16 with text_len 226, at a ragged shape
              and with f32 I/O, with its time beside the unfused chain's.
  3b. drift:  the compound-drift gates of the quantized DiT paths
              (diffusion/drift.py: three chained steps of the JAX gates'
              mid configuration, S = 776) in bf16 through the kernels: int8
              scores and int8_pv against the exact forward, W8A8 against
              the bf16 weights, at JAX's thresholds and, for attention,
              under 5 % of attention's own contribution; each quantized run
              launches only its variant, 9 times.
  3c. f32:    the f32 kernels (csrc/flash_f32.cu: the 3xTF32 exact
              forward and backward with their split prologues, the
              int8-score forward, and the int8_pv / exp_bf16 variants)
              against their plain versions in f32 (attention.F32_TOL,
              attention.f32_variant_limits; the prologues bit for bit)
              at the training shape (B=1 S=17,776 H=30) and the TiTok
              decoder shape, timed beside SDPA in f32 (and its own error
              against the plain versions) with the bounds of both designs
              (the CUDA cores' f32 rate, three TF32 passes on the tensor
              cores); ptxas's registers, spills and serialized wgmma (none
              allowed); then the f32 variants on their paths (the
              dispatcher under LANDIFF_ATTN_INT8_PV=1, flash_attention
              under the exp_bf16 knobs), one launch each.
  4. build the pipeline: infer_video.build_pipeline at the full width of
              LanDiffConfig() (random weights from a seed, zero leaves
              filled, depth not cut), both stages on the card.
  5. video:   the prompt -> codes -> video path (infer_video.generate)
              with LANDIFF_FUSED_ADALN=1 for two prompts: 1,218 valid
              codes, the video's shape and range, 90 * steps adaLN
              launches and 12 + 45 * steps int8 launches per request;
              then stage 1 alone: a repeated (prompt, seed) gives the same
              codes, another seed others; one infer_batch of both prompts
              gives valid codes (its agreement with the single calls in
              bf16 is printed), and at the tiny config in f32 it gives
              exactly the codes of the single calls.
  6. stage2:  one warm request through the stage-2 wrapper alone (prompt +
              seed + 1,218 codes -> (1, 3, 49, 480, 720) video) with the
              adaLN knob unset; the int8 kernel must launch 12 + 45 *
              steps times, the adaLN kernel never.
  7. exact:   one full-width control_warp_forward with int8 scores off;
              the exact kernel must launch 45 times.
  8. dit call: one warm model call timed with and without the knob.
  8b. fast:   the fast serving configuration (LANDIFF_FAST=2 with
              LANDIFF_ATTN_INT8_PV=1, set for this phase only): wrappers
              built from the resident parameters (W8A8 main and control
              DiTs, int8 GPT block linears), one prompt -> codes -> video
              at 50 steps: 1,218 valid codes, the video's shape and range,
              28 model calls (22 with two rows, 6 with one), 45 * 28 + 12
              int8_pv launches and no other forward.
  8c. long video: a two-segment request (num_frames 26) through
              infer_video.generate: 2 x 1,218 codes, 19 latent frames, 73
              frames at 480 x 720, finite, in [0, 1]; seconds per phase and
              per segment; 2 * (12 + 45 * steps) int8 launches.
  8d. ckpt:   the pipelines are freed; a synthetic checkpoint tree of
              LanDiffConfig() at full width, depth cut (CKPT_DEPTH), in the
              release's layout and names (ckpt/synth.py), loaded through
              build_pipeline(ckpt_dir=...) in f32: every loaded tensor
              equal to the written one after the layout change, then one
              request from it in f32 (the f32 int8 forward at the DiT
              shape, the exact one at the TiTok shape); load seconds and
              GB/s.
  9. train dit: the inference pipelines are freed; then the trainer's entry
              point (training.train.train) takes three steps of the
              stage-2 ControlNet step at full width in bf16 on synthesized
              data (batch 1), saves a checkpoint, and a second call resumes
              from it for a fourth step. Every loss finite, every control
              leaf's gradient finite and not all zero, the control
              parameters changed, the main and semantic parameters
              untouched; per step the backward kernel launches 44 times,
              the exact forward 88 (remat), the int8 forward 13. Then one
              step by hand for the forward / backward / optimizer split,
              and the remat_save_attn comparison: the same step without
              LANDIFF_REMAT_SAVE_ATTN twice and with it once: 88 -> 44
              exact forwards, equal loss, gradients within ten times the
              two plain runs' own spread (dq's reduce-adds) and 1e-2,
              seconds and peak memory of each.
  9b. train f32: the same trainer in f32 (its default, no --bf16): two
              steps and a resumed third; per step 44 f32 backward, 100 f32
              exact forward (88 + the TiTok decoder's 12) and one f32 int8
              forward launches.
  10. train lm: two steps of the stage-1 step at full width (GPT 24 x
              2,048, f32); losses finite, parameters changed, no flash
              launch.
  (--profile: one warm denoise-step model call, without and with the knob,
   and 20 stage-1 decode steps, under torch.profiler.)
Then one JSON line with every kernel's numbers, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# Kernel vs plain (attention.kernel_error). Both round p to bf16 at the
# same running max, but exp2 and the order of the f32 sums differ, which
# can move a p or an output across a bf16 rounding boundary: an error set
# by the largest p.v terms, whatever the element's own size. Readings on an
# H100 at the four cases below (DiT / TiTok x exact / int8): max |err| at
# most 0.25 bf16 steps at the largest |plain| output (0.00195 at outputs
# in [1, 2)), relative RMS error at most 3.6e-4, lse error at most 3.8e-6
# (log2 units). The limits are about twice the readings.
KERNEL_TOL_STEPS = 0.5
KERNEL_TOL_RMS = 1e-3
LSE_TOL = 1e-5
# The variants widen these limits by what their arithmetic moves
# (attention.variant_limits): int8_pv by two V-code steps; exp_bf16 is
# held to the plain version with the card's own exp2 within the base
# limits and a tile sum's rounding, and to the true 2^x within limits set
# from the readings.

# Backward kernel vs plain (attention.kernel_error per tensor, dq / dk /
# dv): p and scale*ds are rounded to bf16 in both from exp2 results and f32
# sums that differ in their last bits, and dq is summed by bulk reduce-adds
# in an order that changes from run to run. Readings on an H100 at the two
# cases below, unchanged from the mma.sync kernel to the wgmma one: at most
# 1.0 bf16 steps at the largest |plain| value (dv at the TiTok shape; 0.25
# at the training shape) and a relative RMS error of 3.9e-4; dq differs
# between two runs by at most 0.125 steps, in 2e-4 of its elements. The
# limits are about twice the readings and more.
BWD_TOL_STEPS = 2.0
BWD_TOL_RMS = 2e-3

# adaLN kernel vs plain: both compute a row in f32 and round once, so in
# bf16 an element differs by at most one bf16 step (taken at the element's
# own size, not below that at 2^-7, under which an f32 rounding of the
# sums is worth more than a step); in f32 by the order of the row sums.
# Readings on an H100 at the three cases below: 1.0 step (a flipped last
# bit) and a relative RMS error of 1.3e-5 in bf16; max |err| / (1 + |plain|)
# 3.6e-7 in f32. The limits are about twice the readings.
ADALN_TOL_STEPS = 1.0
ADALN_TOL_RMS_BF16 = 3e-5
ADALN_TOL_F32 = 1e-6

# the forward kernel's variants: (int8 scores, int8_pv, exp_bf16)
FWD_VARIANTS = ((False, False, False), (True, False, False),
                (True, True, False), (True, True, True),
                (True, False, True), (False, False, True))
REPLACES_FWD = {
    False: "landiff_tpu/ops/attention.py:91 _flash_kernel, :197 "
           "_flash_kernel_cached",
    True: "landiff_tpu/ops/attention.py:264 _flash_kernel_cached_i8"}

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit); PEAK_F32
# is the CUDA cores' f32 rate, PEAK_TF32 the tensor cores' TF32 rate (an
# f32-accurate product there takes three passes, 3xTF32, as in the f32
# exact forward and backward)
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# f32 exp2 on the SFUs: 16 results per SM per clock (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0), 132
# SMs, 1.98 GHz (the H100 SXM's maximum boost clock). The bf16x2 form's
# rate is this times the ratio the probe measures in the same run
# (exp2_rates).
PEAK_EXP2 = 132 * 16 * 1.98e9


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters, repeats=5):
    """Median over `repeats` of the mean ms of `iters` back-to-back calls
    (CUDA events), after two warm-up calls."""
    import torch

    fn()
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 3: kernels at the main-path shapes


def exp2_rates():
    """Exp2 results per second of the SFU probe (flash_fwd.cu
    landiff_ex2_rate) in f32 and in bf16x2, timed here; returns the rates
    the bounds use: f32, the larger of PEAK_EXP2 and the f32 reading
    (a bound must not assume less than the card does), and bf16x2, that
    times the measured bf16x2 / f32 ratio."""
    import torch

    from landiff_tpu_torch.ops import kernels

    lib = kernels.flash_library()
    blocks, iters = 132 * 8, 2048
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    read = {}
    for name, pairs in (("f32", 0), ("bf16x2", 1)):
        def call():
            rc = lib.landiff_ex2_rate(out.data_ptr(), blocks, iters, pairs,
                                      stream)
            check(rc == 0, f"exp2 rate probe ({name}): cudaError {rc}")
        ms = cuda_ms(call, 3)
        read[name] = blocks * 256 * 8 * iters * (1 + pairs) / (ms * 1e-3)
    ratio = read["bf16x2"] / read["f32"]
    f32 = max(PEAK_EXP2, read["f32"])
    rates = {False: f32, True: f32 * ratio}
    log(json.dumps({"phase": "exp2_rate", "f32_per_s": read["f32"],
                    "bf16x2_per_s": read["bf16x2"], "ratio": ratio,
                    "published_f32_per_s": PEAK_EXP2,
                    "bound_f32_per_s": rates[False],
                    "bound_bf16x2_per_s": rates[True]}))
    return rates


def least_time(times: dict) -> tuple[float, str, str]:
    """The bound of a kernel whose units work side by side: `times` maps
    each unit ("bytes" for the memory) to the seconds of its share of the
    work at its peak. Returns (the largest, "bytes" or "operations", the
    unit that binds)."""
    unit = max(times, key=times.get)
    return times[unit], "bytes" if unit == "bytes" else "operations", unit


def kernel_case(name, B, S, H, mask_fn, int8, seed, exp2_rate, int8_pv=False,
                exp_bf16=False):
    import functools

    import torch
    import torch.nn.functional as F

    from landiff_tpu_torch.ops import attention as A
    from landiff_tpu_torch.ops import masks as M

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    D = 64
    q = (torch.randn((B, S, H, D), generator=g, device=dev) * 1.5).bfloat16()
    k = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
    v = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
    opts = dict(exp_bf16=exp_bf16, **({"int8_pv": int8_pv} if int8 else {}))
    fn = functools.partial(A.flash_fwd_int8 if int8 else A.flash_fwd_exact,
                           **opts)
    plain = functools.partial(
        A.flash_int8_plain if int8 else A.flash_exact_plain, **opts)

    out, lse = fn(q, k, v, mask_fn=mask_fn)          # first call: tables
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: fn(q, k, v, mask_fn=mask_fn), 3)
    t0 = time.perf_counter()
    ref, ref_lse = plain(q, k, v, mask_fn=mask_fn)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (out.float() - ref.float()).abs().max().item()
    steps, rel_rms = A.kernel_error(out, ref)
    lse_err = (lse - ref_lse).abs().max().item()
    finite = bool(torch.isfinite(out.float()).all())
    lim = A.variant_limits(ref, v, int8_pv=int8_pv, exp_bf16=exp_bf16,
                           tol_steps=KERNEL_TOL_STEPS,
                           tol_rms=KERNEL_TOL_RMS, lse_tol=LSE_TOL)
    checks = [(finite, "output not finite"),
              (err <= lim["max_abs"], f"max |err| {err} > {lim['max_abs']}"),
              (rel_rms <= lim["rel_rms"], f"relative RMS error {rel_rms}"),
              (lse_err <= lim["lse"], f"lse error {lse_err}")]
    card = None
    if exp_bf16:   # the same plain version with the card's own exp2
        card_out, card_lse = plain(q, k, v, mask_fn=mask_fn,
                                   exp2_table=A.card_exp2_table("cuda"))
        c_steps, c_rms = A.kernel_error(out, card_out)
        card = {"max_abs_err": (out.float() - card_out.float()).abs().max()
                .item(), "max_bf16_steps": c_steps, "rel_rms_err": c_rms,
                "lse_max_abs_err": (lse - card_lse).abs().max().item(),
                "limits": lim["card"]}
        checks += [
            (card["max_abs_err"] <= lim["card"]["max_abs"],
             f"vs card exp2: max |err| {card['max_abs_err']}"),
            (c_rms <= lim["card"]["rel_rms"],
             f"vs card exp2: relative RMS error {c_rms}"),
            (card["lse_max_abs_err"] <= lim["card"]["lse"],
             f"vs card exp2: lse error {card['lse_max_abs_err']}")]
        del card_out, card_lse

    prologue = None
    if int8:   # the K quantization kernel against its plain version
        got, want = A.quantize_k(k), A.quantize_k_plain(k)
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        checks.append((exact, "K quantization prologue differs"))
        prologue = {"ms": cuda_ms(lambda: A.quantize_k(k), 5),
                    "plain_ms": cuda_ms(lambda: A.quantize_k_plain(k), 3),
                    "exact": exact}
        del got, want

    library_ms = None
    if not int8:   # SDPA computes the exact function (exp_bf16: close to it)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        attn_mask = None
        if mask_fn is not None:
            i = torch.arange(S, device=dev)
            attn_mask = mask_fn(i[:, None], i[None, :])
        call = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=attn_mask)
        try:   # a yardstick only: a backend that refuses the shape -> null
            library_ms = cuda_ms(call, 3)
        except (RuntimeError, torch.OutOfMemoryError) as e:
            log(json.dumps({"library_refused": name, "error": str(e)[:200]}))
        del attn_mask

    visible = M.visible_count(mask_fn, S, S, device="cuda")
    flops = 4.0 * B * H * visible * D
    nbytes = 4 * B * S * H * D * 2 + B * H * S * 4   # q k v in, out + lse
    # q.k at the int8 rate with int8 scores, p.v with int8_pv; one exp2
    # per visible pair on the SFUs, beside the tensor cores
    bound_s, bound_by, unit = least_time({
        "tensor cores": flops / 2 / (PEAK_INT8 if int8 else PEAK_BF16)
        + flops / 2 / (PEAK_INT8 if int8_pv else PEAK_BF16),
        "exp2": B * H * visible / exp2_rate, "bytes": nbytes / PEAK_BYTES})
    res = {
        "case": name, "shape": [B, S, H, D],
        "mask": None if mask_fn is None else type(mask_fn).__name__
        + f"(kind={mask_fn.descriptor()[0]})",
        "visible_pairs": visible, "max_abs_err": err,
        "max_bf16_steps": steps, "rel_rms_err": rel_rms,
        "lse_max_abs_err": lse_err, "limits": {
            k: lim[k] for k in ("max_abs", "rel_rms", "lse", "exp2_rel_err",
                                "exp2_not_rounded_share") if k in lim},
        "vs_card_exp2": card, "ms": ms, "plain_ms": plain_ms,
        "k_quantization": prologue,
        "library_ms": library_ms, "bound_ms": bound_s * 1e3,
        "bound_by": bound_by, "bound_unit": unit,
        "tflops": flops / (ms * 1e-3) / 1e12,
    }
    kname = A.variant_name(int8, int8_pv, exp_bf16)
    log(json.dumps({"kernel": kname, **res}))
    res["name"] = kname
    res["faults"] = [f"{kname} {name}: {what}" for ok, what in checks
                     if not ok]
    del q, k, v, out, ref, lse, ref_lse
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 3c: the f32 kernels (csrc/flash_f32.cu) at the main-path shapes,
# held to their plain versions in f32 within attention.F32_TOL (the
# int8_pv / exp_bf16 variants within attention.variant_limits from those)


def least_time_designs(designs: dict) -> tuple[float, str, str, dict]:
    """The bound of work that more than one design could do: `designs`
    maps a design to its units' times (as least_time takes them). Each
    design's bound is its largest term; the work's bound the least of
    those. Returns (seconds, "bytes" or "operations", "design: unit", every
    term in ms by design)."""
    best = None
    for name, times in designs.items():
        t, by, unit = least_time(times)
        if best is None or t < best[0]:
            best = (t, by, f"{name}: {unit}")
    terms = {name: {u: v * 1e3 for u, v in times.items()}
             for name, times in designs.items()}
    return best + (terms,)


def f32_fwd_bounds(flops, pairs, nbytes, int8, int8_pv, exp_bf16,
                   exp2_rate):
    """Designs of an f32 forward: FFMA on the CUDA cores, or the products
    on the tensor cores (3xTF32 for an f32 product, two passes for p.v
    with a bf16 p, int8 for int8 scores and int8_pv); the exp2 on the SFUs
    and the bytes beside each."""
    side = {"exp2": pairs / exp2_rate, "bytes": nbytes / PEAK_BYTES}
    half = flops / 2
    if int8_pv:
        return {"int8 tensor cores": {"tensor cores": flops / PEAK_INT8,
                                      **side}}
    pv_passes = 2 if exp_bf16 else 3
    if int8:
        return {"f32 cores": {"f32 cores": half / PEAK_F32,
                              "tensor cores": half / PEAK_INT8, **side},
                "tf32 tensor cores x3": {
                    "tensor cores": half / PEAK_INT8
                    + pv_passes * half / PEAK_TF32, **side}}
    return {"f32 cores": {"f32 cores": flops / PEAK_F32, **side},
            "tf32 tensor cores x3": {
                "tensor cores": (3 * half + pv_passes * half) / PEAK_TF32,
                **side}}


def sdpa_f32(q, k, v, mask_fn):
    """SDPA in f32 on BSHD inputs: (out, a callable that runs it); None
    where the backend refuses the shape."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    attn_mask = None
    if mask_fn is not None:
        i = torch.arange(q.shape[1], device=q.device)
        attn_mask = mask_fn(i[:, None], i[None, :])
    call = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=attn_mask)
    try:
        return call().transpose(1, 2), call
    except (RuntimeError, torch.OutOfMemoryError) as e:
        log(json.dumps({"library_refused": "sdpa f32", "error": str(e)[:200]}))
        return None, None


def f32_fwd_case(name, B, S, H, mask_fn, int8, seed, exp2_rates,
                 int8_pv=False, exp_bf16=False):
    import functools

    import torch

    from landiff_tpu_torch.ops import attention as A
    from landiff_tpu_torch.ops import masks as M

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    D = 64
    q = torch.randn((B, S, H, D), generator=g, device=dev) * 1.5
    k = torch.randn((B, S, H, D), generator=g, device=dev)
    v = torch.randn((B, S, H, D), generator=g, device=dev)
    opts = dict(exp_bf16=exp_bf16, **({"int8_pv": int8_pv} if int8 else {}))
    fn = functools.partial(A.flash_fwd_int8 if int8 else A.flash_fwd_exact,
                           **opts)
    # the plain version at the f32 kernels' kv tile: a p rounded to bf16
    # or int8 is rounded at the same running max
    plain = functools.partial(
        A.flash_int8_plain if int8 else A.flash_exact_plain,
        block_kv=A.F32_BLOCK_KV, **opts)
    out, lse = fn(q, k, v, mask_fn=mask_fn)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: fn(q, k, v, mask_fn=mask_fn), 2, repeats=3)
    t0 = time.perf_counter()
    ref, ref_lse = plain(q, k, v, mask_fn=mask_fn)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain_vs_f64 = None
    if not int8:   # the 3xTF32 forms: held to the plain version in float64
        f32_ref = ref
        ref, ref_lse = A.f64_reference(plain, q, k, v, mask_fn=mask_fn)
        plain_vs_f64 = A.kernel_error_rel(f32_ref, ref)
        del f32_ref
    max_rel, rel_rms = A.kernel_error_rel(out, ref)
    max_abs = (out - ref).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    tol = A.F32_TOL["fwd"]
    variant = int8_pv or exp_bf16
    checks = [(bool(torch.isfinite(out).all()), "output not finite")]
    card = None
    if not variant:
        limits = tol
        checks += [(max_rel <= tol["max_rel"],
                    f"max |err| / max |plain| {max_rel}"),
                   (rel_rms <= tol["rel_rms"], f"relative RMS error {rel_rms}"),
                   (lse_err <= tol["lse"], f"lse error {lse_err}")]
    else:
        limits = A.f32_variant_limits(ref, v, int8=int8, int8_pv=int8_pv,
                                      exp_bf16=exp_bf16)
        checks += [(max_abs <= limits["max_abs"], f"max |err| {max_abs}"),
                   (rel_rms <= limits["rel_rms"],
                    f"relative RMS error {rel_rms}"),
                   (lse_err <= limits["lse"], f"lse error {lse_err}")]
        if exp_bf16:   # the same plain version with the card's own exp2
            c_out, c_lse = (plain if int8 else functools.partial(
                A.f64_reference, plain))(
                q, k, v, mask_fn=mask_fn,
                exp2_table=A.card_exp2_table("cuda"))
            card = {"max_abs_err": (out - c_out).abs().max().item(),
                    "rel_rms_err": A.kernel_error_rel(out, c_out)[1],
                    "lse_max_abs_err": (lse - c_lse).abs().max().item(),
                    "limits": limits["card"]}
            checks += [
                (card["max_abs_err"] <= limits["card"]["max_abs"],
                 f"vs card exp2: max |err| {card['max_abs_err']}"),
                (card["rel_rms_err"] <= limits["card"]["rel_rms"],
                 f"vs card exp2: relative RMS {card['rel_rms_err']}"),
                (card["lse_max_abs_err"] <= limits["card"]["lse"],
                 f"vs card exp2: lse error {card['lse_max_abs_err']}")]
            limits = {k_: limits[k_] for k_ in limits if k_ != "card"}
            del c_out, c_lse
    prologue = None
    if int8:
        got, want = A.quantize_k(k), A.quantize_k_plain(k)
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        checks.append((exact, "K quantization prologue differs"))
        prologue = {"k_quantization_ms": cuda_ms(lambda: A.quantize_k(k), 5),
                    "exact": exact}
        del got, want
    else:   # the split prologues against their plain versions, bit for bit
        s_pad = M.round_up(S, A.F32_BLOCK_KV)
        exact = all(torch.equal(a, b) for a, b in zip(
            A.tf32_split(k), A.tf32_split_plain(k))) and all(
            torch.equal(a, b) for a, b in zip(
                A.tf32_split_t(v, s_pad), A.tf32_split_t_plain(v, s_pad)))
        checks.append((exact, "tf32 split prologues differ"))
        prologue = {"split_ms": cuda_ms(lambda: A.tf32_split(k), 5),
                    "split_t_ms": cuda_ms(lambda: A.tf32_split_t(v, s_pad), 5),
                    "exact": exact}
    library_ms = sdpa_err = sdpa_kernels = None   # SDPA in f32: the exact
    if not int8 and not exp_bf16:                  # function only
        sd, call = sdpa_f32(q, k, v, mask_fn)
        if sd is not None:
            sdpa_err = A.kernel_error_rel(sd, ref)
            library_ms = cuda_ms(call, 2, repeats=3)
            sdpa_kernels = device_kernels(call)
        del sd, call
    visible = M.visible_count(mask_fn, S, S, device="cuda")
    flops = 4.0 * B * H * visible * D
    nbytes = 4 * B * S * H * D * 4 + B * H * S * 4
    designs = f32_fwd_bounds(flops, B * H * visible, nbytes, int8, int8_pv,
                             exp_bf16, exp2_rates[exp_bf16])
    bound_s, bound_by, unit, terms = least_time_designs(designs)
    kname = A.variant_name(int8, int8_pv, exp_bf16, f32=True)
    res = {"case": name, "shape": [B, S, H, D], "dtype": "float32",
           "visible_pairs": visible, "max_abs_err": max_abs,
           "max_rel_err": max_rel, "rel_rms_err": rel_rms,
           "lse_max_abs_err": lse_err, "limits": limits,
           "vs_card_exp2": card, "plain_f32_vs_f64": plain_vs_f64,
           "ms": ms, "plain_ms": plain_ms,
           "prologue": prologue, "library_ms": library_ms,
           "sdpa_vs_plain": sdpa_err, "sdpa_kernels": sdpa_kernels,
           "bound_ms": bound_s * 1e3,
           "bound_by": bound_by, "bound_unit": unit,
           "bound_terms_ms": terms, "tflops": flops / (ms * 1e-3) / 1e12}
    log(json.dumps({"kernel": kname, **res}))
    res["name"] = kname
    res["faults"] = [f"{kname} {name}: {what}" for ok, what in checks
                     if not ok]
    del q, k, v, out, ref, lse, ref_lse
    torch.cuda.empty_cache()
    return res


def f32_bwd_case(name, B, S, H, mask_fn, seeds, exp2_rate):
    """The f32 backward against the plain version in float64 on inputs
    from each of `seeds` (its largest errors over them are the case's);
    timed, with the prologue, SDPA and the run-to-run check, on the
    first."""
    import torch
    import torch.nn.functional as F

    from landiff_tpu_torch.ops import attention as A
    from landiff_tpu_torch.ops import masks as M

    dev = torch.device("cuda")
    D = 64
    tol = A.F32_TOL["bwd"]
    by_seed, faults = {}, []
    for seed in reversed(seeds):   # the first seed's tensors stay
        g = torch.Generator(device=dev).manual_seed(seed)
        r = lambda: torch.randn((B, S, H, D), generator=g, device=dev)
        q, k, v, do = r() * 1.5, r(), r(), r()
        out, lse = A.flash_fwd_exact(q, k, v, mask_fn=mask_fn)
        call = lambda: A.flash_bwd(q, k, v, out, lse, do, mask_fn=mask_fn)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = call()
        torch.cuda.synchronize()
        temp_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        want = A.f64_reference(A.flash_bwd_plain, q, k, v, out, lse, do,
                               mask_fn=mask_fn)
        errs = {}
        for tname, gt, wt in zip(("dq", "dk", "dv"), got, want):
            max_rel, rel_rms = A.kernel_error_rel(gt, wt)
            errs[tname] = {"max_abs_err": (gt - wt).abs().max().item(),
                           "max_rel_err": max_rel, "rel_rms_err": rel_rms}
            for ok, what in (
                    (bool(torch.isfinite(gt).all()), "not finite"),
                    (max_rel <= tol["max_rel"], f"max |err| / max {max_rel}"),
                    (rel_rms <= tol["rel_rms"], f"relative RMS {rel_rms}")):
                if not ok:
                    faults.append(f"flash_bwd_f32 {name} seed {seed} "
                                  f"{tname}: {what}")
        by_seed[seed] = errs
        if seed != seeds[0]:
            del q, k, v, do, out, lse, got, want
    errs = {t: {m: max(e[t][m] for e in by_seed.values())
                for m in by_seed[seeds[0]][t]} for t in ("dq", "dk", "dv")}
    again = call()
    ms = cuda_ms(call, 1, repeats=3)
    t0 = time.perf_counter()
    plain = A.flash_bwd_plain(q, k, v, out, lse, do, mask_fn=mask_fn)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain_vs_f64 = {tname: A.kernel_error_rel(x, y) for tname, x, y in
                    zip(("dq", "dk", "dv"), plain, want)}
    del plain
    prep_ms, prep_err = bwd_prep_check(name, q, out, lse, do, faults)
    for tname, a, b in zip(("dk", "dv"), got[1:], again[1:]):
        if not torch.equal(a, b):
            faults.append(f"flash_bwd_f32 {name}: {tname} differs "
                          "between runs")
    dq_rel, dq_rms = A.kernel_error_rel(again[0], got[0])
    spread = {"dq_max_rel": dq_rel, "dq_rel_rms": dq_rms,
              "dq_share_of_elements_differing":
                  (again[0] != got[0]).float().mean().item()}
    del again
    library_ms = sdpa_err = sdpa_kernels = None
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    attn_mask = None
    if mask_fn is not None:
        i = torch.arange(S, device=dev)
        attn_mask = mask_fn(i[:, None], i[None, :])
    try:
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn_mask)
        dot = do.transpose(1, 2)
        grads = torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)
        sdpa_err = {tname: A.kernel_error_rel(gr.transpose(1, 2), wt)
                    for tname, gr, wt in zip(("dq", "dk", "dv"), grads,
                                             want)}
        del grads
        sdpa_bwd = lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                               retain_graph=True)
        library_ms = cuda_ms(sdpa_bwd, 1, repeats=3)
        sdpa_kernels = device_kernels(sdpa_bwd)
        del o, sdpa_bwd
    except (RuntimeError, torch.OutOfMemoryError) as e:
        log(json.dumps({"library_refused": name, "error": str(e)[:200]}))
    del qt, kt, vt, attn_mask, want
    visible = M.visible_count(mask_fn, S, S, device="cuda")
    flops = 10.0 * B * H * visible * D
    side = {"exp2": B * H * visible / exp2_rate,
            "bytes": (8 * B * S * H * D * 4 + B * H * S * 4) / PEAK_BYTES}
    bound_s, bound_by, unit, terms = least_time_designs({
        "f32 cores": {"f32 cores": flops / PEAK_F32, **side},
        "tf32 tensor cores x3": {"tensor cores": 3 * flops / PEAK_TF32,
                                 **side}})
    res = {"case": name, "shape": [B, S, H, D], "dtype": "float32",
           "visible_pairs": visible, "seeds": list(seeds), "errors": errs,
           "errors_by_seed": by_seed, "limits": tol,
           "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
           "plain_f32_vs_f64": plain_vs_f64,
           "run_to_run": spread, "ms": ms, "plain_ms": plain_ms,
           "prep_ms": prep_ms, "prep_delta_max_abs_err": prep_err,
           "temporaries_gb": temp_gb, "library_ms": library_ms,
           "sdpa_vs_plain": sdpa_err, "sdpa_kernels": sdpa_kernels,
           "bound_ms": bound_s * 1e3,
           "bound_by": bound_by, "bound_unit": unit,
           "bound_terms_ms": terms, "tflops": flops / (ms * 1e-3) / 1e12,
           "faults": faults}
    log(json.dumps({"kernel": "flash_bwd_f32", **res}))
    del q, k, v, do, out, lse, got
    torch.cuda.empty_cache()
    return res


def phase_f32(dec, exp2_rates):
    """Each f32 kernel and variant against its plain version at the
    training shape (B=1 S=17,776 H=30 D=64) and the TiTok decoder shape,
    timed beside SDPA in f32 (and its error) and the bounds of both
    designs; ptxas's registers, spills and serialized wgmma (none
    allowed)."""
    from landiff_tpu_torch.ops import kernels

    results = {}
    for int8, int8_pv, exp_bf16 in FWD_VARIANTS:
        kw = dict(int8_pv=int8_pv, exp_bf16=exp_bf16, exp2_rates=exp2_rates)
        dit = f32_fwd_case("dit_train", 1, 17776, 30, None, int8, seed=41,
                           **kw)
        titok = f32_fwd_case("titok_dec", 1, 18768, 12, dec, int8, seed=42,
                             **kw)
        results[dit["name"]] = (dit, titok)
    train = f32_bwd_case("dit_train", 1, 17776, 30, None, F32_BWD_SEEDS[0],
                         exp2_rate=exp2_rates[False])
    titok = f32_bwd_case("titok_dec", 1, 18768, 12, dec, F32_BWD_SEEDS[1],
                         exp2_rate=exp2_rates[False])
    results["flash_bwd_f32"] = (train, titok)
    faults = [f for a, b in results.values() for f in a["faults"]
              + b["faults"]]
    check(not faults, "f32 kernel vs plain: " + "; ".join(faults))
    ptxas = {e: kernels.ptxas_report("flash_f32", e)
             for entries in F32_PTXAS.values() for e in entries}
    for e, rep_ in ptxas.items():
        check(rep_["spill_stores"] == 0 and rep_["spill_loads"] == 0
              and not rep_["warnings"], f"{e} ptxas: {rep_}")
    lib = kernels.flash_f32_library()
    smem = {"flash_fwd_tf32_kernel": lib.landiff_flash_f32_smem_bytes(0),
            "flash_bwd_tf32_kernel": lib.landiff_flash_f32_smem_bytes(1)}
    log(json.dumps({"phase": "f32_ptxas", "ptxas": ptxas,
                    "smem_bytes": smem}))
    results["ptxas"] = ptxas
    return results


# the f32 backward's inputs at the DiT and the TiTok shape: four seeds
# each, its limits held on every one
F32_BWD_SEEDS = ((43, 45, 47, 49), (44, 46, 48, 50))

# ptxas entries of each f32 kernel: the main kernel's instances and the
# prologues counted with it
_SPLITS = ("tf32_split_kernel", "tf32_split_t_kernel")
F32_PTXAS = {
    "flash_fwd_exact_f32": ("flash_fwd_tf32_kernelILb0ELb0E",
                            "flash_fwd_tf32_kernelILb0ELb1E") + _SPLITS,
    "flash_fwd_exact_exp_bf16_f32": ("flash_fwd_tf32_kernelILb1ELb0E",
                                     "flash_fwd_tf32_kernelILb1ELb1E"),
    "flash_fwd_int8_f32": ("flash_fwd_i8_f32_kernelILb0ELb0E",
                           "quantize_k_f32"),
    "flash_fwd_int8_pv_f32": ("flash_fwd_i8_f32_kernelILb1ELb0E",),
    "flash_fwd_int8_pv_exp_bf16_f32": ("flash_fwd_i8_f32_kernelILb1ELb1E",),
    "flash_fwd_int8_exp_bf16_f32": ("flash_fwd_i8_f32_kernelILb0ELb1E",),
    "flash_bwd_f32": ("flash_bwd_tf32_kernelILb0E",
                      "flash_bwd_tf32_kernelILb1E", "bwd_prep_f32") + _SPLITS}


def f32_entry(name, dit, titok, launches, ptxas):
    """A row of the kernels line for an f32 kernel or variant."""
    ptxas = {e: ptxas[e] for e in F32_PTXAS[name]}
    if name == "flash_bwd_f32":
        replaces = ("landiff_tpu/ops/attention.py:658 "
                    "_flash_bwd_fused_kernel (f32 refs)")
    else:
        int8, pv, eb = ("int8" in name, "_pv" in name, "exp_bf16" in name)
        replaces = REPLACES_FWD[int8] + (
            ", int8_pv :338-348" if pv else "") + (
            ", exp_bf16 _softmax_tile :37-57" if eb else "") + " (f32 refs)"
    redesigned = name in ("flash_fwd_exact_f32", "flash_fwd_exact_exp_bf16_f32",
                          "flash_bwd_f32")
    return {"name": name, "route": "cuda",
            "source": "landiff_tpu_torch/ops/csrc/flash_f32.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": dit["max_abs_err"], "ms": dit["ms"],
            "plain_ms": dit["plain_ms"], "bound_ms": dit["bound_ms"],
            "bound_by": dit["bound_by"], "library_ms": dit["library_ms"],
            "bound_unit": dit["bound_unit"],
            "bound_terms_ms": dit["bound_terms_ms"], "tflops": dit["tflops"],
            "sdpa_vs_plain": dit["sdpa_vs_plain"],
            "design": ("redesigned: wgmma 3xTF32, TMA" if redesigned
                       else "SIMT (FFMA / DP4A)"),
            "ptxas": ptxas, "shape": dit["shape"], "dtype": "float32",
            "titok_dec": {k: titok[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "max_abs_err")}}


def phase_direct_f32():
    """The f32 variants on their paths, at the DiT shape in f32: the
    dispatcher attention() under LANDIFF_ATTN_INT8_PV=1 (its int8 route:
    int8_pv), and flash_attention under the knobs of each exp_bf16
    variant. Counts reset just before and read just after: one launch of
    each, none of anything else."""
    import torch

    from landiff_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = (torch.randn((1, 17776, 30, 64), generator=g, device="cuda")
               for _ in range(3))
    settings = {
        "flash_fwd_int8_pv_f32": ("attention", {"LANDIFF_ATTN_INT8_PV": "1"}),
        "flash_fwd_exact_exp_bf16_f32": (
            "flash_attention", {"LANDIFF_ATTN_EXP_BF16": "1"}),
        "flash_fwd_int8_exp_bf16_f32": (
            "flash_attention", {"LANDIFF_ATTN_INT8": "1",
                                "LANDIFF_ATTN_EXP_BF16": "1"}),
        "flash_fwd_int8_pv_exp_bf16_f32": (
            "flash_attention", {"LANDIFF_ATTN_INT8": "1",
                                "LANDIFF_ATTN_EXP_BF16": "1",
                                "LANDIFF_ATTN_INT8_PV": "1"})}
    reset_counts()
    for entry, env in settings.values():
        with knobs(**env):
            out = getattr(A, entry)(q, k, v)
            check(out.shape == q.shape and bool(torch.isfinite(out).all()),
                  f"{entry} in f32 under {env}: {tuple(out.shape)}")
    torch.cuda.synchronize()
    launches = read_counts()
    want = {k_: 1 if k_ in settings else 0 for k_ in launches}
    check(launches == want, f"f32 direct launches {launches}, want {want}")
    log(json.dumps({"phase": "direct_f32", "settings": settings,
                    "launches": launches}))
    del q, k, v, out
    torch.cuda.empty_cache()
    return launches


def titok_decoder_mask():
    from landiff_tpu_torch.config import TiTokConfig
    from landiff_tpu_torch.ops import masks as M

    t = TiTokConfig()
    layout = M.VideoMaskLayout(num_frames=t.temporal_size,
                               tokens_per_frame=t.frame_tokens,
                               iframe_tokens=t.iframe_latent_tokens,
                               pframe_tokens=t.pframe_latent_tokens)
    check(layout.seq_len == 18768, f"TiTok sequence {layout.seq_len}")
    return M.video_decoder_mask(layout)


def phase_kernels():
    dec = titok_decoder_mask()
    rates = exp2_rates()
    results = phase_fwd_kernels(dec, rates)
    results["flash_bwd"] = phase_bwd_kernel(dec, rates[False])
    results["dec_mask"] = dec
    results["rates"] = rates
    return results


def phase_fwd_kernels(dec, rates):
    """Each variant of the flash forward against its plain version at the
    DiT and the TiTok shapes."""
    results = {}
    for int8, int8_pv, exp_bf16 in FWD_VARIANTS:
        kw = dict(int8_pv=int8_pv, exp_bf16=exp_bf16,
                  exp2_rate=rates[exp_bf16])
        dit = kernel_case("dit", 2, 17776, 30, None, int8, seed=1, **kw)
        titok = kernel_case("titok_dec", 1, 18768, 12, dec, int8, seed=2,
                            **kw)
        results[dit["name"]] = (dit, titok)
    faults = [f for dit, titok in results.values()
              for f in dit["faults"] + titok["faults"]]
    check(not faults, "kernel vs plain: " + "; ".join(faults))
    return results


def fwd_ptxas(int8, int8_pv, exp_bf16):
    """ptxas's report of one forward kernel instance, with its shared
    memory per CTA."""
    from landiff_tpu_torch.ops import kernels

    rep = kernels.ptxas_report(
        "flash_fwd", "flash_fwd_kernelILb%dELb%dELb%dE"
        % (int8, int8_pv, exp_bf16))
    rep["smem_bytes"] = kernels.flash_library().landiff_flash_fwd_smem_bytes(
        int(int8), int(int8_pv))
    return rep


def check_fwd_ptxas():
    """No forward instance has a wgmma that ptxas serialized ("Potential
    Performance Loss"), and the exact and int8 forms, with and without
    exp_bf16, no spills (int8_pv, whose int32 p.v sums sit beside the f32
    accumulator, spills some 100 bytes at 160 registers a thread; PERF.md).
    Returns the reports by variant name."""
    from landiff_tpu_torch.ops.attention import variant_name

    reports = {variant_name(*v): fwd_ptxas(*v) for v in FWD_VARIANTS}
    log(json.dumps({"phase": "flash_fwd_ptxas", "reports": reports}))
    for (int8, int8_pv, exp_bf16), (name, rep) in zip(FWD_VARIANTS,
                                                      reports.items()):
        spills = rep["spill_stores"] + rep["spill_loads"]
        check(not rep["warnings"] and (int8_pv or spills == 0),
              f"{name} ptxas: {rep}")
    return reports


# quantized launches of each drift gate's quantized run: 3 steps x (2 main
# + 1 control layers), one attention call each
DRIFT_LAUNCHES = {"int8": {"flash_fwd_int8": 9},
                  "int8_pv": {"flash_fwd_int8_pv": 9}, "w8a8": {}}


def phase_drift():
    """The compound-drift gates (diffusion/drift.py) in bf16 on the card,
    through the kernels: each must pass and its quantized run launch only
    its variant."""
    import torch

    from landiff_tpu_torch.diffusion import drift

    results = {}
    for gate in drift.GATES:
        res = drift.run_gate(gate, device="cuda", dtype=torch.bfloat16)
        log(json.dumps({"phase": "drift", "gate": gate, **res}))
        check(res["passed"], f"drift gate {gate}: {res}")
        check(res["launches"] == DRIFT_LAUNCHES[gate],
              f"drift gate {gate} launches {res['launches']}")
        results[gate] = res
    torch.cuda.empty_cache()
    return results


# the environment of the flash routes and of the fast configuration; the
# phases that set some of them restore all of them
ROUTE_KNOBS = ("LANDIFF_FAST", "LANDIFF_ATTN_INT8", "LANDIFF_ATTN_INT8_PV",
               "LANDIFF_ATTN_EXP_BF16", "LANDIFF_FUSED_ADALN",
               "LANDIFF_DIT_INT8", "LANDIFF_DECODE_INT8",
               "LANDIFF_DECODE_INT4", "LANDIFF_STEP_REUSE",
               "LANDIFF_CFG_WINDOW", "LANDIFF_REMAT_SAVE_ATTN")


class knobs:
    """Within the block exactly `env` of ROUTE_KNOBS is set; the earlier
    environment comes back after it."""

    def __init__(self, **env):
        self.env = env

    def __enter__(self):
        self.saved = {k: os.environ.pop(k, None) for k in ROUTE_KNOBS}
        os.environ.update({k: v for k, v in self.env.items()
                           if v is not None})

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def phase_direct(dec_mask):
    """flash_attention, the direct entry (what JAX's SP ring calls), under
    the knobs that select each exp_bf16 variant, at the DiT and the TiTok
    shapes: the path of those variants, which the dispatcher never takes
    (JAX's attention() pins exp_bf16=False). Counts reset just before and
    read just after: two launches of each, none of anything else."""
    import torch

    from landiff_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(12)
    shapes = ((2, 17776, 30, None), (1, 18768, 12, dec_mask))
    settings = {
        "flash_fwd_exact_exp_bf16": {"LANDIFF_ATTN_EXP_BF16": "1"},
        "flash_fwd_int8_exp_bf16": {"LANDIFF_ATTN_INT8": "1",
                                    "LANDIFF_ATTN_EXP_BF16": "1"},
        "flash_fwd_int8_pv_exp_bf16": {"LANDIFF_ATTN_INT8": "1",
                                       "LANDIFF_ATTN_EXP_BF16": "1",
                                       "LANDIFF_ATTN_INT8_PV": "1"}}
    inputs = [[torch.randn((B, S, H, 64), generator=g,
                           device="cuda").bfloat16() for _ in range(3)]
              + [mask] for B, S, H, mask in shapes]
    reset_counts()
    for env in settings.values():
        with knobs(**env):
            for q, k, v, mask in inputs:
                out = A.flash_attention(q, k, v, mask_fn=mask)
                check(out.shape == q.shape and bool(
                    torch.isfinite(out.float()).all()),
                    f"flash_attention under {env}: {tuple(out.shape)}")
    torch.cuda.synchronize()
    launches = read_counts()
    want = {k: 2 if k in settings else 0 for k in launches}
    check(launches == want, f"direct launches {launches}, want {want}")
    log(json.dumps({"phase": "direct", "settings": settings,
                    "launches": launches}))
    del inputs
    torch.cuda.empty_cache()
    return launches


def bwd_case(name, B, S, H, mask_fn, seed, exp2_rate):
    """flash_bwd against flash_bwd_plain from the exact forward kernel's
    own out and lse; the SDPA backward, timed alone, as the yardstick."""
    import torch
    import torch.nn.functional as F

    from landiff_tpu_torch.ops import attention as A
    from landiff_tpu_torch.ops import masks as M

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    D = 64
    r = lambda: torch.randn((B, S, H, D), generator=g, device=dev)
    q, k, v, do = (r() * 1.5).bfloat16(), r().bfloat16(), r().bfloat16(), \
        r().bfloat16()
    out, lse = A.flash_fwd_exact(q, k, v, mask_fn=mask_fn)
    call = lambda: A.flash_bwd(q, k, v, out, lse, do, mask_fn=mask_fn)
    got = call()                                     # first call: tables
    torch.cuda.synchronize()
    again = call()
    ms = cuda_ms(call, 3)
    t0 = time.perf_counter()
    want = A.flash_bwd_plain(q, k, v, out, lse, do, mask_fn=mask_fn)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    errs, faults = {}, []
    prep_ms, prep_err = bwd_prep_check(name, q, out, lse, do, faults)
    for tname, gt, wt in zip(("dq", "dk", "dv"), got, want):
        steps, rel_rms = A.kernel_error(gt, wt)
        errs[tname] = {
            "max_abs_err": (gt.float() - wt.float()).abs().max().item(),
            "max_bf16_steps": steps, "rel_rms_err": rel_rms}
        for ok, what in (
                (bool(torch.isfinite(gt.float()).all()), "not finite"),
                (steps <= BWD_TOL_STEPS, f"max |err| {steps} bf16 steps"),
                (rel_rms <= BWD_TOL_RMS, f"relative RMS error {rel_rms}")):
            if not ok:
                faults.append(f"flash_bwd {name} {tname}: {what}")
    # run to run: dk, dv are deterministic, dq is summed by bulk
    # reduce-adds in no fixed order
    for tname, a, b in zip(("dk", "dv"), got[1:], again[1:]):
        if not torch.equal(a, b):
            faults.append(f"flash_bwd {name}: {tname} differs between runs")
    dq_steps, dq_rms = A.kernel_error(again[0], got[0])
    spread = {"dq_max_bf16_steps": dq_steps, "dq_rel_rms": dq_rms,
              "dq_share_of_elements_differing":
                  (again[0] != got[0]).float().mean().item()}
    del again, want

    library_ms = None   # the backward of SDPA, with the dense mask
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    attn_mask = None
    if mask_fn is not None:
        i = torch.arange(S, device=dev)
        attn_mask = mask_fn(i[:, None], i[None, :])
    try:   # a yardstick only: a backend that refuses the shape -> null
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn_mask)
        dot = do.transpose(1, 2)
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            o, (qt, kt, vt), dot, retain_graph=True), 3)
        del o
    except (RuntimeError, torch.OutOfMemoryError) as e:
        log(json.dumps({"library_refused": name, "error": str(e)[:200]}))
    del qt, kt, vt, attn_mask

    visible = M.visible_count(mask_fn, S, S, device="cuda")
    flops = 10.0 * B * H * visible * D
    # q k v do out read, dq dk dv written (bf16), lse read (f32); p is
    # recomputed, one exp2 per visible pair
    nbytes = 8 * B * S * H * D * 2 + B * H * S * 4
    bound_s, bound_by, unit = least_time({
        "tensor cores": flops / PEAK_BF16, "exp2": B * H * visible / exp2_rate,
        "bytes": nbytes / PEAK_BYTES})
    res = {
        "case": name, "shape": [B, S, H, D],
        "mask": None if mask_fn is None else type(mask_fn).__name__
        + f"(kind={mask_fn.descriptor()[0]})",
        "visible_pairs": visible, "errors": errs,
        "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
        "run_to_run": spread, "ms": ms, "plain_ms": plain_ms,
        "prep_ms": prep_ms, "prep_delta_max_abs_err": prep_err,
        "library_ms": library_ms, "bound_ms": bound_s * 1e3,
        "bound_by": bound_by, "bound_unit": unit,
        "tflops": flops / (ms * 1e-3) / 1e12, "faults": faults}
    log(json.dumps({"kernel": "flash_bwd", **res}))
    del q, k, v, do, out, lse, got
    torch.cuda.empty_cache()
    return res


def bwd_prep_check(name, q, out, lse, do, faults):
    """The backward's prologue (flash_bwd_prep) against its plain version:
    q' (bf16; the f32 kernel makes it itself) and the padded lse exactly,
    delta within 1e-5 (the order of a 64-term f32 sum), the dq workspace
    all zeros. Returns (its ms, delta's max |err|); a miss goes to
    `faults`."""
    import torch

    from landiff_tpu_torch.ops import attention as A

    call = lambda: A.flash_bwd_prep(q, out, lse, do)
    got = call()
    want = A.flash_bwd_prep_plain(q, out, lse, do)
    err = (got[2] - want[2]).abs().max().item()
    qs_ok = (got[0] is None if q.dtype == torch.float32
             else torch.equal(got[0], want[0]))
    for ok, what in ((qs_ok, "q' differs"),
                     (torch.equal(got[1], want[1]), "padded lse differs"),
                     (err <= 1e-5 + 1e-5 * want[2].abs().max().item(),
                      f"delta max |err| {err}"),
                     (not bool(got[3].any()), "dq workspace not zeroed")):
        if not ok:
            faults.append(f"flash_bwd prologue {name}: {what}")
    del got, want
    return cuda_ms(call, 5), err


def bwd_masked_rows_case():
    """Rows past the video-decoder layout see nothing and no row sees the
    kv positions there: their dq, dk, dv must be exactly 0 (ragged tiles:
    430 = 6 * 64 + 46)."""
    import torch

    from landiff_tpu_torch.ops import attention as A
    from landiff_tpu_torch.ops import masks as M

    layout = M.VideoMaskLayout(num_frames=3, tokens_per_frame=100,
                               iframe_tokens=70, pframe_tokens=10)
    n, S = layout.seq_len, layout.seq_len + 40
    mask = M.video_decoder_mask(layout)
    g = torch.Generator(device="cuda").manual_seed(11)
    r = lambda: torch.randn((2, S, 3, 64), generator=g,
                            device="cuda").bfloat16()
    q, k, v, do = r(), r(), r(), r()
    out, lse = A.flash_fwd_exact(q, k, v, mask_fn=mask)
    got = A.flash_bwd(q, k, v, out, lse, do, mask_fn=mask)
    want = A.flash_bwd_plain(q, k, v, out, lse, do, mask_fn=mask)
    for tname, gt, wt in zip(("dq", "dk", "dv"), got, want):
        check(float(gt[:, n:].abs().max()) == 0.0,
              f"flash_bwd masked rows: {tname} is not exactly 0 there")
        steps, rel_rms = A.kernel_error(gt, wt)
        check(steps <= BWD_TOL_STEPS and rel_rms <= BWD_TOL_RMS,
              f"flash_bwd masked rows {tname}: {steps} steps, rms {rel_rms}")
    log(json.dumps({"kernel": "flash_bwd", "case": "masked_rows",
                    "shape": [2, S, 3, 64], "rows_past_layout": S - n,
                    "exactly_zero": True}))


def phase_bwd_kernel(dec_mask, exp2_rate):
    train = bwd_case("dit_train", 1, 17776, 30, None, seed=21,
                     exp2_rate=exp2_rate)
    titok = bwd_case("titok_dec", 1, 18768, 12, dec_mask, seed=22,
                     exp2_rate=exp2_rate)
    bwd_masked_rows_case()
    faults = train["faults"] + titok["faults"]
    check(not faults, "kernel vs plain: " + "; ".join(faults))
    train["titok_dec"] = titok
    return train


def adaln_case(name, B, S, D, text_len, dtype_name, seed, timed):
    import torch

    from landiff_tpu_torch.ops import adaln as N

    dev = torch.device("cuda")
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype_name]
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    x = (r(B, S, D) * 1.5 + 0.3).to(dtype)
    w, b = (1.0 + 0.1 * r(D)).to(dtype), (0.1 * r(D)).to(dtype)
    # the pairs as the DiT layer passes them: slices of one (B, 12 D) tensor
    mods = (0.3 * r(B, 12 * D)).to(dtype).chunk(12, dim=-1)
    args = (x, w, b, mods[6], mods[7], mods[0], mods[1])
    fused = lambda: N.adaln_modulate(*args, text_len=text_len, impl="kernel")
    plain = lambda: N.adaln_plain(*args, text_len=text_len)
    unfused = lambda: N.adaln_reference(*args, text_len=text_len)

    out = fused()
    torch.cuda.synchronize()
    ref = plain()
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs().clamp_min(2.0 ** -7)
    steps = (diff / torch.exp2(torch.frexp(mag)[1] - 8.0)).max().item()
    rel_rms = (diff.norm() / ref.float().norm()).item()
    rel_max = (diff / (ref.float().abs() + 1.0)).max().item()
    res = {"case": name, "shape": [B, S, D], "text_len": text_len,
           "dtype": dtype_name, "max_abs_err": diff.max().item(),
           "max_bf16_steps": steps, "rel_rms_err": rel_rms,
           "max_err_over_1_plus_abs": rel_max}
    finite = bool(torch.isfinite(out.float()).all())
    # rows on either side of the text boundary took different pairs
    if 0 < text_len < S:
        other = N.adaln_plain(*args, text_len=0)
        check(bool((other[:, :text_len] != ref[:, :text_len]).any()),
              "adaLN case does not exercise the text pair")
    del diff, mag
    if timed:
        nbytes = 2 * x.numel() * x.element_size()     # x read, out written
        res.update({
            "ms": cuda_ms(fused, 20), "plain_ms": cuda_ms(plain, 3),
            "unfused_ms": cuda_ms(unfused, 3),
            "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "bytes": nbytes, "library_ms": None})
        res["gb_per_s"] = nbytes / (res["ms"] * 1e-3) / 1e9
    log(json.dumps({"kernel": "adaln", **res}))
    ok_err = (steps <= ADALN_TOL_STEPS and rel_rms <= ADALN_TOL_RMS_BF16
              if dtype_name == "bf16" else rel_max <= ADALN_TOL_F32)
    res["faults"] = [f"adaln {name}: {what}" for ok, what in (
        (finite, "output not finite"),
        (ok_err, f"error {steps} bf16 steps, rel rms {rel_rms}, "
                 f"rel max {rel_max}")) if not ok]
    del x, out, ref, args, mods
    torch.cuda.empty_cache()
    return res


def phase_adaln():
    main = adaln_case("dit", 2, 17776, 1920, 226, "bf16", seed=3, timed=True)
    # 226 = 4 * 56 + 2: the text boundary falls inside a 4-row block; 515
    # rows leave a ragged last block
    ragged = adaln_case("ragged", 2, 515, 1920, 226, "bf16", seed=4,
                        timed=False)
    f32 = adaln_case("dit_f32", 2, 4099, 1920, 226, "f32", seed=5,
                     timed=False)
    faults = main["faults"] + ragged["faults"] + f32["faults"]
    check(not faults, "kernel vs plain: " + "; ".join(faults))
    main["ragged"], main["f32"] = ragged, f32
    return main


# ---------------------------------------------------------------------------
# phases 4-8: full width


def reset_counts():
    from landiff_tpu_torch.ops import adaln as N
    from landiff_tpu_torch.ops import attention as A

    A.reset_launch_counts()
    N.adaln_fused.launches = 0


def read_counts():
    """Launches per kernel and forward variant since reset_counts."""
    from landiff_tpu_torch.ops import adaln as N
    from landiff_tpu_torch.ops import attention as A

    return {**A.LAUNCHES,
            "adaln": N.adaln_fused.launches}


def build_full(steps):
    """Both stages at full width through the user's entry point, zero
    leaves filled."""
    import torch

    from landiff_tpu_torch.config import ARSampleConfig, LanDiffConfig
    from landiff_tpu_torch.pipeline import infer_video
    from landiff_tpu_torch.utils import count_params, fill_zero_leaves

    cfg = LanDiffConfig()
    cfg = dataclasses.replace(
        cfg, sampler=dataclasses.replace(cfg.sampler, num_steps=steps))
    t0 = time.perf_counter()
    llm, dif = infer_video.build_pipeline(cfg, ARSampleConfig(seed=1),
                                          seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(123)
    llm.params = fill_zero_leaves(llm.params, gen)
    dif.params = fill_zero_leaves(dif.params, gen)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(json.dumps({
        "phase": "init", "seconds": time.perf_counter() - t0,
        "params": {**{k: count_params(v) for k, v in dif.params.items()},
                   "stage1_lm": count_params(llm.params["lm"]),
                   "stage1_t5": count_params(llm.params["t5"])},
        "gpu_mem_gb": torch.cuda.memory_allocated() / 1e9}))
    return cfg, llm, dif


def check_no_variant(launches):
    """The default path (no knob) runs no int8_pv or exp_bf16 variant."""
    ran = {k: n for k, n in launches.items()
           if ("_pv" in k or "exp_bf16" in k) and n}
    check(not ran, f"forward variants ran on the default path: {ran}")


def check_video(task_video, latent=None):
    check(task_video.shape == (1, 3, 49, 480, 720),
          f"video {task_video.shape}")
    check(bool(np.isfinite(task_video).all()), "video not finite")
    check(task_video.min() >= 0.0 and task_video.max() <= 1.0, "video range")
    check(float(task_video.std()) > 0.0, "video is constant")
    if latent is not None:
        check(latent.shape == (1, 13, 16, 60, 90), f"latent {latent.shape}")
        check(bool(np.isfinite(latent).all()), "latent not finite")


def phase_stage2(cfg, dif, steps):
    """The stage-2 wrapper alone, codes from a seed, knob unset."""
    import torch

    from landiff_tpu_torch.pipeline import dif_infer

    os.environ.pop("LANDIFF_FUSED_ADALN", None)
    per_request = 12 + 45 * steps
    prompt, seed = "a corgi running along a beach at sunset", 1
    codes = np.random.default_rng(seed).integers(
        0, cfg.tokenizer.vq.codebook_size, cfg.tokenizer.titok.latent_tokens)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    task = dif(dif_infer.VideoTask("req0", prompt, seed,
                                   semantic_token=codes))
    seconds = time.perf_counter() - t0
    launches = read_counts()
    check_video(task.result, task.latent)
    check(launches["flash_fwd_int8"] == per_request,
          f"int8 launches {launches['flash_fwd_int8']}, want {per_request}")
    check(launches["flash_fwd_exact"] == 0,
          "exact kernel ran on the int8 path")
    check(launches["adaln"] == 0, "adaLN kernel ran with the knob unset")
    check_no_variant(launches)
    log(json.dumps({
        "phase": "stage2", "warm": True, "fused_adaln": False,
        "seconds": seconds,
        "phase_seconds": dif.phase_seconds,
        "video_mean": float(task.result.mean()),
        "video_std": float(task.result.std()), "launches": launches,
        "peak_gpu_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    return launches


def check_codes(codes, cfg, what):
    check(codes.shape == (cfg.tokenizer.titok.latent_tokens,),
          f"{what}: {codes.shape} codes")
    check(np.issubdtype(codes.dtype, np.integer), f"{what}: {codes.dtype}")
    check(codes.min() >= 0 and codes.max() < cfg.llm.codebook_size,
          f"{what}: codes out of range")
    check(len(np.unique(codes)) > 1, f"{what}: codes are constant")


def phase_video(cfg, llm, dif, steps):
    """prompt -> codes -> video through infer_video.generate with the
    fused adaLN knob set; then stage 1 alone for repeatability and the
    batched decode."""
    import torch

    from landiff_tpu_torch.models import lm
    from landiff_tpu_torch.pipeline import infer_video, llm_infer

    requests = [("a corgi running along a beach at sunset", 1),
                ("a paper boat drifting down a rainy street", 2)]
    # tokens drawn per video: 1,218 codes + 25 structural + EOS; each but
    # the last feeds one decode step
    decode_steps = lm.video_frames_to_code_len(
        cfg.llm, llm.sample_cfg.num_frames)
    check(decode_steps == 1244, f"{decode_steps} draws per video")
    os.environ["LANDIFF_FUSED_ADALN"] = "1"
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        codes = []
        for i, (prompt, seed) in enumerate(requests):
            llm.sample_cfg = dataclasses.replace(llm.sample_cfg, seed=seed)
            res = infer_video.generate(llm, dif, prompt, seed=seed)
            check_codes(res["codes"], cfg, f"request {i}")
            check_video(res["video"])
            codes.append(res["codes"])
            log(json.dumps({
                "phase": "video", "request": i, "warm": i > 0,
                "fused_adaln": True, "stage1_s": res["stage1_s"],
                "stage2_s": res["stage2_s"],
                "stage1_phase_seconds": llm.phase_seconds,
                "decode_steps": decode_steps,
                "decode_steps_per_s":
                    decode_steps / llm.phase_seconds["sample"],
                "stage2_phase_seconds": dif.phase_seconds,
                "video_mean": float(res["video"].mean()),
                "video_std": float(res["video"].std()),
                "codes_head": res["codes"][:8].tolist()}))
        launches = read_counts()
    finally:
        os.environ.pop("LANDIFF_FUSED_ADALN")
    n = len(requests)
    check(launches["adaln"] == n * 90 * steps,
          f"adaLN launches {launches['adaln']}, want {n * 90 * steps}")
    check(launches["flash_fwd_int8"] == n * (12 + 45 * steps),
          f"int8 launches {launches['flash_fwd_int8']}, want "
          f"{n * (12 + 45 * steps)}")
    check(launches["flash_fwd_exact"] == 0, "exact kernel ran on the path")
    check_no_variant(launches)
    check(not np.array_equal(codes[0], codes[1]),
          "two prompts gave the same codes")
    log(json.dumps({"phase": "video", "launches": launches,
                    "peak_gpu_mem_gb": torch.cuda.max_memory_allocated()
                    / 1e9}))

    # stage 1 alone: repeat, another seed, one batched decode
    (pa, sa), (pb, sb) = requests
    task = lambda p: llm_infer.CodeTask("x.npy", p)
    llm.sample_cfg = dataclasses.replace(llm.sample_cfg, seed=sa)
    again = llm(task(pa)).result
    check(np.array_equal(again, codes[0]),
          "a repeated (prompt, seed) gave other codes")
    single_b = llm(task(pb)).result              # prompt b under seed a
    check_codes(single_b, cfg, "prompt b, seed a")
    check(not np.array_equal(single_b, codes[1]),
          "another seed gave the same codes")
    t0 = time.perf_counter()
    batch = llm.infer_batch([task(pa), task(pb)])
    batch_s = time.perf_counter() - t0
    agree = []
    for got, want, name in ((batch[0].result, codes[0], "a"),
                            (batch[1].result, single_b, "b")):
        check_codes(got, cfg, f"batched prompt {name}")
        same = got == want
        agree.append({"equal": bool(same.all()),
                      "first_difference": None if same.all()
                      else int(np.argmin(same)),
                      "share_equal": float(same.mean())})
    # In bf16 at full width the batched decode (4 rows, padded prefix)
    # takes other GEMM shapes than a single call (2 rows), the combined
    # logits carry that rounding times the guidance scale, and one flipped
    # draw changes every later token: the agreement is reported, and the
    # equality is held in f32 below.
    log(json.dumps({"phase": "stage1_batch", "seconds": batch_s,
                    "phase_seconds": llm.phase_seconds,
                    "decode_steps_per_s":
                        decode_steps / llm.phase_seconds["sample"],
                    "vs_single_calls_bf16": agree}))
    return launches


def _forced_logit_gaps(llm, prompts, steps: int, seed: int = 7):
    """The first prompt's logits batched against alone, both fed the same
    random visual tokens for `steps` decode steps, with the KV cache in
    the compute dtype: per step, max |difference| of the guidance-combined
    logits (what a draw sees) over their standard deviation."""
    import torch
    import torch.nn.functional as F

    from landiff_tpu_torch.models import gpt, lm

    cfg, sc, dt = llm.llm_cfg, llm.sample_cfg, llm.compute_dtype
    params, dev = llm.params["lm"], llm.device
    rows = [torch.stack(llm._prompt_rows(p)) for p in prompts]
    lens = [r.shape[1] for r in rows]
    P = -(-max(lens) // 16) * 16
    pad = torch.as_tensor(np.repeat(P - np.asarray(lens), 2), device=dev)
    batched = torch.cat([F.pad(r, (0, 0, P - r.shape[1], 0)) for r in rows])
    cos, sin = lm._rope_tables(cfg, P + steps + 1, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    fed = torch.randint(0, cfg.codebook_size, (steps,), device=dev,
                        generator=gen)
    emb = params["tok_emb"]
    L = lens[0]
    # guidance and temperature only: the same for both prefixes
    st = lm._static(cfg, lm.build_schedule(cfg, L, sc.num_frames), sc)
    one = gpt.KVCache.create(cfg, 2, L + steps + 1, dt, dev)
    many = gpt.KVCache.create(cfg, len(batched), P + steps + 1, dt, dev)
    pos = torch.arange(P + steps + 1, device=dev)
    ppos = (pos[None, :P] - pad[:, None]).clamp_min(0)
    with torch.inference_mode():
        lo, one = gpt.prefill(params["gpt"], rows[0], one, cfg, cos[:L],
                              sin[:L], compute_dtype=dt)
        lb, many = gpt.prefill(params["gpt"], batched, many, cfg, cos[ppos],
                               sin[ppos], compute_dtype=dt, pad=pad)
        gaps = []
        for k in range(steps + 1):
            co = lm._combined_logits(lo, st)
            cb = lm._combined_logits(lb[:2], st)
            gaps.append(float((co - cb).abs().max() / co.std()))
            if k == steps:
                break
            feat = emb[fed[k]][None, None]
            at = slice(L + k, L + k + 1)
            lo, one = gpt.decode_step(
                params["gpt"], feat.expand(2, 1, -1), one, pos[at], cfg,
                cos[at], sin[at], compute_dtype=dt)
            dpos = (pos[P + k] - pad).clamp_min(0)[:, None]
            lb, many = gpt.decode_step(
                params["gpt"], feat.expand(len(batched), 1, -1), many,
                pos[P + k:P + k + 1], cfg, cos[dpos], sin[dpos],
                compute_dtype=dt, pad=pad)
    return gaps


def phase_stage1_batch():
    """Where batched decoding parts from the single calls at full width:
    stage 1 alone (LanDiffConfig's LM and T5, random weights from seed 0,
    zero leaves filled) in bf16, then in f32. One infer_batch of two
    prompts against their single calls under one seed (the first
    differing code and the share of equal codes per prompt), and the
    first prompt's combined logits batched against alone over 64
    teacher-forced decode steps with the cache in the compute dtype
    (_forced_logit_gaps)."""
    import torch

    from landiff_tpu_torch.config import ARSampleConfig, LanDiffConfig
    from landiff_tpu_torch.pipeline import llm_infer
    from landiff_tpu_torch.utils import fill_zero_leaves

    cfg = LanDiffConfig()
    prompts = ("a corgi running along a beach at sunset",
               "a paper boat drifting down a rainy street")
    agree = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(0)
        llm = llm_infer.ArModelInferWrapper(
            llm_infer.init_params(gen, cfg.llm, cfg.t5), cfg.llm, cfg.t5,
            ARSampleConfig(seed=1), compute_dtype=dtype, device="cuda")
        llm.params = fill_zero_leaves(
            llm.params, torch.Generator(device="cuda").manual_seed(123))
        tasks = [llm_infer.CodeTask(f"{i}.npy", p)
                 for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        batch = llm.infer_batch(tasks)
        rows = []
        for task, got in zip(tasks, batch):
            single = llm(task).result
            check_codes(single, cfg, f"{dtype} single call")
            check_codes(got.result, cfg, f"{dtype} batched call")
            same = got.result == single
            rows.append({"equal": bool(same.all()),
                         "first_difference": None if same.all()
                         else int(np.argmin(same)),
                         "share_equal": float(same.mean())})
        gaps = _forced_logit_gaps(llm, prompts, 64)
        check(all(np.isfinite(gaps)), f"{dtype}: logits not finite")
        agree[str(dtype).removeprefix("torch.")] = rows
        log(json.dumps({"phase": "stage1_batch", "dtype": str(dtype),
                        "seconds": time.perf_counter() - t0,
                        "vs_single_calls": rows,
                        "forced_logit_gap_over_std": {
                            "first": gaps[0], "max": max(gaps),
                            "median": float(np.median(gaps)),
                            "last": gaps[-1]}}))
        del llm, batch
        gc.collect()
        torch.cuda.empty_cache()
    return agree


def phase_batch_f32():
    """infer_batch against the single calls where rounding cannot flip a
    draw: the tiny config in f32, on the card. Identical codes."""
    import torch

    from landiff_tpu_torch.config import ARSampleConfig, tiny_test_config
    from landiff_tpu_torch.pipeline import infer_video, llm_infer
    from landiff_tpu_torch.utils import fill_zero_leaves

    cfg = tiny_test_config()
    llm, _ = infer_video.build_pipeline(
        cfg, ARSampleConfig(num_frames=cfg.llm.frames_per_segment, seed=4),
        seed=0, compute_dtype=torch.float32, device="cuda")
    llm.params = fill_zero_leaves(
        llm.params, torch.Generator(device="cuda").manual_seed(5))
    tasks = [llm_infer.CodeTask(f"{i}.npy", p) for i, p in enumerate(
        ("a corgi running along a beach at sunset", "fog"))]
    batch = llm.infer_batch(tasks)
    for task, got in zip(tasks, batch):
        single = llm(task).result
        check(len(single) == cfg.tokenizer.titok.latent_tokens,
              f"tiny config: {len(single)} codes")
        check(np.array_equal(got.result, single),
              f"infer_batch codes differ from the single call for "
              f"{task.prompt!r} in f32: {got.result} vs {single}")
    check(not np.array_equal(batch[0].result, batch[1].result),
          "tiny config: two prompts gave the same codes")
    log(json.dumps({"phase": "stage1_batch_f32", "config": "tiny_test_config",
                    "equal_to_single_calls": True,
                    "codes": [t.result.tolist() for t in batch]}))


def phase_exact(cfg, params):
    import torch

    from landiff_tpu_torch.models import dit
    from landiff_tpu_torch.ops import attention as A

    d = cfg.dit
    g = torch.Generator(device="cuda").manual_seed(7)
    shape = (2, d.latent_frames, d.in_channels, d.latent_height,
             d.latent_width)
    x = torch.randn(shape, generator=g, device="cuda").bfloat16()
    sem = torch.randn(shape, generator=g, device="cuda").bfloat16()
    ctx = torch.randn((2, d.text_length, d.text_dim), generator=g,
                      device="cuda")
    ts = torch.tensor([800.0, 800.0], device="cuda")
    os.environ.pop("LANDIFF_FUSED_ADALN", None)
    os.environ["LANDIFF_ATTN_INT8"] = "0"
    try:
        A.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = dit.control_warp_forward(params["main"], params["control"],
                                           x, ts, ctx, d, sem)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = A.LAUNCHES["flash_fwd_exact"]
    finally:
        os.environ.pop("LANDIFF_ATTN_INT8")
    check(launches == 45, f"exact launches {launches}, want 45")
    check(A.LAUNCHES["flash_fwd_int8"] == 0, "int8 kernel ran with int8 off")
    check(tuple(out.shape) == shape, f"exact-path output {tuple(out.shape)}")
    check(bool(torch.isfinite(out.float()).all()), "exact path not finite")
    log(json.dumps({"phase": "exact", "seconds": seconds,
                    "launches": launches}))
    return launches


def phase_dit_call(cfg, params):
    """One warm denoise-step model call (control_warp_forward, CFG batch
    2, int8 scores) timed without and with LANDIFF_FUSED_ADALN, in turns
    (off, on, on, off), host clock around a synchronised call."""
    import torch

    from landiff_tpu_torch.models import dit

    d = cfg.dit
    g = torch.Generator(device="cuda").manual_seed(9)
    shape = (2, d.latent_frames, d.in_channels, d.latent_height,
             d.latent_width)
    x = torch.randn(shape, generator=g, device="cuda").bfloat16()
    sem = torch.randn(shape, generator=g, device="cuda").bfloat16()
    ctx = torch.randn((2, d.text_length, d.text_dim), generator=g,
                      device="cuda")
    ts = torch.tensor([500.0, 500.0], device="cuda")

    def call(fused):
        if fused:
            os.environ["LANDIFF_FUSED_ADALN"] = "1"
        else:
            os.environ.pop("LANDIFF_FUSED_ADALN", None)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                out = dit.control_warp_forward(
                    params["main"], params["control"], x, ts, ctx, d, sem)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, out
        finally:
            os.environ.pop("LANDIFF_FUSED_ADALN", None)

    call(False), call(True)                       # warm both routes
    reset_counts()
    times = {False: [], True: []}
    outs = {}
    for fused in (False, True, True, False):
        ms, outs[fused] = call(fused)
        times[fused].append(ms)
    launches = read_counts()
    check(launches["adaln"] == 2 * 90,
          f"adaLN launches {launches['adaln']} in two fused calls")
    # the fused route rounds once where the unfused chain rounds twice per
    # modulate: the outputs differ by bf16 roundings carried through 45
    # layers (reading on an H100: 1.2e-2 relative RMS), not by more
    diff = (outs[True].float() - outs[False].float())
    rel = (diff.norm() / outs[False].float().norm()).item()
    check(bool(torch.isfinite(outs[True].float()).all()),
          "fused DiT call not finite")
    check(rel < 3e-2, f"fused DiT call is {rel} (relative RMS) off unfused")
    log(json.dumps({
        "phase": "dit_call", "what": "one control_warp_forward, CFG batch "
        "2, 45 layers, int8 scores", "unfused_ms": times[False],
        "fused_adaln_ms": times[True],
        "fused_vs_unfused_rel_rms": rel, "launches": launches}))


FAST_STEPS = 50
# per 50-step video: 28 model calls x 45 DiT layers + 12 TiTok decoder
# layers, all on the int8 route
FAST_PV_LAUNCHES = 45 * 28 + 12


def phase_long_video(cfg, llm, dif, steps):
    """A two-segment request (num_frames 26) through infer_video.generate
    at full width and depth: 2 x 1,218 valid codes, 19 latent frames (13 +
    (13 - 7)), one streaming decode to 73 frames at 480 x 720, finite, in
    [0, 1]; seconds per phase and per segment. Per segment the int8
    forward launches 45 * steps times, and 12 more for its TiTok decode."""
    import torch

    from landiff_tpu_torch.pipeline import infer_video

    saved = llm.sample_cfg
    llm.sample_cfg = dataclasses.replace(saved, num_frames=26, seed=3)
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        res = infer_video.generate(llm, dif, "a kite over a windy hill",
                                   seed=5)
        launches = read_counts()
    finally:
        llm.sample_cfg = saved
    codes, video, latent = res["codes"], res["video"], res["latent"]
    seg = cfg.tokenizer.titok.latent_tokens
    check(codes.shape == (2 * seg,), f"codes {codes.shape}")
    check_codes(codes[:seg], cfg, "long video, segment 0")
    check_codes(codes[seg:], cfg, "long video, segment 1")
    check(latent.shape == (1, 19, 16, 60, 90), f"latent {latent.shape}")
    check(bool(np.isfinite(latent).all()), "latent not finite")
    check(video.shape == (1, 3, 73, 480, 720), f"video {video.shape}")
    check(bool(np.isfinite(video).all()), "video not finite")
    check(video.min() >= 0.0 and video.max() <= 1.0, "video range")
    want = 2 * (12 + 45 * steps)
    check(launches["flash_fwd_int8"] == want,
          f"int8 launches {launches['flash_fwd_int8']}, want {want}")
    check_no_variant(launches)
    log(json.dumps({
        "phase": "long_video", "segments": 2, "codes": list(codes.shape),
        "latent": list(latent.shape), "video": list(video.shape),
        "stage1_s": res["stage1_s"], "stage2_s": res["stage2_s"],
        "stage1_phase_seconds": llm.phase_seconds,
        "stage2_phase_seconds": res["stage2_phases"],
        "launches": launches,
        "peak_gpu_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "video_mean": float(video.mean()), "video_std": float(video.std())}))
    return launches


# the depth a synthetic checkpoint tree is cut to, at full width (it is
# written to disk and read back)
CKPT_DEPTH = {"gpt_layers": 2, "dit_main_layers": 2,
              "dit_control_layers": 1, "titok_layers": 1, "t5_layers": 2}


def phase_ckpt(workdir, steps):
    """A synthetic checkpoint tree of LanDiffConfig() at full width (depth
    cut to CKPT_DEPTH), written in the release's layout and names by the
    port's own writers (ckpt/synth.py: f32 safetensors, SAT / Lightning
    .pt, the T5 as two bf16 safetensors shards with the HF index), loaded
    through infer_video.build_pipeline(ckpt_dir=...) onto the card in f32:
    every loaded tensor equal to the written one after the layout change
    (converted on the host, put through the bridge), with spot checks of
    the layouts and of the control override; then one request of `steps`
    steps from it in f32, the path of the f32 forwards (int8 at the DiT
    shape, exact at the TiTok shape). Load seconds and GB/s."""
    import torch

    from landiff_tpu_torch import bridge
    from landiff_tpu_torch.ckpt import convert, synth
    from landiff_tpu_torch.config import ARSampleConfig, LanDiffConfig
    from landiff_tpu_torch.pipeline import infer_video
    from landiff_tpu_torch.utils import tree_leaves

    full = LanDiffConfig()
    r = dataclasses.replace
    cfg = r(full,
            llm=r(full.llm, num_layers=CKPT_DEPTH["gpt_layers"]),
            dit=r(full.dit, num_layers=CKPT_DEPTH["dit_main_layers"],
                  control_layers=CKPT_DEPTH["dit_control_layers"]),
            tokenizer=r(full.tokenizer, titok=r(
                full.tokenizer.titok,
                num_layers=CKPT_DEPTH["titok_layers"])),
            t5=r(full.t5, num_layers=CKPT_DEPTH["t5_layers"]),
            sampler=r(full.sampler, num_steps=steps))
    root = workdir / "LanDiff"
    t0 = time.perf_counter()
    written = synth.write_tree(root, cfg, seed=9)
    write_s = time.perf_counter() - t0
    file_bytes = sum(written["files"].values())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    llm, dif = infer_video.build_pipeline(
        cfg, ARSampleConfig(seed=4), ckpt_dir=str(root),
        compute_dtype=torch.float32, device="cuda",
        require_real_tokenizer=False)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    loaded_bytes = sum(t.numel() * t.element_size() for t in
                       tree_leaves(dif.params) + tree_leaves(llm.params))

    # every tensor against the written state dicts, converted here
    sds = written["state_dicts"]
    base = {k[6:]: v for k, v in sds[synth.BASE_DIT].items()}
    parts = convert.split_engine_state(sds[synth.ENGINE])
    main_sd = {**base, **parts["main"]}
    ctrl_sd = {**base, **{k: v for k, v in parts["control"].items()
                          if not k.startswith("semantic_conditioner.")}}
    want = {
        "main": convert.convert_dit(main_sd, cfg.dit.num_layers),
        "control": convert.convert_dit(ctrl_sd, cfg.dit.control_layers,
                                       control=True),
        "semantic": convert.convert_semantic_cond(
            parts["semantic"], cfg.semantic_cond.num_res_blocks),
        "vae": convert.convert_vae(sds[synth.VAE], cfg.vae.num_res_blocks,
                                   len(cfg.vae.ch_mult)),
        "lm": convert.convert_llm(sds["llm/model.safetensors"],
                                  cfg.llm.num_layers)}
    mismatched, compared = [], 0
    for name, tree in want.items():
        got = llm.params["lm"] if name == "lm" else dif.params[name]
        exp = bridge.to_torch(tree, device="cpu")
        for path, (a, b) in enumerate(zip(tree_leaves(got),
                                          tree_leaves(exp))):
            compared += 1
            if name == "lm" and a.dtype != b.dtype:   # GPT blocks cast
                b = b.to(a.dtype)
            if a.shape != b.shape or not torch.equal(a.cpu(), b):
                mismatched.append(f"{name}[{path}]")
    t5_want = {k: torch.from_numpy(v) for k, v in sds[synth.T5_DIR].items()}
    t5 = dif.params["t5"]
    check(torch.equal(t5["blocks"][0]["attn"]["q"].cpu(),
                      t5_want["block.0.layer.0.SelfAttention.q.weight"].T),
          "stage-2 T5 q matrix (bf16 file) differs")
    check(not mismatched, f"loaded tensors differ: {mismatched[:8]}")
    # the layout changes themselves, against the written torch tensors
    qkv = "transformer.layers.0.attention.query_key_value.weight"
    check(torch.equal(dif.params["main"]["layers"][0]["qkv_w"].cpu(),
                      torch.from_numpy(base[qkv]).T),
          "main qkv is not the base checkpoint's, transposed")
    ctrl_key = "model.diffusion_model.control_model." + qkv
    check(torch.equal(dif.params["control"]["layers"][0]["qkv_w"].cpu(),
                      torch.from_numpy(sds[synth.ENGINE][ctrl_key]).T),
          "control qkv is not the LanDiff checkpoint's override")
    vae_key = "decoder.conv_in.conv.weight"
    check(torch.equal(dif.params["vae"]["decoder"]["conv_in"]["w"].cpu(),
                      torch.from_numpy(sds[synth.VAE][vae_key])),
          "VAE conv_in kernel is not the written OIDHW tensor")

    reset_counts()
    t0 = time.perf_counter()
    res = infer_video.generate(llm, dif, "a lighthouse in the fog", seed=6)
    gen_s = time.perf_counter() - t0
    launches = read_counts()
    check_codes(res["codes"], cfg, "ckpt request")
    check_video(res["video"], res["latent"])
    want_i8 = (cfg.dit.num_layers + cfg.dit.control_layers) * steps
    check(launches["flash_fwd_int8_f32"] == want_i8
          and launches["flash_fwd_exact_f32"] == cfg.tokenizer.titok
          .num_layers, f"f32 forward launches {launches}")
    log(json.dumps({
        "phase": "ckpt", "config": "LanDiffConfig() at full width",
        "depth_cut_to": CKPT_DEPTH, "files": written["files"],
        "file_bytes": file_bytes, "write_s": write_s, "load_s": load_s,
        "loaded_bytes_f32": loaded_bytes,
        "load_gb_per_s": file_bytes / load_s / 1e9,
        "tensors_compared": compared, "request_s": gen_s,
        "stage1_s": res["stage1_s"], "stage2_s": res["stage2_s"],
        "compute_dtype": "float32", "launches": launches}))
    del llm, dif, written, sds
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_fast(cfg, llm, dif):
    """The fast serving configuration at full width: LANDIFF_FAST=2 (W8A8
    DiT linears, int8 stage-1 weights, step reuse, guidance window [2, 44))
    and LANDIFF_ATTN_INT8_PV=1, set for this phase only. The wrappers are
    built by their constructors from the resident parameters (they
    quantize: the f32 main and control DiTs, the bf16 GPT blocks), and one
    prompt goes to a video through infer_video.generate at the released 50
    steps. The model calls are counted by their batch rows."""
    import torch

    from landiff_tpu_torch.models import dit as dit_lib
    from landiff_tpu_torch.models import lm
    from landiff_tpu_torch.pipeline import dif_infer, infer_video, llm_infer

    fast_cfg = dataclasses.replace(cfg, sampler=dataclasses.replace(
        cfg.sampler, num_steps=FAST_STEPS))
    prompt, seed = "a corgi running along a beach at sunset", 1
    rows = []
    orig = dit_lib.control_warp_forward

    call_s = {1: [], 2: []}

    def counted(main, control, x, *a, **kw):
        rows.append(x.shape[0])
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(main, control, x, *a, **kw)
        torch.cuda.synchronize()
        call_s.setdefault(x.shape[0], []).append(time.perf_counter() - t)
        return out

    with knobs(LANDIFF_FAST="2", LANDIFF_ATTN_INT8_PV="1"):
        t0 = time.perf_counter()
        fllm = llm_infer.ArModelInferWrapper(
            llm.params, cfg.llm, cfg.t5,
            dataclasses.replace(llm.sample_cfg, seed=seed), device="cuda")
        fdif = dif_infer.CogModelInferWrapper(dif.params, fast_cfg,
                                              device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(isinstance(fllm.params["lm"]["gpt"]["blocks"][0]["wqkv"], dict),
              "stage 1 is not on int8 weights")
        check(all(isinstance(fdif.params[k]["layers"][0]["qkv_w"], dict)
                  for k in ("main", "control")), "the DiT is not W8A8")
        # the first request of these wrappers; every kernel it launches
        # has run earlier in the process
        dit_lib.control_warp_forward = counted
        try:
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            res = infer_video.generate(fllm, fdif, prompt, seed=seed)
            launches = read_counts()
        finally:
            dit_lib.control_warp_forward = orig
    check_codes(res["codes"], cfg, "fast")
    check_video(res["video"])
    check(len(rows) == 28 and rows.count(2) == 22 and rows.count(1) == 6,
          f"fast path model calls by rows {rows}")
    want = {k: 0 for k in launches}
    want["flash_fwd_int8_pv"] = FAST_PV_LAUNCHES
    check(launches == want, f"fast launches {launches}, want {want}")
    decode_steps = lm.video_frames_to_code_len(cfg.llm,
                                               fllm.sample_cfg.num_frames)
    log(json.dumps({
        "phase": "fast", "steps": FAST_STEPS, "first_request": True,
        "env": {"LANDIFF_FAST": "2", "LANDIFF_ATTN_INT8_PV": "1"},
        "build_seconds": build_s, "stage1_s": res["stage1_s"],
        "stage2_s": res["stage2_s"],
        "whole_video_s": res["stage1_s"] + res["stage2_s"],
        "stage1_phase_seconds": fllm.phase_seconds,
        "decode_steps_per_s": decode_steps / fllm.phase_seconds["sample"],
        "stage2_phase_seconds": fdif.phase_seconds,
        "model_calls_by_rows": rows, "launches": launches,
        "model_call_s_median_by_rows": {
            r: float(np.median(v)) for r, v in call_s.items() if v},
        "video_mean": float(res["video"].mean()),
        "video_std": float(res["video"].std()),
        "codes_head": res["codes"][:8].tolist(),
        "peak_gpu_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    return launches


def profiled(fn, what):
    """Run fn() once under torch.profiler (after the caller warmed it):
    device time by kernel class (kernel_kind), the device's busy share of
    the wall time, and the twelve largest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        log(json.dumps({"phase": "profile", "what": what, "wall_ms": wall_ms,
                        "device_ms": "not measured"}))
        return
    by_kind = {}
    for e in kernels:
        k = kernel_kind(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + e.self_device_time_total / 1e3
    device_ms = sum(by_kind.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    log(json.dumps({
        "phase": "profile", "what": what, "wall_ms": wall_ms,
        "device_ms": device_ms, "busy_share": device_ms / wall_ms,
        "kernel_launches": sum(e.count for e in kernels),
        "by_kind_ms": by_kind,
        "top": [{"kernel": e.key[:90], "ms": e.self_device_time_total / 1e3,
                 "calls": e.count} for e in top]}))


def device_kernels(fn):
    """The device kernels of one fn() call (after the caller warmed it),
    by torch.profiler: [{"kernel": name, "ms": device time}], or "not
    measured" where the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    found = [{"kernel": e.key[:300], "ms": e.self_device_time_total / 1e3}
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0]
    return found or "not measured"


def kernel_kind(name):
    low = name.lower()
    if "flash_fwd_kernel" in low:
        return "flash_attention"
    if "adaln_kernel" in low:
        return "adaln"
    if any(t in low for t in ("gemm", "gemv", "xmma", "cutlass", "sm90_",
                              "nvjet")):
        return "gemm"
    if "conv" in low:
        return "conv"
    return "elementwise_norm_other"


def phase_profile_decode(cfg, llm, n_steps=20):
    """n_steps warm stage-1 decode steps (CFG rows 2, the cache of a
    13-frame video) under torch.profiler: how much of a step's wall time
    the card is busy."""
    import torch

    from landiff_tpu_torch.models import gpt
    from landiff_tpu_torch.ops.rope import rope_1d_table

    c = cfg.llm
    params = llm.params["lm"]["gpt"]
    prefix, full = 47, 47 + 1244
    g = torch.Generator(device="cuda").manual_seed(10)
    cos, sin = (torch.from_numpy(t[:full]).cuda()
                for t in rope_1d_table(c.rope))
    feats = torch.randn((2, prefix, c.hidden_size), generator=g,
                        device="cuda").bfloat16()
    feat = torch.randn((2, 1, c.hidden_size), generator=g,
                       device="cuda").bfloat16()
    positions = torch.arange(full, device="cuda")
    with torch.inference_mode():
        cache = gpt.KVCache.create(c, 2, full, torch.bfloat16, "cuda")
        _, cache = gpt.prefill(params, feats, cache, c, cos[:prefix],
                               sin[:prefix])

        def steps(start):
            for i in range(start, start + n_steps):
                gpt.decode_step(params, feat, cache, positions[i:i + 1], c,
                                cos[i:i + 1], sin[i:i + 1])

        steps(prefix)
        profiled(lambda: steps(prefix + n_steps),
                 f"{n_steps} stage-1 decode steps, 2 rows, cache {full}")


def phase_profile(cfg, params, fused):
    """One warm denoise-step model call (control_warp_forward, CFG batch
    2, the default int8 path) under torch.profiler, without or with
    LANDIFF_FUSED_ADALN."""
    import torch

    from landiff_tpu_torch.models import dit

    d = cfg.dit
    g = torch.Generator(device="cuda").manual_seed(8)
    shape = (2, d.latent_frames, d.in_channels, d.latent_height,
             d.latent_width)
    x = torch.randn(shape, generator=g, device="cuda").bfloat16()
    sem = torch.randn(shape, generator=g, device="cuda").bfloat16()
    ctx = torch.randn((2, d.text_length, d.text_dim), generator=g,
                      device="cuda")
    ts = torch.tensor([500.0, 500.0], device="cuda")
    fwd = lambda: dit.control_warp_forward(params["main"], params["control"],
                                           x, ts, ctx, d, sem)
    if fused:
        os.environ["LANDIFF_FUSED_ADALN"] = "1"
    try:
        with torch.inference_mode():
            fwd()
            profiled(fwd, "one control_warp_forward, CFG batch 2, "
                     f"LANDIFF_FUSED_ADALN {'1' if fused else 'unset'}")
    finally:
        os.environ.pop("LANDIFF_FUSED_ADALN", None)


# ---------------------------------------------------------------------------
# phases 9-10: the trainer at full width


# per optimizer step of the stage-2 trainer (batch 1, remat): 15 control
# layers and main layers 1-29 are differentiated (main layer 0 sees no
# input that depends on the control branch): one exact forward, its
# recompute and one backward each; main layer 0 and the 12 TiTok decoder
# layers of the semantic conditioner take the int8 forward
# launches per stage-2 training step (44 differentiated layers, remat: two
# exact forwards each; main layer 0 and the TiTok decoder's 12 layers
# without grad, which in bf16 take the int8 route, in f32 the int8 route
# at the DiT shape and the exact one at the TiTok shape, whose K/V miss
# the "cached" budget at 4 bytes)
TRAIN_DIT_LAUNCHES = {
    "bf16": {"flash_bwd": 44, "flash_fwd_exact": 88, "flash_fwd_int8": 13,
             "adaln": 0},
    "f32": {"flash_bwd_f32": 44, "flash_fwd_exact_f32": 88 + 12,
            "flash_fwd_int8_f32": 1, "adaln": 0}}


def step_seconds(rows):
    """Seconds of each logged step from the cumulative means the trainer
    logs (sec_per_step = elapsed / steps so far, log_every=1)."""
    total = [r["sec_per_step"] * (i + 1) for i, r in enumerate(rows)]
    return [b - a for a, b in zip([0.0] + total, total)]


def leaf_sums(tree):
    """A (sum, sum of |x|) pair per leaf in f64: equal pairs before and
    after mean the tree was not touched."""
    import torch

    from landiff_tpu_torch.utils import tree_leaves

    sums = torch.stack([torch.stack((t.double().sum(), t.double().abs().sum()))
                        for t in tree_leaves(tree)])
    return sums.cpu()


def phase_train_dit(workdir, dtype_name="bf16", steps=3):
    """training.train.train("dit") at full width, batch 1, in bf16 (the
    trainer's --bf16) or f32 (its default): `steps` steps and a
    checkpoint, then a resumed one more. The parameter inits are wrapped
    so that the zero-init leaves are filled (as for the inference phases)
    and the trees can be inspected afterwards; the gradient function is
    wrapped to inspect every step's gradients. In bf16 then one step by
    hand for the forward / backward / optimizer split, and the
    LANDIFF_REMAT_SAVE_ATTN comparison (phase_remat_save_attn)."""
    import torch

    from landiff_tpu_torch.config import LanDiffConfig
    from landiff_tpu_torch.models import dit as dit_lib
    from landiff_tpu_torch.models import semantic_cond as sc_lib
    from landiff_tpu_torch.training import diffusion_loss, optim
    from landiff_tpu_torch.training import train as train_lib
    from landiff_tpu_torch.utils import (count_params, fill_zero_leaves,
                                         tree_leaves)

    cfg = LanDiffConfig()
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype_name]
    launches_per_step = TRAIN_DIT_LAUNCHES[dtype_name]
    data = workdir / f"dit_data_{dtype_name}"
    ckpt = workdir / f"dit_ckpt_{dtype_name}"
    metrics = workdir / f"dit_metrics_{dtype_name}.jsonl"
    train_lib.synthesize("dit", cfg, 4, str(data), seed=0, shard_size=4)

    made, grad_reports = {}, []
    orig_dit_init, orig_sc_init = dit_lib.init, sc_lib.init
    orig_grad = optim.grad

    def dit_init(gen, c, *, control=False, dtype=torch.float32):
        tree = fill_zero_leaves(
            orig_dit_init(gen, c, control=control, dtype=dtype), gen)
        made["control" if control else "main"] = tree
        return tree

    def sc_init(gen, *a, **kw):
        made["sem"] = fill_zero_leaves(orig_sc_init(gen, *a, **kw), gen)
        return made["sem"]

    def grad(loss, params):
        grads = orig_grad(loss, params)
        leaves = tree_leaves(grads)
        finite = torch.stack([torch.isfinite(g).all() for g in leaves])
        nonzero = torch.stack([g.any() for g in leaves])
        grad_reports.append({
            "leaves": len(leaves), "finite": int(finite.sum()),
            "not_all_zero": int(nonzero.sum()),
            "global_norm": float(optim.global_norm(grads))})
        return grads

    dit_lib.init, sc_lib.init, optim.grad = dit_init, sc_init, grad
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, last = train_lib.train(
            "dit", str(data), steps=steps, batch_size=1, dtype=dtype,
            ckpt_dir=str(ckpt), log_every=1, metrics_path=str(metrics),
            device="cuda")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        first_launches = read_counts()
        first = dict(made)
        before = {k: leaf_sums(first[k]) for k in ("main", "sem")}
        rows = [json.loads(l) for l in metrics.read_text().splitlines()]

        reset_counts()
        t0 = time.perf_counter()
        state2, last2 = train_lib.train(
            "dit", str(data), steps=steps + 1, batch_size=1, dtype=dtype,
            ckpt_dir=str(ckpt), log_every=1, metrics_path=str(metrics),
            resume=True, device="cuda")
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        resumed_launches = read_counts()
    finally:
        dit_lib.init, sc_lib.init, optim.grad = (orig_dit_init, orig_sc_init,
                                                 orig_grad)
    all_rows = [json.loads(l) for l in metrics.read_text().splitlines()]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check([r["step"] for r in all_rows] == list(range(1, steps + 2)),
          f"logged steps {[r['step'] for r in all_rows]}")
    check(all(np.isfinite(r["loss"]) for r in all_rows),
          f"losses {[r['loss'] for r in all_rows]}")
    check(len(grad_reports) == steps + 1,
          f"{len(grad_reports)} gradient passes")
    for i, rep in enumerate(grad_reports):
        check(rep["finite"] == rep["leaves"],
              f"step {i + 1}: a control gradient is not finite: {rep}")
        # final_ln_w / final_ln_b of the control tree are read by no
        # control forward (it has no final head), in JAX as here
        check(rep["not_all_zero"] == rep["leaves"] - 2,
              f"step {i + 1}: a control gradient is all zero: {rep}")
    for got, n in ((first_launches, steps), (resumed_launches, 1)):
        want = {k: launches_per_step.get(k, 0) * n for k in got}
        check(got == want, f"launches over {n} steps {got}, want {want}")
    # the frozen trees were not touched by the first steps
    for k in ("main", "sem"):
        check(torch.equal(leaf_sums(first[k]), before[k]),
              f"the {k} parameters changed")
    # the control branch moved (the first update has rate 0, the second not)
    ctrl0, ctrl3 = tree_leaves(first["control"]), tree_leaves(state[0])
    changed = [not torch.equal(a, b) for a, b in zip(ctrl0, ctrl3)]
    matrices = [c for c, a in zip(changed, ctrl0) if a.dim() >= 2]
    check(all(matrices), "a control matrix did not change in the steps")
    ctrl4 = tree_leaves(state2[0])
    check(any(not torch.equal(a, b) for a, b in zip(ctrl3, ctrl4)),
          "the resumed step changed nothing")
    check(all(bool(torch.isfinite(t.float()).all()) for t in ctrl4),
          "a control parameter is not finite after four steps")

    log(json.dumps({
        "phase": "train_dit" if dtype_name == "bf16" else "train_f32",
        "dtype": dtype_name, "batch_size": 1,
        "params": {k: count_params(first[k]) for k in first},
        "losses": [r["loss"] for r in all_rows],
        "step_seconds": step_seconds(rows),
        "resumed_step_seconds": all_rows[-1]["sec_per_step"],
        "train_call_seconds": [first_s, resumed_s],
        "gradients": grad_reports,
        "control_leaves_changed": [sum(changed), len(changed)],
        "launches_per_step": launches_per_step,
        "launches": {"first_steps": first_launches,
                     "resumed_step": resumed_launches},
        "peak_gpu_mem_gb": peak_gb}))
    if dtype_name != "bf16":
        return first_launches

    # one more step by hand for the split: forward, backward (with the
    # recompute of 44 layers), optimizer update
    made2 = dict(made)     # the resumed call's frozen trees
    del first, before, state, ctrl0, ctrl3
    d = cfg.dit
    g = torch.Generator(device="cuda").manual_seed(31)
    lat = torch.randn((1, d.latent_frames, d.in_channels, d.latent_height,
                       d.latent_width), generator=g, device="cuda")
    ctx = torch.randn((1, d.text_length, d.text_dim), generator=g,
                      device="cuda")
    tokens = torch.randint(0, cfg.tokenizer.vq.codebook_size,
                           (1, cfg.tokenizer.titok.latent_tokens),
                           generator=g, device="cuda")
    opt = train_lib.make_optimizer(1e-4, 4)
    ctrl = optim.require_grad(state2[0])
    opt_state = state2[1]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    loss = diffusion_loss.video_diffusion_loss(
        made2["main"], ctrl, made2["sem"], lat, ctx, tokens, g, d,
        cfg.sampler, cfg.tokenizer, cfg.semantic_cond,
        compute_dtype=torch.bfloat16, remat=True)
    ev[1].record()
    grads = orig_grad(loss, ctrl)
    ev[2].record()
    updates, opt_state = opt.update(grads, opt_state, ctrl)
    optim.apply_updates(ctrl, updates)
    ev[3].record()
    torch.cuda.synchronize()
    log(json.dumps({
        "phase": "train_dit_split", "what": "one step by hand, batch 1",
        "forward_ms": ev[0].elapsed_time(ev[1]),
        "backward_with_recompute_ms": ev[1].elapsed_time(ev[2]),
        "optimizer_ms": ev[2].elapsed_time(ev[3]),
        "loss": float(loss.detach())}))
    del loss, grads, updates
    phase_remat_save_attn(cfg, made2["main"], state2[0], made2["sem"], lat,
                          ctx, tokens, orig_grad)
    return first_launches


def phase_remat_save_attn(cfg, main, control, sem, lat, ctx, tokens, grad):
    """One bf16 stage-2 step by hand (the same inputs and draws) without
    LANDIFF_REMAT_SAVE_ATTN, again without it, then with it: the exact
    forwards per step (88 -> 44), seconds and peak memory of each; the
    loss must be equal, the gradients equal within the spread of two runs
    without the knob (dq's reduce-adds in no fixed order move the last
    bits of every gradient upstream of q), bounded."""
    import torch

    from landiff_tpu_torch.training import diffusion_loss, optim
    from landiff_tpu_torch.utils import tree_leaves

    def step(save_attn):
        with knobs(LANDIFF_REMAT_SAVE_ATTN="1" if save_attn else None):
            ctrl = optim.require_grad(control)
            g = torch.Generator(device="cuda").manual_seed(37)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            loss = diffusion_loss.video_diffusion_loss(
                main, ctrl, sem, lat, ctx, tokens, g, cfg.dit, cfg.sampler,
                cfg.tokenizer, cfg.semantic_cond,
                compute_dtype=torch.bfloat16, remat=True)
            grads = grad(loss, ctrl)
            torch.cuda.synchronize()
            return {"loss": float(loss.detach()),
                    "seconds": time.perf_counter() - t0,
                    "peak_gpu_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": read_counts()}, tree_leaves(grads)

    def diff(a, b):
        """||a - b|| / ||b|| over all control leaves together (a leaf whose
        gradient is 0 but for rounding, such as k_ln_b's, has no relative
        size of its own)."""
        num = sum((x.double() - y.double()).square().sum() for x, y in
                  zip(a, b))
        den = sum(y.double().square().sum() for y in b)
        return float((num / den).sqrt())

    step(True)                      # warm both routes once
    plain, g_plain = step(False)
    again, g_again = step(False)
    saved, g_saved = step(True)
    spread, moved = diff(g_again, g_plain), diff(g_saved, g_plain)
    bit_equal = all(torch.equal(a, b) for a, b in zip(g_saved, g_plain))
    check(plain["launches"]["flash_fwd_exact"] == 88
          and saved["launches"]["flash_fwd_exact"] == 44,
          f"exact forwards per step {plain['launches']} / "
          f"{saved['launches']}")
    check(saved["launches"]["flash_bwd"] == 44, "backward launches")
    check(saved["loss"] == plain["loss"], "the loss moved with the knob")
    # bound: ten times the two plain runs' own spread, and 1e-2 (bf16 ds)
    check(moved <= max(10 * spread, 1e-6) and moved <= 1e-2,
          f"gradients moved by {moved} with the knob (spread {spread})")
    log(json.dumps({"phase": "remat_save_attn", "without": plain,
                    "without_again": again, "with": saved,
                    "grad_max_rel_diff_with_vs_without": moved,
                    "grad_max_rel_diff_two_runs_without": spread,
                    "grads_bit_equal": bit_equal,
                    "residual_gb": saved["peak_gpu_mem_gb"]
                    - plain["peak_gpu_mem_gb"]}))


def phase_train_lm(workdir):
    """training.train.train("lm") at full width (GPT 24 x 2,048, f32, the
    trainer's default), two steps, batch 1: the dense attention route, no
    flash launch."""
    import torch

    from landiff_tpu_torch.config import LanDiffConfig
    from landiff_tpu_torch.models import lm as lm_lib
    from landiff_tpu_torch.training import train as train_lib
    from landiff_tpu_torch.utils import count_params, tree_leaves

    cfg = LanDiffConfig()
    data, metrics = workdir / "lm_data", workdir / "lm_metrics.jsonl"
    train_lib.synthesize("lm", cfg, 2, str(data), seed=0, shard_size=2)
    made = {}
    orig_init = lm_lib.init

    def lm_init(gen, *a, **kw):
        made["lm"] = orig_init(gen, *a, **kw)
        return made["lm"]

    lm_lib.init = lm_init
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, last = train_lib.train(
            "lm", str(data), steps=2, batch_size=1, log_every=1,
            metrics_path=str(metrics), device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        lm_lib.init = orig_init
    launches = read_counts()
    rows = [json.loads(l) for l in metrics.read_text().splitlines()]
    check([r["step"] for r in rows] == [1, 2], f"logged steps {rows}")
    check(all(np.isfinite(r["loss"]) for r in rows), f"losses {rows}")
    check(not any(launches.values()),
          f"a kernel launched on the stage-1 step: {launches}")
    before, after = tree_leaves(made["lm"]), tree_leaves(state[0])
    changed = [not torch.equal(a, b) for a, b in zip(before, after)]
    # every GPT matrix and the token embedding moved in the second update
    # (the first has rate 0); the micro conditioner's first linear sits
    # behind a zero-init output linear and gets no gradient yet
    moved = [not torch.equal(a, b) for a, b in zip(
        tree_leaves(made["lm"]["gpt"]) + [made["lm"]["tok_emb"]],
        tree_leaves(state[0]["gpt"]) + [state[0]["tok_emb"]]) if a.dim() >= 2]
    check(all(moved), "a GPT matrix did not change in two steps")
    check(all(bool(torch.isfinite(t).all()) for t in after),
          "an LM parameter is not finite after two steps")
    sched = train_lib._lm_schedule(cfg)
    log(json.dumps({
        "phase": "train_lm", "dtype": "f32", "batch_size": 1,
        "sequence": sched.full_len, "params": count_params(made["lm"]),
        "losses": [r["loss"] for r in rows],
        "step_seconds": step_seconds(rows), "train_call_seconds": seconds,
        "leaves_changed": [sum(changed), len(changed)],
        "launches": launches,
        "peak_gpu_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))


# ---------------------------------------------------------------------------


def bwd_entry(bwd, launches):
    """The flash backward's entry of the kernels line: its numbers at the
    training shape, the TiTok case, and ptxas's report of the main kernel
    with its shared memory per CTA."""
    from landiff_tpu_torch.ops import kernels

    ptxas = {"unmasked_or_causal": kernels.ptxas_report(
                 "flash_bwd", "flash_bwd_kernelILb0"),
             "video_mask": kernels.ptxas_report(
                 "flash_bwd", "flash_bwd_kernelILb1"),
             "smem_bytes": kernels.flash_bwd_library()
             .landiff_flash_bwd_smem_bytes()}
    return {
        "name": "flash_bwd", "route": "cuda",
        "source": "landiff_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": "landiff_tpu/ops/attention.py:658 "
                    "_flash_bwd_fused_kernel",
        "launches": launches,
        "max_abs_err": bwd["max_abs_err"], "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"], "library_ms": bwd["library_ms"],
        "tflops": bwd["tflops"], "prep_ms": bwd["prep_ms"], "ptxas": ptxas,
        "shape": bwd["shape"], "errors": bwd["errors"],
        "run_to_run": bwd["run_to_run"], "titok_dec": bwd["titok_dec"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4,
                    help="denoise steps per request (the release uses 50)")
    ap.add_argument("--only", choices=("flash_fwd", "flash_bwd", "f32",
                                       "stage1_batch", "long_video", "ckpt",
                                       "train"),
                    help="build, then only this kernel's cases at the "
                         "main-path shapes, or only the batched decoding "
                         "check at full width (no pipeline, no last "
                         "line)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one denoise-step model call, without "
                         "and with the adaLN knob, and 20 decode steps")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run "
                         "needs an NVIDIA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from landiff_tpu_torch.ops import kernels

    t_start = time.perf_counter()
    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(json.dumps({
        "phase": "device", "name": torch.cuda.get_device_name(0),
        "capability": list(torch.cuda.get_device_capability(0)),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "nvidia_smi": smi[0],
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}))

    # 2. build
    t0 = time.perf_counter()
    libs = kernels.build()
    report = {name: [line.strip() for line in
                     lib.with_suffix(".log").read_text().splitlines()
                     if "registers" in line or "spill" in line]
              for name, lib in libs.items()}
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                    "libraries": {k: v.name for k, v in libs.items()},
                    "ptxas": report}))

    if args.only == "flash_fwd":
        check_fwd_ptxas()
        phase_fwd_kernels(titok_decoder_mask(), exp2_rates())
        phase_drift()
        return
    if args.only == "f32":
        phase_f32(titok_decoder_mask(), exp2_rates())
        phase_direct_f32()
        return
    if args.only == "long_video":
        cfg, llm, dif = build_full(args.steps)
        phase_long_video(cfg, llm, dif, args.steps)
        return
    if args.only in ("ckpt", "train"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            if args.only == "ckpt":
                phase_ckpt(Path(tmp), args.steps)
            else:
                phase_train_dit(Path(tmp))
                phase_train_dit(Path(tmp), "f32", steps=2)
        return
    if args.only == "stage1_batch":
        phase_stage1_batch()
        return
    if args.only == "flash_bwd":
        bwd = phase_bwd_kernel(titok_decoder_mask(), exp2_rates()[False])
        log(json.dumps({"flash_bwd": bwd_entry(bwd, None)}))
        return
    # 3. kernels
    fwd_reports = check_fwd_ptxas()
    measured = phase_kernels()
    dec_mask = measured.pop("dec_mask")
    direct_launches = phase_direct(dec_mask)
    adaln = phase_adaln()
    # 3b. the drift gates; 3c. the f32 kernels
    drift = phase_drift()
    f32 = phase_f32(dec_mask, measured.pop("rates"))
    f32_direct_launches = phase_direct_f32()
    # 4. the pipeline; 5. prompt -> codes -> video; 6. stage 2 alone
    cfg, llm, dif = build_full(args.steps)
    video_launches = phase_video(cfg, llm, dif, args.steps)
    phase_batch_f32()
    stage2_launches = phase_stage2(cfg, dif, args.steps)
    # 7. exact path; 8. one model call with and without the knob
    exact_launches = phase_exact(cfg, dif.params)
    phase_dit_call(cfg, dif.params)
    if args.profile:
        phase_profile(cfg, dif.params, fused=False)
        phase_profile(cfg, dif.params, fused=True)
        phase_profile_decode(cfg, llm)
    # 8b. the fast serving configuration; 8c. a two-segment video
    fast_launches = phase_fast(cfg, llm, dif)
    phase_long_video(cfg, llm, dif, args.steps)
    del llm, dif
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 8d. a synthetic checkpoint tree through build_pipeline, in f32
        ckpt_launches = phase_ckpt(Path(tmp), args.steps)
        # 9. the stage-2 trainer in bf16 (and LANDIFF_REMAT_SAVE_ATTN),
        # 9b. in f32; 10. the stage-1 trainer
        train_launches = phase_train_dit(Path(tmp))
        gc.collect()
        torch.cuda.empty_cache()
        f32_train_launches = phase_train_dit(Path(tmp), "f32", steps=2)
        gc.collect()
        torch.cuda.empty_cache()
        phase_train_lm(Path(tmp))

    # launches of each forward variant on its path: the exact kernel on the
    # int8-off DiT call, the int8 kernel on prompt -> video, int8_pv on the
    # fast configuration, the exp_bf16 variants on the direct entry
    path_launches = {**direct_launches,
                     "flash_fwd_exact": exact_launches,
                     "flash_fwd_int8": video_launches["flash_fwd_int8"],
                     "flash_fwd_int8_pv": fast_launches["flash_fwd_int8_pv"]}
    rows = []
    for int8, int8_pv, exp_bf16 in FWD_VARIANTS:
        from landiff_tpu_torch.ops.attention import variant_name

        kname = variant_name(int8, int8_pv, exp_bf16)
        dit, titok = measured[kname]
        launches = path_launches[kname]
        check(launches > 0, f"{kname} never launched on its path")
        replaces = REPLACES_FWD[int8] + (
            ", int8_pv :338-348" if int8_pv else "") + (
            ", exp_bf16 _softmax_tile :37-57" if exp_bf16 else "")
        rows.append({
            "name": kname, "route": "cuda",
            "source": "landiff_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": dit["max_abs_err"], "ms": dit["ms"],
            "plain_ms": dit["plain_ms"], "bound_ms": dit["bound_ms"],
            "bound_by": dit["bound_by"], "library_ms": dit["library_ms"],
            "bound_unit": dit["bound_unit"], "tflops": dit["tflops"],
            "ptxas": fwd_reports[kname], "shape": dit["shape"],
            "titok_dec": titok})
        gate = "int8_pv" if int8_pv else "int8"
        if int8 and not exp_bf16:
            rows[-1]["drift"] = {k: drift[gate][k] for k in (
                "corr", "rel", "share_of_attention", "limits")}
    rows[1]["launches_stage2_alone"] = stage2_launches["flash_fwd_int8"]
    check(video_launches["adaln"] > 0, "adaln never launched on its path")
    rows.append({
        "name": "adaln", "route": "cuda",
        "source": "landiff_tpu_torch/ops/csrc/adaln.cu",
        "replaces": "landiff_tpu/ops/adaln.py:33 _kernel",
        "launches": video_launches["adaln"],
        "max_abs_err": adaln["max_abs_err"], "ms": adaln["ms"],
        "plain_ms": adaln["plain_ms"], "bound_ms": adaln["bound_ms"],
        "bound_by": adaln["bound_by"], "library_ms": None,
        "unfused_ms": adaln["unfused_ms"], "shape": adaln["shape"],
        "max_bf16_steps": adaln["max_bf16_steps"],
        "ragged": adaln["ragged"], "f32": adaln["f32"]})
    check(train_launches["flash_bwd"] > 0,
          "flash_bwd never launched on the training path")
    rows.append(bwd_entry(measured["flash_bwd"], train_launches["flash_bwd"]))
    rows[0]["launches_train_dit"] = train_launches["flash_fwd_exact"]
    # the f32 forms: the exact forward and the backward on the f32 trainer's
    # steps, the int8 forward on the f32 request from the checkpoint tree
    f32_launches = {
        "flash_fwd_exact_f32": f32_train_launches["flash_fwd_exact_f32"],
        "flash_fwd_int8_f32": ckpt_launches["flash_fwd_int8_f32"],
        "flash_bwd_f32": f32_train_launches["flash_bwd_f32"]}
    # the f32 variants on the dispatcher (int8_pv) and the direct entry
    for name in ("flash_fwd_exact_exp_bf16_f32", "flash_fwd_int8_pv_f32",
                 "flash_fwd_int8_pv_exp_bf16_f32",
                 "flash_fwd_int8_exp_bf16_f32"):
        f32_launches[name] = f32_direct_launches[name]
    for name, n in f32_launches.items():
        check(n > 0, f"{name} never launched on its path")
        dit, titok = f32[name]
        rows.append(f32_entry(name, dit, titok, n, f32["ptxas"]))
        if name == "flash_fwd_int8_f32":
            rows[-1]["launches_train_f32"] = \
                f32_train_launches["flash_fwd_int8_f32"]
    log(json.dumps({"phase": "done",
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
