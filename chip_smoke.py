#!/usr/bin/env python3
"""Drive the PyTorch port (landiff_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # 2 denoise steps per request
    python3 chip_smoke.py --steps 50   # the released sampler's 50 steps
    python3 chip_smoke.py --only flash_bwd   # build, then that kernel's
                                             # cases alone (flash_fwd:
                                             # with the drift gates;
                                             # flash_bwd; no last line)
    python3 chip_smoke.py --only stage1_batch  # batched decoding against
                                               # single calls at full
                                               # width, bf16 and f32
    python3 chip_smoke.py --only f32 | ckpt | long_video | train
                                       # one of the phases 3c (with 8e),
                                       # 8d, 8c, 9 (with 9a, 9b)
    python3 chip_smoke.py --only tokenizer   # 3d, 8f, 8g, 11, 12, then
                                             # the pipeline for 6b
    python3 chip_smoke.py --only variants    # the pipeline, then 5b and
                                             # 5c (seeded codes)
    python3 chip_smoke.py --only serving     # the pipeline, then 8h
    python3 chip_smoke.py --only tp          # the pipeline, then 8i
    python3 chip_smoke.py --only sp          # 8j (builds what it needs)
    python3 chip_smoke.py --only train_mesh  # 13 (builds what it needs)
    python3 chip_smoke.py --only multihost   # 14 (builds what it needs)
    python3 chip_smoke.py --only qkv_prep    # build, then the DiT's qkv
                                             # preparation kernel alone

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
              and with f32 I/O, with its time beside the unfused chain's;
              the DiT's qkv preparation kernel against its plain version
              at the 2b (sincos3d) and 5b (rotary3d) DiT shapes in bf16,
              and at 5b in f32, timed beside its byte bound, the plain
              version and the chain it replaces.
  3b. drift:  the compound-drift gates of the quantized DiT paths
              (diffusion/drift.py: three chained steps of the JAX gates'
              mid configuration, S = 776) in bf16 through the kernels: int8
              scores and int8_pv against the exact forward, W8A8 against
              the bf16 weights, at JAX's thresholds and, for attention,
              under 5 % of attention's own contribution; each quantized run
              launches only its variant, 9 times.
  3c. f32:    the f32 kernels (csrc/flash_f32.cu: the 3xTF32 exact
              forward and backward with their split prologues, the
              int8-score forward with int8 scores and 3xTF32 or int8 p.v,
              and the int8_pv / exp_bf16 variants) against their plain
              versions in float64 (attention.f64_reference; the int8
              forms attention.int8_f64_reference, on four seeds a shape,
              their scores bit-equal to the plain version's; limits
              attention.F32_TOL, attention.f32_variant_limits; the
              prologues bit for bit) at the training shape (B=1 S=17,776
              H=30) and the TiTok decoder shape, timed beside SDPA in f32
              (and its own error) with the bounds of both designs (the
              CUDA cores' f32 rate, the tensor cores: three TF32 passes,
              int8); ptxas's registers, spills and serialized wgmma (none
              allowed); then the f32 variants on their paths (the
              dispatcher under LANDIFF_ATTN_INT8_PV=1, flash_attention
              under the exp_bf16 knobs), one launch each.
  3d. encoder mask: the flash kernels of the tokenizer's paths under the
              video-encoder mask at the full TiTok layout (B=1 S=18,768
              H=12): the bf16 exact and int8 forwards and the bf16
              backward against their plain versions (phase 3's limits),
              the f32 exact and int8 forwards and the f32 backward against
              the float64 references on four seeds each (attention.
              F32_TOL), each timed beside its bound at this shape.
  4. build the pipeline: infer_video.build_pipeline at the full width of
              LanDiffConfig() (random weights from a seed, zero leaves
              filled, depth not cut), both stages on the card.
  5. video:   the prompt -> codes -> video path (infer_video.generate)
              with LANDIFF_FUSED_ADALN=1 for two prompts: 1,218 valid
              codes, the video's shape and range, 90 * steps adaLN
              launches, 45 * steps qkv preparation launches and 12 + 45
              * steps int8 launches per request;
              then stage 1 alone (one semantic frame, the first GPT_CUT
              GPT blocks): a repeated (prompt, seed) gives the
              same codes, another seed others; one infer_batch of both
              prompts
              gives valid codes (its agreement with the single calls in
              bf16 is printed), and at the tiny config in f32 it gives
              exactly the codes of the single calls.
  5b. rotary3d: one full-width model call (CFG batch 2, int8 scores)
              under pos_embed="rotary3d", one with rot_v, and the sincos
              call of the same inputs, timed in turns, then a rotary3d call
              with LANDIFF_FUSED_ADALN=1: outputs finite and far from the
              sincos one, 45 int8 launches a call (and 90 adaLN with the
              knob), nothing else.
  5c. samplers: stage 2 through the wrapper at --steps from the first
              request's codes with vpode_dpmpp2m and with video_ddim: the
              video's shape, range, finiteness, 12 + 45 * steps int8
              launches, phase seconds; then each k-sampler over (1, 13,
              16, 60, 90) on the card with a closed-form denoiser and
              seeded draws, within 1e-5 of the same call on the CPU
              (relative RMS; element by element, of the largest state).
  6. stage2:  one warm request through the stage-2 wrapper alone (prompt +
              seed + 1,218 codes -> (1, 3, 49, 480, 720) video) with the
              adaLN knob unset; the int8 kernel must launch 12 + 45 *
              steps times, the adaLN kernel never.
  6b. prefix video: image to video, a 1-frame 480 x 720 prefix VAE-encoded
              and held over the first latent frame at the stage2 phase's
              step count: the video's shape, range, finiteness, the held
              frame equal to the prefix's own encoding, 12 + 45 * steps
              int8 launches.
  7. exact:   one full-width control_warp_forward with int8 scores off;
              the exact kernel must launch 45 times.
  8. dit call: one warm model call timed with and without the knob.
  8b. fast:   the fast serving configuration (LANDIFF_FAST=2 with
              LANDIFF_ATTN_INT8_PV=1, set for this phase only): wrappers
              built from the resident parameters (W8A8 main and control
              DiTs, int8 GPT block linears), one prompt -> codes -> video
              at FAST_STEPS (26, not the release's 50), stage 1 on the
              first GPT_CUT (6) GPT blocks: 1,218 valid codes, the
              video's shape and range, the model calls the sampler's reuse
              and window schedules give (16: 14 with two rows, 2 with
              one), 45 per call + 12 int8_pv launches and no other
              forward.
  8c. long video: a two-segment request (num_frames 26) through
              infer_video.generate, stage 1 on the first GPT_CUT (6) GPT
              blocks: 2 x 1,218 codes, 19 latent frames, 73
              frames at 480 x 720, finite, in [0, 1]; seconds per phase and
              per segment; 2 * (12 + 45 * steps) int8 launches.
  8h. serving: the serving engine (serving/scheduler.py) over the
              resident wrappers, no rebuild, stage 1 on the first GPT_CUT
              GPT blocks (its one-request reading too), behind
              serving/app.py's handler on a ThreadingHTTPServer at
              127.0.0.1:0: three
              concurrent POST /generate with different prompts: one
              stage-1 batch of 3 (/stats), HTTP 200 with a 49-frame
              720 x 480 GIF each, 1,218 valid codes and a video as in 5
              per request, 12 + 45 * steps int8 launches per request and
              no other forward; each request's stage 2 equal, bit for
              bit, to a direct call of the stage-2 wrapper on its codes
              and seed, with memory_allocated steady between requests;
              with LANDIFF_OFFLOAD=1 two calls on the first request's
              codes: at least 95 % of the moved trees' bytes freed, both
              videos equal to the call without the knob, the offload's
              and restage's seconds and the decode's peak with and
              without the knob; one request's DiT model call under
              observability.trace and named_scope("serving_request"):
              the Chrome trace holds the scope and the int8 flash
              kernel's 45 device events. Seconds (stage 1 of the batch
              against phase 5's warm request, stage 2, end to end) and
              peak memory beside nvidia-smi's line.
  8i. tp:     tensor-parallel inference with the ranks as processes
              sharing the card (device exchange buffers, gloo barriers:
              times are readings of that layout, not speed): model=2 at full
              width (15 heads a rank) built from the resident trees after
              they go to host memory: one model call against the
              unsharded one (corr > 0.999, mean relative drift < 0.03),
              45 int8 launches and 90 all-reduces a rank, each rank's
              parameter bytes equal to parallel.plan's; one whole request
              at 2 denoise steps (1,218 codes equal on every rank, a
              video as in 5, 102 int8 launches a rank; its first code
              apart from phase 5's first request printed); model=4 at 2 +
              1 layers, heads padded to 32, bf16 and W8A8 calls against
              the unsharded ones; the int8 forward at 15 heads and at 8
              with 2 padded ones against its plain version, the padded
              heads exactly 0 (phase_tp).
  8j. sp:     sequence / context-parallel inference, ranks sharing the
              card as in 8i: data=1,time=2 ring attention at the DiT
              shape in the exact, int8 and f32 int8 forms against the
              ring of their plain versions and against one kernel call;
              the context-parallel VAE decode of 13 latents at full width
              against the whole decode (and, read only, the streaming
              one), peak per rank; wrappers at full width on the mesh
              (stage 1 unsharded in rank 0 on GPT_CUT blocks): one model
              call against the unsharded one (90 int8 launches and 90
              ring shifts a rank), one request at --steps through
              infer_video.generate (LANDIFF_OFFLOAD=1) decoded
              context-parallel; then
              model=2,time=2 at 2 + 1 layers in bf16 and W8A8 (phase_sp).
  8f. tokenize: the pipelines are freed; video -> codes at full width
              (vq.encode_to_index: Theia 12 x 768, TiTok 12 x 768, VQ
              2,048 x 16) on a seeded 13-frame 480 x 720 clip, first and
              warm: 1,218 codes in range, 12 int8 launches (encoder mask)
              and nothing else, then index_to_feature's round trip (12
              more); seconds, peak memory.
  8g. vae encode: engine.encode_first_stage on a seeded 49-frame 480 x
              720 clip, whole and streaming, twice each: (1, 13, 16, 60,
              90) finite latents, seconds and peak memory.
  8e. dit call f32: one full-width f32 DiT model
              call (CFG batch 2, 45 layers, random weights): seconds, and
              45 launches of the f32 int8 forward, nothing else.
  8d. ckpt:   a synthetic checkpoint tree of
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
  9a. train rotary3d: the trainer under pos_embed="rotary3d" (its
              config replaced for the call), bf16, batch 1, two steps:
              losses finite; per step 44 backward, 88 exact and 13 int8
              forward launches; seconds per step.
  9b. train f32: the same trainer in f32 (its default, no --bf16): two
              steps and a resumed third; per step 44 f32 backward, 100 f32
              exact forward (88 + the TiTok decoder's 12) and one f32 int8
              forward launches.
  10. train lm: two steps of the stage-1 step at full width (GPT 24 x
              2,048, f32); losses finite, parameters changed, no flash
              launch.
  11. train vq: train("vq") at full width, batch 1, f32 (its default),
              three steps on synthesized Theia features, the first with
              the k-means codebook init: losses finite, parameters moved,
              per step 24 f32 exact forwards and 24 f32 backward launches
              (the first step 12 more forwards: the k-means pass runs
              the encoder alone), nothing else;
              seconds per step, peak memory.
  12. prepare: data.prepare over two seeded 13-frame 480 x 720 .npy clips
              at full width, --model vq and lm, shards read back through
              data.loader; 24 int8 launches for lm, none for vq.
  13. train_mesh: training on meshes of ranks sharing the card (ROADMAP
              item 15b, its training half): the ring backward at the DiT
              hop shape in bf16 and f32 against one flash_bwd over the
              whole sequence, and at a small shape against the ring of
              plain versions; one data=1,time=2 `train --mesh` step of
              the stage-2 trainer at full width and depth in bf16 against
              the one-device step on the same batch and draws (loss, per
              control leaf correlation and relative error of the
              gradients; per rank the exact forward and backward
              launches twice the one-device step's, shifts, peak memory,
              seconds); data=1,model=2 steps of dit, lm and vq at 2 + 1
              DiT layers, 2 GPT blocks, 2 TiTok layers against one
              device; a data=2 lm step (ZeRO: optimizer bytes per rank
              against zero.opt_state_bytes_per_device) against one
              device.
  14. multihost: the multi-process launch (parallel/multihost.py): two
              processes of this script started as a launcher starts
              them (MASTER_ADDR 127.0.0.1, a free MASTER_PORT, RANK 0 /
              1, WORLD_SIZE 2, LOCAL_RANK 0), both on cuda:0 through gloo,
              each its rank of global_mesh(model=2) with its shard of the
              DiT at full width, 2 + 1 layers: one CFG-batch-2 model call
              each (tp_infer.model_call); the two outputs bit-equal and
              within the tp limits of the unsharded call, 3 int8 launches
              and 6 all-reduces a rank; then the model group's gloo
              all-gather, bf16 all-reduce and staged shifts on CUDA
              tensors against their values (phase_multihost).
  (--profile: one warm denoise-step model call, without and with the knob,
   and 20 stage-1 decode steps, under torch.profiler.)
Then one JSON line with every kernel's numbers, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
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
# the qkv preparation kernel vs plain: the same design (a head's 64 values
# in f32, one rounding): one bf16 step at the element's own size; in f32,
# max |err| / (1 + |plain|) within 1e-5 (rsqrtf's 2 ulps, the sums' order)
QKV_TOL_STEPS = 1.0
QKV_TOL_F32 = 1e-5

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


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


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


def f32_fwd_case(name, B, S, H, mask_fn, int8, seeds, exp2_rates,
                 int8_pv=False, exp_bf16=False):
    """One f32 forward form at one shape against its plain version in
    float64 (attention.f64_reference; the int8-score forms
    attention.int8_f64_reference, whose codes and scores are the
    kernel's) within attention.F32_TOL or attention.f32_variant_limits,
    the exp_bf16 forms also against the reference with the card's exp2, on
    inputs from each of `seeds` (the largest errors over them are the
    case's); timed, with the prologues, SDPA f32 and, for the int8 forms,
    the scores' bit-equality check (lse from one kv position is the score),
    on the first."""
    import functools

    import torch

    from landiff_tpu_torch.ops import attention as A
    from landiff_tpu_torch.ops import masks as M

    dev = torch.device("cuda")
    D = 64
    opts = dict(exp_bf16=exp_bf16, **({"int8_pv": int8_pv} if int8 else {}))
    fn = functools.partial(A.flash_fwd_int8 if int8 else A.flash_fwd_exact,
                           **opts)
    # the plain version at the f32 kernels' kv tile: a p rounded to bf16
    # or int8 is rounded at the same running max
    plain = functools.partial(
        A.flash_int8_plain if int8 else A.flash_exact_plain,
        block_kv=A.F32_BLOCK_KV, **opts)
    reference = (functools.partial(A.int8_f64_reference,
                                   block_kv=A.F32_BLOCK_KV, **opts) if int8
                 else functools.partial(A.f64_reference, plain))
    tol = A.F32_TOL["fwd"]
    variant = int8_pv or exp_bf16
    by_seed, faults = {}, []
    for seed in reversed(seeds):   # the first seed's tensors stay
        g = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randn((B, S, H, D), generator=g, device=dev) * 1.5
        k = torch.randn((B, S, H, D), generator=g, device=dev)
        v = torch.randn((B, S, H, D), generator=g, device=dev)
        out, lse = fn(q, k, v, mask_fn=mask_fn)
        torch.cuda.synchronize()
        ref, ref_lse = reference(q, k, v, mask_fn=mask_fn)
        max_rel, rel_rms = A.kernel_error_rel(out, ref)
        err = {"max_abs_err": (out - ref).abs().max().item(),
               "max_rel_err": max_rel, "rel_rms_err": rel_rms,
               "lse_max_abs_err": (lse - ref_lse).abs().max().item()}
        checks = [(bool(torch.isfinite(out).all()), "output not finite")]
        if not variant:
            limits = tol
            checks += [(max_rel <= tol["max_rel"],
                        f"max |err| / max |ref| {max_rel}"),
                       (rel_rms <= tol["rel_rms"],
                        f"relative RMS error {rel_rms}"),
                       (err["lse_max_abs_err"] <= tol["lse"],
                        f"lse error {err['lse_max_abs_err']}")]
        else:
            limits = A.f32_variant_limits(ref, v, int8=int8, int8_pv=int8_pv,
                                          exp_bf16=exp_bf16)
            checks += [(err["max_abs_err"] <= limits["max_abs"],
                        f"max |err| {err['max_abs_err']}"),
                       (rel_rms <= limits["rel_rms"],
                        f"relative RMS error {rel_rms}"),
                       (err["lse_max_abs_err"] <= limits["lse"],
                        f"lse error {err['lse_max_abs_err']}")]
        if exp_bf16:   # the same reference with the card's own exp2
            c_out, c_lse = reference(q, k, v, mask_fn=mask_fn,
                                     exp2_table=A.card_exp2_table("cuda"))
            card = {"max_abs_err": (out - c_out).abs().max().item(),
                    "rel_rms_err": A.kernel_error_rel(out, c_out)[1],
                    "lse_max_abs_err": (lse - c_lse).abs().max().item()}
            checks += [
                (card["max_abs_err"] <= limits["card"]["max_abs"],
                 f"vs card exp2: max |err| {card['max_abs_err']}"),
                (card["rel_rms_err"] <= limits["card"]["rel_rms"],
                 f"vs card exp2: relative RMS {card['rel_rms_err']}"),
                (card["lse_max_abs_err"] <= limits["card"]["lse"],
                 f"vs card exp2: lse error {card['lse_max_abs_err']}")]
            err["vs_card_exp2"] = card
            del c_out, c_lse
        by_seed[seed] = err
        faults += [f"seed {seed}: {what}" for ok, what in checks if not ok]
        del out, lse, ref_lse
        if seed != seeds[0]:
            del q, k, v, ref
    plain_vs_f64 = None
    t0 = time.perf_counter()
    got_plain = plain(q, k, v, mask_fn=mask_fn)[0]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain_vs_f64 = A.kernel_error_rel(got_plain, ref)
    del got_plain
    ms = cuda_ms(lambda: fn(q, k, v, mask_fn=mask_fn), 2, repeats=3)
    prologue = None
    if int8:
        got, want = A.quantize_k(k), A.quantize_k_plain(k)
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        if not exact:
            faults.append("K quantization prologue differs")
        # one kv position: p = 1 and lse is that position's score, so the
        # kernel's q codes and scales (made in the CTA), K's and the order
        # of the two products are the plain version's if the lse are equal
        lse1 = fn(q, k[:, :1].contiguous(), v[:, :1].contiguous(),
                  mask_fn=None)[1]
        want1 = plain(q, k[:, :1], v[:, :1])[1]
        scores_exact = torch.equal(lse1, want1)
        if not scores_exact:
            faults.append("scores (lse from one kv position) differ from "
                          "the plain version's")
        prologue = {"k_quantization_ms": cuda_ms(lambda: A.quantize_k(k), 5),
                    "exact": exact, "scores_exact": scores_exact}
        if not int8_pv:
            s_pad = M.round_up(S, A.F32_BLOCK_KV)
            prologue["split_t_ms"] = cuda_ms(
                lambda: A.tf32_split_t(v, s_pad), 5)
        del got, want, lse1, want1
    else:   # the split prologues against their plain versions, bit for bit
        s_pad = M.round_up(S, A.F32_BLOCK_KV)
        exact = all(torch.equal(a, b) for a, b in zip(
            A.tf32_split(k), A.tf32_split_plain(k))) and all(
            torch.equal(a, b) for a, b in zip(
                A.tf32_split_t(v, s_pad), A.tf32_split_t_plain(v, s_pad)))
        if not exact:
            faults.append("tf32 split prologues differ")
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
    errs = {m: max(e[m] for e in by_seed.values())
            for m in ("max_abs_err", "max_rel_err", "rel_rms_err",
                      "lse_max_abs_err")}
    res = {"case": name, "shape": [B, S, H, D], "dtype": "float32",
           "visible_pairs": visible, "seeds": list(seeds), **errs,
           "errors_by_seed": by_seed, "limits": {
               k_: v_ for k_, v_ in limits.items() if k_ != "card"},
           "limits_vs_card_exp2": limits.get("card"),
           "plain_f32_vs_f64": plain_vs_f64,
           "ms": ms, "plain_ms": plain_ms,
           "prologue": prologue, "library_ms": library_ms,
           "sdpa_vs_plain": sdpa_err, "sdpa_kernels": sdpa_kernels,
           "bound_ms": bound_s * 1e3,
           "bound_by": bound_by, "bound_unit": unit,
           "bound_terms_ms": terms, "tflops": flops / (ms * 1e-3) / 1e12}
    log(json.dumps({"kernel": kname, **res}))
    res["name"] = kname
    res["faults"] = [f"{kname} {name}: {what}" for what in faults]
    del q, k, v, ref
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
        seeds = F32_I8_SEEDS if int8 else ((41,), (42,))
        dit = f32_fwd_case("dit_train", 1, 17776, 30, None, int8, seeds[0],
                           **kw)
        titok = f32_fwd_case("titok_dec", 1, 18768, 12, dec, int8,
                             seeds[1], **kw)
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
    smem = {name: lib.landiff_flash_f32_smem_bytes(i) for i, name in
            enumerate(("flash_fwd_tf32_kernel", "flash_bwd_tf32_kernel")
                      + F32_VARIANT_NAMES)}
    log(json.dumps({"phase": "f32_ptxas", "ptxas": ptxas,
                    "smem_bytes": smem}))
    results["ptxas"] = ptxas
    return results


# the f32 backward's and the f32 int8-score forward's inputs at the DiT and
# the TiTok shape: four seeds each, their limits held on every one
F32_BWD_SEEDS = ((43, 45, 47, 49), (44, 46, 48, 50))
F32_I8_SEEDS = ((41, 61, 63, 65), (42, 62, 64, 66))

# ptxas entries of each f32 kernel: the main kernel's instances and the
# prologues counted with it
_SPLITS = ("tf32_split_kernel", "tf32_split_t_kernel")
F32_PTXAS = {
    "flash_fwd_exact_f32": ("flash_fwd_tf32_kernelILb0ELb0E",
                            "flash_fwd_tf32_kernelILb0ELb1E") + _SPLITS,
    "flash_fwd_exact_exp_bf16_f32": ("flash_fwd_tf32_kernelILb1ELb0E",
                                     "flash_fwd_tf32_kernelILb1ELb1E"),
    "flash_fwd_int8_f32": ("flash_fwd_i8_f32_kernelILb0ELb0ELb0E",
                           "flash_fwd_i8_f32_kernelILb0ELb0ELb1E",
                           "quantize_k_f32", "tf32_split_t_kernel"),
    "flash_fwd_int8_pv_f32": ("flash_fwd_i8_f32_kernelILb1ELb0ELb0E",
                              "flash_fwd_i8_f32_kernelILb1ELb0ELb1E"),
    "flash_fwd_int8_pv_exp_bf16_f32": (
        "flash_fwd_i8_f32_kernelILb1ELb1ELb0E",
        "flash_fwd_i8_f32_kernelILb1ELb1ELb1E"),
    "flash_fwd_int8_exp_bf16_f32": ("flash_fwd_i8_f32_kernelILb0ELb1ELb0E",
                                    "flash_fwd_i8_f32_kernelILb0ELb1ELb1E"),
    "flash_bwd_f32": ("flash_bwd_tf32_kernelILb0E",
                      "flash_bwd_tf32_kernelILb1E", "bwd_prep_f32") + _SPLITS}
# the int8-score forward's shared memory by form, in the order of
# landiff_flash_f32_smem_bytes (2 + 2 int8_pv + exp_bf16)
F32_VARIANT_NAMES = ("flash_fwd_int8_f32", "flash_fwd_int8_exp_bf16_f32",
                     "flash_fwd_int8_pv_f32",
                     "flash_fwd_int8_pv_exp_bf16_f32")


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
    design = ("wgmma int8 scores, 3xTF32 or int8 p.v, TMA" if "int8" in name
              else "wgmma 3xTF32, TMA")
    return {"name": name, "route": "cuda",
            "source": "landiff_tpu_torch/ops/csrc/flash_f32.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": dit["max_abs_err"], "ms": dit["ms"],
            "plain_ms": dit["plain_ms"], "bound_ms": dit["bound_ms"],
            "bound_by": dit["bound_by"], "library_ms": dit["library_ms"],
            "bound_unit": dit["bound_unit"],
            "bound_terms_ms": dit["bound_terms_ms"], "tflops": dit["tflops"],
            "sdpa_vs_plain": dit["sdpa_vs_plain"],
            "design": design, "seeds": dit.get("seeds"),
            "scores_exact": (dit.get("prologue") or {}).get("scores_exact"),
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


def titok_encoder_mask():
    """The TiTok encoder's mask at its full layout: the latent-query rows
    (from frames_end on) see kv past frames_end (masks.py:107-110)."""
    from landiff_tpu_torch.ops import masks as M

    return M.video_encoder_mask(titok_decoder_mask().layout)


# the encoder-mask cases' inputs: bf16 forwards and backward one seed
# each, the f32 kernels four seeds each (their limits held on every one)
ENC_SEEDS = {"bf16": 81, "f32_fwd": (82, 84, 86, 88),
             "f32_bwd": (83, 85, 87, 89)}


def phase_encoder_mask(rates):
    """Each flash kernel of the tokenizer's paths under the video-encoder
    mask at the full TiTok layout (B=1 S=18,768 H=12 D=64): the bf16 exact
    and int8 forwards and the bf16 backward against their plain versions
    (the limits of phase 3), the f32 exact and int8 forwards and the f32
    backward against the float64 references on four seeds (attention.
    F32_TOL, as phase 3c), each with its ms beside its bound at this
    shape. Returns {kernel name: case}."""
    enc = titok_encoder_mask()
    B, S, H = 1, 18768, 12
    res = {}
    for int8 in (False, True):
        c = kernel_case("titok_enc", B, S, H, enc, int8, seed=ENC_SEEDS["bf16"],
                        exp2_rate=rates[False])
        res[c["name"]] = c
    res["flash_bwd"] = bwd_case("titok_enc", B, S, H, enc,
                                seed=ENC_SEEDS["bf16"], exp2_rate=rates[False])
    for int8 in (False, True):
        c = f32_fwd_case("titok_enc", B, S, H, enc, int8, ENC_SEEDS["f32_fwd"],
                         exp2_rates=rates)
        res[c["name"]] = c
    res["flash_bwd_f32"] = f32_bwd_case("titok_enc", B, S, H, enc,
                                        ENC_SEEDS["f32_bwd"],
                                        exp2_rate=rates[False])
    faults = [f for c in res.values() for f in c["faults"]]
    check(not faults, "encoder mask, kernel vs plain: " + "; ".join(faults))
    summary = {name: {k: c[k] for k in ("ms", "bound_ms", "bound_by",
                                        "plain_ms", "library_ms",
                                        "max_abs_err")}
               for name, c in res.items()}
    log(json.dumps({"phase": "encoder_mask", "shape": [B, S, H, 64],
                    "kernels": summary}))
    return res


def enc_entry(case):
    """The encoder-mask hold of a kernel, for its row of the kernels line."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "rel_rms_err", "max_rel_err", "max_bf16_steps",
            "errors", "seeds", "limits", "visible_pairs")
    return {"shape": case["shape"], "mask": "video_encoder",
            **{k: case[k] for k in keys if k in case}}


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


def qkv_prep_case(name, B, S, H, dtype_name, rotary, seed, timed):
    """The DiT's qkv preparation kernel at (B, S, 3 H 64), qk-LN on, the
    rotary3d tables of the DiT at H heads or none, against its plain
    version; timed (CUDA events) beside its byte bound, the plain version
    and the chain of PyTorch operations it replaces (models/dit.py
    `_qkv_chain`)."""
    import torch

    from landiff_tpu_torch.config import DiTConfig
    from landiff_tpu_torch.models import dit
    from landiff_tpu_torch.ops import attention as A
    from landiff_tpu_torch.ops import qkv_prep as QP

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype_name]
    cfg = DiTConfig(hidden_size=H * 64, num_heads=H,
                    pos_embed="rotary3d" if rotary else "sincos3d")
    check(cfg.text_length + cfg.video_tokens == S, f"S {S}")
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device="cuda")
    D3 = 3 * H * 64
    y = (r(B, S, D3) + 0.2).to(dtype)
    p = {"qkv_b": 0.1 * r(D3), "q_ln_w": 1.5 + 0.2 * r(64),
         "q_ln_b": 0.1 * r(64), "k_ln_w": 1.5 + 0.2 * r(64),
         "k_ln_b": 0.1 * r(64)}
    p = {k: t.to(dtype) for k, t in p.items()}
    tables = (dit._rotary3d_on(cfg, "cuda", dtype) if rotary
              else (None, None))
    args = (y, p["qkv_b"], p["q_ln_w"], p["q_ln_b"], p["k_ln_w"],
            p["k_ln_b"], *tables)
    fused = lambda: QP.qkv_prep(*args, heads=H)
    plain = lambda: QP.qkv_prep_plain(*args, heads=H)
    chain = lambda: dit._qkv_chain(y, p, cfg)

    with torch.inference_mode():
        out = fused()
        torch.cuda.synchronize()
        ref = plain()
        res = {"case": name, "shape": [B, S, D3], "dtype": dtype_name,
               "rotary": rotary, "errors": {}}
        faults = []
        for part, a, b in zip("qkv", out, ref):
            diff = (a.float() - b.float()).abs()
            mag = b.float().abs().clamp_min(2.0 ** -7)
            steps = (diff / torch.exp2(torch.frexp(mag)[1] - 8.0)).max().item()
            rel_max = (diff / (b.float().abs() + 1.0)).max().item()
            res["errors"][part] = {
                "max_abs_err": diff.max().item(), "max_bf16_steps": steps,
                "rel_rms_err": (diff.norm() / b.float().norm()).item(),
                "max_err_over_1_plus_abs": rel_max}
            ok = (steps <= QKV_TOL_STEPS if dtype_name == "bf16"
                  else rel_max <= QKV_TOL_F32)
            if not ok or not bool(torch.isfinite(a.float()).all()):
                faults.append(f"qkv_prep {name} {part}: {res['errors'][part]}")
            del diff, mag
        # the chain rounds about six times where the kernel rounds once
        res["chain_vs_plain"] = [A.kernel_error(a, b)
                                 for a, b in zip(chain(), ref)]
        del out, ref
        if timed:
            # y read and q, k, v written once; the bias, the affine and the
            # tables read once
            small = sum(t.numel() * t.element_size()
                        for t in args[1:] if t is not None)
            nbytes = 2 * y.numel() * y.element_size() + small
            res.update({
                "ms": cuda_ms(fused, 20), "plain_ms": cuda_ms(plain, 3),
                "chain_ms": cuda_ms(chain, 5),
                "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
                "bytes": nbytes, "library_ms": None})
            res["share_of_bound"] = res["bound_ms"] / res["ms"]
            res["gb_per_s"] = nbytes / (res["ms"] * 1e-3) / 1e9
    log(json.dumps({"kernel": "qkv_prep", **res}))
    res["faults"] = faults
    del y, args, p
    torch.cuda.empty_cache()
    return res


def phase_qkv_prep():
    """The qkv preparation kernel at the 2b DiT shape (sincos3d, bf16) and
    the 5b one (rotary3d, bf16 timed, and f32), with ptxas's report."""
    from landiff_tpu_torch.ops import kernels

    main = qkv_prep_case("2b", 2, 17776, 30, "bf16", False, seed=6,
                         timed=True)
    wide = qkv_prep_case("5b", 2, 17776, 48, "bf16", True, seed=7,
                         timed=True)
    f32 = qkv_prep_case("5b_f32", 2, 17776, 48, "f32", True, seed=8,
                        timed=False)
    faults = main["faults"] + wide["faults"] + f32["faults"]
    check(not faults, "kernel vs plain: " + "; ".join(faults))
    main["5b"], main["f32"] = wide, f32
    main["ptxas"] = kernels.ptxas_report("qkv_prep",
                                         "qkv_layer_norm_rotary_kernel")
    return main


def qkv_prep_entry(qkv, launches):
    """The kernels line's row of the qkv preparation kernel."""
    return {
        "name": "qkv_prep", "route": "cuda",
        "source": "landiff_tpu_torch/ops/csrc/qkv_prep.cu",
        "replaces": "none: the DiT layer's chain from the qkv product to "
                    "the attention inputs (XLA's fusion in the JAX package)",
        "launches": launches,
        **{k: qkv[k] for k in ("errors", "ms", "plain_ms", "chain_ms",
                               "bound_ms", "bound_by", "share_of_bound",
                               "library_ms", "shape", "ptxas",
                               "chain_vs_plain")},
        "5b": {k: qkv["5b"][k] for k in ("errors", "ms", "plain_ms",
                                         "chain_ms", "bound_ms",
                                         "share_of_bound", "shape")},
        "f32": qkv["f32"]["errors"]}


# ---------------------------------------------------------------------------
# phases 4-8: full width


def reset_counts():
    from landiff_tpu_torch.ops import adaln as N
    from landiff_tpu_torch.ops import attention as A
    from landiff_tpu_torch.ops import qkv_prep as QP

    A.reset_launch_counts()
    N.adaln_fused.launches = 0
    QP.qkv_prep.launches = 0


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
    batched decode, at one frame on the first GPT_CUT GPT blocks."""
    import torch

    from landiff_tpu_torch.models import lm
    from landiff_tpu_torch.ops import qkv_prep as QP
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
        codes, stage1_s = [], []
        for i, (prompt, seed) in enumerate(requests):
            llm.sample_cfg = dataclasses.replace(llm.sample_cfg, seed=seed)
            res = infer_video.generate(llm, dif, prompt, seed=seed)
            check_codes(res["codes"], cfg, f"request {i}")
            check_video(res["video"])
            codes.append(res["codes"])
            stage1_s.append(res["stage1_s"])
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
        launches["qkv_prep"] = QP.qkv_prep.launches
    finally:
        os.environ.pop("LANDIFF_FUSED_ADALN")
    n = len(requests)
    check(launches["adaln"] == n * 90 * steps,
          f"adaLN launches {launches['adaln']}, want {n * 90 * steps}")
    check(launches["qkv_prep"] == n * 45 * steps,
          f"qkv launches {launches['qkv_prep']}, want {n * 45 * steps}")
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

    # stage 1 alone, at one semantic frame (the I-frame's draws, a quarter
    # of a video's) and on the first GPT_CUT blocks: the repeat, the seed
    # and the batch need no more, and the script's time limit does: a
    # repeat, another seed, one batched decode
    (pa, sa), (pb, sb) = requests
    task = lambda p: llm_infer.CodeTask("x.npy", p)
    saved = dataclasses.replace(llm.sample_cfg, seed=sa)
    short_steps = lm.video_frames_to_code_len(cfg.llm, 1)

    def short(seed, prompt):
        llm.sample_cfg = dataclasses.replace(saved, seed=seed, num_frames=1)
        got = llm(task(prompt)).result
        check(len(got) == short_steps - 2 and got.min() >= 0
              and got.max() < cfg.llm.codebook_size
              and len(np.unique(got)) > 1,
              f"one-frame codes of {prompt!r}, seed {seed}: {got}")
        return got

    with gpt_depth(llm, GPT_CUT):
        try:
            first = short(sa, pa)
            check(np.array_equal(short(sa, pa), first),
                  "a repeated (prompt, seed) gave other codes")
            single_b = short(sa, pb)             # prompt b under seed a
            check(not np.array_equal(short(sb, pa), first),
                  "another seed gave the same codes")
            llm.sample_cfg = dataclasses.replace(saved, num_frames=1)
            t0 = time.perf_counter()
            batch = llm.infer_batch([task(pa), task(pb)])
            batch_s = time.perf_counter() - t0
        finally:
            llm.sample_cfg = saved
    agree = []
    for got, want in ((batch[0].result, first), (batch[1].result, single_b)):
        check(got.shape == want.shape, f"batched codes {got.shape}")
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
    log(json.dumps({"phase": "stage1_batch", "num_frames": 1,
                    "decode_steps": short_steps, "seconds": batch_s,
                    "phase_seconds": llm.phase_seconds,
                    "decode_steps_per_s":
                        short_steps / llm.phase_seconds["sample"],
                    "vs_single_calls_bf16": agree}))
    return launches, codes[0], stage1_s[-1]


def _dit_call_inputs(cfg, seed):
    """Seeded CFG-batch-2 inputs of one full-width DiT model call."""
    import torch

    d = cfg.dit
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (2, d.latent_frames, d.in_channels, d.latent_height,
             d.latent_width)
    x = torch.randn(shape, generator=g, device="cuda").bfloat16()
    sem = torch.randn(shape, generator=g, device="cuda").bfloat16()
    ctx = torch.randn((2, d.text_length, d.text_dim), generator=g,
                      device="cuda")
    return x, sem, ctx


def phase_rotary3d(cfg, params):
    """One full-width CFG-batch-2 model call (control_warp_forward, int8
    scores) under pos_embed="rotary3d", with rot_v, and the sincos call of
    the same inputs and parameters, timed in turns (host clock around a
    synchronised call, each route warmed first); then one rotary3d call
    with LANDIFF_FUSED_ADALN=1. Every output finite, each rotary one far
    from the sincos one (no table added; q / k rotated), rot_v's from
    rotary3d's; 45 int8 launches per call and nothing else (90 adaLN more
    with the knob)."""
    import torch

    from landiff_tpu_torch.models import dit

    x, sem, ctx = _dit_call_inputs(cfg, 21)
    ts = torch.tensor([600.0, 600.0], device="cuda")
    cfgs = {"sincos3d": cfg.dit,
            "rotary3d": dataclasses.replace(cfg.dit, pos_embed="rotary3d"),
            "rotary3d_rot_v": dataclasses.replace(
                cfg.dit, pos_embed="rotary3d", rot_v=True)}

    def call(name):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = dit.control_warp_forward(
                params["main"], params["control"], x, ts, ctx, cfgs[name],
                sem)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out, read_counts()

    os.environ.pop("LANDIFF_FUSED_ADALN", None)
    for name in cfgs:                                  # warm each route
        call(name)
    times = {name: [] for name in cfgs}
    outs, launches = {}, {}
    for name in ("sincos3d", "rotary3d", "rotary3d_rot_v", "rotary3d_rot_v",
                 "rotary3d", "sincos3d"):
        ms, outs[name], launches[name] = call(name)
        times[name].append(ms)
    for name, counts in launches.items():
        ran = {k: n for k, n in counts.items() if n}
        check(ran == {"flash_fwd_int8": 45},
              f"{name} call launched {ran}, want 45 int8 forwards")
    ref = outs["sincos3d"].float()
    rel = {}
    for name in ("rotary3d", "rotary3d_rot_v"):
        o = outs[name].float()
        check(bool(torch.isfinite(o).all()), f"{name} call not finite")
        check(tuple(o.shape) == tuple(ref.shape), f"{name} {tuple(o.shape)}")
        rel[name] = ((o - ref).norm() / ref.norm()).item()
        check(rel[name] > 1e-2,
              f"{name} call is {rel[name]} (relative RMS) off sincos")
    rot_v_rel = ((outs["rotary3d_rot_v"].float() - outs["rotary3d"].float())
                 .norm() / outs["rotary3d"].float().norm()).item()
    check(rot_v_rel > 0.0, "rot_v changed nothing")
    os.environ["LANDIFF_FUSED_ADALN"] = "1"
    try:
        call("rotary3d")
        fused_ms, fused, fused_launches = call("rotary3d")
    finally:
        os.environ.pop("LANDIFF_FUSED_ADALN")
    ran = {k: n for k, n in fused_launches.items() if n}
    check(ran == {"flash_fwd_int8": 45, "adaln": 90},
          f"fused rotary3d call launched {ran}")
    check(bool(torch.isfinite(fused.float()).all()),
          "fused rotary3d call not finite")
    log(json.dumps({
        "phase": "rotary3d", "what": "one control_warp_forward, CFG batch "
        "2, 45 layers, int8 scores, by pos_embed", "ms": times,
        "fused_adaln_rotary3d_ms": fused_ms,
        "rel_rms_vs_sincos": rel, "rot_v_vs_rotary3d_rel_rms": rot_v_rel,
        "launches_per_call": launches["rotary3d"],
        "launches_fused_call": fused_launches}))
    return launches["rotary3d"]


def phase_samplers(cfg, dif, codes, steps):
    """Stage 2 through the wrapper (dif_infer) at `steps` with each
    deterministic request sampler, from stage-1 codes: a finite (1, 3,
    49, 480, 720) video in [0, 1], 12 + 45 * steps int8 launches and
    nothing else; then each k-sampler over the latent shape (1, 13, 16,
    60, 90) on the card with a closed-form denoiser and seeded per-step
    draws, held to the same call on the CPU within 1e-5 (relative RMS,
    and element by element relative to the largest state)."""
    import torch

    from landiff_tpu_torch.diffusion import k_samplers as ks
    from landiff_tpu_torch.diffusion import schedule
    from landiff_tpu_torch.pipeline import dif_infer

    os.environ.pop("LANDIFF_FUSED_ADALN", None)
    base = dif.cfg
    per_request = 12 + 45 * steps
    requests, counts = {}, {}
    try:
        for name in ("vpode_dpmpp2m", "video_ddim"):
            dif.cfg = dataclasses.replace(base, sampler=dataclasses.replace(
                base.sampler, name=name, num_steps=steps))
            reset_counts()
            t0 = time.perf_counter()
            task = dif(dif_infer.VideoTask(name, "a kite over a windy hill",
                                           5, semantic_token=codes))
            seconds = time.perf_counter() - t0
            launches = read_counts()
            check_video(task.result, task.latent)
            ran = {k: n for k, n in launches.items() if n}
            check(ran == {"flash_fwd_int8": per_request},
                  f"{name} request launched {ran}, want {per_request} int8")
            counts[name] = launches
            requests[name] = {
                "seconds": seconds, "phase_seconds": dif.phase_seconds,
                "video_mean": float(task.result.mean()),
                "video_std": float(task.result.std()), "launches": ran}
    finally:
        dif.cfg = base

    shape = (1, cfg.dit.latent_frames, cfg.dit.in_channels,
             cfg.dit.latent_height, cfg.dit.latent_width)
    rng = np.random.default_rng(40)
    x0 = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 0.3)
    sig = ks.append_zero(schedule.edm_sigmas(6))
    noises = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
              for _ in range(len(sig) - 1)]
    image = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    drawn = dict(noises=noises, s_churn=2.0)
    runs = {
        "euler_edm": lambda den, x: ks.euler_edm_sample(den, x, sig, **drawn),
        "heun_edm": lambda den, x: ks.heun_edm_sample(den, x, sig, **drawn),
        "sdedit_edm": lambda den, x: ks.sdedit_edm_sample(
            den, image.to(x.device), x, sig, **drawn),
        "ddim": lambda den, x: ks.ddim_sample(den, x, sig, noises=noises),
        "euler_ancestral": lambda den, x: ks.euler_ancestral_sample(
            den, x, sig, noises=noises),
        "dpmpp2s_ancestral": lambda den, x: ks.dpmpp2s_ancestral_sample(
            den, x, sig, noises=noises),
        "dpmpp2m": lambda den, x: ks.dpmpp2m_sample(den, x, sig),
        "sde_dpmpp2m": lambda den, x: ks.sde_dpmpp2m_sample(
            den, x, sig, noises=noises),
        "lms": lambda den, x: ks.linear_multistep_sample(den, x, sig),
    }
    k_errors = {}
    for name, run in runs.items():
        outs = {}
        for device in ("cuda", "cpu"):
            wd = w.to(device)
            out = run(lambda x, sigma: torch.tanh(x / (1.0 + sigma) + wd),
                      x0.to(device))
            check(out.device.type == device, f"{name} left {device}")
            outs[device] = out.cpu()
        diff = outs["cuda"] - outs["cpu"]
        k_errors[name] = {
            "finite": bool(torch.isfinite(outs["cuda"]).all()),
            "max_abs": float(diff.abs().max()),
            "rel_rms": float(diff.norm() / outs["cpu"].norm())}
    log(json.dumps({"phase": "samplers", "steps": steps,
                    "requests": requests, "k_samplers_card_vs_cpu": k_errors,
                    "k_sampler_shape": list(shape), "sigmas": sig.tolist()}))
    # The two devices run the same f32 operations but for tanh's last bit
    # and the card's division by a scalar (a product by its reciprocal);
    # an ulp of the largest state, x0 * sqrt(1 + sigma_0^2) (about 400),
    # survives the loop's cancellation down to outputs near 1. So the card
    # is held to the CPU within 1e-5 relative RMS, and within 1e-5 of that
    # largest state element by element.
    top = float(x0.abs().max()) * float(np.sqrt(1.0 + sig[0] ** 2))
    for name, e in k_errors.items():
        check(e["finite"], f"k-sampler {name} not finite on the card")
        check(e["rel_rms"] <= 1e-5 and e["max_abs"] <= 1e-5 * top,
              f"k-sampler {name}: card vs CPU {e} (state scale {top})")
    return counts


def phase_train_rotary3d(workdir):
    """train("dit") under pos_embed="rotary3d" (the trainer's
    LanDiffConfig replaced for the call), bf16, batch 1, two steps on the
    bf16 phase's synthesized data, zero leaves filled: losses finite and
    per step 44 backward, 88 exact and 13 int8 forward launches."""
    import torch

    from landiff_tpu_torch.config import LanDiffConfig
    from landiff_tpu_torch.models import dit as dit_lib
    from landiff_tpu_torch.models import semantic_cond as sc_lib
    from landiff_tpu_torch.training import train as train_lib
    from landiff_tpu_torch.utils import fill_zero_leaves

    def rotary_config():
        cfg = LanDiffConfig()
        return dataclasses.replace(cfg, dit=dataclasses.replace(
            cfg.dit, pos_embed="rotary3d"))

    orig = (train_lib.LanDiffConfig, dit_lib.init, sc_lib.init)
    data = workdir / "dit_data_bf16"
    metrics = workdir / "dit_metrics_rotary3d.jsonl"
    train_lib.LanDiffConfig = rotary_config
    dit_lib.init = lambda gen, *a, **kw: fill_zero_leaves(
        orig[1](gen, *a, **kw), gen)
    sc_lib.init = lambda gen, *a, **kw: fill_zero_leaves(
        orig[2](gen, *a, **kw), gen)
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_lib.train("dit", str(data), steps=2, batch_size=1,
                        dtype=torch.bfloat16, log_every=1,
                        metrics_path=str(metrics), device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
    finally:
        train_lib.LanDiffConfig, dit_lib.init, sc_lib.init = orig
    rows = [json.loads(l) for l in metrics.read_text().splitlines()]
    check([r["step"] for r in rows] == [1, 2], f"rotary3d steps {rows}")
    check(all(np.isfinite(r["loss"]) for r in rows),
          f"rotary3d losses {[r['loss'] for r in rows]}")
    want = {k: 2 * n for k, n in TRAIN_DIT_LAUNCHES["bf16"].items()}
    got = {k: n for k, n in launches.items() if n or k in want}
    check(got == want, f"rotary3d train launches {got}, want {want}")
    per_step = {k: n // 2 for k, n in got.items()}
    log(json.dumps({
        "phase": "train_rotary3d", "dtype": "bf16", "batch_size": 1,
        "losses": [r["loss"] for r in rows],
        "step_seconds": step_seconds(rows), "train_call_seconds": seconds,
        "launches_per_step": per_step,
        "peak_gpu_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    return per_step


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
    x, sem, ctx = _dit_call_inputs(cfg, 7)
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
    check(out.shape == x.shape, f"exact-path output {tuple(out.shape)}")
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
    x, sem, ctx = _dit_call_inputs(cfg, 9)
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


def phase_dit_call_f32():
    """One full-width f32 DiT model call (control_warp_forward, CFG batch
    2, 30 main + 15 control layers of LanDiffConfig(), random weights from
    a seed with the zero leaves filled, compute_dtype f32), built once the
    bf16 pipelines are freed: the path of an f32 request's DiT, whose K / V
    (17,776 rows) fill the "cached" budget at f32, so that every layer
    takes the f32 int8-score forward. A warm call timed (host clock around
    a synchronised call, twice); launches 45 flash_fwd_int8_f32 and
    nothing else; the output finite and of its shape."""
    import torch

    from landiff_tpu_torch.config import LanDiffConfig
    from landiff_tpu_torch.models import dit
    from landiff_tpu_torch.utils import count_params, fill_zero_leaves

    d = LanDiffConfig().dit
    gen = torch.Generator(device="cuda").manual_seed(21)
    t0 = time.perf_counter()
    main = fill_zero_leaves(dit.init(gen, d), gen)
    control = fill_zero_leaves(dit.init(gen, d, control=True), gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    shape = (2, d.latent_frames, d.in_channels, d.latent_height,
             d.latent_width)
    x = torch.randn(shape, generator=gen, device="cuda")
    sem = torch.randn(shape, generator=gen, device="cuda")
    ctx = torch.randn((2, d.text_length, d.text_dim), generator=gen,
                      device="cuda")
    ts = torch.tensor([500.0, 500.0], device="cuda")
    os.environ.pop("LANDIFF_FUSED_ADALN", None)

    def call():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = dit.control_warp_forward(main, control, x, ts, ctx, d, sem,
                                           compute_dtype=torch.float32)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    first_s, _ = call()
    reset_counts()
    seconds, out = call()
    launches = read_counts()
    again_s, _ = call()
    want = {k: 45 if k == "flash_fwd_int8_f32" else 0 for k in launches}
    check(launches == want, f"f32 DiT call launches {launches}, want {want}")
    check(tuple(out.shape) == shape and out.dtype == torch.float32,
          f"f32 DiT call output {tuple(out.shape)} {out.dtype}")
    check(bool(torch.isfinite(out).all()), "f32 DiT call not finite")
    log(json.dumps({
        "phase": "dit_call_f32", "what": "one control_warp_forward in f32, "
        "CFG batch 2, 30 + 15 layers, full width", "init_s": init_s,
        "params": count_params(main) + count_params(control),
        "first_s": first_s, "seconds": [seconds, again_s],
        "launches": launches,
        "gpu_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    del main, control, x, sem, ctx, out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# the fast phase's denoise steps: 26, not the release's 50 (to keep the
# script inside its time): the guidance window [2, 44) then
# leaves steps 0 and 1 to the cond row alone, and reuse skips every
# second middle step
FAST_STEPS = 26


def fast_rows() -> list:
    """The batch rows of each model call of a FAST_STEPS video under
    LANDIFF_FAST=2 (reuse every 2nd step, window [2, 44)), from the
    sampler's own schedules."""
    from landiff_tpu_torch.diffusion import samplers

    compute = samplers.reuse_compute_schedule(FAST_STEPS, 2)
    full = samplers.cfg_window_schedule(FAST_STEPS, 2, 44)
    return [2 if full[i] else 1 for i in range(FAST_STEPS) if compute[i]]


# stage 1 is bound by the host (1,476 launches a decode step), so a full
# decode costs 35-57 s by the host; the fast, long-video, serving and tp
# requests decode with the first GPT_CUT of the 24 GPT blocks, to keep
# the script inside its time limit (a depth cut: widths, schedule
# and codes as before)
GPT_CUT = 6


@contextlib.contextmanager
def gpt_depth(llm, layers):
    """The resident stage-1 wrapper with only its first `layers` GPT
    blocks while the block runs."""
    gpt = llm.params["lm"]["gpt"]
    blocks, llm_cfg = gpt["blocks"], llm.llm_cfg
    gpt["blocks"] = blocks[:layers]
    llm.llm_cfg = dataclasses.replace(llm_cfg, num_layers=layers)
    try:
        yield
    finally:
        gpt["blocks"], llm.llm_cfg = blocks, llm_cfg


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
        with gpt_depth(llm, GPT_CUT):
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


# tensor parallelism on one card: ranks share the device (gloo barriers,
# device exchange buffers), so every time here is a reading of that
# layout, not a speed; the drift limits are the W8A8 gate's
# (diffusion/drift.GATES)
TP_LIMITS = {"corr": 0.999, "rel": 0.03}
TP_PROMPT = ("a corgi running along a beach at sunset", 1)   # phase 5's first


def _to_host(tree):
    """Every tensor of a tree of dicts and lists to (pageable) host
    memory, in place."""
    for k, v in (tree.items() if isinstance(tree, dict)
                 else enumerate(tree)):
        if isinstance(v, (dict, list)):
            _to_host(v)
        elif hasattr(v, "is_cuda") and v.is_cuda:
            tree[k] = v.cpu()


def _tp_drift(ref, got, what):
    from landiff_tpu_torch.diffusion import drift

    d = drift.drift(ref.float().cpu().numpy(), got.float().cpu().numpy())
    check(bool(np.isfinite(d["corr"])) and d["corr"] > TP_LIMITS["corr"]
          and d["rel"] < TP_LIMITS["rel"],
          f"{what}: drift {d} outside {TP_LIMITS}")
    return d


def _tp_call(mesh, key, dit_cfg, x, ts, ctx, sem):
    """One sharded CFG-batch-2 model call: (output, seconds, per-rank
    reports of that call)."""
    import torch

    from landiff_tpu_torch.parallel import tp_infer

    mesh.run(tp_infer.rank_report, True)
    t0 = time.perf_counter()
    out = mesh.run(tp_infer.model_call, key, x, ts, ctx, sem, dit_cfg,
                   torch.bfloat16)[0]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, seconds, mesh.run(tp_infer.rank_report, True)


def _check_tp_ranks(reports, layers, what):
    for rep in reports:
        n = rep["launches"]
        check(n["flash_fwd_int8"] == layers,
              f"{what}: rank {rep['rank']} int8 launches "
              f"{n['flash_fwd_int8']}, want {layers}")
        check(sum(n.values()) == layers,
              f"{what}: rank {rep['rank']} ran other flash kernels {n}")
        check(rep["collectives"]["all_reduce"] == 2 * layers,
              f"{what}: rank {rep['rank']} all-reduces "
              f"{rep['collectives']}, want {2 * layers}")


def _padded_head_case(H, pads, seed):
    """The int8 forward at a tensor-parallel rank's head count against its
    plain version; the last `pads` heads as zero-padded ones arrive
    (q, k the qk-LN bias, v zero): their output must be exactly 0."""
    import torch

    from landiff_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (2, 17776, H, 64)
    q = (torch.randn(shape, generator=g, device="cuda") * 1.5).bfloat16()
    k = torch.randn(shape, generator=g, device="cuda").bfloat16()
    v = torch.randn(shape, generator=g, device="cuda").bfloat16()
    if pads:
        bias = (torch.randn(64, generator=g, device="cuda") * 0.1).bfloat16()
        q[:, :, H - pads:] = bias
        k[:, :, H - pads:] = bias
        v[:, :, H - pads:] = 0
    out, _ = A.flash_fwd_int8(q, k, v)
    ref, _ = A.flash_int8_plain(q, k, v)
    steps, rel_rms = A.kernel_error(out, ref)
    lim = A.variant_limits(ref, v, int8_pv=False, exp_bf16=False,
                           tol_steps=KERNEL_TOL_STEPS,
                           tol_rms=KERNEL_TOL_RMS, lse_tol=LSE_TOL)
    err = (out.float() - ref.float()).abs().max().item()
    pad_max = out[:, :, H - pads:].float().abs().max().item() if pads else 0.0
    check(bool(torch.isfinite(out.float()).all()), f"H={H}: not finite")
    check(err <= lim["max_abs"] and rel_rms <= lim["rel_rms"],
          f"H={H}: int8 forward {err} / {rel_rms} off its plain version")
    check(pad_max == 0.0, f"H={H}: padded heads give {pad_max}, not 0")
    return {"H": H, "padded_heads": pads, "max_abs_err": err,
            "rel_rms_err": rel_rms, "max_bf16_steps": steps,
            "padded_heads_max_abs": pad_max}


def phase_tp(cfg, llm, dif):
    """Tensor-parallel inference on the one card (ROADMAP item 15a): ranks
    as processes sharing cuda:0, exchanging through device buffers with
    gloo barriers on the host (parallel/mesh.Group).

    (a) make_mesh(model=2) at full width: the resident unsharded
    references first (one CFG-batch-2 model call; the codes of phase 5's
    first request with stage 1 cut to its first GPT_CUT blocks), then the
    mesh wrappers shard both stages from the resident trees (15 of 30
    heads a rank; the GPT's blocks cut so), which are dropped as their
    shards land. One sharded model call against the unsharded
    one (drift limits TP_LIMITS); each rank: 45 int8 flash launches, 90
    all-reduces, its parameter bytes equal to parallel.plan's, its peak
    memory. Then one whole request through infer_video.generate at 2
    denoise steps: 1,218 codes in range (the stage-1 wrapper checks that
    every rank drew the same), a finite (1, 3, 49, 480, 720) video in
    [0, 1], 12 + 45 x 2 int8 launches a rank; the first code that differs
    from the unsharded request is printed, not held.
    (b) make_mesh(model=4) at full width, depth cut to 2 + 1 DiT layers:
    heads padded 30 -> 32 (8 a rank), one sharded call in bf16 and one
    under W8A8 (after the prep) against the unsharded bf16 / W8A8 calls;
    3 launches and 6 all-reduces a rank; the DiT bytes against plan.
    Then the int8 forward itself at 15 heads and at 8 with 2 padded ones
    against its plain version, the padded heads' output exactly 0.
    The resident llm / dif wrappers are left without their trees."""
    import gc

    import torch

    from landiff_tpu_torch.config import MeshConfig
    from landiff_tpu_torch.models import dit
    from landiff_tpu_torch.parallel import mesh as mesh_lib
    from landiff_tpu_torch.parallel import plan as plan_lib
    from landiff_tpu_torch.parallel import tp_infer
    from landiff_tpu_torch.pipeline import dif_infer, infer_video, llm_infer
    from landiff_tpu_torch.utils import fill_zero_leaves

    t_phase = time.perf_counter()
    d = cfg.dit
    prompt, seed = TP_PROMPT
    x, sem, ctx = _dit_call_inputs(cfg, 13)
    ts = torch.tensor([500.0, 500.0], device="cuda")
    with torch.inference_mode():
        ref = dit.control_warp_forward(dif.params["main"],
                                       dif.params["control"], x, ts, ctx, d,
                                       sem)
    # stage 1 at GPT_CUT of its 24 blocks from here on (llm is not used
    # after this phase): the unsharded request's codes at that depth
    gpt = llm.params["lm"]["gpt"]
    gpt["blocks"] = gpt["blocks"][:GPT_CUT]
    llm.llm_cfg = dataclasses.replace(llm.llm_cfg, num_layers=GPT_CUT)
    sample_cfg = dataclasses.replace(llm.sample_cfg, seed=seed)
    llm.sample_cfg = sample_cfg
    ref_codes = llm(llm_infer.CodeTask("x.npy", prompt)).result
    # the objects of the earlier phases out of the collector's scans: rank
    # 0 paces every rank, twice per GPT block a decode step
    gc.collect()
    gc.freeze()
    # the card cannot hold the resident stages and every rank's shards at
    # once: the stage-2 T5 (19 GB in f32) waits in host memory, and each
    # stage's resident trees are dropped once the mesh holds its shards
    # (the wrappers llm / dif are not used after this phase)
    t0 = time.perf_counter()
    _to_host(dif.params["t5"])
    gc.collect()
    torch.cuda.empty_cache()
    to_host_s = time.perf_counter() - t0
    # plan's per-rank bytes of the trees the wrappers shard: the DiT
    # shards are bf16, as plan() counts them; the T5s and the lm keep the
    # dtypes of the trees they are cut from
    mcfg = MeshConfig(model=2)
    bf16 = plan_lib.plan(mcfg, cfg)["components"]
    want = {("stage2", "main"): bf16["dit_main"]["per_chip_bytes"],
            ("stage2", "control"): bf16["dit_control"]["per_chip_bytes"]}
    for (stage, c), tree in ((("stage2", "t5"), dif.params["t5"]),
                             (("stage1", "lm"), llm.params["lm"]),
                             (("stage1", "t5"), llm.params["t5"])):
        want[(stage, c)] = plan_lib.component_bytes(c, tree, cfg, mcfg)[1]

    t0 = time.perf_counter()
    mesh = mesh_lib.make_mesh(mcfg, devices=["cuda:0"] * 2)
    out = {"phase": "tp", "mesh": "model=2", "backend": mesh.backend,
           "layout": "2 ranks (processes) sharing cuda:0; device "
                     "exchange buffers, gloo barriers; times are not "
                     "speed readings",
           "device_total_memory": torch.cuda.get_device_properties(0)
           .total_memory, "t5_to_host_s": to_host_s}
    try:
        tp_llm = llm_infer.ArModelInferWrapper(
            llm.params, llm.llm_cfg, cfg.t5, sample_cfg,
            compute_dtype=torch.bfloat16, mesh=mesh, device="cuda")
        llm.params = None
        gc.collect()
        torch.cuda.empty_cache()
        cfg2 = dataclasses.replace(cfg, sampler=dataclasses.replace(
            cfg.sampler, num_steps=2))
        tp_dif = dif_infer.CogModelInferWrapper(
            dif.params, cfg2, compute_dtype=torch.bfloat16, mesh=mesh,
            device="cuda")
        dif.params = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        got, call_s, reports = _tp_call(mesh, tp_dif.key, d, x, ts, ctx,
                                        sem)
        _check_tp_ranks(reports, d.num_layers + d.control_layers,
                        "model=2 call")
        out["model_call"] = {"seconds": call_s,
                             "drift": _tp_drift(ref, got, "model=2 call")}
        keys = {"stage1": tp_llm.key, "stage2": tp_dif.key}
        out["ranks"] = []
        for rep in reports:
            held = {f"{s}/{c}": rep["param_bytes"][keys[s]][c]
                    for s, c in want}
            for (s, c), n in want.items():
                check(held[f"{s}/{c}"] == n,
                      f"rank {rep['rank']} holds {held[f'{s}/{c}']} bytes "
                      f"of {s}/{c}, plan says {n}")
            out["ranks"].append({
                "rank": rep["rank"], "launches": rep["launches"],
                "collectives": rep["collectives"], "param_bytes": held,
                "semantic_bytes": rep["param_bytes"][keys["stage2"]][
                    "semantic"],
                "max_memory_allocated": rep["max_memory_allocated"]})
        out["plan_bytes"] = {f"{s}/{c}": n for (s, c), n in want.items()}
        log(json.dumps(out))

        t0 = time.perf_counter()
        res = infer_video.generate(tp_llm, tp_dif, prompt, seed=seed)
        out["request_s"] = time.perf_counter() - t0
        reports = mesh.run(tp_infer.rank_report, True)
        check_codes(res["codes"], cfg, "tp request")
        check_video(res["video"], res["latent"])
        for rep in reports:
            n = rep["launches"]["flash_fwd_int8"]
            check(n == 12 + 45 * 2,
                  f"tp request: rank {rep['rank']} int8 launches {n}")
        same = res["codes"] == ref_codes
        out["request"] = {
            "stage1_s": res["stage1_s"], "stage2_s": res["stage2_s"],
            "stage1_phase_seconds": tp_llm.phase_seconds,
            "stage2_phase_seconds": res["stage2_phases"],
            "ranks_codes_equal": True,
            "vs_unsharded_codes": {
                "equal": bool(same.all()),
                "first_difference": None if same.all()
                else int(np.argmin(same)), "share_equal": float(same.mean())},
            "launches_per_rank": [r["launches"] for r in reports],
            "collectives_per_rank": [r["collectives"] for r in reports],
            "max_memory_allocated": [r["max_memory_allocated"]
                                     for r in reports],
            "video_mean": float(res["video"].mean()),
            "video_std": float(res["video"].std())}
    finally:
        mesh.close()
        gc.unfreeze()
    tp_launches = [r["launches"]["flash_fwd_int8"] for r in out["ranks"]]
    del tp_llm, tp_dif, res
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps(out))

    # (b) model=4, heads padded 30 -> 32, depth cut
    t0 = time.perf_counter()
    cut = dataclasses.replace(d, num_layers=2, control_layers=1)
    gen = torch.Generator(device="cuda").manual_seed(21)
    params = fill_zero_leaves({"main": dit.init(gen, cut),
                               "control": dit.init(gen, cut, control=True)},
                              gen)
    with torch.inference_mode():
        refs = {False: dit.control_warp_forward(
            params["main"], params["control"], x, ts, ctx, cut, sem),
            True: dit.control_warp_forward(
                dit.quantize_int8(params["main"]),
                dit.quantize_int8(params["control"]), x, ts, ctx, cut, sem)}
    mesh = mesh_lib.make_mesh(MeshConfig(model=4), devices=["cuda:0"] * 4)
    out = {"phase": "tp", "mesh": "model=4", "backend": mesh.backend,
           "depth": "2 + 1 DiT layers", "heads_per_rank": 8}
    try:
        plan4 = plan_lib.plan(mesh.cfg, dataclasses.replace(cfg, dit=cut))
        for int8 in (False, True):
            key = f"tp4/{'w8a8' if int8 else 'bf16'}"
            for k in ("main", "control"):
                mesh_lib.load(mesh, key, k, tp_infer.dit_shards(
                    params[k], cut, mesh.cfg, mesh.devices, int8=int8,
                    dtype=torch.bfloat16))
            got, call_s, reports = _tp_call(mesh, key, cut, x, ts, ctx, sem)
            _check_tp_ranks(reports, 3, f"model=4 {key}")
            entry = {"seconds": call_s,
                     "drift": _tp_drift(refs[int8], got, f"model=4 {key}"),
                     "max_memory_allocated": [r["max_memory_allocated"]
                                              for r in reports]}
            if not int8:
                for rep in reports:
                    for c, name in (("main", "dit_main"),
                                    ("control", "dit_control")):
                        n = plan4["components"][name]["per_chip_bytes"]
                        check(rep["param_bytes"][key][c] == n,
                              f"model=4 rank {rep['rank']} {c} bytes "
                              f"{rep['param_bytes'][key][c]}, plan {n}")
                entry["param_bytes_per_rank"] = {
                    c: reports[0]["param_bytes"][key][c]
                    for c in ("main", "control")}
            out[key] = entry
    finally:
        mesh.close()
    out["kernel_at_tp_heads"] = [_padded_head_case(15, 0, 31),
                                 _padded_head_case(8, 2, 32)]
    out["seconds"] = time.perf_counter() - t0
    log(json.dumps(out))
    log(json.dumps({"phase": "tp", "seconds": time.perf_counter() - t_phase}))
    return tp_launches


# sequence / context parallelism on one card: the ranks share it, as in
# the tp phase, so every time here is a reading of that layout, not a
# speed. The ring against one kernel call over the whole sequence: each
# hop's p is rounded to bf16 at that hop's running max, each hop's output
# is rounded to bf16 before the merge, and the merged output is rounded
# again. Readings on an H100 at the DiT shape, time=2 (exact and int8):
# 0.5 bf16 steps at the largest output, relative RMS 3.0e-3; the limits
# are twice them and more (f32 forms: no bf16 rounding; readings 5.7e-7
# max relative, 3.9e-7 RMS; limits three times F32_TOL's)
RING_SINGLE_TOL = {"steps": 3.0, "rel_rms": 6e-3}
RING_SINGLE_F32_TOL = {"max_rel": 3e-5, "rel_rms": 1.5e-5}
SP_PROMPT = ("a paper boat drifting down a rain gutter", 5)


def _plain_ring(q, k, v, n, hop, dtype):
    """The ring of n ranks run in this process with a plain hop(q, k, v)
    -> (out, lse (B, H, Sq) log2), in the order the ranks merge (at hop j
    rank r holds rank r - j's block), merged in `dtype` as
    ring_attention._merge merges."""
    import torch

    from landiff_tpu_torch.parallel import ring_attention as R

    s = q.shape[1] // n
    part = lambda x, r: x[:, r * s:(r + 1) * s].contiguous()
    outs = []
    for r in range(n):
        out = lse = None
        for j in range(n):
            o, l = hop(part(q, r), part(k, (r - j) % n), part(v, (r - j) % n))
            o, l = o.to(dtype), l.transpose(1, 2).to(dtype)
            out, lse = (o, l) if out is None else R._merge(out, lse, o, l,
                                                           base2=True)
        outs.append(out)
    return torch.cat(outs, dim=1)


def _ring_case(mesh, int8: bool, f32: bool, seed: int):
    """Ring attention at the DiT shape (B=2 S=17,776 H=30 D=64) over the
    mesh's time ranks through the flash forward (int8 scores or exact,
    bf16 or f32): against the same ring with the kernels' plain versions
    as hops in this process (bf16: the plain versions, merged in f32, the
    result rounded to bf16: the kernel limits and one step of that last
    rounding; f32: the float64 references, merged in float64: F32_TOL),
    and against one kernel call over the whole sequence (RING_SINGLE_TOL).
    Per rank: one launch a hop, 2 shifts a hop after the first."""
    import torch

    from landiff_tpu_torch.ops import attention as A
    from landiff_tpu_torch.parallel import ring_attention as R
    from landiff_tpu_torch.parallel import tp_infer

    n = mesh.cfg.time
    dt = torch.float32 if f32 else torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (2, 17776, 30, 64)
    q = (torch.randn(shape, generator=g, device="cuda") * 1.5).to(dt)
    k, v = (torch.randn(shape, generator=g, device="cuda").to(dt)
            for _ in range(2))
    kname = A.variant_name(int8, f32=f32)
    mesh.run(tp_infer.rank_report, True)
    out = R.ring_attention(q, k, v, mesh, impl="pallas", int8_scores=int8,
                           int8_pv=False)
    reports = mesh.run(tp_infer.rank_report, True)
    t0 = time.perf_counter()
    R.ring_attention(q, k, v, mesh, impl="pallas", int8_scores=int8,
                     int8_pv=False)
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    mesh.run(tp_infer.rank_report, True)
    for rep in reports:
        got = {kk: c for kk, c in rep["launches"].items() if c}
        check(got == {kname: n}, f"ring {kname}: rank {rep['rank']} "
              f"launched {got}, want {n} of {kname}")
        check(rep["collectives"]["ring_shift"] == 2 * (n - 1),
              f"ring {kname}: rank {rep['rank']} {rep['collectives']}")
    t0 = time.perf_counter()
    if f32:
        hop = (A.int8_f64_reference if int8 else
               lambda a, b, c: A.f64_reference(A.flash_exact_plain, a, b, c))
        ref = _plain_ring(q, k, v, n, hop, torch.float64)
    else:
        hop = A.flash_int8_plain if int8 else A.flash_exact_plain
        ref = _plain_ring(q, k, v, n, hop, torch.float32).to(dt)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    single = A.flash_attention(q, k, v, int8_scores=int8, int8_pv=False,
                               exp_bf16=False)
    entry = {"form": kname, "shape": list(shape), "time": n,
             "ring_s": ring_s, "plain_ring_s": plain_s,
             "launches_per_rank": [r["launches"][kname] for r in reports],
             "shifts_per_rank": [r["collectives"]["ring_shift"]
                                 for r in reports]}
    check(bool(torch.isfinite(out.float()).all()), f"ring {kname}: finite")
    if f32:
        max_rel, rms = A.kernel_error_rel(out, ref)
        tol = A.F32_TOL["fwd"]
        check(max_rel <= tol["max_rel"] and rms <= tol["rel_rms"],
              f"ring {kname}: {max_rel} / {rms} off the plain ring, "
              f"limits {tol}")
        s_rel, s_rms = A.kernel_error_rel(out, single)
        check(s_rel <= RING_SINGLE_F32_TOL["max_rel"]
              and s_rms <= RING_SINGLE_F32_TOL["rel_rms"],
              f"ring {kname}: {s_rel} / {s_rms} off one call")
        entry.update(vs_plain={"max_rel_err": max_rel, "rel_rms_err": rms,
                               "limits": tol},
                     vs_single_call={"max_rel_err": s_rel,
                                     "rel_rms_err": s_rms,
                                     "limits": RING_SINGLE_F32_TOL})
    else:
        steps, rms = A.kernel_error(out, ref)
        lim = A.variant_limits(ref, v, int8_pv=False, exp_bf16=False,
                               tol_steps=KERNEL_TOL_STEPS + 1.0,
                               tol_rms=KERNEL_TOL_RMS, lse_tol=LSE_TOL)
        err = (out.float() - ref.float()).abs().max().item()
        check(err <= lim["max_abs"] and rms <= lim["rel_rms"],
              f"ring {kname}: {err} ({steps} steps) / {rms} off the plain "
              f"ring, limits {lim}")
        s_steps, s_rms = A.kernel_error(out, single)
        check(s_steps <= RING_SINGLE_TOL["steps"]
              and s_rms <= RING_SINGLE_TOL["rel_rms"],
              f"ring {kname}: {s_steps} steps / {s_rms} off one call")
        entry.update(vs_plain={"max_abs_err": err, "max_bf16_steps": steps,
                               "rel_rms_err": rms, "limits": lim},
                     vs_single_call={"max_bf16_steps": s_steps,
                                     "rel_rms_err": s_rms,
                                     "limits": RING_SINGLE_TOL})
    log(json.dumps({"phase": "sp", "case": "ring", **entry}))
    return entry


def _cp_decode_case(mesh, cfg):
    """The VAE decode of 13 latents at full width (LanDiffConfig().vae,
    random weights from a seed), bf16: context-parallel over the mesh's
    time ranks against the whole decode in this process (the same
    function: the whole video's GroupNorm statistics; the W8A8 gate's
    limits, TP_LIMITS) and, as a reading, against the streaming decode
    the unsharded request takes (its statistics per chunk); seconds and
    peak memory per rank."""
    import torch

    from landiff_tpu_torch.diffusion import drift
    from landiff_tpu_torch.models import vae
    from landiff_tpu_torch.parallel import tp_infer, vae_cp

    gen = torch.Generator(device="cuda").manual_seed(51)
    p = vae.init_decoder(gen, cfg.vae)
    d = cfg.dit
    z = torch.randn((1, d.out_channels, d.latent_frames, d.latent_height,
                     d.latent_width), generator=gen, device="cuda")
    out = {"latents": list(z.shape)}
    for name, fn in (
            ("whole", lambda: vae.decode(p, z, cfg.vae)[0].float()),
            ("streaming", lambda: vae.decode_streaming(p, z, cfg.vae))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            t0 = time.perf_counter()
            video = fn()
            torch.cuda.synchronize()
        out[name] = {"seconds": time.perf_counter() - t0,
                     "max_memory_allocated": torch.cuda.max_memory_allocated()}
        if name == "whole":
            whole = video
        else:
            stream = video
        del video
    torch.cuda.empty_cache()
    mesh.run(tp_infer.rank_report, True)
    t0 = time.perf_counter()
    cp = vae_cp.decode_temporal_cp(p, z, cfg.vae, mesh).float()
    torch.cuda.synchronize()
    reports = mesh.run(tp_infer.rank_report, True)
    check(cp.shape == whole.shape == (1, 3, 49, 480, 720),
          f"cp decode {tuple(cp.shape)}")
    check(bool(torch.isfinite(cp).all()), "cp decode not finite")
    out["cp"] = {
        "seconds": time.perf_counter() - t0,
        "max_memory_allocated": [r["max_memory_allocated"] for r in reports],
        "collectives_per_rank": [r["collectives"] for r in reports],
        "vs_whole": _tp_drift(whole, cp, "cp decode vs whole"),
        "vs_streaming_reading": drift.drift(stream.cpu().numpy(),
                                            cp.cpu().numpy())}
    del whole, stream, cp, p
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "sp", "case": "cp_decode", **out}))
    return out


def phase_sp(steps):
    """Sequence / context-parallel inference on the one card (ROADMAP item
    15b, its inference half): ranks as processes sharing cuda:0, as in the
    tp phase (device exchange buffers, gloo barriers; readings of that
    layout, not speed).

    (a) data=1,time=2: ring attention at the DiT shape in the exact and
    int8 bf16 forms and the int8 f32 form (_ring_case); the CP decode of
    13 latents at full VAE width (_cp_decode_case). Then the wrappers at
    full width on the mesh (random weights from a seed, zero leaves
    filled; stage 1 on the first GPT_CUT GPT blocks, unsharded in rank 0
    as a mesh without `model` leaves it; rank 0's DiT replica is the
    wrapper's own tree): one model call against the unsharded call on
    rank 0's trees (TP_LIMITS), 90 int8 launches, 90 ring shifts, one
    all-gather and no all-reduce a rank, the DiT bytes per rank equal to
    plan's; one request through infer_video.generate at `steps` denoise
    steps with LANDIFF_OFFLOAD=1 (every rank's DiT trees leave the card
    before the two ranks decode beside rank 0's T5s): 1,218 codes, a
    video as in 5 from the CP decode, 12 + 90 x steps int8 launches a
    rank. (b) model=2,time=2 at 2 + 1 DiT layers
    (15 heads a rank, tokens over two): bf16 and W8A8 calls against the
    unsharded ones (TP_LIMITS), 6 launches, 6 all-reduces and 6 ring
    shifts a rank. Returns the per-rank launches on the path."""
    import gc

    import torch

    from landiff_tpu_torch.config import ARSampleConfig, LanDiffConfig, \
        MeshConfig
    from landiff_tpu_torch.models import dit
    from landiff_tpu_torch.parallel import mesh as mesh_lib
    from landiff_tpu_torch.parallel import plan as plan_lib
    from landiff_tpu_torch.parallel import tp_infer
    from landiff_tpu_torch.pipeline import dif_infer, infer_video, llm_infer
    from landiff_tpu_torch.utils import fill_zero_leaves

    t_phase = time.perf_counter()
    cfg = LanDiffConfig()
    cfg = dataclasses.replace(
        cfg, sampler=dataclasses.replace(cfg.sampler, num_steps=steps))
    d = cfg.dit
    x, sem, ctx = _dit_call_inputs(cfg, 17)
    ts = torch.tensor([500.0, 500.0], device="cuda")
    launches = {}
    t0 = time.perf_counter()
    mesh = mesh_lib.make_mesh(MeshConfig(time=2), devices=["cuda:0"] * 2)
    out = {"phase": "sp", "mesh": "data=1,time=2", "backend": mesh.backend,
           "layout": "2 ranks (processes) sharing cuda:0; device exchange "
                     "buffers, gloo barriers; times are not speed "
                     "readings", "mesh_s": time.perf_counter() - t0}
    try:
        rings = [_ring_case(mesh, False, False, 61),
                 _ring_case(mesh, True, False, 62),
                 _ring_case(mesh, True, True, 63)]
        launches["ring"] = {r["form"]: r["launches_per_rank"] for r in rings}
        decode = _cp_decode_case(mesh, cfg)

        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(71)
        llm_cfg = dataclasses.replace(cfg.llm, num_layers=GPT_CUT)
        prompt, seed = SP_PROMPT
        llm = llm_infer.ArModelInferWrapper(
            fill_zero_leaves(llm_infer.init_params(gen, llm_cfg, cfg.t5),
                             gen),
            llm_cfg, cfg.t5, ARSampleConfig(seed=seed), mesh=mesh,
            device="cuda")
        check(llm.mesh is None, "stage 1 was sharded on a mesh without "
              "`model`")
        dif = dif_infer.CogModelInferWrapper(
            fill_zero_leaves(dif_infer.init_params(gen, cfg), gen), cfg,
            mesh=mesh, device="cuda")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        st = mesh.ctx.state[dif.key]
        with torch.inference_mode():
            ref = dit.control_warp_forward(st["main"], st["control"], x, ts,
                                           ctx, d, sem)
        got, call_s, reports = _tp_call(mesh, dif.key, d, x, ts, ctx, sem)
        layers = d.num_layers + d.control_layers
        plan = plan_lib.plan(mesh.cfg, cfg)["components"]
        for rep in reports:
            n = rep["launches"]
            check(n["flash_fwd_int8"] == 2 * layers and sum(n.values())
                  == 2 * layers, f"sp call: rank {rep['rank']} launches {n}")
            c = rep["collectives"]
            check(c == {"all_reduce": 0, "all_gather": 1,
                        "ring_shift": 2 * layers},
                  f"sp call: rank {rep['rank']} collectives {c}")
            for part, name in (("main", "dit_main"),
                               ("control", "dit_control")):
                b = rep["param_bytes"][dif.key][part]
                want = plan[name]["per_chip_bytes"]
                check(b == want, f"sp: rank {rep['rank']} {part} bytes {b}"
                      f", plan {want}")
        out["model_call"] = {
            "seconds": call_s, "drift": _tp_drift(ref, got, "sp call"),
            "launches_per_rank": [r["launches"]["flash_fwd_int8"]
                                  for r in reports],
            "collectives_per_rank": [r["collectives"] for r in reports],
            "param_bytes_per_rank": [r["param_bytes"][dif.key]
                                     for r in reports],
            "max_memory_allocated": [r["max_memory_allocated"]
                                     for r in reports]}
        launches["model_call"] = out["model_call"]["launches_per_rank"]
        del ref, got
        log(json.dumps(out))

        # the DiT trees of every rank go to host memory before the decode
        # (LANDIFF_OFFLOAD): the two ranks' decodes beside rank 0's T5s
        t0 = time.perf_counter()
        os.environ["LANDIFF_OFFLOAD"] = "1"
        try:
            res = infer_video.generate(llm, dif, prompt, seed=seed)
        finally:
            os.environ.pop("LANDIFF_OFFLOAD")
        request_s = time.perf_counter() - t0
        reports = mesh.run(tp_infer.rank_report, True)
        check_codes(res["codes"], cfg, "sp request")
        check_video(res["video"], res["latent"])
        for rep in reports:
            n = rep["launches"]["flash_fwd_int8"]
            check(n == 12 + 2 * layers * steps,
                  f"sp request: rank {rep['rank']} int8 launches {n}")
        launches["request"] = [r["launches"]["flash_fwd_int8"]
                               for r in reports]
        out = {"phase": "sp", "mesh": "data=1,time=2", "request": {
            "seconds": request_s, "stage1_s": res["stage1_s"],
            "stage2_s": res["stage2_s"],
            "stage1": "unsharded in rank 0 (no model axis)",
            "stage2_phase_seconds": res["stage2_phases"],
            "cp_decode": True, "offload": dif.offloaded,
            "launches_per_rank": [r["launches"] for r in reports],
            "collectives_per_rank": [r["collectives"] for r in reports],
            "max_memory_allocated": [r["max_memory_allocated"]
                                     for r in reports],
            "video_mean": float(res["video"].mean()),
            "video_std": float(res["video"].std())}}
        log(json.dumps(out))
    finally:
        mesh.close()
    del llm, dif, res, st
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the 2-D hybrid, depth cut
    t0 = time.perf_counter()
    cut = dataclasses.replace(d, num_layers=2, control_layers=1)
    gen = torch.Generator(device="cuda").manual_seed(81)
    params = fill_zero_leaves({"main": dit.init(gen, cut),
                               "control": dit.init(gen, cut, control=True)},
                              gen)
    with torch.inference_mode():
        refs = {False: dit.control_warp_forward(
            params["main"], params["control"], x, ts, ctx, cut, sem),
            True: dit.control_warp_forward(
                dit.quantize_int8(params["main"]),
                dit.quantize_int8(params["control"]), x, ts, ctx, cut, sem)}
    mesh = mesh_lib.make_mesh(MeshConfig(model=2, time=2),
                              devices=["cuda:0"] * 4)
    out = {"phase": "sp", "mesh": "model=2,time=2", "backend": mesh.backend,
           "depth": "2 + 1 DiT layers", "heads_per_rank": 15}
    try:
        for int8 in (False, True):
            key = f"tpsp/{'w8a8' if int8 else 'bf16'}"
            for k in ("main", "control"):
                mesh_lib.load(mesh, key, k, tp_infer.dit_shards(
                    params[k], cut, mesh.cfg, mesh.devices, int8=int8,
                    dtype=torch.bfloat16))
            got, call_s, reports = _tp_call(mesh, key, cut, x, ts, ctx, sem)
            for rep in reports:
                n, c = rep["launches"], rep["collectives"]
                check(n["flash_fwd_int8"] == 6 and sum(n.values()) == 6,
                      f"{key}: rank {rep['rank']} launches {n}")
                check(c["all_reduce"] == 6 and c["ring_shift"] == 6,
                      f"{key}: rank {rep['rank']} collectives {c}")
            out[key] = {"seconds": call_s,
                        "drift": _tp_drift(refs[int8], got, key),
                        "max_memory_allocated": [r["max_memory_allocated"]
                                                 for r in reports]}
            launches[key] = [r["launches"]["flash_fwd_int8"]
                             for r in reports]
    finally:
        mesh.close()
    out["seconds"] = time.perf_counter() - t0
    log(json.dumps(out))
    log(json.dumps({"phase": "sp", "decode_peaks": decode["cp"][
        "max_memory_allocated"], "seconds": time.perf_counter() - t_phase}))
    return launches


SERVING_PROMPTS = (("a lighthouse in a storm at night", 11),
                   ("a red fox jumping over a frozen stream", 12),
                   ("a hot air balloon above a canyon", 13))


def _post(url, form, timeout):
    """POST a form to the local server, past any proxy the environment
    names: (status, body, seconds)."""
    import urllib.parse
    import urllib.request

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    t0 = time.perf_counter()
    with opener.open(url, data=urllib.parse.urlencode(form).encode(),
                     timeout=timeout) as r:
        return r.status, r.read().decode(), time.perf_counter() - t0


def phase_serving(cfg, llm, dif, steps, stage1_one_s=None):
    """The serving engine over the resident wrappers (no rebuild), through
    its HTTP server: three concurrent POST /generate with different
    prompts; then the offload and the profiler trace. See the module
    docstring (8h)."""
    import base64
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import torch
    from PIL import Image

    from landiff_tpu_torch import observability
    from landiff_tpu_torch.diffusion import engine as E
    from landiff_tpu_torch.pipeline import dif_infer, llm_infer
    from landiff_tpu_torch.serving import app
    from landiff_tpu_torch.serving.scheduler import ServingEngine
    from landiff_tpu_torch.utils import tree_leaves

    for knob in ("LANDIFF_FUSED_ADALN", "LANDIFF_OFFLOAD"):
        os.environ.pop(knob, None)
    t_phase = time.perf_counter()
    per_request = 12 + 45 * steps
    gb = lambda n: n / 1e9
    if stage1_one_s is None:      # one single request at the same depth
        t0 = time.perf_counter()
        llm(llm_infer.CodeTask("one.npy", SERVING_PROMPTS[0][0]))
        stage1_one_s = time.perf_counter() - t0

    # 1. three concurrent requests through the HTTP server; the engine's
    # results are kept as they go out
    eng = ServingEngine(llm, dif, max_batch=8, linger_s=2.0)
    served = {}
    generate = eng.generate

    def recording(prompt, seed=42, fps=8):
        served[prompt] = res = generate(prompt, seed=seed, fps=fps)
        return res

    eng.generate = recording
    sc = llm.sample_cfg
    app._PIPELINE.clear()
    app._PIPELINE.update(engine=eng,
                         engine_key=(sc.cfg_scale, sc.motion_score))
    server = ThreadingHTTPServer(("127.0.0.1", 0), app._Handler)
    serve = threading.Thread(target=server.serve_forever, daemon=True)
    serve.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    answers, errors = {}, []

    def client(prompt, seed):
        try:
            answers[prompt] = _post(url + "/generate", {
                "prompt": prompt, "cfg_scale": repr(sc.cfg_scale),
                "motion": repr(sc.motion_score), "seed": seed}, 600)
        except Exception as e:  # reported below, in the main thread
            errors.append(repr(e))

    try:
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        clients = [threading.Thread(target=client, args=r)
                   for r in SERVING_PROMPTS]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=900)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        check(not errors and not any(c.is_alive() for c in clients),
              f"serving clients: {errors}")
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        with opener.open(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        serve.join(timeout=60)
        eng.shutdown()
        app._PIPELINE.clear()
    check(stats["stage1_batch_sizes"] == [3] and stats["requests"] == 3,
          f"stage-1 batches {stats}")
    check(launches["flash_fwd_int8"] == 3 * per_request,
          f"int8 launches {launches['flash_fwd_int8']}, want "
          f"{3 * per_request}")
    check(launches["flash_fwd_exact"] == 0 and launches["adaln"] == 0,
          f"exact / adaLN kernels ran on the served path: {launches}")
    check_no_variant(launches)
    gifs = {}
    for prompt, _ in SERVING_PROMPTS:
        status, page, _ = answers[prompt]
        check(status == 200, f"HTTP {status}")
        gif = base64.b64decode(page.split("data:image/gif;base64,")[1]
                               .split('"')[0])
        img = Image.open(io.BytesIO(gif))
        check_codes(served[prompt]["codes"], cfg, f"served {prompt!r}")
        check_video(served[prompt]["video"])
        _, _, T, H, W = served[prompt]["video"].shape
        check(img.format == "GIF" and img.n_frames == T
              and img.size == (W, H),
              f"answer image {img.format} {img.n_frames} {img.size}")
        gifs[prompt] = len(gif)

    # 2. each request's stage 2 again, directly, on its codes and seed
    # (the decode's peak read by a wrapper); memory between requests
    # steady; then the offload twice on the first request's codes
    decodes = []
    decode = E.decode_first_stage

    def timed_decode(*a, **kw):
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = decode(*a, **kw)
        torch.cuda.synchronize()
        decodes.append({"allocated_at_start_gb": gb(start),
                        "peak_gb": gb(torch.cuda.max_memory_allocated())})
        return out

    offload_mem = {}
    offload = dif.offload_diffusion_params

    def measured_offload():
        torch.cuda.synchronize()
        offload_mem["before"] = torch.cuda.memory_allocated()
        offload()
        offload_mem["after"] = torch.cuda.memory_allocated()

    moved = sum(t.numel() * t.element_size() for k in
                ("main", "control", "semantic")
                for t in tree_leaves(dif.params[k]))
    task = lambda prompt, seed: dif_infer.VideoTask(
        "s.mp4", prompt, seed, semantic_token=served[prompt]["codes"])
    E.decode_first_stage = timed_decode
    dif.offload_diffusion_params = measured_offload
    between, offload_runs = [], []
    try:
        for prompt, seed in SERVING_PROMPTS:
            direct = dif(task(prompt, seed)).result
            check(np.array_equal(direct, served[prompt]["video"]),
                  f"served stage 2 of {prompt!r} differs from a direct call")
            between.append(torch.cuda.memory_allocated())
        os.environ["LANDIFF_OFFLOAD"] = "1"
        prompt, seed = SERVING_PROMPTS[0]
        for i in range(2):
            video = dif(task(prompt, seed)).result
            check(dif.offloaded, "the knob left the trees on the card")
            check(np.array_equal(video, served[prompt]["video"]),
                  f"offloaded call {i} differs from the call without it")
            offload_runs.append({k: dif.phase_seconds.get(k) for k in
                                 ("restage", "offload", "denoise", "vae")})
            if i == 0:
                freed = offload_mem["before"] - offload_mem["after"]
                check(freed >= 0.95 * moved,
                      f"offload freed {freed} of {moved} bytes")
    finally:
        os.environ.pop("LANDIFF_OFFLOAD", None)
        E.decode_first_stage = decode
        del dif.offload_diffusion_params
        dif.restage_diffusion_params()
    check(max(between) - min(between) <= 2 ** 20,
          f"memory between requests not steady: {between}")
    check(len(decodes) == 5, f"{len(decodes)} decodes")

    # 3. one request's DiT model call (CFG batch 2, 45 layers) under the
    # profiler: a whole request's trace (T5, VAE) would be tens of MB
    from landiff_tpu_torch.models import dit

    x, sem, ctx = _dit_call_inputs(cfg, 9)
    ts = torch.tensor([500.0, 500.0], device="cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        reset_counts()
        with observability.trace(tmp, device="cuda"), \
                observability.named_scope("serving_request"), \
                torch.inference_mode():
            traced = dit.control_warp_forward(
                dif.params["main"], dif.params["control"], x, ts, ctx,
                cfg.dit, sem)
            torch.cuda.synchronize()
        trace_launches = read_counts()["flash_fwd_int8"]
        (path,) = Path(tmp).glob("*.json")
        trace_bytes = path.stat().st_size
        events = json.loads(path.read_text())["traceEvents"]
    scope = [e for e in events if e.get("name") == "serving_request"]
    int8_kernels = [e for e in events
                    if str(e.get("cat", "")).lower() == "kernel"
                    and "flash_fwd_kernel" in e.get("name", "")
                    and ("<true, false, false>" in e["name"]
                         or "ILb1ELb0ELb0E" in e["name"])]
    check(bool(torch.isfinite(traced.float()).all()),
          "traced model call not finite")
    check(scope, "the trace holds no serving_request scope")
    check(len(int8_kernels) == trace_launches == 45,
          f"{len(int8_kernels)} int8 flash kernels in the trace, "
          f"{trace_launches} launches")

    log(json.dumps({
        "phase": "serving", "card": nvidia_smi(),
        "http_requests": {p: {"status": answers[p][0],
                              "end_to_end_s": answers[p][2],
                              "stage1_s": served[p]["stage1_s"],
                              "stage2_s": served[p]["stage2_s"],
                              "stage2_phases": served[p]["stage2_phases"],
                              "gif_bytes": gifs[p]}
                          for p, _ in SERVING_PROMPTS},
        "stats": stats,
        "stage1_batch_of_3_s": max(served[p]["stage1_s"]
                                   for p, _ in SERVING_PROMPTS),
        "stage1_one_request_s": stage1_one_s,
        "launches": launches,
        "int8_launches_per_request": launches["flash_fwd_int8"] / 3,
        "peak_gpu_mem_gb": gb(peak),
        "allocated_before_after_gb": [gb(mem_before), gb(mem_after)],
        "allocated_between_direct_requests_gb": [gb(b) for b in between],
        "offload": {"moved_gb": gb(moved),
                    "allocated_before_gb": gb(offload_mem["before"]),
                    "allocated_after_gb": gb(offload_mem["after"]),
                    "freed_share": (offload_mem["before"]
                                    - offload_mem["after"]) / moved,
                    "runs": offload_runs},
        "decode_peaks": {"without_knob": decodes[:3],
                         "with_knob": decodes[3:]},
        "trace": {"bytes": trace_bytes, "events": len(events),
                  "int8_kernels": len(int8_kernels),
                  "scope_ms": scope[0].get("dur", 0) / 1e3},
        "seconds": time.perf_counter() - t_phase}))
    return launches


def phase_prefix(cfg, dif, steps):
    """Image to video through the stage-2 wrapper: a seeded 1-frame
    480 x 720 prefix in [0, 1] is VAE-encoded (the posterior's mode) and
    held over the first latent frame while the rest is sampled at the
    stage2 phase's step count; the video's shape, range and finiteness,
    the first latent frame equal to the prefix's own encoding, 12 + 45 *
    steps int8 launches."""
    import torch

    from landiff_tpu_torch.diffusion import engine
    from landiff_tpu_torch.pipeline import dif_infer

    prefix = np.random.default_rng(34).random((1, 3, 1, 480, 720),
                                              dtype=np.float32)
    codes = np.random.default_rng(35).integers(
        0, cfg.tokenizer.vq.codebook_size, cfg.tokenizer.titok.latent_tokens)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    task = dif(dif_infer.VideoTask("prefix", "a lighthouse at dusk", 3,
                                   semantic_token=codes), prefix_video=prefix)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    check_video(task.result, task.latent)
    want = 12 + 45 * steps
    check(launches["flash_fwd_int8"] == want,
          f"prefix request: int8 launches {launches['flash_fwd_int8']}, "
          f"want {want}")
    check_no_variant(launches)
    with torch.inference_mode():
        enc = engine.encode_first_stage(
            dif.params["vae"], engine.pre_process_video(
                torch.from_numpy(prefix).cuda()), cfg.vae,
            compute_dtype=dif.compute_dtype).float().cpu().numpy()
    held = task.latent[:, :1]
    err = float(np.abs(held - enc).max())
    check(enc.shape == held.shape == (1, 1, 16, 60, 90),
          f"prefix latents {enc.shape} / {held.shape}")
    # the sampler splices the encoding in unchanged, and the same encode
    # of the same input reruns the same cuDNN algorithms (no benchmark
    # mode): the held frame is the encoding exactly, as on the CPU
    check(err == 0.0,
          f"held prefix frame differs from its encoding by {err}")
    log(json.dumps({
        "phase": "prefix_video", "prefix": list(prefix.shape),
        "video": list(task.result.shape), "finite": True,
        "seconds": seconds, "phase_seconds": dif.phase_seconds,
        "held_frame_max_abs_err": err, "launches": launches,
        "peak_gpu_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    return launches


def phase_tokenize():
    """video -> codes at full width (Theia 12 x 768, TiTok 12 x 768, VQ
    2,048 x 16; random weights from a seed, zero leaves filled) on a
    seeded 13-frame 480 x 720 clip through vq.encode_to_index, twice
    (first and warm, the warm one split into Theia and TiTok + VQ), then
    index_to_feature's round trip. 1,218 codes in [0, 2,048); the encoder
    launches the bf16 int8 forward 12 times (under the encoder mask) and
    nothing else, the decoder 12 more (decoder mask)."""
    import torch

    from landiff_tpu_torch.config import TokenizerConfig
    from landiff_tpu_torch.models import vq
    from landiff_tpu_torch.utils import count_params, fill_zero_leaves

    cfg = TokenizerConfig()
    gen = torch.Generator(device="cuda").manual_seed(31)
    params = fill_zero_leaves(vq.init(gen, cfg, with_theia=True), gen)
    video = torch.from_numpy(np.random.default_rng(32).integers(
        0, 256, (1, 13, 480, 720, 3), dtype=np.uint8)).cuda()
    want = {"flash_fwd_int8": cfg.titok.num_layers}
    runs = {}
    with torch.inference_mode():
        for run in ("first", "warm"):
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if run == "warm":
                feats = vq.extract_features(params, video, cfg)
                torch.cuda.synchronize()
                t_theia = time.perf_counter() - t0
                quant, idx = vq.encode_features_to_index(params, feats, cfg)
            else:
                quant, idx = vq.encode_to_index(params, video, cfg)
            torch.cuda.synchronize()
            launches = {k: n for k, n in read_counts().items() if n}
            runs[run] = {"seconds": time.perf_counter() - t0,
                         "launches": launches,
                         "peak_gpu_mem_gb":
                             torch.cuda.max_memory_allocated() / 1e9}
            check(launches == want, f"tokenize ({run}): launches "
                  f"{launches}, want {want}")
        runs["warm"]["theia_seconds"] = t_theia
        runs["warm"]["titok_vq_seconds"] = runs["warm"]["seconds"] - t_theia
        codes = idx.cpu().numpy()
        check(codes.shape == (1, cfg.titok.latent_tokens),
              f"codes {codes.shape}")
        check(codes.min() >= 0 and codes.max() < cfg.vq.codebook_size,
              "codes out of range")
        check(len(np.unique(codes)) > 1, "codes are constant")
        check(quant.shape == (1, cfg.titok.latent_tokens, cfg.vq.dim)
              and bool(torch.isfinite(quant).all()), "quantized latents")
        reset_counts()
        t0 = time.perf_counter()
        rec = vq.index_to_feature(params, idx, cfg)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        dec_launches = {k: n for k, n in read_counts().items() if n}
    check(rec.shape == (1, 13, cfg.titok.grid_h, cfg.titok.grid_w,
                        cfg.feature_dim) and bool(torch.isfinite(rec).all()),
          f"round trip {tuple(rec.shape)}")
    check(dec_launches == want, f"index_to_feature launches {dec_launches}")
    log(json.dumps({
        "phase": "tokenize", "clip": list(video.shape),
        "params": {"theia": count_params(params["theia"]),
                   "encoder": count_params(params["encoder"]),
                   "quant": count_params(params["quant"])},
        "codes": list(codes.shape), "distinct_codes":
            int(len(np.unique(codes))), "encode": runs,
        "round_trip": {"features": list(rec.shape), "seconds": dec_s,
                       "launches": dec_launches}}))
    del params, video, quant, rec
    torch.cuda.empty_cache()
    return runs["warm"]["launches"]


def phase_vae_encode():
    """video -> VAE latents at full width on a seeded 49-frame 480 x 720
    clip in [-1, 1]: engine.encode_first_stage whole and streaming (9 +
    5 x 8 frames), each twice; seconds and peak memory; (1, 13, 16, 60,
    90) finite latents; no flash kernel (the convs are cuDNN's)."""
    import torch

    from landiff_tpu_torch.config import VAEConfig
    from landiff_tpu_torch.diffusion import engine
    from landiff_tpu_torch.models import vae as vae_lib
    from landiff_tpu_torch.utils import count_params, fill_zero_leaves

    cfg = VAEConfig()
    gen = torch.Generator(device="cuda").manual_seed(33)
    params = {"encoder": fill_zero_leaves(vae_lib.init_encoder(gen, cfg),
                                          gen)}
    video = torch.rand((1, 3, 49, 480, 720), generator=gen,
                       device="cuda") * 2.0 - 1.0
    out, lat = {}, {}
    with torch.inference_mode():
        for streaming in (False, True):
            name = "streaming" if streaming else "whole"
            secs = []
            for _ in range(2):
                reset_counts()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                z = engine.encode_first_stage(params, video, cfg,
                                              streaming=streaming)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            check(tuple(z.shape) == (1, 13, 16, 60, 90),
                  f"{name} latents {tuple(z.shape)}")
            check(bool(torch.isfinite(z).all()), f"{name} latents not finite")
            launches = {k: n for k, n in read_counts().items() if n}
            check(not launches, f"vae encode launched {launches}")
            lat[name] = z.float()
            out[name] = {"seconds": secs, "peak_gpu_mem_gb":
                         torch.cuda.max_memory_allocated() / 1e9,
                         "peak_above_inputs_gb":
                         (torch.cuda.max_memory_allocated() - base) / 1e9,
                         "latent_std": float(z.float().std())}
    log(json.dumps({
        "phase": "vae_encode", "clip": list(video.shape),
        "params": count_params(params), "latents": [1, 13, 16, 60, 90],
        "whole_vs_streaming_max_abs":
            float((lat["whole"] - lat["streaming"]).abs().max()), **out}))
    del params, video, lat, z
    torch.cuda.empty_cache()


# the tokenizer trainer's flash launches per step at full width in f32:
# 12 encoder + 12 decoder attention calls, each an exact forward under
# grad and a backward; the first step's k-means pass (no grad) adds 24
# exact forwards
TRAIN_VQ_LAUNCHES = {"flash_fwd_exact_f32": 24, "flash_bwd_f32": 24}


def phase_train_vq(workdir, steps=3):
    """training.train.train("vq") at full width, batch 1, in f32 (the
    trainer's default) on synthesized Theia features: `steps` steps, the
    first with the k-means codebook init; every loss finite, the trained
    parameters moved, the codebook initialised; seconds per step, peak
    memory and the flash launches of each step (read at each step's
    gradient) by kind."""
    import torch

    from landiff_tpu_torch.config import LanDiffConfig
    from landiff_tpu_torch.models import vq as vq_lib
    from landiff_tpu_torch.training import optim
    from landiff_tpu_torch.training import train as train_lib
    from landiff_tpu_torch.utils import count_params

    cfg = LanDiffConfig()
    data = workdir / "vq_data"
    metrics = workdir / "vq_metrics.jsonl"
    train_lib.synthesize("vq", cfg, steps, str(data), seed=0,
                         shard_size=steps)
    made, per_step = {}, []
    orig_init, orig_grad = vq_lib.init, optim.grad

    def init(*a, **kw):
        made["params"] = orig_init(*a, **kw)
        made["before"] = leaf_sums(made["params"])
        return made["params"]

    def grad(loss, params):
        grads = orig_grad(loss, params)
        torch.cuda.synchronize()
        per_step.append({k: n for k, n in read_counts().items() if n})
        reset_counts()
        return grads

    vq_lib.init, optim.grad = init, grad
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, last = train_lib.train("vq", str(data), steps=steps,
                                      batch_size=1, log_every=1,
                                      metrics_path=str(metrics),
                                      device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        vq_lib.init, optim.grad = orig_init, orig_grad
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    check(len(rows) == steps, f"{len(rows)} metric rows")
    for r in rows:
        check(all(np.isfinite(r[k]) for k in ("total_loss", "re_loss",
                                              "commit_loss")),
              f"train vq: loss not finite {r}")
    want = [dict(TRAIN_VQ_LAUNCHES) for _ in range(steps)]
    want[0]["flash_fwd_exact_f32"] += 12   # the k-means pass: the encoder
    check(per_step == want, f"train vq launches {per_step}, want {want}")
    after = leaf_sums(state[0])
    moved = int((after != made["before"]).any(dim=1).sum())
    check(moved > len(after) // 2, f"only {moved} leaves moved")
    check(bool(state[2]["initted"]) and state[3] is False,
          "codebook state not initialised")
    log(json.dumps({
        "phase": "train_vq", "dtype": "float32", "batch": 1, "steps": steps,
        "params": count_params(state[0]), "seconds": seconds,
        "step_seconds": step_seconds(rows),
        "losses": [{k: r[k] for k in ("total_loss", "re_loss",
                                      "commit_loss")} for r in rows],
        "launches_per_step": per_step, "leaves_moved": moved,
        "leaves": len(after),
        "peak_gpu_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    del state, made
    torch.cuda.empty_cache()
    return per_step


def phase_prepare(workdir):
    """data.prepare over two seeded 13-frame 480 x 720 .npy clips (one with
    a caption) at full width in bf16, --model vq and --model lm, random
    weights; the shards read back through data.loader: features (2, 13,
    30, 45, 768) finite, codes (2, 1,218) in range, captions; the lm pass
    launches the int8 forward 12 times per segment."""
    import torch

    from landiff_tpu_torch.config import LanDiffConfig
    from landiff_tpu_torch.data import loader, prepare

    cfg = LanDiffConfig().tokenizer
    clips = workdir / "clips"
    clips.mkdir()
    rng = np.random.default_rng(36)
    for name in ("a", "b"):
        np.save(clips / f"{name}.npy", rng.integers(
            0, 256, (13, 480, 720, 3), dtype=np.uint8))
    (clips / "captions.json").write_text(json.dumps({"a": "a red kite"}))
    res = {}
    for model in ("vq", "lm"):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        shards = prepare.prepare(str(clips), str(workdir / f"prep_{model}"),
                                 model=model, device="cuda")
        seconds = time.perf_counter() - t0
        launches = {k: n for k, n in read_counts().items() if n}
        batch = next(loader.ShardedNpzDataset(
            workdir / f"prep_{model}", 2).iter_epoch(0))
        if model == "vq":
            f = batch["features"]
            check(f.shape == (2, 13, cfg.titok.grid_h, cfg.titok.grid_w,
                              cfg.feature_dim) and np.isfinite(f).all(),
                  f"prepared features {f.shape}")
            check(not launches, f"prepare vq launched {launches}")
        else:
            c = batch["codes"]
            check(c.shape == (2, cfg.titok.latent_tokens)
                  and c.min() >= 0 and c.max() < cfg.vq.codebook_size,
                  f"prepared codes {c.shape}")
            check(sorted(batch["caption"]) == ["", "a red kite"],
                  f"captions {batch['caption']}")
            check(launches == {"flash_fwd_int8": 2 * cfg.titok.num_layers},
                  f"prepare lm launches {launches}")
        res[model] = {"seconds": seconds, "shards": len(shards),
                      "keys": sorted(batch), "launches": launches,
                      "peak_gpu_mem_gb":
                          torch.cuda.max_memory_allocated() / 1e9}
    log(json.dumps({"phase": "prepare", "clips": [2, 13, 480, 720, 3],
                    **res}))
    torch.cuda.empty_cache()
    return res


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
    # the files build_pipeline reads (Theia's is the tokenizer's encode side)
    file_bytes = sum(n for rel, n in written["files"].items()
                     if rel != synth.THEIA)

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
    prompt goes to a video through infer_video.generate at FAST_STEPS
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
            with gpt_depth(fllm, GPT_CUT):
                res = infer_video.generate(fllm, fdif, prompt, seed=seed)
            launches = read_counts()
        finally:
            dit_lib.control_warp_forward = orig
    check_codes(res["codes"], cfg, "fast")
    check_video(res["video"])
    check(rows == fast_rows(), f"fast path model calls by rows {rows}, "
          f"want {fast_rows()}")
    want = {k: 0 for k in launches}
    # 45 DiT layers a model call + 12 TiTok decoder layers, all int8_pv
    want["flash_fwd_int8_pv"] = 45 * len(rows) + 12
    check(launches == want, f"fast launches {launches}, want {want}")
    decode_steps = lm.video_frames_to_code_len(cfg.llm,
                                               fllm.sample_cfg.num_frames)
    log(json.dumps({
        "phase": "fast", "steps": FAST_STEPS, "first_request": True,
        "stage1_gpt_blocks": GPT_CUT,
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
    device time by the benchmark's kernel classes
    (portbench/kernel_classes/), the device's busy share of the wall
    time, and the twelve largest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from portbench.core.trace import classify, load_classes

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
    classes, by_kind = load_classes(), {}
    for e in kernels:
        k = classify(e.key, classes) or "unclassified"
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


# ---------------------------------------------------------------------------
# phase 13: training on meshes whose ranks share the card (device exchange
# buffers, gloo barriers, as the tp and sp phases): every time here is a
# reading of that layout, not a speed.
#
# The ring backward against one flash_bwd over the whole sequence (the
# same out and lse): each hop's dq / dk / dv is rounded to bf16 by the
# kernel before the ring's f32 sums, which are rounded again; each hop
# also carries the kernel's own error. Limits set before the first
# reading: twice the backward's limits and one step for the last rounding
# (bf16); three times F32_TOL's backward limits (f32). Against the ring of
# plain versions (the same hops in this process): n hops of the kernel's
# limits and one step.
RING_BWD_TOL = {"steps": 2 * BWD_TOL_STEPS + 1.0, "rel_rms": 2 * BWD_TOL_RMS}
RING_BWD_F32_TOL = {"max_rel": 6e-6, "rel_rms": 3e-6}
# The SP step against the one-device step, both bf16 through the kernels:
# the loss within 1e-2 relative; per control leaf the gradients correlated
# at 0.999 at least (below is a fault to find, not a limit to widen) and
# within 5e-2 relative L2 error. k_ln_b's gradient is 0 but for rounding
# (it moves every score of a row alike) and the control tree's final
# LayerNorm is read by no forward: reported, not held.
MESH_LOSS_REL = 1e-2
MESH_GRAD_CORR = 0.999
MESH_GRAD_REL = 5e-2
MESH_OPT = {"lr": 1e-3, "steps": 2, "grad_accum": 1}


def _grad_agreement(got, want):
    """Per leaf of two gradient trees (host tensors of one device's
    layout): correlation and relative L2 error of got against want, in
    f64 on the card; the leaves held to the limits and the worst ones."""
    import torch

    from landiff_tpu_torch.parallel import mesh as mesh_lib

    rows = {}

    def leaf(path, g, w):
        name = "/".join(path)
        g, w = g.cuda().double().ravel(), w.cuda().double().ravel()
        wn = float(w.norm())
        rel = float((g - w).norm()) / wn if wn else float((g - w).norm())
        corr = float(torch.corrcoef(torch.stack([g, w]))[0, 1]) \
            if wn and float(g.norm()) else float("nan")
        rows[name] = {"corr": corr, "rel": rel, "norm": wn}

    mesh_lib.map_with_path(leaf, got, want)
    held = {k: r for k, r in rows.items()
            if not k.endswith("k_ln_b") and "final_ln" not in k}
    for name, r in held.items():
        check(r["corr"] >= MESH_GRAD_CORR and r["rel"] <= MESH_GRAD_REL,
              f"mesh gradient {name}: {r}, limits corr {MESH_GRAD_CORR}, "
              f"rel {MESH_GRAD_REL}")
    worst = sorted(held.items(), key=lambda kv: kv[1]["corr"])[:3]
    return {"leaves": len(rows), "held": len(held),
            "min_corr": min(r["corr"] for r in held.values()),
            "max_rel": max(r["rel"] for r in held.values()),
            "worst": dict(worst),
            "not_held": {k: r for k, r in rows.items() if k not in held}}


def _update_agreement(after, start, ref_after, what):
    """The parameter change of a mesh run against one device's, per leaf
    of two or more dimensions that moved: (min correlation, max relative
    L2 error), held to the gradient limits."""
    import torch

    from landiff_tpu_torch.parallel import mesh as mesh_lib

    out = []

    def leaf(path, a, s, r):
        if not isinstance(a, torch.Tensor) or a.dim() < 2:
            return
        d = (a.cuda().double() - s.cuda().double()).ravel()
        w = (r.cuda().double() - s.cuda().double()).ravel()
        if float(w.norm()) == 0.0:
            return
        out.append((float(torch.corrcoef(torch.stack([d, w]))[0, 1]),
                    float((d - w).norm() / w.norm()), "/".join(path)))

    mesh_lib.map_with_path(leaf, after, start, ref_after)
    check(out, f"{what}: no parameter moved")
    worst = min(out)
    check(worst[0] >= MESH_GRAD_CORR and max(o[1] for o in out)
          <= MESH_GRAD_REL, f"{what}: update {worst} and max rel "
          f"{max(o[1] for o in out)} outside corr {MESH_GRAD_CORR}, rel "
          f"{MESH_GRAD_REL}")
    return {"leaves": len(out), "min_corr": worst[0], "min_corr_leaf":
            worst[2], "max_rel": max(o[1] for o in out)}


def _ring_bwd_case(mesh, dtype_name, seed):
    """The ring backward over time=2 at the DiT hop shape (B=1 S=17,776
    H=30 D=64, 8,888 positions a rank) from the whole sequence's out and
    lse (the exact forward kernel) against one flash_bwd over the whole
    sequence; per rank two backward launches, 6 shifts."""
    import torch

    from landiff_tpu_torch.ops import attention as A
    from landiff_tpu_torch.parallel import ring_attention as R
    from landiff_tpu_torch.parallel import tp_infer

    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype_name]
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (1, 17776, 30, 64)
    q = (torch.randn(shape, generator=g, device="cuda") * 1.5).to(dt)
    k, v, do = (torch.randn(shape, generator=g, device="cuda").to(dt)
                for _ in range(3))
    out, lse = A.flash_attention(q, k, v, int8_scores=False, int8_pv=False,
                                 exp_bf16=False, return_lse=True)
    whole = A.flash_bwd(q, k, v, out, lse, do)
    mesh.run(tp_infer.rank_report, True)
    t0 = time.perf_counter()
    ring = R.ring_attention_bwd(q, k, v, out, lse.transpose(1, 2), do, mesh,
                                impl="pallas")
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    reports = mesh.run(tp_infer.rank_report, True)
    kname = "flash_bwd_f32" if dtype_name == "f32" else "flash_bwd"
    for rep in reports:
        got = {kk: c for kk, c in rep["launches"].items() if c}
        check(got == {kname: 2}, f"ring bwd {dtype_name}: rank "
              f"{rep['rank']} launched {got}")
        check(rep["collectives"]["ring_shift"] == 6,
              f"ring bwd: rank {rep['rank']} {rep['collectives']}")
    errs = {}
    for name, a, b in zip(("dq", "dk", "dv"), ring, whole):
        check(bool(torch.isfinite(a.float()).all()), f"ring bwd {name}")
        if dtype_name == "f32":
            max_rel, rms = A.kernel_error_rel(a, b)
            tol = RING_BWD_F32_TOL
            check(max_rel <= tol["max_rel"] and rms <= tol["rel_rms"],
                  f"ring bwd f32 {name}: {max_rel} / {rms}, limits {tol}")
            errs[name] = {"max_rel_err": max_rel, "rel_rms_err": rms}
        else:
            steps, rms = A.kernel_error(a, b)
            tol = RING_BWD_TOL
            check(steps <= tol["steps"] and rms <= tol["rel_rms"],
                  f"ring bwd {name}: {steps} steps / {rms}, limits {tol}")
            errs[name] = {"max_bf16_steps": steps, "rel_rms_err": rms,
                          "max_abs_err": (a.float() - b.float()).abs()
                          .max().item()}
    entry = {"case": "ring_bwd", "dtype": dtype_name, "shape": list(shape),
             "time": 2, "vs_one_flash_bwd": errs, "limits": tol,
             "ring_s": ring_s,
             "max_abs_err": max((a.float() - b.float()).abs().max().item()
                                for a, b in zip(ring, whole)),
             "launches_per_rank": [r["launches"][kname] for r in reports],
             "shifts_per_rank": [r["collectives"]["ring_shift"]
                                 for r in reports]}
    log(json.dumps({"phase": "train_mesh", **entry}))
    del q, k, v, do, out, lse, whole, ring
    torch.cuda.empty_cache()
    return entry


def _ring_bwd_plain_case(mesh, seed):
    """At a small shape (B=1 S=2 x 640 H=2 D=64, bf16) the ring of
    kernels against the ring of the backward's plain versions run in this
    process: at hop j rank r holds block r - j; dq sums on its rank, dk /
    dv on their block's, in f32, rounded once."""
    import torch

    from landiff_tpu_torch.ops import attention as A
    from landiff_tpu_torch.parallel import ring_attention as R

    g = torch.Generator(device="cuda").manual_seed(seed)
    n, s = 2, 640
    shape = (1, n * s, 2, 64)
    q = (torch.randn(shape, generator=g, device="cuda") * 1.5).bfloat16()
    k, v, do = (torch.randn(shape, generator=g, device="cuda").bfloat16()
                for _ in range(3))
    out, lse = A.flash_attention(q, k, v, int8_scores=False, int8_pv=False,
                                 exp_bf16=False, return_lse=True)
    ring = R.ring_attention_bwd(q, k, v, out, lse.transpose(1, 2), do, mesh,
                                impl="pallas")
    part = lambda x, r: x[:, r * s:(r + 1) * s].contiguous()
    acc = [torch.zeros(shape, dtype=torch.float32, device="cuda")
           for _ in range(3)]
    for r in range(n):
        for j in range(n):
            b = (r - j) % n
            dq, dk, dv = A.flash_bwd_plain(
                part(q, r), part(k, b), part(v, b), part(out, r),
                lse[:, :, r * s:(r + 1) * s].contiguous(), part(do, r))
            acc[0][:, r * s:(r + 1) * s] += dq.float()
            acc[1][:, b * s:(b + 1) * s] += dk.float()
            acc[2][:, b * s:(b + 1) * s] += dv.float()
    tol = {"steps": n * BWD_TOL_STEPS + 1.0, "rel_rms": BWD_TOL_RMS}
    errs = {}
    for name, a, w in zip(("dq", "dk", "dv"), ring, acc):
        steps, rms = A.kernel_error(a, w.bfloat16())
        check(steps <= tol["steps"] and rms <= tol["rel_rms"],
              f"ring bwd vs plain ring {name}: {steps} steps / {rms}, "
              f"limits {tol}")
        errs[name] = {"max_bf16_steps": steps, "rel_rms_err": rms}
    entry = {"case": "ring_bwd_vs_plain_ring", "shape": list(shape),
             "time": n, "errors": errs, "limits": tol}
    log(json.dumps({"phase": "train_mesh", **entry}))
    return entry


def _filled_setup(model, cfg, opt, dtype, seed):
    """The trainer's setup (train.SETUPS) with every zero leaf of its
    trees filled from a seed (zero gates would cut the gradients) and the
    optimizer state made anew from the filled parameters: (state, frozen
    trees, the one-device run(state, batch, generator))."""
    import torch

    from landiff_tpu_torch.training import diffusion_loss
    from landiff_tpu_torch.training import train as train_lib
    from landiff_tpu_torch.utils import fill_zero_leaves

    gen = torch.Generator(device="cuda").manual_seed(seed)
    state, run, frozen = train_lib.SETUPS[model](cfg, opt, "cuda", dtype)
    params = fill_zero_leaves(state[0], gen)
    frozen = {k: fill_zero_leaves(t, gen) for k, t in frozen.items()}
    if model == "dit":               # the trainer's step on the filled trees
        step = diffusion_loss.make_train_step(
            opt, cfg.dit, cfg.sampler, cfg.tokenizer, cfg.semantic_cond,
            compute_dtype=dtype)

        def run(st, b, g):
            ctrl, o, loss = step(st[0], st[1], frozen["main"], frozen["sem"],
                                 b["latents"], b["context"], b["tokens"], g)
            return (ctrl, o), {"loss": loss}
    return (params, opt.init(params), *state[2:]), frozen, run


def _host(tree):
    from landiff_tpu_torch.utils import tree_map

    return tree_map(lambda x: x.detach().cpu() if hasattr(x, "detach")
                    else x, tree)


def _train_mesh_sp(workdir, mesh):
    """data=1,time=2: one `train --mesh` step of the stage-2 trainer at
    full width and depth in bf16 (remat) against the one-device step on
    the same synthesized batch and the same draws (the step's generator
    seeded alike on every rank); the zero leaves of the inits filled, as
    the train phase does. The one-device step runs first, its loss and
    gradients kept on the host, the card freed before the ranks start."""
    import torch

    from landiff_tpu_torch.config import LanDiffConfig
    from landiff_tpu_torch.models import dit as dit_lib
    from landiff_tpu_torch.models import semantic_cond as sc_lib
    from landiff_tpu_torch.parallel import tp_infer
    from landiff_tpu_torch.training import diffusion_loss, optim
    from landiff_tpu_torch.training import train as train_lib
    from landiff_tpu_torch.utils import fill_zero_leaves

    cfg = LanDiffConfig()
    data = workdir / "mesh_dit_data"
    train_lib.synthesize("dit", cfg, 1, str(data), seed=0, shard_size=1)
    kw = dict(steps=1, batch_size=1, dtype=torch.bfloat16, log_every=1,
              device="cuda")
    orig = (dit_lib.init, sc_lib.init, optim.grad,
            diffusion_loss.mesh_loss_and_grads)
    seen = {}

    def dit_init(gen, c, *, control=False, dtype=torch.float32):
        return fill_zero_leaves(orig[0](gen, c, control=control,
                                        dtype=dtype), gen)

    def sc_init(gen, *a, **k):
        return fill_zero_leaves(orig[1](gen, *a, **k), gen)

    def grad(loss, params):
        grads = orig[2](loss, params)
        seen["one"] = _host(grads)
        return grads

    def mesh_grads(*a, **k):          # rank 0's: summed over time
        loss, grads, draws = orig[3](*a, **k)
        seen["mesh"] = _host(grads)
        return loss, grads, draws

    dit_lib.init, sc_lib.init, optim.grad = dit_init, sc_init, grad
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, last = train_lib.train("dit", str(data), **kw)
        torch.cuda.synchronize()
        one = {"seconds": time.perf_counter() - t0,
               "loss": float(last["loss"]),
               "launches": {k: n for k, n in read_counts().items() if n},
               "peak_gpu_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        optim.grad = orig[2]
        gc.collect()
        torch.cuda.empty_cache()
        diffusion_loss.mesh_loss_and_grads = mesh_grads
        mesh.run(tp_infer.rank_report, True)
        t0 = time.perf_counter()
        _, last = train_lib.train("dit", str(data), mesh_spec=mesh, **kw)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        reports = mesh.run(tp_infer.rank_report, True)
    finally:
        (dit_lib.init, sc_lib.init, optim.grad,
         diffusion_loss.mesh_loss_and_grads) = orig
    gc.collect()
    torch.cuda.empty_cache()
    mesh_loss = float(last["loss"])
    loss_rel = abs(mesh_loss - one["loss"]) / abs(one["loss"])
    check(np.isfinite(mesh_loss) and loss_rel <= MESH_LOSS_REL,
          f"sp step loss {mesh_loss} against {one['loss']}")
    grads = _grad_agreement(seen["mesh"], seen["one"])
    n = mesh.cfg.time
    layers = cfg.dit.num_layers + cfg.dit.control_layers
    diff = one["launches"]["flash_bwd"]
    want = {"flash_bwd": n * diff,
            "flash_fwd_exact": n * one["launches"]["flash_fwd_exact"],
            # the main stream's first layer needs no gradient: its ring
            # takes the inference hops (int8), n instead of one call
            "flash_fwd_int8": one["launches"]["flash_fwd_int8"] - 1 + n}
    shifts = 2 * (n - 1) * (layers + diff) + (4 * n - 2) * diff
    for rep in reports:
        got = {k: c for k, c in rep["launches"].items() if c}
        check(got == want, f"sp step: rank {rep['rank']} launches {got}, "
              f"want {want}")
        check(rep["collectives"]["ring_shift"] == shifts,
              f"sp step: rank {rep['rank']} {rep['collectives']}, "
              f"want {shifts} shifts")
    entry = {"case": "sp", "mesh": "data=1,time=2", "dtype": "bf16",
             "remat": True, "depth": f"{cfg.dit.num_layers} + "
             f"{cfg.dit.control_layers} (full)", "one_device": one,
             "mesh_loss": mesh_loss, "loss_rel_diff": loss_rel,
             "loss_limit": MESH_LOSS_REL, "gradients": grads,
             "grad_limits": {"corr": MESH_GRAD_CORR, "rel": MESH_GRAD_REL},
             "train_call_s": mesh_s,
             "launches_per_rank": [r["launches"] for r in reports],
             "collectives_per_rank": [r["collectives"] for r in reports],
             "max_memory_allocated": [r["max_memory_allocated"]
                                      for r in reports],
             "seconds_note": "ranks time-slice one card: not speed"}
    log(json.dumps({"phase": "train_mesh", **entry}))
    del seen
    return entry


def _mesh_vs_one(mesh, model, cfg, dtype, batches, seed):
    """Two steps of `model` on the mesh (MeshTrainer, train.py's mesh
    path) against train.py's one-device steps from the same filled
    state and generator seeds: losses; dit's first-step gradients (its
    bf16 parameters move by a few bf16 steps, too coarse to compare), else
    the parameter change. Per rank: launches, collectives, parameter and
    optimizer bytes, peak memory."""
    import torch

    from landiff_tpu_torch.parallel import tp_infer
    from landiff_tpu_torch.training import mesh_train, optim
    from landiff_tpu_torch.training import train as train_lib
    from landiff_tpu_torch.utils import tree_map

    opt = train_lib.make_optimizer(**MESH_OPT)
    state, frozen, run = _filled_setup(model, cfg, opt, dtype, seed)
    start = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                     else x, state)
    start_host = _host(state[0])
    seen = {}
    orig = optim.grad
    if model == "dit":

        def grad(loss, params):
            g = orig(loss, params)
            seen.setdefault("one", _host(g))
            return g

        optim.grad = grad
    losses = []
    try:
        for i, b in enumerate(batches):
            state, m = run(state, b, torch.Generator(device="cuda")
                           .manual_seed(seed + i))
            losses.append(float(next(iter(
                v for k, v in m.items() if k in ("loss", "total_loss")))))
    finally:
        if model == "dit":
            optim.grad = orig
    ref = _host(state)
    del state, run
    gc.collect()
    torch.cuda.empty_cache()
    mesh.run(tp_infer.rank_report, True)
    trainer = mesh_train.MeshTrainer(mesh, model, cfg, MESH_OPT, dtype, start,
                                     frozen, keep_grads=model == "dit")
    del start, frozen
    try:
        t0 = time.perf_counter()
        mlosses = []
        for i, b in enumerate(batches):
            m = trainer.step(b, seed + i)
            mlosses.append(float(m.get("loss", m.get("total_loss"))))
            if i == 0 and model == "dit":
                seen["mesh"] = trainer.grads()
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        reports = mesh.run(tp_infer.rank_report, True)
        sizes = trainer.report()
        after = trainer.state()
    finally:
        trainer.close()
    rel = [abs(a - b) / abs(b) for a, b in zip(mlosses, losses)]
    check(all(np.isfinite(mlosses)) and max(rel) <= MESH_LOSS_REL,
          f"{model} on {mesh.cfg}: losses {mlosses} against {losses}")
    entry = {"model": model, "dtype": str(dtype).split(".")[-1],
             "losses": mlosses, "one_device_losses": losses,
             "loss_rel_diff": rel, "seconds": mesh_s,
             "launches_per_rank": [{k: c for k, c in r["launches"].items()
                                    if c} for r in reports],
             "collectives_per_rank": [r["collectives"] for r in reports],
             "bytes_per_rank": sizes,
             "max_memory_allocated": [r["max_memory_allocated"]
                                      for r in reports]}
    if model == "dit":
        entry["gradients"] = _grad_agreement(seen["mesh"], seen["one"])
    else:
        entry["update"] = _update_agreement(after[0], start_host, ref[0],
                                            f"{model} on {mesh.cfg}")
    if model == "vq":
        entry["codebook_max_abs_diff"] = float(
            (after[0]["quant"]["codebook"] - ref[0]["quant"]["codebook"])
            .abs().max())
        check(entry["codebook_max_abs_diff"] <= 1e-3,
              f"vq codebook off one device by "
              f"{entry['codebook_max_abs_diff']}")
    return entry, after


def phase_train_mesh(workdir):
    """Training on meshes whose ranks share the card (ROADMAP item 15b,
    its training half): the ring_bwd, sp, tp and zero cases. Returns the
    per-rank launches of the sp step and the ring_bwd entries."""
    import torch

    from landiff_tpu_torch.config import LanDiffConfig, MeshConfig
    from landiff_tpu_torch.parallel import mesh as mesh_lib
    from landiff_tpu_torch.training import train as train_lib
    from landiff_tpu_torch.training import zero

    t_phase = time.perf_counter()
    out = {}
    mesh = mesh_lib.make_mesh(MeshConfig(time=2), devices=["cuda:0"] * 2)
    try:
        out["ring_bwd"] = {d: _ring_bwd_case(mesh, d, 91 + i)
                           for i, d in enumerate(("bf16", "f32"))}
        out["ring_bwd_plain"] = _ring_bwd_plain_case(mesh, 93)
        out["sp"] = _train_mesh_sp(workdir, mesh)
    finally:
        mesh.close()
    gc.collect()
    torch.cuda.empty_cache()

    full = LanDiffConfig()
    cut = dataclasses.replace(
        full, dit=dataclasses.replace(full.dit, num_layers=2,
                                      control_layers=1),
        llm=dataclasses.replace(full.llm, num_layers=2),
        tokenizer=dataclasses.replace(full.tokenizer, titok=dataclasses
                                      .replace(full.tokenizer.titok,
                                               num_layers=2)))

    def batches(model, n_rows, seed):
        """Two synthesized batches of n_rows (train.synthesize's shapes)."""
        import tempfile as tf

        with tf.TemporaryDirectory(dir=workdir) as d:
            train_lib.synthesize(model, cut, 2 * n_rows, d, seed=seed,
                                 shard_size=2 * n_rows)
            z = np.load(sorted(Path(d).glob("*.npz"))[0])
            return [{k: torch.from_numpy(z[k][i * n_rows:(i + 1) * n_rows])
                     .cuda() for k in z.files} for i in range(2)]

    t0 = time.perf_counter()
    mesh = mesh_lib.make_mesh(MeshConfig(model=2), devices=["cuda:0"] * 2)
    try:
        tp = {}
        for model, dtype in (("dit", torch.bfloat16), ("lm", torch.float32),
                             ("vq", torch.float32)):
            tp[model], _ = _mesh_vs_one(mesh, model, cut, dtype,
                                        batches(model, 1, 5), 101)
            gc.collect()
            torch.cuda.empty_cache()
            log(json.dumps({"phase": "train_mesh", "case": "tp",
                            "mesh": "data=1,model=2", **tp[model]}))
    finally:
        mesh.close()
    out["tp"] = {"depth": "DiT 2 + 1 layers, GPT 2 blocks, TiTok 2 layers",
                 "seconds": time.perf_counter() - t0}
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mesh = mesh_lib.make_mesh(MeshConfig(data=2), devices=["cuda:0"] * 2)
    try:
        opt = train_lib.make_optimizer(**MESH_OPT)
        state, _, _ = _filled_setup("lm", cut, opt, torch.float32, 111)
        want, total = zero.opt_state_bytes_per_device(state[1], 2)
        del state
        entry, _ = _mesh_vs_one(mesh, "lm", cut, torch.float32,
                                batches("lm", 2, 6), 111)
        for r in entry["bytes_per_rank"]:
            check(r["opt_bytes"] == want, f"zero: rank {r['rank']} holds "
                  f"{r['opt_bytes']} optimizer bytes, want {want}")
        entry.update(opt_bytes_per_rank_want=want, opt_bytes_whole=total)
        log(json.dumps({"phase": "train_mesh", "case": "zero",
                        "mesh": "data=2", **entry}))
    finally:
        mesh.close()
    gc.collect()
    torch.cuda.empty_cache()
    out["zero_seconds"] = time.perf_counter() - t0
    log(json.dumps({"phase": "train_mesh",
                    "seconds": time.perf_counter() - t_phase}))
    return out


# the multi-process launch on the one card: two processes started as a
# launcher starts them, each a rank of model=2 (parallel/multihost.py),
# sharing cuda:0 through gloo (all-reduce and all-gather of CUDA tensors,
# the shift's send and receive staged through host memory); the DiT at
# full width, depth cut as phase 8i's model=4 check
MULTIHOST_DEPTH = {"num_layers": 2, "control_layers": 1}
MULTIHOST_SEED = 23


def _multihost_model(cfg):
    """The cut DiT config and its main + control trees (random, zero
    leaves filled) from MULTIHOST_SEED, on the card: the same in every
    process."""
    import torch

    from landiff_tpu_torch.models import dit
    from landiff_tpu_torch.utils import fill_zero_leaves

    cut = dataclasses.replace(cfg.dit, **MULTIHOST_DEPTH)
    gen = torch.Generator(device="cuda").manual_seed(MULTIHOST_SEED)
    return cut, fill_zero_leaves({"main": dit.init(gen, cut),
                                  "control": dit.init(gen, cut, control=True)},
                                 gen)


def _multihost_collectives(ctx) -> dict:
    """The model group's collectives on small CUDA tensors against the
    values they must give: all-gather, all-reduce in bf16, and the ring
    shift both ways (gloo's send and receive, staged through the host).
    Run after the counted call."""
    import torch

    g, r = ctx.model_group, ctx.coords["model"]

    def mine(i):
        return torch.arange(6.0, device=ctx.device).reshape(2, 3) + 10 * i

    total = g.all_reduce(torch.full((5,), 1.0 + r, dtype=torch.bfloat16,
                                    device=ctx.device))
    return {"staged_shift": g.stage,
            "all_gather": bool(torch.equal(
                g.all_gather(mine(r)), torch.cat([mine(0), mine(1)]))),
            "all_reduce_bf16": bool((total == 3.0).all()),
            "shift": bool(torch.equal(g.shift(mine(r)), mine((r - 1) % 2))),
            "shift_reverse": bool(torch.equal(g.shift(mine(r), reverse=True),
                                              mine((r + 1) % 2)))}


def multihost_worker(out_dir: Path):
    """One launched process of phase 14 (chip_smoke.py --multihost-worker
    DIR, MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE / LOCAL_RANK in
    its environment): initialize from the environment, its rank of
    global_mesh(model=2), its shard of the cut DiT, one CFG-batch-2
    model call through tp_infer.model_call, then the collectives' check
    (_multihost_collectives); writes the output to DIR/rank<r>.pt and
    prints "MULTIHOST <json>" (device, backend, launches, collectives,
    the check, seconds)."""
    import torch

    from landiff_tpu_torch.config import LanDiffConfig, MeshConfig
    from landiff_tpu_torch.parallel import mesh as mesh_lib
    from landiff_tpu_torch.parallel import multihost
    from landiff_tpu_torch.parallel import tp_infer

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False      # as main()'s
    torch.backends.cudnn.allow_tf32 = False
    check(multihost.initialize(timeout_s=120), "initialize: one process")
    mesh = multihost.global_mesh(MeshConfig(model=2))
    rank = mesh.rank
    cfg = LanDiffConfig()
    cut, params = _multihost_model(cfg)
    for k in ("main", "control"):       # this rank's shard alone
        mesh_lib.load(mesh, "mh", k, tp_infer.dit_shards(
            params[k], cut, mesh.cfg, mesh.shard_devices,
            dtype=torch.bfloat16))
    del params
    x, sem, ctx = _dit_call_inputs(cfg, 13)
    ts = torch.tensor([500.0, 500.0], device="cuda")
    setup_s = time.perf_counter() - t0
    mesh.run(tp_infer.rank_report, True)
    multihost.barrier("call")
    t0 = time.perf_counter()
    out = mesh.run(tp_infer.model_call, "mh", x, ts, ctx, sem, cut,
                   torch.bfloat16)[0]
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    rep = mesh.run(tp_infer.rank_report, True)[0]
    checks = mesh.run(_multihost_collectives)[0]
    torch.save(out.cpu(), out_dir / f"rank{rank}.pt")
    multihost.barrier("done")
    mesh.close()
    log("MULTIHOST " + json.dumps({
        **{k: rep[k] for k in ("rank", "coords", "backend", "device",
                               "launches", "collectives",
                               "max_memory_allocated")},
        "collective_checks": checks, "setup_s": setup_s, "call_s": call_s,
        "out_mean": float(out.float().mean()),
        "out_abs_mean": float(out.float().abs().mean())}))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_multihost():
    """14. The multi-process launch (parallel/multihost.py): two
    processes of this script (--multihost-worker), started with
    MASTER_ADDR=127.0.0.1, a free MASTER_PORT, RANK 0 / 1, WORLD_SIZE=2,
    LOCAL_RANK=0, both on cuda:0 through gloo; each its rank of
    global_mesh(model=2), its shard of the DiT at full width (15 of 30
    heads) and MULTIHOST_DEPTH, one CFG-batch-2 model call with the int8
    flash kernel. Both outputs bit-equal, within TP_LIMITS of the
    unsharded call run here; per rank 3 int8 launches, nothing else, 6
    all-reduces (an in-process model=2 mesh's counts at that depth); the
    gloo collectives' check true in both (the shift staged). Returns the
    launches per rank."""
    import torch

    from landiff_tpu_torch.config import LanDiffConfig
    from landiff_tpu_torch.models import dit

    t_phase = time.perf_counter()
    cfg = LanDiffConfig()
    cut, params = _multihost_model(cfg)
    x, sem, ctx = _dit_call_inputs(cfg, 13)
    ts = torch.tensor([500.0, 500.0], device="cuda")
    with torch.inference_mode():
        ref = dit.control_warp_forward(params["main"], params["control"],
                                       x, ts, ctx, cut, sem)
    del params, x, sem, ctx
    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2", LOCAL_RANK="0")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mh_") as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--multihost-worker", tmp], env={**env, "RANK": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        try:
            texts = [p.communicate(timeout=240)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        workers_s = time.perf_counter() - t0
        for r, (p, text) in enumerate(zip(procs, texts)):
            check(p.returncode == 0, f"multihost: process {r} exited "
                  f"{p.returncode}:\n{text[-3000:]}")
        reports = [json.loads(next(ln for ln in t.splitlines()
                                   if ln.startswith("MULTIHOST "))[10:])
                   for t in texts]
        outs = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(2)]
    check([r["rank"] for r in reports] == [0, 1], f"ranks {reports}")
    for rep in reports:
        check(rep["device"] == "cuda:0" and rep["backend"] == "gloo",
              f"multihost: rank {rep['rank']} on {rep['device']} "
              f"({rep['backend']})")
        check(all(rep["collective_checks"].values()),
              f"multihost: rank {rep['rank']}'s collectives "
              f"{rep['collective_checks']}")
    check(torch.equal(outs[0], outs[1]), "multihost: the ranks' outputs "
          "differ")
    _check_tp_ranks(reports, sum(MULTIHOST_DEPTH.values()), "multihost")
    out = {"phase": "multihost", "mesh": "model=2",
           "layout": "2 launched processes sharing cuda:0 over gloo (the "
                     "shift staged through host memory); times are not "
                     "speed readings",
           "depth": "2 + 1 DiT layers", "heads_per_rank": 15,
           "drift": _tp_drift(ref, outs[0].cuda(), "multihost"),
           "ranks_equal": True, "workers_s": workers_s,
           "ranks": reports, "seconds": time.perf_counter() - t_phase}
    log(json.dumps(out))
    return [r["launches"]["flash_fwd_int8"] for r in reports]


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
    ap.add_argument("--steps", type=int, default=2,
                    help="denoise steps per request (the release uses 50)")
    ap.add_argument("--only", choices=("flash_fwd", "flash_bwd", "f32",
                                       "stage1_batch", "long_video", "ckpt",
                                       "train", "tokenizer", "variants",
                                       "serving", "tp", "sp", "train_mesh",
                                       "multihost", "qkv_prep"),
                    help="build, then only this kernel's cases at the "
                         "main-path shapes, or only the batched decoding "
                         "check at full width (no pipeline, no last "
                         "line)")
    ap.add_argument("--multihost-worker", metavar="DIR", type=Path,
                    help=argparse.SUPPRESS)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one denoise-step model call, without "
                         "and with the adaLN knob, and 20 decode steps")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run "
                         "needs an NVIDIA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if args.multihost_worker:
        multihost_worker(args.multihost_worker)
        return
    from landiff_tpu_torch.ops import kernels

    t_start = time.perf_counter()
    # 1. device
    smi = [nvidia_smi()]
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
        phase_dit_call_f32()
        return
    if args.only == "long_video":
        cfg, llm, dif = build_full(args.steps)
        phase_long_video(cfg, llm, dif, args.steps)
        return
    if args.only == "serving":
        cfg, llm, dif = build_full(args.steps)
        with gpt_depth(llm, GPT_CUT):
            phase_serving(cfg, llm, dif, args.steps)
        return
    if args.only == "tp":
        cfg, llm, dif = build_full(args.steps)
        phase_tp(cfg, llm, dif)
        return
    if args.only == "sp":
        phase_sp(args.steps)
        return
    if args.only == "multihost":
        phase_multihost()
        return
    if args.only == "train_mesh":
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            phase_train_mesh(Path(tmp))
        return
    if args.only in ("ckpt", "train"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            if args.only == "ckpt":
                phase_ckpt(Path(tmp), args.steps)
            else:
                phase_train_dit(Path(tmp))
                phase_train_rotary3d(Path(tmp))
                phase_train_dit(Path(tmp), "f32", steps=2)
        return
    if args.only == "stage1_batch":
        phase_stage1_batch()
        return
    if args.only == "tokenizer":
        phase_encoder_mask(exp2_rates())
        phase_tokenize()
        phase_vae_encode()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            phase_train_vq(Path(tmp))
            phase_prepare(Path(tmp))
        cfg, llm, dif = build_full(args.steps)
        phase_prefix(cfg, dif, args.steps)
        return
    if args.only == "variants":
        cfg, llm, dif = build_full(args.steps)
        phase_rotary3d(cfg, dif.params)
        codes = np.random.default_rng(41).integers(
            0, cfg.tokenizer.vq.codebook_size,
            cfg.tokenizer.titok.latent_tokens)
        phase_samplers(cfg, dif, codes, args.steps)
        return
    if args.only == "flash_bwd":
        bwd = phase_bwd_kernel(titok_decoder_mask(), exp2_rates()[False])
        log(json.dumps({"flash_bwd": bwd_entry(bwd, None)}))
        return
    if args.only == "qkv_prep":
        log(json.dumps({"qkv_prep": qkv_prep_entry(phase_qkv_prep(),
                                                   None)}))
        return
    # 3. kernels
    fwd_reports = check_fwd_ptxas()
    measured = phase_kernels()
    dec_mask = measured.pop("dec_mask")
    direct_launches = phase_direct(dec_mask)
    adaln = phase_adaln()
    qkv = phase_qkv_prep()
    # 3b. the drift gates; 3c. the f32 kernels
    drift = phase_drift()
    rates = measured.pop("rates")
    f32 = phase_f32(dec_mask, rates)
    f32_direct_launches = phase_direct_f32()
    # 3d. the kernels under the TiTok encoder's mask
    enc = phase_encoder_mask(rates)
    # 4. the pipeline; 5. prompt -> codes -> video; 6. stage 2 alone
    cfg, llm, dif = build_full(args.steps)
    video_launches, video_codes, _ = phase_video(
        cfg, llm, dif, args.steps)
    # 5b. Rotary3D model calls; 5c. the other samplers from those codes
    rotary_launches = phase_rotary3d(cfg, dif.params)
    sampler_launches = phase_samplers(cfg, dif, video_codes, args.steps)
    phase_batch_f32()
    stage2_launches = phase_stage2(cfg, dif, args.steps)
    # 6b. image to video: a prefix frame through the VAE encoder
    prefix_launches = phase_prefix(cfg, dif, args.steps)
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
    # 8h. the serving engine and its HTTP server, the offload, the trace
    with gpt_depth(llm, GPT_CUT):
        serving_launches = phase_serving(cfg, llm, dif, args.steps)
    # 8i. tensor-parallel inference, ranks sharing the card (their trees
    # leave the card: llm / dif are not used after this)
    tp_launches = phase_tp(cfg, llm, dif)
    del llm, dif
    gc.collect()
    torch.cuda.empty_cache()
    # 8j. sequence / context-parallel inference, ranks sharing the card
    sp_launches = phase_sp(args.steps)
    # 8f. video -> codes; 8g. video -> VAE latents
    tokenize_launches = phase_tokenize()
    phase_vae_encode()
    # 8e. one full-width f32 DiT model call
    f32_call_launches = phase_dit_call_f32()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 8d. a synthetic checkpoint tree through build_pipeline, in f32
        ckpt_launches = phase_ckpt(Path(tmp), args.steps)
        # 9. the stage-2 trainer in bf16 (and LANDIFF_REMAT_SAVE_ATTN),
        # 9b. in f32; 10. the stage-1 trainer
        train_launches = phase_train_dit(Path(tmp))
        gc.collect()
        torch.cuda.empty_cache()
        # 9a. two stage-2 steps under Rotary3D
        rotary_train_launches = phase_train_rotary3d(Path(tmp))
        gc.collect()
        torch.cuda.empty_cache()
        f32_train_launches = phase_train_dit(Path(tmp), "f32", steps=2)
        gc.collect()
        torch.cuda.empty_cache()
        phase_train_lm(Path(tmp))
        # 11. the tokenizer trainer; 12. data preparation
        gc.collect()
        torch.cuda.empty_cache()
        vq_launches = phase_train_vq(Path(tmp))
        phase_prepare(Path(tmp))
        # 13. training on meshes of ranks sharing the card
        gc.collect()
        torch.cuda.empty_cache()
        train_mesh = phase_train_mesh(Path(tmp))
    # 14. the multi-process launch: two processes, ranks of model=2
    gc.collect()
    torch.cuda.empty_cache()
    multihost_launches = phase_multihost()

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
    rows.append(qkv_prep_entry(qkv, video_launches["qkv_prep"]))
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
            rows[-1]["launches_dit_call_f32"] = \
                f32_call_launches["flash_fwd_int8_f32"]
    # the encoder-mask holds, and the launches on this slice's paths
    by_name = {r["name"]: r for r in rows}
    for name, case in enc.items():
        by_name[name]["titok_enc"] = enc_entry(case)
    by_name["flash_fwd_int8"]["launches_tokenize"] = \
        tokenize_launches["flash_fwd_int8"]
    by_name["flash_fwd_int8"]["launches_prefix_video"] = \
        prefix_launches["flash_fwd_int8"]
    by_name["flash_fwd_int8"]["launches_serving"] = \
        serving_launches["flash_fwd_int8"]
    by_name["flash_fwd_int8"]["launches_tp_model_call_per_rank"] = \
        tp_launches
    # per rank under time=2 (the ring's hops), model=2,time=2 at 2 + 1
    # layers, and the ring alone in each form
    by_name["flash_fwd_int8"]["launches_sp_model_call_per_rank"] = \
        sp_launches["model_call"]
    by_name["flash_fwd_int8"]["launches_sp_request_per_rank"] = \
        sp_launches["request"]
    by_name["flash_fwd_int8"]["launches_tpsp_call_per_rank"] = \
        sp_launches["tpsp/bf16"]
    for name, n in sp_launches["ring"].items():
        by_name[name]["launches_sp_ring_per_rank"] = n
    by_name["flash_fwd_int8"]["launches_multihost_per_rank"] = \
        multihost_launches
    by_name["flash_fwd_int8"]["launches_rotary3d_call"] = \
        rotary_launches["flash_fwd_int8"]
    by_name["flash_fwd_int8"]["launches_samplers"] = {
        name: n["flash_fwd_int8"] for name, n in sampler_launches.items()}
    for name in ("flash_bwd", "flash_fwd_exact"):
        by_name[name]["launches_train_rotary3d_step"] = \
            rotary_train_launches[name]
        # per rank of the data=1,time=2 stage-2 step: the ring's hops
        by_name[name]["launches_train_mesh_sp_per_rank"] = [
            r[name] for r in train_mesh["sp"]["launches_per_rank"]]
    by_name["flash_bwd"]["ring_bwd"] = train_mesh["ring_bwd"]["bf16"]
    by_name["flash_bwd"]["ring_bwd_vs_plain_ring"] = \
        train_mesh["ring_bwd_plain"]
    by_name["flash_bwd_f32"]["ring_bwd"] = train_mesh["ring_bwd"]["f32"]
    for name in ("flash_fwd_exact_f32", "flash_bwd_f32"):
        by_name[name]["launches_train_vq"] = sum(
            step.get(name, 0) for step in vq_launches)
    log(json.dumps({"phase": "done",
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
