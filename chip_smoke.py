#!/usr/bin/env python3
"""Drive the PyTorch port (landiff_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # 4 denoise steps per request
    python3 chip_smoke.py --steps 50   # the released sampler's 50 steps

Phases, in order; any failure exits nonzero before the last line:
  1. device:  the card's name and power limit; TF32 off for matmuls and
              convolutions, printed.
  2. build:   nvcc builds every kernel from the checkout's sources, one
              process per source, started together.
  3. kernels: each flash kernel against its plain PyTorch version at the
              two main-path shapes (DiT: B=2 S=17,776 H=30 D=64 unmasked;
              TiTok decoder: B=1 S=18,768 H=12 D=64, video-decoder mask),
              with times, bounds and the SDPA yardstick; the fused adaLN
              kernel against its plain version at the DiT shape
              (2, 17,776, 1,920) bf16 with text_len 226, at a ragged shape
              and with f32 I/O, with its time beside the unfused chain's.
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
  (--profile: one warm denoise-step model call, without and with the knob,
   and 20 stage-1 decode steps, under torch.profiler.)
Then one JSON line with every kernel's numbers, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
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

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit)
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12
# SFU exp2 co-bound: 16 MUFU results per SM per clock, 132 SMs, 1.98 GHz
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


def kernel_case(name, B, S, H, mask_fn, int8, seed):
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
    fn = A.flash_fwd_int8 if int8 else A.flash_fwd_exact
    plain = A.flash_int8_plain if int8 else A.flash_exact_plain

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

    library_ms = None
    if not int8:
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
    ops_s = (flops / 2 / PEAK_INT8 + flops / 2 / PEAK_BF16 if int8
             else flops / PEAK_BF16)
    nbytes = 4 * B * S * H * D * 2 + B * H * S * 4   # q k v in, out + lse
    bytes_s = nbytes / PEAK_BYTES
    res = {
        "case": name, "shape": [B, S, H, D],
        "mask": None if mask_fn is None else type(mask_fn).__name__
        + f"(kind={mask_fn.descriptor()[0]})",
        "visible_pairs": visible, "max_abs_err": err,
        "max_bf16_steps": steps, "rel_rms_err": rel_rms,
        "lse_max_abs_err": lse_err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(ops_s, bytes_s) * 1e3,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "exp2_bound_ms": B * H * visible / PEAK_EXP2 * 1e3,
        "tflops": flops / (ms * 1e-3) / 1e12,
    }
    kname = "flash_fwd_int8" if int8 else "flash_fwd_exact"
    log(json.dumps({"kernel": kname, **res}))
    res["faults"] = [f"{kname} {name}: {what}" for ok, what in (
        (finite, "output not finite"),
        (steps <= KERNEL_TOL_STEPS, f"max |err| {steps} bf16 steps"),
        (rel_rms <= KERNEL_TOL_RMS, f"relative RMS error {rel_rms}"),
        (lse_err <= LSE_TOL, f"lse error {lse_err}")) if not ok]
    del q, k, v, out, ref, lse, ref_lse
    torch.cuda.empty_cache()
    return res


def phase_kernels():
    from landiff_tpu_torch.config import TiTokConfig
    from landiff_tpu_torch.ops import masks as M

    t = TiTokConfig()
    layout = M.VideoMaskLayout(num_frames=t.temporal_size,
                               tokens_per_frame=t.frame_tokens,
                               iframe_tokens=t.iframe_latent_tokens,
                               pframe_tokens=t.pframe_latent_tokens)
    check(layout.seq_len == 18768, f"TiTok sequence {layout.seq_len}")
    dec = M.video_decoder_mask(layout)
    results = {}
    for kname, int8 in (("flash_fwd_exact", False), ("flash_fwd_int8", True)):
        dit = kernel_case("dit", 2, 17776, 30, None, int8, seed=1)
        titok = kernel_case("titok_dec", 1, 18768, 12, dec, int8, seed=2)
        results[kname] = (dit, titok)
    faults = [f for dit, titok in results.values()
              for f in dit["faults"] + titok["faults"]]
    check(not faults, "kernel vs plain: " + "; ".join(faults))
    return results


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
    from landiff_tpu_torch.ops import adaln as N
    from landiff_tpu_torch.ops import attention as A

    return {"flash_fwd_int8": A.flash_fwd_int8.launches,
            "flash_fwd_exact": A.flash_fwd_exact.launches,
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
        launches = A.flash_fwd_exact.launches
    finally:
        os.environ.pop("LANDIFF_ATTN_INT8")
    check(launches == 45, f"exact launches {launches}, want 45")
    check(A.flash_fwd_int8.launches == 0, "int8 kernel ran with int8 off")
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4,
                    help="denoise steps per request (the release uses 50)")
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

    # 3. kernels
    measured = phase_kernels()
    adaln = phase_adaln()
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
    del llm, dif
    torch.cuda.empty_cache()

    rows = []
    for kname, launches, replaces in (
            ("flash_fwd_exact", exact_launches,
             "landiff_tpu/ops/attention.py:91 _flash_kernel, "
             ":197 _flash_kernel_cached"),
            ("flash_fwd_int8", video_launches["flash_fwd_int8"],
             "landiff_tpu/ops/attention.py:264 _flash_kernel_cached_i8")):
        dit, titok = measured[kname]
        check(launches > 0, f"{kname} never launched on its path")
        rows.append({
            "name": kname, "route": "cuda",
            "source": "landiff_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": dit["max_abs_err"], "ms": dit["ms"],
            "plain_ms": dit["plain_ms"], "bound_ms": dit["bound_ms"],
            "bound_by": dit["bound_by"], "library_ms": dit["library_ms"],
            "shape": dit["shape"], "titok_dec": titok})
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
    log(json.dumps({"phase": "done",
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
