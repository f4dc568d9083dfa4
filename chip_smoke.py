#!/usr/bin/env python3
"""Drive the PyTorch port (landiff_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # 4 denoise steps per request
    python3 chip_smoke.py --steps 50   # the released sampler's 50 steps

Phases, in order; any failure exits nonzero before the last line:
  1. device:  the card's name and power limit; TF32 off for matmuls and
              convolutions, printed.
  2. build:   nvcc builds every kernel from the checkout's sources.
  3. kernels: each flash kernel against its plain PyTorch version at the
              two main-path shapes (DiT: B=2 S=17,776 H=30 D=64 unmasked;
              TiTok decoder: B=1 S=18,768 H=12 D=64, video-decoder mask),
              with times, bounds and the SDPA yardstick.
  4. main:    full-width LanDiffConfig() stage 2 (random weights from a
              seed, zero gates filled): two requests, each prompt + seed +
              1,218 codes -> (1, 3, 49, 480, 720) video; the int8 kernel
              must launch 12 + 45 * steps times per request.
  5. exact:   one full-width control_warp_forward with int8 scores off;
              the exact kernel must launch 45 times.
  (--profile: one warm denoise-step model call under torch.profiler.)
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


# ---------------------------------------------------------------------------
# phase 4 / 5: full width


def build_full(steps):
    import torch

    from landiff_tpu_torch.config import LanDiffConfig
    from landiff_tpu_torch.pipeline import dif_infer
    from landiff_tpu_torch.utils import count_params, fill_zero_leaves

    cfg = LanDiffConfig()
    cfg = dataclasses.replace(
        cfg, sampler=dataclasses.replace(cfg.sampler, num_steps=steps))
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = fill_zero_leaves(dif_infer.init_params(gen, cfg), gen)
    torch.cuda.synchronize()
    log(json.dumps({
        "phase": "init", "seconds": time.perf_counter() - t0,
        "params": {k: count_params(v) for k, v in params.items()},
        "gpu_mem_gb": torch.cuda.memory_allocated() / 1e9}))
    return cfg, params


def phase_main(cfg, params, steps):
    import torch

    from landiff_tpu_torch.ops import attention as A
    from landiff_tpu_torch.pipeline import dif_infer

    wrapper = dif_infer.CogModelInferWrapper(params, cfg, device="cuda")
    requests = [("a corgi running along a beach at sunset", 1),
                ("a paper boat drifting down a rainy street", 2)]
    per_request = 12 + 45 * steps
    A.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    for i, (prompt, seed) in enumerate(requests):
        codes = np.random.default_rng(seed).integers(
            0, cfg.tokenizer.vq.codebook_size,
            cfg.tokenizer.titok.latent_tokens)
        t0 = time.perf_counter()
        task = wrapper(dif_infer.VideoTask(f"req{i}", prompt, seed,
                                           semantic_token=codes))
        seconds = time.perf_counter() - t0
        video = task.result
        check(video.shape == (1, 3, 49, 480, 720), f"video {video.shape}")
        check(bool(np.isfinite(video).all()), "video not finite")
        check(video.min() >= 0.0 and video.max() <= 1.0, "video range")
        check(task.latent.shape == (1, 13, 16, 60, 90),
              f"latent {task.latent.shape}")
        check(bool(np.isfinite(task.latent).all()), "latent not finite")
        check(float(video.std()) > 0.0, "video is constant")
        check(A.flash_fwd_int8.launches == (i + 1) * per_request,
              f"int8 launches {A.flash_fwd_int8.launches}, want "
              f"{(i + 1) * per_request}")
        log(json.dumps({
            "phase": "main", "request": i, "warm": i > 0,
            "seconds": seconds, "phase_seconds": wrapper.phase_seconds,
            "video_mean": float(video.mean()),
            "video_std": float(video.std()),
            "int8_launches_so_far": A.flash_fwd_int8.launches}))
    launches = {"flash_fwd_int8": A.flash_fwd_int8.launches,
                "flash_fwd_exact": A.flash_fwd_exact.launches}
    check(launches["flash_fwd_exact"] == 0,
          "exact kernel ran on the int8 path")
    log(json.dumps({"phase": "main", "launches": launches,
                    "peak_gpu_mem_gb": torch.cuda.max_memory_allocated()
                    / 1e9}))
    return launches["flash_fwd_int8"]


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


def phase_profile(cfg, params):
    """One warm denoise-step model call (control_warp_forward, CFG batch
    2, the default int8 path) under torch.profiler: device time by kernel
    class and the device's busy share of the call's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    with torch.inference_mode():
        fwd()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        log(json.dumps({"phase": "profile", "wall_ms": wall_ms,
                        "device_ms": "not measured"}))
        return

    def kind(name):
        low = name.lower()
        if "flash_fwd_kernel" in low:
            return "flash_attention"
        if any(t in low for t in ("gemm", "xmma", "cutlass", "sm90_",
                                  "nvjet")):
            return "gemm"
        if "conv" in low:
            return "conv"
        return "elementwise_norm_other"

    by_kind = {}
    for e in kernels:
        k = kind(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + e.self_device_time_total / 1e3
    device_ms = sum(by_kind.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    log(json.dumps({
        "phase": "profile", "what": "one control_warp_forward, CFG batch 2",
        "wall_ms": wall_ms, "device_ms": device_ms,
        "busy_share": device_ms / wall_ms, "by_kind_ms": by_kind,
        "top": [{"kernel": e.key[:90], "ms": e.self_device_time_total / 1e3,
                 "calls": e.count} for e in top]}))


# ---------------------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4,
                    help="denoise steps per request (the release uses 50)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one denoise-step model call")
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
    lib = kernels.build()
    report = [line.strip() for line in
              lib.with_suffix(".log").read_text().splitlines()
              if "registers" in line or "spill" in line]
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                    "library": lib.name, "ptxas": report}))

    # 3. kernels
    measured = phase_kernels()
    # 4. main path, 5. exact path
    cfg, params = build_full(args.steps)
    int8_launches = phase_main(cfg, params, args.steps)
    exact_launches = phase_exact(cfg, params)
    if args.profile:
        phase_profile(cfg, params)
    del params
    torch.cuda.empty_cache()

    rows = []
    for kname, launches, replaces in (
            ("flash_fwd_exact", exact_launches,
             "landiff_tpu/ops/attention.py:91 _flash_kernel, "
             ":197 _flash_kernel_cached"),
            ("flash_fwd_int8", int8_launches,
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
    log(json.dumps({"phase": "done",
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
