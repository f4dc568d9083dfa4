"""End-to-end entry point: prompt -> semantic tokens -> video (counterpart
of landiff_tpu/pipeline/infer_video.py).

    python -m landiff_tpu_torch.pipeline.infer_video --prompt "..." --tiny --device cpu

Reference: landiff/infer_video.py (main :105-114, llm_infer :61-86,
infer_diffusion :89-102). Both stages live on the device at once. `--tiny`
runs the whole pipeline with a tiny random-init config (no checkpoints).
`run` is split in two: `generate` computes (stage 1, then stage 2) and
`run` builds the pipeline, calls it and writes `<stem>_codes.npy` and the
video file. A checkpoint tree (`ckpt_dir`, or the resolved LANDIFF_HOME /
<repo>/ckpts/LanDiff in `main`) is loaded through ckpt/load.py; a prompt
of more than one segment (`--num-frames 26`: two) streams through
pipeline/long_video.py. Not ported yet: device meshes (ROADMAP item 15)
and LANDIFF_OFFLOAD (item 16).
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from pathlib import Path

import numpy as np
import torch

from landiff_tpu_torch.config import ARSampleConfig, LanDiffConfig, \
    tiny_test_config
from landiff_tpu_torch.diffusion import engine
from landiff_tpu_torch.pipeline import dif_infer, llm_infer, long_video
from landiff_tpu_torch.utils import save_video_tensor, seed_from_text

logger = logging.getLogger("landiff_tpu_torch.infer_video")


def build_pipeline(cfg: LanDiffConfig, sample_cfg: ARSampleConfig,
                   seed: int = 0, ckpt_dir: str | None = None,
                   compute_dtype=torch.bfloat16, mesh=None, device="cuda",
                   require_real_tokenizer: bool | None = None):
    """Returns (llm_wrapper, dif_wrapper). With a checkpoint dir, the
    converted weights of that tree (ckpt/load.py) and the T5 tokenizer
    directory found in it; otherwise random-init parameters made from
    `seed` on `device`. require_real_tokenizer (default: whether a
    checkpoint is loaded, as JAX's :56-62) makes a missing tokenizer an
    error; a caller that loads a tree without tokenizer files (a
    synthetic one) passes False and gets the byte-level fallback."""
    if mesh is not None:
        raise NotImplementedError(
            "device meshes are not ported yet: ROADMAP item 15")
    if require_real_tokenizer is None:
        require_real_tokenizer = ckpt_dir is not None
    # stage 1 first: its wrapper keeps the compute-dtype copy of the large
    # matrices and the f32 originals are freed before stage 2 is built
    tok_dir = None
    if ckpt_dir is not None:
        from landiff_tpu_torch.ckpt import load as ckpt_load

        tok_dir = ckpt_load.tokenizer_dir(ckpt_dir)
        llm_params = ckpt_load.load_stage1(ckpt_dir, cfg, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        llm_params = llm_infer.init_params(gen, cfg.llm, cfg.t5)
    llm = llm_infer.ArModelInferWrapper(
        llm_params, cfg.llm, cfg.t5, sample_cfg, tokenizer_dir=tok_dir,
        compute_dtype=compute_dtype,
        require_real_tokenizer=require_real_tokenizer, device=device)
    del llm_params
    dif_params = (ckpt_load.load_stage2(ckpt_dir, cfg, device=device)
                  if ckpt_dir is not None else dif_infer.init_params(gen, cfg))
    dif = dif_infer.CogModelInferWrapper(
        dif_params, cfg, tokenizer_dir=tok_dir, compute_dtype=compute_dtype,
        require_real_tokenizer=require_real_tokenizer, device=device)
    return llm, dif


def file_stem(prompt: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in prompt[:48])


def generate(llm, dif, prompt: str, seed: int = 42, fps: int = 8) -> dict:
    """The computing half of `run`: stage 1 (prompt -> codes, drawn from
    the stage-1 wrapper's sample_cfg.seed), then stage 2 (codes -> video,
    from `seed`). Returns {"codes", "video", "latent", "stage1_s",
    "stage2_s", "stage2_phases"}; the seconds are host seconds
    synchronised on the device. Codes of more than one segment take the
    long-video path (JAX :96-135): per-segment denoising with a prefix of
    min(7, latent_frames - 1) latent frames and one streaming decode;
    its phases are t5, one entry per segment and vae."""
    cfg = dif.cfg
    stem = file_stem(prompt)

    def now():
        if dif.device.type == "cuda":
            torch.cuda.synchronize(dif.device)
        return time.perf_counter()

    t0 = now()
    code_task = llm(llm_infer.CodeTask(save_file_name=f"{stem}.npy",
                                       prompt=prompt))
    t1 = now()
    logger.info("stage 1: %d codes in %.1fs", len(code_task.result), t1 - t0)

    seg_tokens = cfg.tokenizer.titok.latent_tokens
    if len(code_task.result) // seg_tokens > 1:
        video_task, phases = _generate_long(dif, code_task, prompt, seed,
                                            fps, stem, now)
    else:
        video_task = dif(dif_infer.VideoTask(
            save_file_name=f"{stem}.mp4", prompt=prompt, seed=seed, fps=fps,
            semantic_token=code_task.result))
        phases = dict(dif.phase_seconds)
    t2 = now()
    logger.info("stage 2: video %s in %.1fs", video_task.result.shape,
                t2 - t1)
    return {"codes": code_task.result, "video": video_task.result,
            "latent": video_task.latent, "stage1_s": t1 - t0,
            "stage2_s": t2 - t1, "stage2_phases": phases}


def _generate_long(dif, code_task, prompt: str, seed: int, fps: int,
                   stem: str, now):
    """Stage 2 of a multi-segment request (JAX infer_video.py:96-135)."""
    if os.environ.get("LANDIFF_OFFLOAD") == "1":
        raise NotImplementedError(
            "LANDIFF_OFFLOAD (moving the diffusion parameters off the "
            "device before the decode) is not ported yet: ROADMAP item 16")
    cfg = dif.cfg
    phases = {}
    t0 = now()
    with torch.inference_mode():
        context = dif.encode_text(prompt)
        t = phases["t5"] = now() - t0
        marks = [now()]

        def on_segment(i, _):
            marks.append(now())
            phases[f"segment_{i}"] = marks[-1] - marks[-2]

        gen = torch.Generator(device=dif.device).manual_seed(
            seed_from_text(prompt, seed))
        # the reference's chunking: a 7-latent prefix out of 13 (yaml:213),
        # clamped for small configurations
        latents = long_video.generate_long_video_latents(
            dif.params, cfg, context, torch.zeros_like(context),
            code_task.result, generator=gen,
            prefix_latents=min(7, cfg.dit.latent_frames - 1),
            compute_dtype=dif.compute_dtype, on_segment=on_segment)
        t = now()
        video = engine.decode_first_stage(dif.params["vae"], latents,
                                          cfg.vae,
                                          compute_dtype=dif.compute_dtype)
        vid8 = engine.video_to_uint8(engine.post_process_video(video))
        vid8 = vid8.cpu().numpy()
        phases["vae"] = now() - t
    task = dif_infer.VideoTask(
        save_file_name=f"{stem}.mp4", prompt=prompt, seed=seed, fps=fps,
        semantic_token=code_task.result,
        result=vid8.astype(np.float32) / 255.0,
        latent=latents.float().cpu().numpy())
    return task, phases


def run(prompt: str, output_dir: str = "results", seed: int = 42,
        cfg_scale: float = 7.5, motion_score: float = 0.1,
        num_frames: int = 13, tiny: bool = False,
        ckpt_dir: str | None = None, fps: int = 8,
        mesh_spec: str | None = None, device="cuda"):
    if mesh_spec:
        raise NotImplementedError(
            "device meshes are not ported yet: ROADMAP item 15")
    cfg = tiny_test_config() if tiny else LanDiffConfig()
    if tiny and num_frames % cfg.llm.frames_per_segment != 0:
        # tiny config uses a smaller segment; map "one segment" semantics
        num_frames = cfg.llm.frames_per_segment
    sample_cfg = ARSampleConfig(cfg_scale=cfg_scale,
                                motion_score=motion_score,
                                num_frames=num_frames, seed=seed)
    dtype = torch.float32 if tiny else torch.bfloat16
    llm, dif = build_pipeline(cfg, sample_cfg, seed, ckpt_dir,
                              compute_dtype=dtype, device=device)
    res = generate(llm, dif, prompt, seed, fps)

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    stem = file_stem(prompt)
    np.save(out / f"{stem}_codes.npy", res["codes"])
    res["video_path"] = save_video_tensor(res["video"][0],
                                          str(out / f"{stem}.mp4"), fps)
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="LanDiff text-to-video (PyTorch / CUDA port)")
    parser.add_argument("--prompt", required=True)
    parser.add_argument("--output-dir", default="results")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--cfg-scale", type=float, default=7.5)
    parser.add_argument("--motion-score", type=float, default=0.1)
    parser.add_argument("--num-frames", "--num_frames", type=int, default=13,
                        help="semantic frames (13 -> 49 RGB)")
    parser.add_argument("--ckpt-dir", "--ckpt_dir", default=None,
                        help="converted checkpoint dir (default: "
                             "LANDIFF_HOME, then <repo>/ckpts/LanDiff)")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny random-init config (no ckpts; smoke)")
    parser.add_argument("--fps", type=int, default=8)
    parser.add_argument("--mesh", default=None,
                        help="device mesh (not ported yet)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of both stages (cuda, cpu)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    ckpt_dir = args.ckpt_dir
    if ckpt_dir is None and not args.tiny \
            and os.environ.get("LANDIFF_SKIP_INIT") != "1":
        from landiff_tpu_torch.ckpt import resolve

        ckpt_dir = resolve.initialize_model_path(required=False)
        if ckpt_dir is None:
            logger.warning("no checkpoints found; running random-init "
                           "(output will be noise): pass --tiny for smoke")
    res = run(args.prompt, args.output_dir, args.seed, args.cfg_scale,
              args.motion_score, args.num_frames, args.tiny, ckpt_dir,
              args.fps, mesh_spec=args.mesh, device=args.device)
    print(f"stage1 {res['stage1_s']:.1f}s stage2 {res['stage2_s']:.1f}s "
          f"video {res['video'].shape} -> {res['video_path']}")
    return res


if __name__ == "__main__":
    main()
