"""End-to-end entry point: prompt -> semantic tokens -> video (counterpart
of landiff_tpu/pipeline/infer_video.py).

    python -m landiff_tpu_torch.pipeline.infer_video --prompt "..." --tiny --device cpu

Reference: landiff/infer_video.py (main :105-114, llm_infer :61-86,
infer_diffusion :89-102). Both stages live on the device at once. `--tiny`
runs the whole pipeline with a tiny random-init config (no checkpoints).
`run` is split in two: `generate` computes (stage 1, then stage 2) and
`run` builds the pipeline, calls it and writes `<stem>_codes.npy` and the
video file. Not ported yet: checkpoints (`ckpt_dir`), device meshes and
videos of more than one segment.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np
import torch

from landiff_tpu_torch.config import ARSampleConfig, LanDiffConfig, \
    tiny_test_config
from landiff_tpu_torch.pipeline import dif_infer, llm_infer
from landiff_tpu_torch.utils import save_video_tensor

logger = logging.getLogger("landiff_tpu_torch.infer_video")


def build_pipeline(cfg: LanDiffConfig, sample_cfg: ARSampleConfig,
                   seed: int = 0, ckpt_dir: str | None = None,
                   compute_dtype=torch.bfloat16, mesh=None, device="cuda"):
    """Returns (llm_wrapper, dif_wrapper) with random-init parameters made
    from `seed` on `device`."""
    if ckpt_dir is not None:
        raise NotImplementedError(
            "loading converted checkpoints is not ported yet: ROADMAP "
            "item 10")
    if mesh is not None:
        raise NotImplementedError(
            "device meshes are not ported yet: ROADMAP item 15")
    gen = torch.Generator(device=device).manual_seed(seed)
    # stage 1 first: its wrapper keeps the compute-dtype copy of the large
    # matrices and the f32 originals are freed before stage 2 is built
    llm = llm_infer.ArModelInferWrapper(
        llm_infer.init_params(gen, cfg.llm, cfg.t5), cfg.llm, cfg.t5,
        sample_cfg, compute_dtype=compute_dtype, device=device)
    dif = dif_infer.CogModelInferWrapper(
        dif_infer.init_params(gen, cfg), cfg, compute_dtype=compute_dtype,
        device=device)
    return llm, dif


def file_stem(prompt: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in prompt[:48])


def generate(llm, dif, prompt: str, seed: int = 42, fps: int = 8) -> dict:
    """The computing half of `run`: stage 1 (prompt -> codes, drawn from
    the stage-1 wrapper's sample_cfg.seed), then stage 2 (codes -> video,
    from `seed`). Returns {"codes", "video", "stage1_s", "stage2_s"}; the
    seconds are host seconds synchronised on the device."""
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
        raise NotImplementedError(
            "videos of more than one segment (long-video streaming) are "
            "not ported yet: ROADMAP item 11")
    video_task = dif(dif_infer.VideoTask(
        save_file_name=f"{stem}.mp4", prompt=prompt, seed=seed, fps=fps,
        semantic_token=code_task.result))
    t2 = now()
    logger.info("stage 2: video %s in %.1fs", video_task.result.shape,
                t2 - t1)
    return {"codes": code_task.result, "video": video_task.result,
            "stage1_s": t1 - t0, "stage2_s": t2 - t1}


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
    parser.add_argument("--num-frames", type=int, default=13,
                        help="semantic frames (13 -> 49 RGB)")
    parser.add_argument("--ckpt-dir", default=None,
                        help="converted checkpoint dir (not ported yet)")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny random-init config (no ckpts; smoke)")
    parser.add_argument("--fps", type=int, default=8)
    parser.add_argument("--mesh", default=None,
                        help="device mesh (not ported yet)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of both stages (cuda, cpu)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.ckpt_dir is None and not args.tiny:
        logger.warning("no checkpoints found; running random-init "
                       "(output will be noise): pass --tiny for smoke")
    res = run(args.prompt, args.output_dir, args.seed, args.cfg_scale,
              args.motion_score, args.num_frames, args.tiny, args.ckpt_dir,
              args.fps, mesh_spec=args.mesh, device=args.device)
    print(f"stage1 {res['stage1_s']:.1f}s stage2 {res['stage2_s']:.1f}s "
          f"video {res['video'].shape} -> {res['video_path']}")
    return res


if __name__ == "__main__":
    main()
