"""Eval-time media logging (the reference's log_video/log_conditionings,
diffusion_video.py:317-444): render sample frames + prompts to PNG grids
and metrics JSONL, without any wandb dependency."""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger("landiff_tpu_torch.eval")


def video_grid(video: np.ndarray, max_frames: int = 8) -> np.ndarray:
    """(B, 3, T, H, W) in [0,1] -> one (H*B, W*max_frames, 3) uint8 grid."""
    b, _, t, h, w = video.shape
    idx = np.linspace(0, t - 1, min(max_frames, t)).astype(int)
    rows = []
    for i in range(b):
        frames = [np.clip(video[i, :, j].transpose(1, 2, 0) * 255, 0,
                          255).astype(np.uint8) for j in idx]
        rows.append(np.concatenate(frames, axis=1))
    return np.concatenate(rows, axis=0)


def log_video(video, prompts, out_dir: str | Path, step: int,
              metrics: dict | None = None) -> Path:
    """Write <out_dir>/step_<N>.png grid + sidecar json with prompts and
    metrics. Returns the png path."""
    from PIL import Image

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    grid = video_grid(np.asarray(video))
    png = out_dir / f"step_{step:08d}.png"
    Image.fromarray(grid).save(png)
    side = {"step": step, "prompts": list(prompts)}
    if metrics:
        side["metrics"] = {k: float(np.asarray(v))
                           for k, v in metrics.items()}
    (out_dir / f"step_{step:08d}.json").write_text(json.dumps(side))
    logger.info("eval media -> %s", png)
    return png
