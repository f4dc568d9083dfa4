"""Shared helpers (counterpart of landiff_tpu/utils.py, the parts the
ported path needs): run-stable seeds, env knobs, the sampling filters,
video output, parameter-tree walks and the zero-leaf fill."""

from __future__ import annotations

import hashlib
import logging
import os
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("landiff_tpu_torch")

# LANDIFF_FAST presets of the JAX package (utils.py:34-35): level 1 turns
# on the quantization knobs. The port reads the same names so that a knob
# it has not ported yet is refused rather than silently dropped.
_FAST_PRESET = {"LANDIFF_DIT_INT8": (1, True),
                "LANDIFF_DECODE_INT8": (1, True)}


def fast_level() -> int:
    """Numeric LANDIFF_FAST level (0 = off; legacy truthy strings = 1)."""
    v = os.environ.get("LANDIFF_FAST", "")
    if not v:
        return 0
    try:
        return int(v)
    except ValueError:
        return 0 if v.lower() in ("0", "false", "no") else 1


def env_flag(name: str, default: bool = False) -> bool:
    """Read a boolean env knob. An explicit setting always wins; otherwise
    LANDIFF_FAST>=level turns on the knobs in its preset; otherwise
    `default`."""
    v = os.environ.get(name)
    if v is None:
        if name in _FAST_PRESET and fast_level() >= _FAST_PRESET[name][0]:
            return _FAST_PRESET[name][1]
        return default
    return v.lower() not in ("0", "false", "no", "")


def stable_hash(key: str) -> int:
    """Run-stable hash (reference utils.py:317-324): first 20 hex digits of
    sha256, as an int. Used to derive per-prompt seeds."""
    return int(hashlib.sha256(key.encode()).hexdigest()[:20], 16)


def seed_from_text(text: str, seed: int) -> int:
    """Combined seed used by the diffusion stage (dif_infer.py:190-194)."""
    return (stable_hash(text) + seed) % (2**31)


def top_p_filter_probs(probs: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering over probability vectors (utils.py:62-78): keeps
    the smallest prefix of descending-sorted probs whose cumsum is < top_p,
    always the top-1, everything tied with the smallest kept prob
    (`>= thresh`), and renormalizes."""
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(sorted_probs, dim=-1)
    # remove where the shifted cumsum >= top_p (the first element stays)
    remove = cum >= top_p
    remove = torch.cat([torch.zeros_like(remove[..., :1]),
                        remove[..., :-1]], dim=-1)
    kept = torch.where(remove, torch.inf, sorted_probs)
    thresh = kept.amin(-1, keepdim=True)
    out = torch.where(probs >= thresh, probs, 0.0)
    return out / out.sum(-1, keepdim=True)


def top_k_filter_logits(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Standard top-k: logits below the k-th largest -> -inf. k <= 0
    disables."""
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, -torch.inf, logits)


def cthw_to_uint8(video: np.ndarray) -> np.ndarray:
    """(C, T, H, W) float in [0, 1] -> (T, H, W, C) uint8
    (utils.py:90-94)."""
    video = np.asarray(video)
    if video.ndim != 4:
        raise ValueError(f"expected a (C, T, H, W) video, got {video.shape}")
    imgs = np.transpose(video, (1, 2, 3, 0)) * 255.0
    return np.clip(imgs, 0, 255).astype(np.uint8)


def save_video_tensor(video, video_path: str, fps: int = 8) -> Path:
    """Write a (C, T, H, W) float video in [0, 1] to mp4 (utils.py:97-117).
    Without an ffmpeg backend it writes an MJPEG AVI instead; returns the
    path actually written."""
    import imageio

    images = cthw_to_uint8(video)
    path = Path(video_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        with open(path, "wb") as f:
            with imageio.get_writer(f, format="mp4", fps=fps) as writer:
                for image in images:
                    writer.append_data(image)
        return path
    except Exception as e:  # no ffmpeg plugin: pure-python MJPEG-AVI muxer
        from landiff_tpu_torch.video_io import write_mjpeg_avi

        logger.warning("mp4 writer unavailable (%s); writing MJPEG AVI", e)
        path.unlink(missing_ok=True)
        return write_mjpeg_avi(images, path.with_suffix(".avi"), fps)


def tree_map(fn, tree, *rest):
    """Apply fn to every leaf of a tree of dicts, lists and tuples; with
    more trees of the same structure, to the leaves at the same place."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def count_params(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def fill_zero_leaves(tree, generator: torch.Generator, scale: float = 0.02):
    """Replace all-zero floating tensors with small random normals (the
    counterpart of landiff_tpu/utils.py:130).

    LanDiff zero-inits its gating parameters (DiT adaLN tables, ControlNet
    zero linears, the semantic conditioner's conv_out), so a freshly
    initialised model's output does not depend on attention, the MLP or
    the control path. Fill them before any check that should see those
    paths. Draws come from `generator`, which must live on the leaves'
    device."""

    def fill(leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and leaf.numel() > 0 and not bool(leaf.any())):
            noise = torch.randn(leaf.shape, generator=generator,
                                device=leaf.device, dtype=torch.float32)
            return (noise * scale).to(leaf.dtype)
        return leaf

    return tree_map(fill, tree)
