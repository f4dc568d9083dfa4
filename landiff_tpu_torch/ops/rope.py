"""Rotary position embeddings: the 1-D table of the stage-1 GPT and the
3-D tables of TiTok (counterpart of landiff_tpu/ops/rope.py; reference
landiff/modules/pos_emb.py).

Tables are host-side float32 numpy, built once per config; application
is an interleaved-pair rotation in fp32, cast back."""

from __future__ import annotations

import functools

import numpy as np
import torch

from landiff_tpu_torch.config import Rope1DConfig, Rope3DConfig


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs of x (..., heads, head_dim) by the angles
    cos/sin (..., head_dim//2), broadcast over heads (pos_emb.py:32-46):
      out[2i]   = x[2i]*cos_i - x[2i+1]*sin_i
      out[2i+1] = x[2i]*sin_i + x[2i+1]*cos_i   (fp32, cast back)."""
    xf = x.float()
    xr = xf[..., 0::2]
    xi = xf[..., 1::2]
    cos = cos[..., None, :].float()
    sin = sin[..., None, :].float()
    out = torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


@functools.lru_cache(maxsize=8)
def rope_1d_table(cfg: Rope1DConfig) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables of shape (max_len, dim//2), float32:
    freqs_i = theta**(-2i/dim), angle(t, i) = t * freqs_i
    (pos_emb.py:49-70)."""
    dim, end, theta = cfg.dim, cfg.max_len, cfg.theta_base
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2]
                             .astype(np.float32) / dim))
    t = np.arange(end, dtype=np.float32)
    angles = np.outer(t, freqs).astype(np.float32)
    return np.cos(angles), np.sin(angles)


def _axis_freqs(theta: float, n_cis: int, denom_dim: int) -> np.ndarray:
    """freqs_j = theta**(-2j/denom_dim) for j in [0, n_cis)."""
    r = np.arange(0, 2 * n_cis, 2).astype(np.float32)
    return 1.0 / (theta ** (r / denom_dim))


def _rope3d_angles(cfg: Rope3DConfig, t_pos, h_pos, w_pos) -> np.ndarray:
    """Angles for integer position arrays (pos_emb.py:223-258).

    multiple=16 (the released configs): [t: dim/8 | h: 3dim/16 | w:
    3dim/16] channels, (N, dim//2). multiple=6: interleaved (t, h, w)
    triples over dim//6 bands, freqs theta**(-6i/dim), (N, 3 * (dim//6)):
    narrower than dim//2 where dim/2 is not a multiple of 3, as in the
    reference."""
    dim, theta = cfg.dim, cfg.theta_base
    pos = [np.asarray(p, dtype=np.float32) for p in (t_pos, h_pos, w_pos)]
    if cfg.multiple == 16:
        t_dim = dim // 4
        hw_dim = dim // 8 * 3
        t_f = _axis_freqs(theta, t_dim // 2, t_dim)
        hw_f = _axis_freqs(theta, hw_dim // 2, hw_dim)
        return np.concatenate([np.outer(pos[0], t_f), np.outer(pos[1], hw_f),
                               np.outer(pos[2], hw_f)],
                              axis=-1).astype(np.float32)
    if cfg.multiple == 6:
        n = dim // 6
        f = 1.0 / (theta ** (np.arange(0, dim, 6)[:n].astype(np.float32)
                             / dim))
        ang = np.stack([np.outer(p, f) for p in pos], axis=-1)
        return ang.reshape(len(pos[0]), -1).astype(np.float32)
    raise ValueError(f"multiple must be 6 or 16, got {cfg.multiple}")


@functools.lru_cache(maxsize=8)
def rope_3d_grid_table(cfg: Rope3DConfig) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of shape (max_time, max_height, max_width, dim//2)."""
    T, H, W = cfg.max_time, cfg.max_height, cfg.max_width
    flat = np.arange(T * H * W)
    ang = _rope3d_angles(cfg, flat // (H * W), (flat % (H * W)) // W,
                         flat % W).reshape(T, H, W, -1)
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=8)
def rope_3d_text_table(cfg: Rope3DConfig) -> tuple[np.ndarray, np.ndarray]:
    """1-D-style table for positions where t==h==w (pos_emb.py:163-204)."""
    p = np.arange(cfg.one_dim_max_time)
    ang = _rope3d_angles(cfg, p, p, p)
    return np.cos(ang), np.sin(ang)


def rope_3d_by_index(cfg: Rope3DConfig, pos_idx: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Gather (cos, sin) (..., dim//2) for integer (t, h, w) indices
    (..., 3), as Rope3DPosEmb.get_freqs_cis_by_idx (pos_emb.py:265-311):
    t==h==w positions route to the text table."""
    pos_idx = np.asarray(pos_idx)
    lead = pos_idx.shape[:-1]
    flat = pos_idx.reshape(-1, 3)
    eq = (flat[:, 0] == flat[:, 1]) & (flat[:, 1] == flat[:, 2])
    tc = np.clip(flat[:, 0], 0, cfg.max_time - 1)
    hc = np.clip(flat[:, 1], 0, cfg.max_height - 1)
    wc = np.clip(flat[:, 2], 0, cfg.max_width - 1)
    gcos, gsin = rope_3d_grid_table(cfg)
    tcos, tsin = rope_3d_text_table(cfg)
    teq = np.clip(flat[:, 0], 0, cfg.one_dim_max_time - 1)
    cos = np.where(eq[:, None], tcos[teq], gcos[tc, hc, wc])
    sin = np.where(eq[:, None], tsin[teq], gsin[tc, hc, wc])
    return (cos.reshape(*lead, -1).astype(np.float32),
            sin.reshape(*lead, -1).astype(np.float32))


def shape_to_index(t: int, h: int, w: int) -> np.ndarray:
    """All (t, h, w) indices of a 3-D grid, row-major: (t*h*w, 3)."""
    tt, hh, ww = np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                             indexing="ij")
    return np.stack([tt, hh, ww], axis=-1).reshape(-1, 3)


def len_to_rope_index(n: int) -> np.ndarray:
    """(n, 3) array where row i = [i, i, i] ("text-like" positions)."""
    r = np.arange(n)
    return np.stack([r, r, r], axis=-1)
