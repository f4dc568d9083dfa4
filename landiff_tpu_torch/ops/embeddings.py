"""Sinusoidal embeddings (counterpart of landiff_tpu/ops/embeddings.py;
sgm/modules/diffusionmodules/util.py:207-232): cos block then sin block,
freqs exp(-log(max_period) * i / half)."""

from __future__ import annotations

import math

import torch


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0,
                       dtype=torch.float32) -> torch.Tensor:
    """timesteps: (N,) possibly fractional -> (N, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb.to(dtype)
