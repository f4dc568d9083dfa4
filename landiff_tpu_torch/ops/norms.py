"""Normalisation primitives (counterpart of landiff_tpu/ops/norms.py).

fp32 statistics, input-dtype arithmetic, in the same order of operations
as the JAX functions, so bf16 results round at the same places."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm: x * rsqrt(mean(x^2) + eps) * weight. The mean of squares
    is f32; the scale is cast to x.dtype before the multiply, as the JAX
    function does (norms.py:18-29)."""
    dt = x.dtype
    var = x.float().square().mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps).to(dt) * weight.to(dt)


def layer_norm(x: torch.Tensor, weight=None, bias=None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; weight/bias optional."""
    dt = x.dtype
    mean = x.mean(-1, keepdim=True, dtype=torch.float32)
    xc = x - mean.to(dt)
    var = xc.float().square().mean(-1, keepdim=True)
    out = xc * torch.rsqrt(var + eps).to(dt)
    if weight is not None:
        out = out * weight.to(dt)
    if bias is not None:
        out = out + bias.to(dt)
    return out


def qk_layer_norm(q, k, q_w, q_b, k_w, k_b, eps: float = 1e-5):
    """Per-head-dim LayerNorm on q and k (norms.py:78). The default eps is
    1e-5; the DiT's own qk-LN uses 1e-6 (models/dit.py `_layer`)."""
    return layer_norm(q, q_w, q_b, eps), layer_norm(k, k_w, k_b, eps)


def group_norm(x: torch.Tensor, weight, bias, num_groups: int = 32,
               eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm with channels at axis 1 (NCHW / NCTHW): statistics over
    each group's channels and every spatial / temporal position."""
    dt = x.dtype
    shp = x.shape
    xg = x.reshape(shp[0], num_groups, -1)
    mean = xg.mean(-1, keepdim=True, dtype=torch.float32)
    xc = xg - mean.to(dt)
    var = xc.float().square().mean(-1, keepdim=True)
    xg = xc * torch.rsqrt(var + eps).to(dt)
    bshape = (1, shp[1]) + (1,) * (len(shp) - 2)
    return (xg.reshape(shp) * weight.to(dt).reshape(bshape)
            + bias.to(dt).reshape(bshape))
