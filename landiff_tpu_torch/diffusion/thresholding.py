"""CFG-combine / dynamic-thresholding functions (counterpart of
landiff_tpu/diffusion/thresholding.py; reference sgm/modules/
diffusionmodules/sampling_utils.py:8-119).

Each guider `dyn_thresh` strategy takes (uncond, cond, scale) and returns
the combined prediction. Video tensors are (B, T, C, H, W); statistics are
f32 whatever the input dtype. Quantiles are torch.quantile's linear
interpolation, as jnp.quantile's; standard deviations are unbiased (ddof
1) where the reference's torch .std() is.
"""

from __future__ import annotations

import torch


def _by_channel(x):
    """(B, T, C, H, W) -> (B, C, T*H*W)."""
    b, t, c, h, w = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(b, c, t * h * w)


def _from_channel(flat, shape):
    b, t, c, h, w = shape
    return flat.reshape(b, c, t, h, w).permute(0, 2, 1, 3, 4)


def no_dynamic_thresholding(uncond, cond, scale):
    """NoDynamicThresholding (sampling_utils.py:8-13)."""
    return uncond + scale * (cond - uncond)


def static_thresholding(uncond, cond, scale):
    """StaticThresholding (sampling_utils.py:16-20): clamp to [-1, 1]."""
    return torch.clamp(uncond + scale * (cond - uncond), -1.0, 1.0)


def dynamic_threshold(x, p: float = 0.95):
    """dynamic_threshold (sampling_utils.py:23-32): per-(n, c) two-sided
    quantile clamp where the spread exceeds 1."""
    flat = _by_channel(x)
    lo = torch.quantile(flat, 1 - p, dim=-1, keepdim=True)
    hi = torch.quantile(flat, p, dim=-1, keepdim=True)
    s = torch.maximum(-lo, hi)
    flat = torch.where(s > 1, torch.clamp(flat, -s, s), flat)
    return _from_channel(flat, x.shape)


def dynamic_thresholding2(x0, p: float = 0.995):
    """dynamic_thresholding2 (sampling_utils.py:35-42): per-sample |x|
    quantile clamp (Imagen), floor 1, no rescale."""
    x = x0.float()
    s = torch.quantile(x.abs().reshape(x.shape[0], -1), p, dim=1)
    s = s.clamp_min(1.0).reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.clamp(x, -s, s).to(x0.dtype)


def latent_dynamic_thresholding(x0, p: float = 0.9995):
    """latent_dynamic_thresholding (sampling_utils.py:45-52) on (B, C, L)
    latents: quantile over axis 2, clamp and divide by it."""
    x = x0.float()
    s = torch.quantile(x.abs(), p, dim=2)
    s = s.reshape(s.shape + (1,) * (x.ndim - s.ndim))
    return (torch.clamp(x, -s, s) / s).to(x0.dtype)


def dynamic_thresholding(uncond, cond, scale):
    """DynamicThresholding (sampling_utils.py:65-73): the CFG result
    renormalised to the uncond's global mean / std."""
    u = uncond.float()
    std = u.std()
    result = no_dynamic_thresholding(u, cond.float(), scale)
    out = (result - result.mean()) / result.std() * std
    return out.to(uncond.dtype)


def dynamic_thresholding_v1(uncond, cond, scale, *, scale_factor: float):
    """DynamicThresholdingV1 (sampling_utils.py:76-94): unscale, recenter
    per (b, c), normalise by the global max magnitude, latent-threshold,
    restore."""
    u = uncond.float()
    result = no_dynamic_thresholding(u, cond.float(), scale)
    flat = _by_channel(result / scale_factor)
    means = flat.mean(dim=2, keepdim=True)
    recentered = flat - means
    magnitudes = recentered.abs().max()
    thresholded = latent_dynamic_thresholding(recentered / magnitudes)
    flat = thresholded * magnitudes + means
    return (_from_channel(flat, result.shape) * scale_factor).to(
        uncond.dtype)


def dynamic_thresholding_v2(uncond, cond, scale):
    """DynamicThresholdingV2 (sampling_utils.py:97-119): the scale-8 CFG
    direction rescaled to the per-(b, c) std of the scale-4 one; `scale`
    is ignored, as in the reference (hardcoded 4 / 8)."""
    del scale
    u = uncond.float()
    diff = cond.float() - u

    def stats(x):
        flat = _by_channel(x)
        means = flat.mean(dim=2, keepdim=True)
        centered = flat - means
        return means, centered, centered.std(dim=2, keepdim=True)

    _, _, mim_std = stats(u + diff * 4.0)
    cfg_means, cfg_centered, cfg_std = stats(u + diff * 8.0)
    renorm = cfg_centered / cfg_std * mim_std + cfg_means
    return _from_channel(renorm, u.shape).to(uncond.dtype)
