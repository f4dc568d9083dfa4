"""Plain reference of one step of LanDiff's stage-2 sampler: the
zero-terminal-SNR schedule, the DiscreteDenoiser's v-prediction scalings,
DynamicCFG and the VP-SDE DPM-Solver++(2M) update (CogVideoX's
sampling.py), in float64 scalars over float32 tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.dit import control_warp_forward


def _alphas_cumprod(s):
    betas = np.linspace(s["linear_start"] ** 0.5, s["linear_end"] ** 0.5,
                        s["num_train_timesteps"], dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    k = s["shift_scale"]
    return acp / (k + (1 - k) * acp)


def _zero_snr(s, n):
    """alpha_cumprod_sqrt over n steps, rescaled to zero terminal SNR and
    flipped to ascending time; with the timestep of each entry."""
    acp = _alphas_cumprod(s)
    N = s["num_train_timesteps"]
    if n < N:
        ts = np.linspace(N - 1, 0, n, endpoint=False).astype(int)[::-1]
        acp = acp[ts]
    else:
        ts = np.arange(N)
    a = np.sqrt(acp)
    a = (a - a[-1]) * (a[0] / (a[0] - a[-1]))
    return a[::-1].copy(), ts


def schedule(s):
    """Per step i: alpha, alpha_next, alpha_prev, timestep, cfg scale."""
    n = s["num_steps"]
    a, ts = _zero_snr(s, n)
    a = np.concatenate([a, [1.0]])
    ts = np.concatenate([[-1], ts])
    steps = []
    for i in range(n):
        t = int(ts[-(i + 1)])
        # DynamicCFG with its literal step index num_steps - timestep
        cfg = 1.0 + s["cfg_scale"] * (1.0 - math.cos(
            math.pi * ((n - t) / n) ** s["cfg_exp"])) / 2.0
        steps.append({"alpha": a[i], "alpha_next": a[i + 1],
                      "alpha_prev": a[i - 1] if i > 0 else None,
                      "timestep": t, "cfg_scale": cfg, "last": i == n - 1})
    return steps


def quantized_alpha(s, alpha):
    """The DiscreteDenoiser snaps alpha to the nearest entry of the full
    1000-step table."""
    table = _zero_snr(s, s["num_train_timesteps"])[0]
    return float(table[np.abs(table - alpha).argmin()])


def dpmpp2m(alpha, alpha_next, alpha_prev):
    """(m1, m2, m3, m4, m_noise) of one VP-SDE DPM++(2M) step; m3, m4 None
    on a first-order step."""
    with np.errstate(divide="ignore"):
        lam = lambda a: np.log(np.sqrt(np.float64(a) ** 2
                                       / (1 - np.float64(a) ** 2)))
        h = lam(alpha_next) - lam(alpha)
        an2 = np.float64(alpha_next) ** 2
        m1 = np.sqrt((1 - an2) / (1 - np.float64(alpha) ** 2)) * np.exp(-h)
        m2 = np.expm1(-2 * h) * alpha_next
        mn = np.sqrt(1 - an2) * np.sqrt(1 - np.exp(-2 * h))
        if alpha_prev is None:
            return float(m1), float(m2), None, None, float(mn)
        r = (lam(alpha) - lam(alpha_prev)) / h
    return float(m1), float(m2), 1 + 1 / (2 * r), 1 / (2 * r), float(mn)


def denoised(main, control, sem, x, context, d, s, i, rows=False):
    """The CFG-combined x0 prediction of step i for latents x (B, T, C,
    H, W): rows [uncond (zero context), cond] through the DiT. rows: also
    return the two rows' own predictions."""
    st = schedule(s)[i]
    B = x.shape[0]
    a = quantized_alpha(s, st["alpha"])
    c_skip, c_out = a, -math.sqrt(1.0 - a * a)
    x2 = torch.cat([x, x]).float()
    ctx2 = torch.cat([torch.zeros_like(context), context]).float()
    ts = torch.full((2 * B,), float(st["timestep"]), device=x.device)
    net = control_warp_forward(main, control, x2, ts, ctx2, d,
                               torch.cat([sem, sem]))
    den = net * c_out + x2 * c_skip
    out = den[:B] + st["cfg_scale"] * (den[B:] - den[:B])
    return (out, den[:B], den[B:]) if rows else out


def implied_prediction(x, x_next, old_d, noise, s, i):
    """The prediction that `update` turns into x_next: the update solved
    for it."""
    st = schedule(s)[i]
    if st["last"]:
        return x_next
    m1, m2, m3, m4, mn = dpmpp2m(st["alpha"], st["alpha_next"],
                                 st["alpha_prev"])
    r = (m1 * x + mn * noise - x_next) / m2
    if m3 is None or st["alpha_next"] < 1e-14:
        return r
    return (r + m4 * old_d) / m3


def update(x, den, old_d, noise, s, i):
    """x_{i+1} from x_i, this step's prediction, the previous step's
    prediction and this step's noise."""
    st = schedule(s)[i]
    if st["last"]:
        return den
    m1, m2, m3, m4, mn = dpmpp2m(st["alpha"], st["alpha_next"],
                                 st["alpha_prev"])
    if m3 is None or st["alpha_next"] < 1e-14:
        return m1 * x - m2 * den + mn * noise
    return m1 * x - m2 * (m3 * den - m4 * old_d) + mn * noise
