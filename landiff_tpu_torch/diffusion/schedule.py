"""Diffusion schedules: ZeroSNR discretization, VideoScaling, DynamicCFG
scale schedule, as pure float64 host functions.

A copy of landiff_tpu/diffusion/schedule.py, which is numpy-only but
belongs to the JAX package. The tables are tiny and must be bit-faithful
to the reference, which computes them in f64
(sgm/modules/diffusionmodules/util.py:20-33, discretizer.py:80-141,
guiders.py:58-79, denoiser_scaling.py:62-70)."""

from __future__ import annotations

import math

import numpy as np

from landiff_tpu_torch.config import SamplerConfig


def make_beta_schedule_linear(n: int, linear_start: float,
                              linear_end: float) -> np.ndarray:
    """'linear' DDPM betas: sqrt-space linspace squared, float64."""
    return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n,
                       dtype=np.float64) ** 2


def equally_spaced_steps(num_substeps: int, max_step: int) -> np.ndarray:
    """discretizer.py:11-14."""
    return np.linspace(max_step - 1, 0, num_substeps,
                       endpoint=False).astype(int)[::-1]


def zero_snr_alphas_cumprod(cfg: SamplerConfig) -> np.ndarray:
    """Full 1000-entry shifted alphas_cumprod table (discretizer.py:80-114)."""
    betas = make_beta_schedule_linear(cfg.num_train_timesteps,
                                      cfg.linear_start, cfg.linear_end)
    alphas_cumprod = np.cumprod(1.0 - betas)
    # SNR shift
    s = cfg.shift_scale
    return alphas_cumprod / (s + (1 - s) * alphas_cumprod)


def zero_snr_sigmas(cfg: SamplerConfig, n: int | None = None,
                    return_idx: bool = True):
    """alpha_cumprod_sqrt table for `n` sampling steps, rescaled to zero
    terminal SNR and flipped (discretizer.py:116-141).

    Returns (alpha_cumprod_sqrt[n] descending 0.99..~0, timesteps[n] asc)."""
    if n is None:
        n = cfg.num_steps
    acp = zero_snr_alphas_cumprod(cfg)
    if n < cfg.num_train_timesteps:
        timesteps = equally_spaced_steps(n, cfg.num_train_timesteps)
        acp = acp[timesteps]
    elif n == cfg.num_train_timesteps:
        timesteps = np.arange(cfg.num_train_timesteps)
    else:
        raise ValueError(n)
    acs = np.sqrt(acp)
    a0, aT = acs[0], acs[-1]
    acs = (acs - aT) * (a0 / (a0 - aT))
    flipped = acs[::-1].copy()
    if return_idx:
        return flipped, timesteps
    return flipped


def legacy_ddpm_sigmas(cfg: SamplerConfig, n: int | None = None):
    """LegacyDDPMDiscretization (discretizer.py:50-78): EDM-style sigmas
    sqrt((1-acp)/acp), flipped descending."""
    if n is None:
        n = cfg.num_steps
    betas = make_beta_schedule_linear(cfg.num_train_timesteps,
                                      cfg.linear_start, cfg.linear_end)
    acp = np.cumprod(1.0 - betas)
    if n < cfg.num_train_timesteps:
        acp = acp[equally_spaced_steps(n, cfg.num_train_timesteps)]
    return np.sqrt((1 - acp) / acp)[::-1].copy()


def edm_sigmas(n: int, sigma_min: float = 0.002, sigma_max: float = 80.0,
               rho: float = 7.0):
    """EDMDiscretization (discretizer.py:36-47)."""
    ramp = np.linspace(0, 1, n)
    lo, hi = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    return (hi + ramp * (lo - hi)) ** rho


def vanilla_cfg_scale(scale: float, timestep=None) -> float:
    """VanillaCFG: constant scale (guiders.py:24-56)."""
    return scale


def eps_scaling(sigma: np.ndarray):
    """EpsScaling (denoiser_scaling.py:30-39): (c_skip, c_out, c_in,
    c_noise)."""
    return (np.ones_like(sigma), -sigma, 1.0 / np.sqrt(sigma ** 2 + 1.0),
            sigma)


def v_scaling(sigma: np.ndarray):
    """VScaling (denoiser_scaling.py:42-50)."""
    return (1.0 / (sigma ** 2 + 1.0), -sigma / np.sqrt(sigma ** 2 + 1.0),
            1.0 / np.sqrt(sigma ** 2 + 1.0), sigma)


def video_scaling(alpha_cumprod_sqrt: np.ndarray):
    """VideoScaling (v-pred in alpha-sqrt form, denoiser_scaling.py:62-70):
    returns (c_skip, c_out, c_in). c_noise is the timestep idx, handled by
    the caller."""
    a = alpha_cumprod_sqrt
    return a, -np.sqrt(1.0 - a ** 2), np.ones_like(a)


def dynamic_cfg_scale(cfg: SamplerConfig, timestep: int) -> float:
    """DynamicCFG scale for one step (guiders.py:58-79), replicating the
    reference's literal `step_index = num_steps - timestep` (which goes far
    negative for the 1000-step timestep indices — intentional parity with
    the shipped CogVideoX behavior, computed in f64 like the original)."""
    step_index = cfg.num_steps - timestep
    return 1.0 + cfg.cfg_scale * (
        1.0 - math.cos(math.pi * (step_index / cfg.num_steps) ** cfg.cfg_exp)
    ) / 2.0


def sampler_tables(cfg: SamplerConfig):
    """Everything the DPM++2M SDE loop needs, precomputed f64.

    Returns dict of numpy arrays over steps i = 0..num_steps-1:
      alpha[i], alpha_next[i], alpha_prev[i] (nan for i=0), timestep[i],
      idx[i] (=num_steps-i), cfg_scale[i], plus the raw appended table.
    Matches VideoDDIMSampler.prepare_sampling_loop (sampling.py:544-566):
    alpha table appended with 1.0, timesteps prepended with -1, step i uses
    timesteps[-(i+1)].
    """
    acs, timesteps = zero_snr_sigmas(cfg, cfg.num_steps, return_idx=True)
    acs_ext = np.concatenate([acs, [1.0]])
    ts_ext = np.concatenate([[-1], timesteps])
    n = cfg.num_steps
    step_ts = np.array([ts_ext[-(i + 1)] for i in range(n)])
    return {
        "alpha": acs_ext[:n],
        "alpha_next": acs_ext[1:n + 1],
        "alpha_prev": np.concatenate([[np.nan], acs_ext[:n - 1]]),
        "timestep": step_ts,
        "idx": np.array([n - i for i in range(n)]),
        "cfg_scale": np.array([dynamic_cfg_scale(cfg, int(t))
                               for t in step_ts]),
        "table": acs_ext,
    }


def dpmpp2m_coeffs(alpha: float, alpha_next: float,
                   alpha_prev: float | None):
    """Multipliers for one VPSDE-DPM++2M step (sampling.py:678-783), f64.

    alpha=0 (the zero-SNR start) makes lambda = log(0) = -inf; the reference
    relies on IEEE inf propagation (exp(-inf)=0, expm1(-inf)=-1), so compute
    with numpy scalars, not python math.

    Returns (mult1, mult2, mult3, mult4, mult_noise); mult3/4 are None on
    the first step."""
    with np.errstate(divide="ignore"):
        a2, an2 = np.float64(alpha) ** 2, np.float64(alpha_next) ** 2
        lamb = np.log(np.sqrt(a2 / (1 - a2)))
        lamb_next = np.log(np.sqrt(an2 / (1 - an2)))
        h = lamb_next - lamb
        mult1 = np.sqrt((1 - an2) / (1 - a2)) * np.exp(-h)
        mult2 = np.expm1(-2 * h) * alpha_next
        mult_noise = np.sqrt(1 - an2) * np.sqrt(1 - np.exp(-2 * h))
        if alpha_prev is None or np.isnan(alpha_prev):
            return float(mult1), float(mult2), None, None, float(mult_noise)
        ap2 = np.float64(alpha_prev) ** 2
        lamb_prev = np.log(np.sqrt(ap2 / (1 - ap2)))
        r = (lamb - lamb_prev) / h
        mult3 = 1 + 1 / (2 * r)
        mult4 = 1 / (2 * r)
    return (float(mult1), float(mult2), float(mult3), float(mult4),
            float(mult_noise))


def dpmpp2m_ode_coeffs(alpha: float, alpha_next: float,
                       alpha_prev: float | None):
    """Deterministic VP-ODE DPM++2M multipliers (VPODEDPMPP2MSampler,
    sampling.py:840-881): mult1 without the exp(-h) SDE contraction,
    mult2 with expm1(-h), no noise term."""
    with np.errstate(divide="ignore"):
        a2, an2 = np.float64(alpha) ** 2, np.float64(alpha_next) ** 2
        lamb = np.log(np.sqrt(a2 / (1 - a2)))
        lamb_next = np.log(np.sqrt(an2 / (1 - an2)))
        h = lamb_next - lamb
        mult1 = np.sqrt((1 - an2) / (1 - a2))
        mult2 = np.expm1(-h) * alpha_next
        if alpha_prev is None or np.isnan(alpha_prev):
            return float(mult1), float(mult2), None, None
        ap2 = np.float64(alpha_prev) ** 2
        lamb_prev = np.log(np.sqrt(ap2 / (1 - ap2)))
        r = (lamb - lamb_prev) / h
        mult3 = 1 + 1 / (2 * r)
        mult4 = 1 / (2 * r)
    return float(mult1), float(mult2), float(mult3), float(mult4)
