"""The k-diffusion / EDM sampler family in sigma parameterization
(counterpart of landiff_tpu/diffusion/k_samplers.py; reference sgm/
modules/diffusionmodules/sampling.py:87-535, sampling_utils.py:122-157).

The coefficient tables are host-side f64 numpy, rounded to f32 per step
as the JAX scan's tables are; the loop is a Python loop over steps, and a
scalar the JAX body computes from two table entries is computed in f32
here too. Unused by the shipped LanDiff configs, which sample with
samplers.py, but part of the reference's sampler surface.

denoise_fn contract (sigma space, unlike samplers.py):
    denoised = denoise_fn(x, sigma) -> f32 tensor like x
with `sigma` a Python float (an f32 value). Guidance happens inside
denoise_fn; the combine functions are in thresholding.py.

Every sampler takes `sigmas`: descending noise levels including the
trailing zero (append_zero), length num_steps + 1. Randomness: `noises`,
a list with one unit-normal tensor like x per executed step (the seam
through which a test feeds the JAX key chain's draws: per step key, k =
split(key), normal(k)), else draws from `generator` (else a generator
seeded 0 on x's device, as JAX's default key is PRNGKey(0)) on the steps
that use them.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

_F32 = np.float32


def append_zero(sigmas: np.ndarray) -> np.ndarray:
    """sgm util.append_zero: a trailing 0 noise level."""
    return np.concatenate([np.asarray(sigmas, np.float64), [0.0]])


def _to_d(x, sigma: float, denoised):
    """to_d (sampling_utils.py:148-149) with a safe denominator (the
    sigma = 0 case is never used by a caller)."""
    return (x - denoised) / max(sigma, float(_F32(1e-20)))


def get_ancestral_step(sigma_from, sigma_to, eta: float = 1.0):
    """sampling_utils.py:137-145, host-side f64."""
    if not eta:
        return sigma_to, np.zeros_like(np.asarray(sigma_to, np.float64))
    sigma_from = np.asarray(sigma_from, np.float64)
    sigma_to = np.asarray(sigma_to, np.float64)
    sigma_up = np.minimum(
        sigma_to,
        eta * np.sqrt(sigma_to ** 2 * (sigma_from ** 2 - sigma_to ** 2)
                      / np.maximum(sigma_from ** 2, 1e-300)))
    sigma_down = np.sqrt(np.maximum(sigma_to ** 2 - sigma_up ** 2, 0.0))
    return sigma_down, sigma_up


def linear_multistep_coeff(order: int, t: np.ndarray, i: int, j: int) -> float:
    """LMS coefficient (sampling_utils.py:122-134): the integral over
    [t[i], t[i+1]] of the j-th Lagrange basis over the nodes t[i-k],
    k < order. The reference integrates numerically (scipy quad); the
    integrand is a polynomial of degree order - 1, integrated exactly, as
    the JAX package does."""
    if order - 1 > i:
        raise ValueError(f"Order {order} too high for step {i}")
    poly = np.polynomial.Polynomial([1.0])
    for k in range(order):
        if j == k:
            continue
        poly = poly * np.polynomial.Polynomial(
            [-t[i - k], 1.0]) / (t[i - j] - t[i - k])
    integ = poly.integ()
    return float(integ(t[i + 1]) - integ(t[i]))


def _prep(x, sigmas):
    """prepare_sampling_loop (sampling.py:46-57): x *= sqrt(1 + sigma0^2)."""
    sig = np.asarray(sigmas, np.float64)
    if sig.ndim != 1 or len(sig) < 2:
        raise ValueError(f"sigmas must be 1-D with >= 2 levels: {sig.shape}")
    x = x.float() * math.sqrt(1.0 + float(sig[0]) ** 2)
    return x, sig, len(sig) - 1


def _f32(a) -> list[float]:
    """Per-step f32 values of an f64 table, as Python floats."""
    return [float(v) for v in np.asarray(a, np.float64).astype(_F32)]


class _Draws:
    """The unit-normal draw of the i-th executed step: noises[i], else
    from the generator."""

    def __init__(self, x, generator, noises):
        self.noises = noises
        if noises is None and generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        self.generator = generator

    def __call__(self, i: int, x):
        if self.noises is not None:
            return self.noises[i].to(x.device, torch.float32)
        return torch.randn(x.shape, generator=self.generator,
                           device=x.device, dtype=torch.float32)


def euler_edm_sample(denoise_fn: Callable, x, sigmas, *, generator=None,
                     noises=None, s_churn: float = 0.0, s_tmin: float = 0.0,
                     s_tmax: float = float("inf"), s_noise: float = 1.0):
    """EulerEDMSampler (sampling.py:87-135, 255-259)."""
    return _edm_sample(denoise_fn, x, sigmas, generator=generator,
                       noises=noises, s_churn=s_churn, s_tmin=s_tmin,
                       s_tmax=s_tmax, s_noise=s_noise, heun=False)


def heun_edm_sample(denoise_fn: Callable, x, sigmas, *, generator=None,
                    noises=None, s_churn: float = 0.0, s_tmin: float = 0.0,
                    s_tmax: float = float("inf"), s_noise: float = 1.0):
    """HeunEDMSampler (sampling.py:262-278): an Euler step and a
    trapezoidal correction from a second model call (none where
    next_sigma == 0)."""
    return _edm_sample(denoise_fn, x, sigmas, generator=generator,
                       noises=noises, s_churn=s_churn, s_tmin=s_tmin,
                       s_tmax=s_tmax, s_noise=s_noise, heun=True)


def _edm_sample(denoise_fn, x, sigmas, *, generator, noises, s_churn,
                s_tmin, s_tmax, s_noise, heun: bool, start_step: int = 0):
    x, sig, n = _prep(x, sigmas)
    draw = _Draws(x, generator, noises)
    # reference: s_churn / (num_sigmas - 1), num_sigmas = len(sigmas)
    gamma = np.where((s_tmin <= sig[:n]) & (sig[:n] <= s_tmax),
                     min(s_churn / max(n, 1), 2 ** 0.5 - 1), 0.0)
    sl = slice(start_step, n)
    sigma_hat = _f32((sig[:n] * (gamma + 1.0))[sl])
    next_sigma = _f32(sig[1:][sl])
    churn = _f32(np.sqrt(np.maximum(
        (sig[:n] * (gamma + 1.0)) ** 2 - sig[:n] ** 2, 0.0))[sl])
    has_churn = (gamma > 0)[sl]
    correct = (sig[1:][sl] > 1e-14) & heun
    for i in range(len(sigma_hat)):
        sh, ns = sigma_hat[i], next_sigma[i]
        if has_churn[i]:
            x = x + draw(i, x) * s_noise * churn[i]
        denoised = denoise_fn(x, sh).float()
        d = _to_d(x, sh, denoised)
        dt = float(_F32(ns) - _F32(sh))
        euler = x + dt * d
        if correct[i]:
            den2 = denoise_fn(euler, ns).float()
            d2 = _to_d(euler, ns, den2)
            x = x + (d + d2) / 2.0 * dt
        else:
            x = euler
    return x


def sdedit_edm_sample(denoise_fn: Callable, image, randn, sigmas, *,
                      generator=None, noises=None, edit_ratio: float = 0.5,
                      s_churn: float = 0.0, s_tmin: float = 0.0,
                      s_tmax: float = float("inf"), s_noise: float = 1.0):
    """SdeditEDMSampler (sampling.py:492-535): skip the steps with
    i / num_steps < edit_ratio; start from image + randn * sigma at the
    first executed step (randn is the unit noise, before the prepare
    scaling)."""
    sig = np.asarray(sigmas, np.float64)
    n = len(sig) - 1
    start = next((i for i in range(n) if i / n >= edit_ratio), n)
    if start >= n:
        return image.float()
    x0 = image.float() + randn.float() * float(sig[start])
    # undo the prepare scaling so the start state is x0
    x0 = x0 / math.sqrt(1.0 + float(sig[0]) ** 2)
    return _edm_sample(denoise_fn, x0, sigmas, generator=generator,
                       noises=noises, s_churn=s_churn, s_tmin=s_tmin,
                       s_tmax=s_tmax, s_noise=s_noise, heun=False,
                       start_step=start)


def ddim_sample(denoise_fn: Callable, x, sigmas, *, generator=None,
                noises=None, s_noise: float = 0.1):
    """DDIMSampler (sampling.py:138-174): stochastic DDIM in sigma space.
    The reference class cannot run as shipped (sampler_step calls
    possible_correction_step, which only the EDM subclasses define); this
    is its evident intent, the identity correction, as in the JAX
    package."""
    x, sig, n = _prep(x, sigmas)
    draw = _Draws(x, generator, noises)
    sigma, next_sigma = _f32(sig[:n]), _f32(sig[1:])
    dt = _f32(sig[1:] * (1 - s_noise ** 2) ** 0.5 - sig[:n])
    for i in range(n):
        denoised = denoise_fn(x, sigma[i]).float()
        d = _to_d(x, sigma[i], denoised)
        amp = float(_F32(s_noise) * _F32(next_sigma[i]))
        x = x + dt[i] * d + amp * draw(i, x)
    return x


def euler_ancestral_sample(denoise_fn: Callable, x, sigmas, *,
                           generator=None, noises=None, eta: float = 1.0,
                           s_noise: float = 1.0):
    """EulerAncestralSampler (sampling.py:177-214, 281-288)."""
    x, sig, n = _prep(x, sigmas)
    draw = _Draws(x, generator, noises)
    down, up = get_ancestral_step(sig[:n], sig[1:], eta=eta)
    sigma, down, up = _f32(sig[:n]), _f32(down), _f32(up)
    for i in range(n):
        denoised = denoise_fn(x, sigma[i]).float()
        d = _to_d(x, sigma[i], denoised)
        x = x + float(_F32(down[i]) - _F32(sigma[i])) * d
        if sig[i + 1] > 0.0:
            x = x + draw(i, x) * s_noise * up[i]
    return x


def dpmpp2s_ancestral_sample(denoise_fn: Callable, x, sigmas, *,
                             generator=None, noises=None, eta: float = 1.0,
                             s_noise: float = 1.0):
    """DPMPP2SAncestralSampler (sampling.py:291-328): one midpoint model
    call per step (none where sigma_down == 0: ancestral Euler)."""
    x, sig, n = _prep(x, sigmas)
    draw = _Draws(x, generator, noises)
    down, up = get_ancestral_step(sig[:n], sig[1:], eta=eta)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = -np.log(np.maximum(sig[:n], 1e-300))
        t_next = -np.log(np.maximum(down, 1e-300))
        h = t_next - t
        s = t + 0.5 * h
        sig_s = np.exp(-s)
        m1 = sig_s / sig[:n]
        m2 = np.expm1(-0.5 * h)
        m3 = down / sig[:n]
        m4 = np.expm1(-h)
    second = down > 1e-14
    z = np.zeros(n)
    sig_s, m1, m2, m3, m4 = (_f32(np.where(second, a, z))
                             for a in (sig_s, m1, m2, m3, m4))
    sigma, down32, up = _f32(sig[:n]), _f32(down), _f32(up)
    for i in range(n):
        denoised = denoise_fn(x, sigma[i]).float()
        if second[i]:
            x2 = m1[i] * x - m2[i] * denoised
            denoised2 = denoise_fn(x2, sig_s[i]).float()
            x = m3[i] * x - m4[i] * denoised2
        else:
            d = _to_d(x, sigma[i], denoised)
            x = x + float(_F32(down32[i]) - _F32(sigma[i])) * d
        if sig[i + 1] > 0.0:
            x = x + draw(i, x) * s_noise * up[i]
    return x


def _dpmpp2m_tables(sig, n, *, sde: bool) -> dict:
    """The per-step tables of DPMPP2MSampler (sampling.py:331-406) and
    SDEDPMPP2MSampler (:409-489), host-side f64."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t = -np.log(np.maximum(sig[:n], 1e-300))
        t_next = -np.log(np.maximum(sig[1:], 1e-300))
        h = t_next - t
        if sde:
            m1 = sig[1:] / sig[:n] * np.exp(-h)
            m2 = np.expm1(-2.0 * h)
            mn = sig[1:] * np.sqrt(np.maximum(1.0 - np.exp(-2.0 * h), 0.0))
        else:
            m1 = sig[1:] / sig[:n]
            m2 = np.expm1(-h)
            mn = np.zeros(n)
        h_last = np.concatenate([[np.nan], h[:-1]])
        r = h_last / h
        m3 = 1.0 + 1.0 / (2.0 * r)
        m4 = 1.0 / (2.0 * r)
    # the first step has no old denoised; the last (sigma_next 0) is
    # first order too
    first_order = np.zeros(n, bool)
    first_order[0] = True
    first_order |= sig[1:] < 1e-14
    z = np.zeros(n)
    return {
        "sigma": sig[:n],
        "m1": np.where(sig[1:] >= 1e-14, m1, z),
        "m2": np.where(sig[1:] >= 1e-14, m2, z),
        "m3": np.where(first_order, z, m3),
        "m4": np.where(first_order, z, m4),
        "mn": mn,
        "first_order": first_order,
        "is_last": sig[1:] < 1e-14,
    }


def _dpmpp2m_sample(denoise_fn, x, sigmas, *, generator, noises, sde: bool):
    x, sig, n = _prep(x, sigmas)
    draw = _Draws(x, generator, noises)
    c = _dpmpp2m_tables(sig, n, sde=sde)
    tab = {k: (v if v.dtype == bool else _f32(v)) for k, v in c.items()}
    old_d = torch.zeros_like(x)
    for i in range(n):
        denoised = denoise_fn(x, tab["sigma"][i]).float()
        if tab["is_last"][i]:
            # at sigma_next == 0 the update is the denoised itself
            x_new = denoised
        else:
            d = denoised if tab["first_order"][i] else (
                tab["m3"][i] * denoised - tab["m4"][i] * old_d)
            x_new = tab["m1"][i] * x - tab["m2"][i] * d
            if sde:
                x_new = x_new + draw(i, x) * tab["mn"][i]
        x, old_d = x_new, denoised
    return x


def dpmpp2m_sample(denoise_fn: Callable, x, sigmas, *, generator=None,
                   noises=None):
    """DPMPP2MSampler (ODE, sampling.py:331-406); draws nothing."""
    return _dpmpp2m_sample(denoise_fn, x, sigmas, generator=generator,
                           noises=noises, sde=False)


def sde_dpmpp2m_sample(denoise_fn: Callable, x, sigmas, *, generator=None,
                       noises=None):
    """SDEDPMPP2MSampler (sampling.py:409-489)."""
    return _dpmpp2m_sample(denoise_fn, x, sigmas, generator=generator,
                           noises=noises, sde=True)


def linear_multistep_sample(denoise_fn: Callable, x, sigmas, *,
                            order: int = 4):
    """LinearMultistepSampler (sampling.py:217-252): an Adams-Bashforth
    update with exactly integrated Lagrange coefficients over the sigma
    grid; draws nothing."""
    x, sig, n = _prep(x, sigmas)
    coeff = np.zeros((n, order))
    for i in range(n):
        cur = min(i + 1, order)
        for j in range(cur):
            coeff[i, j] = linear_multistep_coeff(cur, sig, i, j)
    coeff = torch.from_numpy(coeff.astype(_F32)).to(x.device)
    sigma = _f32(sig[:n])
    ds = torch.zeros((order,) + tuple(x.shape), device=x.device)
    for i in range(n):
        denoised = denoise_fn(x, sigma[i]).float()
        d = _to_d(x, sigma[i], denoised)
        ds = torch.cat([d[None], ds[:-1]])   # the newest d first
        x = x + torch.tensordot(coeff[i], ds, dims=([0], [0]))
    return x
