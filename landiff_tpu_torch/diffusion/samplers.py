"""VPSDE-DPM++2M sampler (counterpart of the default sampler of
landiff_tpu/diffusion/samplers.py; reference sgm/modules/
diffusionmodules/sampling.py:678-837).

The JAX scan becomes a Python loop over host-precomputed f64 coefficient
tables cast to f32. Per-step SDE noise comes from a torch.Generator, or
from an injected list of per-step noise tensors: the seam through which a
test feeds the noise the JAX key chain draws (samplers.py:142, :166).

denoise_fn contract (provided by the engine):
    denoised = denoise_fn(x, step) -> f32 tensor like x
with `step` a dict of per-step host scalars
    {"alpha": f32, "timestep": int, "idx": int, "cfg_scale": f32}.
With a guidance window the sampler calls `denoise_fn.cond_only(x, step)`
(the cond row alone) outside it. With a clean prefix (`fixed_frames`) and
`sdedit`, the prefix is re-noised to each step's alpha from its own draw
(`prefix_noises`, the seam for the JAX key chain's k_prefix draws, as
`noises` is for k_noise). Not ported yet: the deterministic samplers.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from landiff_tpu_torch.config import SamplerConfig
from landiff_tpu_torch.diffusion import schedule as sched

# always-compute windows of cross-step model-output reuse
# (LANDIFF_STEP_REUSE, samplers.py:33-34)
REUSE_HEAD_DEFAULT = 3
REUSE_TAIL_DEFAULT = 3


def reuse_compute_schedule(n: int, reuse_every: int,
                           head: int = REUSE_HEAD_DEFAULT,
                           tail: int = REUSE_TAIL_DEFAULT) -> np.ndarray:
    """bool[n], True = call the model (samplers.py:37-53). The first head
    and last tail steps compute (both clamped to >= 1: step 0 has no
    residual to reuse, the last step's denoised is the output); in between
    every reuse_every-th step from head computes."""
    head = max(1, int(head))
    tail = max(1, int(tail))
    compute = np.ones(n, bool)
    for i in range(head, n - tail):
        compute[i] = (i - head) % int(reuse_every) == 0
    return compute


def cfg_window_schedule(n: int, lo: int, hi: int) -> np.ndarray:
    """bool[n], True = both CFG rows, False = the cond row alone
    (samplers.py:84-91): guidance on steps [lo, hi), hi < 0 counting from
    the end."""
    hi = hi if hi >= 0 else n + hi
    mask = np.zeros(n, bool)
    mask[max(0, lo):max(0, min(n, hi))] = True
    return mask


def _per_step_arrays(cfg: SamplerConfig):
    t = sched.sampler_tables(cfg)
    n = cfg.num_steps
    m1 = np.zeros(n)
    m2 = np.zeros(n)
    m3 = np.zeros(n)
    m4 = np.zeros(n)
    mn = np.zeros(n)
    first_order = np.zeros(n, bool)
    for i in range(n):
        a, an, ap = t["alpha"][i], t["alpha_next"][i], t["alpha_prev"][i]
        c1, c2, c3, c4, cn = sched.dpmpp2m_coeffs(a, an, ap)
        m1[i], m2[i], mn[i] = c1, c2, cn
        if c3 is None or an < 1e-14:
            first_order[i] = True
        else:
            m3[i], m4[i] = c3, c4
    return t, {
        "m1": m1, "m2": m2, "m3": m3, "m4": m4, "mn": mn,
        "first_order": first_order,
        "is_last": t["idx"] == 1,
        "alpha": t["alpha"],
        "timestep": t["timestep"],
        "idx": t["idx"],
        "cfg_scale": t["cfg_scale"],
    }


def step_dicts(cfg: SamplerConfig) -> list[dict]:
    """The per-step scalars the loop hands to denoise_fn and uses itself:
    f32 coefficients (as the JAX scan's f32 tables), int indices, bools."""
    _, c = _per_step_arrays(cfg)
    steps = []
    for i in range(cfg.num_steps):
        s = {}
        for key, arr in c.items():
            if arr.dtype == bool:
                s[key] = bool(arr[i])
            elif key in ("timestep", "idx"):
                s[key] = int(arr[i])
            else:
                s[key] = float(np.float32(arr[i]))
        steps.append(s)
    return steps


def vpsde_dpmpp2m_sample(denoise_fn: Callable, x: torch.Tensor,
                         cfg: SamplerConfig, *,
                         generator: torch.Generator | None = None,
                         noises=None, fixed_frames: int = 0,
                         sdedit: bool = False, prefix_noises=None,
                         reuse_every: int = 0,
                         reuse_head: int = REUSE_HEAD_DEFAULT,
                         reuse_tail: int = REUSE_TAIL_DEFAULT,
                         cfg_window: tuple[int, int] | None = None
                         ) -> torch.Tensor:
    """DPM-Solver++(2M) SDE in VP parameterization.

    x: (B, T, C, H, W) initial noise; if fixed_frames > 0, x[:, :f] are
    clean prefix latents spliced back every step, or with sdedit
    (samplers.py:144-148) the prefix noised to the step's alpha, alpha *
    prefix + rd * sqrt(1 - alpha^2), rd a fresh draw like the prefix
    (prefix_noises[i], else from `generator` before the step's noise).
    noises: optional per-step noise tensors like x (else drawn from
    `generator`, one draw per step whether the model is called or not,
    samplers.py:166).

    reuse_every > 1 (samplers.py:158-163): on the steps
    reuse_compute_schedule marks False the model is not called and the
    step takes denoised = x + resid, the residual (denoised - x) of the
    last computed step. cfg_window (lo, hi): outside [lo, hi) the step
    calls denoise_fn.cond_only, the cond row alone (samplers.py:257-286).
    JAX segments the schedule into static programs; this loop chooses per
    step, which calls the same functions on the same steps."""
    n = cfg.num_steps
    compute = (reuse_compute_schedule(n, reuse_every, reuse_head, reuse_tail)
               if reuse_every and reuse_every > 1 else np.ones(n, bool))
    full = np.ones(n, bool)
    if cfg_window is not None:
        if getattr(denoise_fn, "cond_only", None) is None:
            raise ValueError(
                "cfg_window requested but denoise_fn has no .cond_only "
                "variant (engine.make_denoise_fn provides one)")
        full = cfg_window_schedule(n, *cfg_window)
    prefix = x[:, :fixed_frames].float() if fixed_frames > 0 else None
    x = x.float()
    old_d = torch.zeros_like(x)
    resid = None
    for i, step in enumerate(step_dicts(cfg)):
        if prefix is not None and sdedit:
            if prefix_noises is not None:
                rd = prefix_noises[i].to(x.device, torch.float32)
            else:
                rd = torch.randn(prefix.shape, generator=generator,
                                 device=x.device, dtype=torch.float32)
            a = torch.tensor(step["alpha"], dtype=torch.float32,
                             device=x.device)
            noised = a * prefix + rd * torch.sqrt(1.0 - a * a)
            x = torch.cat([noised, x[:, fixed_frames:]], dim=1)
        elif prefix is not None:
            x = torch.cat([prefix, x[:, fixed_frames:]], dim=1)
        if compute[i]:
            fn = denoise_fn if full[i] else denoise_fn.cond_only
            denoised = fn(x, step).float()
            resid = denoised - x
        else:
            denoised = x + resid
        if noises is not None:
            noise = noises[i].to(x.device, torch.float32)
        else:
            noise = torch.randn(x.shape, generator=generator,
                                device=x.device, dtype=torch.float32)
        if step["is_last"]:
            x_new = denoised
        elif step["first_order"]:
            x_new = (step["m1"] * x - step["m2"] * denoised
                     + step["mn"] * noise)
        else:
            denoised_d = step["m3"] * denoised - step["m4"] * old_d
            x_new = (step["m1"] * x - step["m2"] * denoised_d
                     + step["mn"] * noise)
        x, old_d = x_new, denoised
    if prefix is not None:
        x = torch.cat([prefix, x[:, fixed_frames:]], dim=1)
    return x
