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
Not ported yet (all opt-in): step reuse, the guidance window, the
deterministic samplers.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from landiff_tpu_torch.config import SamplerConfig
from landiff_tpu_torch.diffusion import schedule as sched


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
                         noises=None, fixed_frames: int = 0) -> torch.Tensor:
    """DPM-Solver++(2M) SDE in VP parameterization.

    x: (B, T, C, H, W) initial noise; if fixed_frames > 0, x[:, :f] are
    clean prefix latents spliced back every step. noises: optional
    per-step noise tensors like x (else drawn from `generator`)."""
    prefix = x[:, :fixed_frames] if fixed_frames > 0 else None
    x = x.float()
    old_d = torch.zeros_like(x)
    for i, step in enumerate(step_dicts(cfg)):
        if prefix is not None:
            x = torch.cat([prefix, x[:, fixed_frames:]], dim=1)
        denoised = denoise_fn(x, step).float()
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
