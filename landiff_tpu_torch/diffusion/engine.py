"""Stage-2 diffusion engine (counterpart of landiff_tpu/diffusion/
engine.py): DiT(+control) + DiscreteDenoiser + DynamicCFG + the
VPSDE-DPM++2M sampler + the VAE first stage.

CFG batch order is [uncond, cond] (guiders.py prepare_inputs: cat(uc, c)).
The semantic feature is computed once and captured by the denoise closure
(the reference's InferValueRegistry cache).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from landiff_tpu_torch.config import DiTConfig, SamplerConfig, \
    SemanticCondConfig, TokenizerConfig, VAEConfig
from landiff_tpu_torch.diffusion import samplers, schedule
from landiff_tpu_torch.models import dit as dit_lib
from landiff_tpu_torch.models import semantic_cond as sc_lib
from landiff_tpu_torch.models import vae as vae_lib


@functools.lru_cache(maxsize=8)
def denoiser_quantized_alphas(cfg: SamplerConfig) -> np.ndarray:
    """DiscreteDenoiser.possibly_quantize_sigma (denoiser.py:63-72): snap
    each sampler alpha to the nearest entry of the full 1000-entry table."""
    table = schedule.zero_snr_sigmas(cfg, cfg.num_train_timesteps,
                                     return_idx=False)
    al = schedule.sampler_tables(cfg)["alpha"]
    idx = np.abs(al[None, :] - table[:, None]).argmin(axis=0)
    return table[idx]


def make_denoise_fn(main_params, control_params, sem_params,
                    dit_cfg: DiTConfig, sampler_cfg: SamplerConfig,
                    tok_cfg: TokenizerConfig, sem_cfg: SemanticCondConfig,
                    context, uc_context, semantic_tokens, *,
                    compute_dtype=torch.bfloat16):
    """The per-step denoise closure.

    context / uc_context: (B, 226, 4096); semantic_tokens: (B, L). Returns
    denoise_fn(x, step) -> f32 v-parameterized x0 prediction after the
    DynamicCFG combination (engine.py:99-123)."""
    q_alpha = denoiser_quantized_alphas(sampler_cfg).astype(np.float32)
    alpha_table = schedule.sampler_tables(sampler_cfg)["alpha"].astype(
        np.float32)
    ctx2 = torch.cat([uc_context, context], dim=0)          # [uc, c]
    sem = sc_lib.semantic_feature_from_tokens(
        sem_params, semantic_tokens, tok_cfg, sem_cfg,
        forward_t=dit_cfg.latent_frames, compute_dtype=compute_dtype)
    sem2 = torch.cat([sem, sem], dim=0)

    def denoise_fn(x, step):
        B = x.shape[0]
        # DiscreteDenoiser sigma quantization: nearest 1000-table entry,
        # in f32 as the JAX closure computes it
        a = np.float32(step["alpha"])
        alpha = q_alpha[np.argmin(np.abs(a - alpha_table))]
        c_skip = float(alpha)
        c_out = float(-np.sqrt(np.float32(1.0) - alpha * alpha))
        x2 = torch.cat([x, x], dim=0)
        ts = torch.full((2 * B,), float(step["timestep"]),
                        dtype=torch.float32, device=x.device)
        net_out = dit_lib.control_warp_forward(
            main_params, control_params, x2.to(compute_dtype), ts, ctx2,
            dit_cfg, sem2, compute_dtype=compute_dtype)
        denoised = net_out.float() * c_out + x2.float() * c_skip
        x_u, x_c = denoised[:B], denoised[B:]
        return x_u + step["cfg_scale"] * (x_c - x_u)

    return denoise_fn


def sample_latents(denoise_fn, sampler_cfg: SamplerConfig,
                   dit_cfg: DiTConfig, *, generator: torch.Generator,
                   init_noise=None, step_noise=None) -> torch.Tensor:
    """Engine.sample (diffusion_video.py:255-315), VPSDE branch: randn
    latents -> sampler loop. Returns (1, T, C, H, W) f32 on the
    generator's device. init_noise / step_noise: optional initial latents
    and per-step noises replacing the generator's draws."""
    if sampler_cfg.name != "vpsde_dpmpp2m":
        raise NotImplementedError(
            f"sampler {sampler_cfg.name!r} is not ported yet")
    device = generator.device
    if init_noise is not None:
        x = torch.as_tensor(init_noise, dtype=torch.float32).to(device)
    else:
        shape = (1, dit_cfg.latent_frames, dit_cfg.in_channels,
                 dit_cfg.latent_height, dit_cfg.latent_width)
        x = torch.randn(shape, generator=generator, device=device)
    return samplers.vpsde_dpmpp2m_sample(denoise_fn, x, sampler_cfg,
                                         generator=generator,
                                         noises=step_noise)


def decode_first_stage(vae_params, latents, vae_cfg: VAEConfig, *,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """latents (B, T, C, H', W') -> video (B, 3, T_out, H, W) in [-1, 1]
    (dif_infer.py:245-271: 1/scale_factor then serial chunked decode)."""
    z = latents.permute(0, 2, 1, 3, 4) / vae_cfg.scale_factor
    return vae_lib.decode_streaming(vae_params["decoder"], z, vae_cfg,
                                    compute_dtype=compute_dtype)


def post_process_video(video: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1] (dif_infer.py:37-49)."""
    return torch.clamp((video + 1.0) / 2.0, 0.0, 1.0)


def video_to_uint8(video: torch.Tensor) -> torch.Tensor:
    """[0, 1] float video -> uint8 on the device (utils.py:328-332)."""
    return torch.clamp(torch.round(video * 255.0), 0, 255).to(torch.uint8)
