"""Stage-2 diffusion engine (counterpart of landiff_tpu/diffusion/
engine.py): DiT(+control) + DiscreteDenoiser + DynamicCFG + the sampler
chosen by `SamplerConfig.name` (VPSDE-DPM++2M by default, VPODE-DPM++2M,
Video-DDIM) + the VAE first stage (decode, context-parallel over a
`time` group too, and encode for prefix video).

CFG batch order is [uncond, cond] (guiders.py prepare_inputs: cat(uc, c)).
The semantic feature is computed once and captured by the denoise closure
(the reference's InferValueRegistry cache); `update_bundle_tokens` makes
the closure of the next long-video segment, for which only that feature
changes.
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
from landiff_tpu_torch.observability import named_scope
from landiff_tpu_torch.utils import env_value, logger


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
                    compute_dtype=torch.bfloat16, net=None):
    """The per-step denoise closure.

    context / uc_context: (B, 226, 4096); semantic_tokens: (B, L). Returns
    denoise_fn(x, step) -> f32 v-parameterized x0 prediction after the
    DynamicCFG combination (engine.py:99-123), with its twin
    denoise_fn.cond_only(x, step): the cond row alone, batch B, no CFG
    combination (engine.py:125-145), for steps outside a guidance
    window. net: the network call net(x2, ts, ctx2, sem2) -> output in
    place of control_warp_forward on the parameters (the tensor-parallel
    one, parallel/tp_infer.py); the closure then has no cond_only twin."""
    sem = sc_lib.semantic_feature_from_tokens(
        sem_params, semantic_tokens, tok_cfg, sem_cfg,
        forward_t=dit_cfg.latent_frames, compute_dtype=compute_dtype)
    ctx2 = torch.cat([uc_context, context], dim=0)          # [uc, c]
    return _denoise_closure(main_params, control_params, dit_cfg,
                            sampler_cfg, ctx2, sem, compute_dtype, net)


def update_bundle_tokens(denoise_fn, sem_params, semantic_tokens,
                         dit_cfg: DiTConfig, tok_cfg: TokenizerConfig,
                         sem_cfg: SemanticCondConfig, *,
                         compute_dtype=torch.bfloat16):
    """The denoise closure of the next long-video segment (engine.py:73):
    only the semantic feature is computed again, from that segment's
    tokens; parameters, text context, schedule tables and the network
    (a tensor-parallel one too: JAX's update_tp_bundle) are shared."""
    main_params, control_params, sampler_cfg, ctx2, net = denoise_fn.shared
    sem = sc_lib.semantic_feature_from_tokens(
        sem_params, semantic_tokens, tok_cfg, sem_cfg,
        forward_t=dit_cfg.latent_frames, compute_dtype=compute_dtype)
    return _denoise_closure(main_params, control_params, dit_cfg,
                            sampler_cfg, ctx2, sem, compute_dtype, net)


def _denoise_closure(main_params, control_params, dit_cfg: DiTConfig,
                     sampler_cfg: SamplerConfig, ctx2, sem, compute_dtype,
                     net=None):
    q_alpha = denoiser_quantized_alphas(sampler_cfg).astype(np.float32)
    alpha_table = schedule.sampler_tables(sampler_cfg)["alpha"].astype(
        np.float32)
    sem2 = torch.cat([sem, sem], dim=0)

    def scalings(step):
        # DiscreteDenoiser sigma quantization: nearest 1000-table entry,
        # in f32 as the JAX closure computes it
        a = np.float32(step["alpha"])
        alpha = q_alpha[np.argmin(np.abs(a - alpha_table))]
        return float(alpha), float(-np.sqrt(np.float32(1.0) - alpha * alpha))

    def whole_net(x2, ts, c2, s2):
        return dit_lib.control_warp_forward(
            main_params, control_params, x2, ts, c2, dit_cfg, s2,
            compute_dtype=compute_dtype)

    def denoise_fn(x, step):
        with named_scope("landiff.denoise.call"):
            B = x.shape[0]
            c_skip, c_out = scalings(step)
            x2 = torch.cat([x, x], dim=0)
            ts = torch.full((2 * B,), float(step["timestep"]),
                            dtype=torch.float32, device=x.device)
            net_out = (net or whole_net)(x2.to(compute_dtype), ts, ctx2,
                                         sem2)
            denoised = net_out.float() * c_out + x2.float() * c_skip
            x_u, x_c = denoised[:B], denoised[B:]
            return x_u + step["cfg_scale"] * (x_c - x_u)

    def cond_only(x, step):
        with named_scope("landiff.denoise.call"):
            B = x.shape[0]
            c_skip, c_out = scalings(step)
            ts = torch.full((B,), float(step["timestep"]),
                            dtype=torch.float32, device=x.device)
            net_out = whole_net(x.to(compute_dtype), ts, ctx2[B:], sem)
            return net_out.float() * c_out + x.float() * c_skip

    if net is None:
        denoise_fn.cond_only = cond_only
    denoise_fn.shared = (main_params, control_params, sampler_cfg, ctx2, net)
    return denoise_fn


def sample_latents(denoise_fn, sampler_cfg: SamplerConfig,
                   dit_cfg: DiTConfig, *, generator: torch.Generator,
                   init_noise=None, step_noise=None, prefix=None,
                   sdedit: bool = False, prefix_noise=None,
                   reuse_every: int | None = None,
                   cfg_window: tuple[int, int] | None = None) -> torch.Tensor:
    """Engine.sample (diffusion_video.py:255-315): randn latents ->
    sampler loop. Returns (1, T, C, H, W) f32 on the
    generator's device. init_noise / step_noise: optional initial latents
    and per-step noises replacing the generator's draws. prefix: clean
    latents (1, f, C, H, W) spliced over the first f frames and held there
    (the long-video prefix, diffusion_video.py:287-288), re-noised per step
    with sdedit (prefix_noise: its per-step draws).

    reuse_every (default LANDIFF_STEP_REUSE, off) and cfg_window (default
    LANDIFF_CFG_WINDOW "lo,hi", off), as JAX reads them (engine.py:
    179-198), LANDIFF_FAST=2 supplying both: a window from the environment
    is dropped with a warning when denoise_fn has no cond_only twin; an
    explicit cfg_window without one raises in the sampler.

    sampler_cfg.name picks the sampler as the reference's yaml target does
    (engine.py:210-221): "vpsde_dpmpp2m", or the deterministic
    "vpode_dpmpp2m" / "video_ddim", which draw only the initial latents
    and drop step_noise, sdedit, reuse and the window without a word, as
    the reference does; another name raises ValueError."""
    if reuse_every is None:
        reuse_every = int(env_value("LANDIFF_STEP_REUSE", "0") or 0)
    if cfg_window is None:
        env = env_value("LANDIFF_CFG_WINDOW", "")
        if env:
            lo, hi = env.split(",")
            cfg_window = (int(lo), int(hi))
            if getattr(denoise_fn, "cond_only", None) is None:
                logger.warning("LANDIFF_CFG_WINDOW ignored: denoise_fn has "
                               "no cond_only variant")
                cfg_window = None
    device = generator.device
    if init_noise is not None:
        x = torch.as_tensor(init_noise, dtype=torch.float32).to(device)
    else:
        shape = (1, dit_cfg.latent_frames, dit_cfg.in_channels,
                 dit_cfg.latent_height, dit_cfg.latent_width)
        x = torch.randn(shape, generator=generator, device=device)
    fixed = 0
    if prefix is not None:
        fixed = prefix.shape[1]
        x = torch.cat([prefix.float().to(device), x[:, fixed:]], dim=1)
    name = sampler_cfg.name
    if name == "vpode_dpmpp2m":
        return samplers.vpode_dpmpp2m_sample(denoise_fn, x, sampler_cfg,
                                             fixed_frames=fixed)
    if name == "video_ddim":
        return samplers.video_ddim_sample(denoise_fn, x, sampler_cfg,
                                          fixed_frames=fixed)
    if name != "vpsde_dpmpp2m":
        raise ValueError(f"unknown sampler name: {name!r}")
    return samplers.vpsde_dpmpp2m_sample(denoise_fn, x, sampler_cfg,
                                         generator=generator,
                                         noises=step_noise,
                                         fixed_frames=fixed, sdedit=sdedit,
                                         prefix_noises=prefix_noise,
                                         reuse_every=reuse_every,
                                         cfg_window=cfg_window)


def decode_first_stage(vae_params, latents, vae_cfg: VAEConfig, *,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """latents (B, T, C, H', W') -> video (B, 3, T_out, H, W) in [-1, 1]
    (dif_infer.py:245-271: 1/scale_factor then serial chunked decode)."""
    z = latents.permute(0, 2, 1, 3, 4) / vae_cfg.scale_factor
    return vae_lib.decode_streaming(vae_params["decoder"], z, vae_cfg,
                                    compute_dtype=compute_dtype)


def decode_first_stage_cp(vae_params, latents, vae_cfg: VAEConfig, group,
                          *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """decode_first_stage with the frames over the ranks of a `time`
    Group (engine.py:250-261, parallel/vae_cp.py): called by every rank of
    the group with the whole latents; the f32 video on every rank. The
    whole video's GroupNorm statistics, where the streaming decode takes
    each chunk's."""
    from landiff_tpu_torch.parallel import vae_cp

    z = latents.permute(0, 2, 1, 3, 4) / vae_cfg.scale_factor
    return vae_cp.decode_cp(vae_params["decoder"], z, vae_cfg, group,
                            compute_dtype=compute_dtype).float()


def encode_first_stage(vae_params, video, vae_cfg: VAEConfig, *,
                       generator: torch.Generator | None = None,
                       noise: torch.Tensor | None = None,
                       compute_dtype=torch.bfloat16,
                       streaming: bool = False) -> torch.Tensor:
    """video (B, 3, T, H, W) in [-1, 1] -> scaled latents (B, T', z, H/8,
    W/8) (diffusion_video.py:232-253): the posterior's mode, or a sample
    with a generator or a given noise (vae.sample_posterior). streaming:
    the chunked encode (vae.encode_streaming), whose per-chunk GroupNorm
    statistics make it a different function from the whole encode."""
    enc = vae_lib.encode_streaming if streaming else vae_lib.encode
    moments = enc(vae_params["encoder"], video, vae_cfg,
                  compute_dtype=compute_dtype)
    z = vae_lib.sample_posterior(moments, generator, noise)
    return (vae_cfg.scale_factor * z).permute(0, 2, 1, 3, 4)


def pre_process_video(video: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1] (dif_infer.py:22-34)."""
    return torch.clamp(video * 2.0 - 1.0, -1.0, 1.0)


def post_process_video(video: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1] (dif_infer.py:37-49)."""
    with named_scope("landiff.vae.post"):
        return torch.clamp((video + 1.0) / 2.0, 0.0, 1.0)


def video_to_uint8(video: torch.Tensor) -> torch.Tensor:
    """[0, 1] float video -> uint8 on the device (utils.py:328-332)."""
    with named_scope("landiff.vae.post"):
        return torch.clamp(torch.round(video * 255.0), 0,
                           255).to(torch.uint8)
