"""Stage-2 training: VideoDiffusionLoss and the ControlNet train step
(counterpart of landiff_tpu/training/diffusion_loss.py).

Reference: sgm/modules/diffusionmodules/loss.py (VideoDiffusionLoss) and
sigma_sampling.py (DiscreteSampling). Only the control branch is trained
(freeze_dit=True, dit_video_concat.py:1190-1193).

Random draws. The JAX loss draws inside the traced function from one key:
the timestep index, the noise and the per-sample context dropout. Here
they are a `LossDraws` value, made by `draw_loss_inputs` from a
`torch.Generator` or handed in, which is how a test feeds both packages
the same draws. Not ported yet: the sequence-parallel step
(make_train_step_sp).
"""

from __future__ import annotations

import dataclasses

import torch

from landiff_tpu_torch.config import DiTConfig, SamplerConfig, \
    SemanticCondConfig, TokenizerConfig
from landiff_tpu_torch.diffusion import schedule
from landiff_tpu_torch.models import dit as dit_lib
from landiff_tpu_torch.models import semantic_cond as sc_lib
from landiff_tpu_torch.training import optim, sr


def uniform_sigma_indices(gen: torch.Generator, n_samples: int, num_idx: int,
                          dp_rank: int = 0, dp_size: int = 1) -> torch.Tensor:
    """DiscreteSampling uniform_sampling groups (sigma_sampling.py:31-63):
    rank r draws timesteps from its group's interval so a DP batch covers
    the noise levels evenly."""
    i = 1
    while dp_size % i != 0 or num_idx % (dp_size // i) != 0:
        i += 1
    group_num = dp_size // i
    group_width = dp_size // group_num
    interval = num_idx // group_num
    g = dp_rank // group_width
    return torch.randint(g * interval, (g + 1) * interval, (n_samples,),
                         generator=gen, device=gen.device)


@dataclasses.dataclass
class LossDraws:
    """One step's random inputs: idx (B,) timestep indices, noise like the
    latents (f32), keep (B,) bool context-dropout mask or None, sr_bits a
    tree of stochastic-rounding bits like the control parameters, a
    generator to draw them from, or None."""

    idx: torch.Tensor
    noise: torch.Tensor
    keep: torch.Tensor | None = None
    sr_bits: object = None


def draw_loss_inputs(gen: torch.Generator, latents_shape, num_idx: int, *,
                     ucg_rate: float = 0.0, dp_rank: int = 0,
                     dp_size: int = 1) -> LossDraws:
    """The draws of one step from `gen`, on its device, in the order of
    the JAX loss (index, noise, dropout); sr_bits is `gen` itself."""
    B = latents_shape[0]
    idx = uniform_sigma_indices(gen, B, num_idx, dp_rank, dp_size)
    noise = torch.randn(tuple(latents_shape), generator=gen,
                        device=gen.device, dtype=torch.float32)
    keep = None
    if ucg_rate > 0.0:
        keep = torch.rand((B,), generator=gen,
                          device=gen.device) < 1.0 - ucg_rate
    return LossDraws(idx, noise, keep, gen)


def _as_draws(rng, latents_shape, sampler_cfg: SamplerConfig, *, ucg_rate,
              dp_rank=0, dp_size=1) -> LossDraws:
    """rng as LossDraws: itself, or drawn from a torch.Generator."""
    if isinstance(rng, LossDraws):
        return rng
    return draw_loss_inputs(rng, latents_shape,
                            sampler_cfg.num_train_timesteps,
                            ucg_rate=ucg_rate, dp_rank=dp_rank,
                            dp_size=dp_size)


def video_diffusion_loss(main_params, control_params, sem_params,
                         latents, context, semantic_tokens, rng,
                         dit_cfg: DiTConfig, sampler_cfg: SamplerConfig,
                         tok_cfg: TokenizerConfig,
                         sem_cfg: SemanticCondConfig, *,
                         fixed_frames: int = 0, dp_rank: int = 0,
                         dp_size: int = 1, compute_dtype=torch.bfloat16,
                         remat: bool = True, ucg_rate: float = 0.0):
    """v-pred L2 with 1/(1-acp) weighting; prefix frames kept clean and
    excluded from the loss (loss.py:155-172).

    rng: a torch.Generator on the latents' device, from which the step's
    draws are taken (draw_loss_inputs with ucg_rate, dp_rank, dp_size), or
    the LossDraws themselves. ucg_rate: with that probability per sample
    the text context is zeroed (draws.keep), the per-embedder
    unconditional-guidance dropout that trains CFG: the uc row at
    inference is exactly zeros."""
    B = latents.shape[0]
    draws = _as_draws(rng, latents.shape, sampler_cfg, ucg_rate=ucg_rate,
                      dp_rank=dp_rank, dp_size=dp_size)
    if draws.keep is not None:
        context = context * draws.keep[:, None, None].to(context.dtype)
    table = torch.from_numpy(
        schedule.zero_snr_sigmas(sampler_cfg, sampler_cfg.num_train_timesteps,
                                 return_idx=False).copy()
    ).to(latents.device, torch.float32)
    idx = draws.idx
    a = table[idx].reshape(B, 1, 1, 1, 1)              # alpha_cumprod_sqrt
    x = latents.float()
    noised = x * a + draws.noise * torch.sqrt(1.0 - a ** 2)
    if fixed_frames > 0:
        noised = torch.cat([x[:, :fixed_frames], noised[:, fixed_frames:]],
                           dim=1)

    sem_feature = sc_lib.semantic_feature_from_tokens(
        sem_params, semantic_tokens, tok_cfg, sem_cfg,
        forward_t=dit_cfg.latent_frames, compute_dtype=compute_dtype)

    # DiscreteDenoiser: c_skip=a, c_out=-sqrt(1-a^2), c_in=1, c_noise=idx.
    # remat defaults ON for training: a 30L+15L backward at S=17,776
    # holds every layer's activations otherwise
    net_out = dit_lib.control_warp_forward(
        main_params, control_params, noised.to(compute_dtype),
        idx.float(), context, dit_cfg, sem_feature,
        compute_dtype=compute_dtype, remat=remat).float()
    denoised = net_out * (-torch.sqrt(1.0 - a ** 2)) + noised * a

    w = 1.0 / (1.0 - a ** 2)
    tgt, out = x, denoised
    if fixed_frames > 0:
        tgt = tgt[:, fixed_frames:]
        out = out[:, fixed_frames:]
        w = w.expand(x.shape)[:, fixed_frames:]
    per_sample = (w * (out - tgt) ** 2).reshape(B, -1).mean(dim=1)
    return per_sample.mean()


def make_train_step(optimizer, dit_cfg, sampler_cfg, tok_cfg, sem_cfg, *,
                    fixed_frames: int = 0, compute_dtype=torch.bfloat16,
                    remat: bool = True, ucg_rate: float = 0.0,
                    sr_updates: bool = False):
    """ControlNet training step: gradients with respect to the control
    branch only (freeze_dit semantics); the main DiT and the semantic
    conditioner are inputs. Step signature, as JAX's with the key replaced
    by a generator or the draws:
    (control_params, opt_state, main_params, sem_params, latents, context,
    tokens, rng) -> (control_params, opt_state, loss).

    sr_updates=True applies the updates with stochastic rounding on bf16
    leaves (training/sr.py), with bits from the generator or from
    draws.sr_bits."""

    def train_step(control_params, opt_state, main_params, sem_params,
                   latents, context, tokens, rng):
        draws = _as_draws(rng, latents.shape, sampler_cfg,
                          ucg_rate=ucg_rate)
        control_params = optim.require_grad(control_params)
        loss = video_diffusion_loss(
            main_params, control_params, sem_params, latents, context,
            tokens, draws, dit_cfg, sampler_cfg, tok_cfg, sem_cfg,
            fixed_frames=fixed_frames, compute_dtype=compute_dtype,
            remat=remat)
        grads = optim.grad(loss, control_params)
        updates, opt_state = optimizer.update(grads, opt_state,
                                              control_params)
        if sr_updates:
            control_params = sr.apply_updates_sr(control_params, updates,
                                                 draws.sr_bits)
        else:
            control_params = optim.apply_updates(control_params, updates)
        return control_params, opt_state, loss.detach()

    return train_step
