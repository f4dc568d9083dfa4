"""Stage-2 training: VideoDiffusionLoss and the ControlNet train step
(counterpart of landiff_tpu/training/diffusion_loss.py).

Reference: sgm/modules/diffusionmodules/loss.py (VideoDiffusionLoss) and
sigma_sampling.py (DiscreteSampling). Only the control branch is trained
(freeze_dit=True, dit_video_concat.py:1190-1193).

Random draws. The JAX loss draws inside the traced function from one key:
the timestep index, the noise and the per-sample context dropout. Here
they are a `LossDraws` value, made by `draw_loss_inputs` from a
`torch.Generator` or handed in, which is how a test feeds both packages
the same draws.

On a mesh (`make_train_step_sp`, `make_train_step_mesh`) every rank draws
the WHOLE batch's LossDraws, as the one-device step does, and takes its
`data` rows, so that the mesh step equals the one-device step with the
same generator. Under "sp" (time > 1, model = 1: JAX's
make_train_step_sp) the network runs token-sharded over `time`
(dit.control_warp_forward_sp, ring attention) with whole weights; under
"tp" (model > 1) on each rank's heads (control_warp_forward_tp, the
tp_infer.prep_dit_tp layout); under "dp" (data alone) whole. The loss is
the sum over the data ranks of their rows' per-sample losses over the
whole batch size; the control gradients are summed over `time` and
`data`, and the update is optim.sharded_update (ZeRO over `data`).
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
from landiff_tpu_torch.utils import tree_leaves


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
                         remat: bool = True, ucg_rate: float = 0.0,
                         net=None):
    """v-pred L2 with 1/(1-acp) weighting; prefix frames kept clean and
    excluded from the loss (loss.py:155-172).

    rng: a torch.Generator on the latents' device, from which the step's
    draws are taken (draw_loss_inputs with ucg_rate, dp_rank, dp_size), or
    the LossDraws themselves. ucg_rate: with that probability per sample
    the text context is zeroed (draws.keep), the per-embedder
    unconditional-guidance dropout that trains CFG: the uc row at
    inference is exactly zeros. net: the network in place of
    dit.control_warp_forward, net(main, control, x, timesteps, context,
    semantic_feature) (a mesh's sharded forward)."""
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
    if net is None:
        def net(main, control, x, ts, ctx, sem):
            return dit_lib.control_warp_forward(
                main, control, x, ts, ctx, dit_cfg, sem,
                compute_dtype=compute_dtype, remat=remat)
    net_out = net(main_params, control_params, noised.to(compute_dtype),
                  idx.float(), context, sem_feature).float()
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


def mesh_mode(mesh_cfg) -> str:
    """The stage-2 trainer's layout on a mesh (JAX train.py:155-165):
    "sp" with time > 1 and model = 1; "tp" with model > 1 (time ranks, if
    any, repeat the work); "dp" with data alone."""
    if mesh_cfg.time > 1 and mesh_cfg.model == 1:
        return "sp"
    return "tp" if mesh_cfg.model > 1 else "dp"


def _draw_rows(draws: LossDraws, rows: slice) -> LossDraws:
    return LossDraws(draws.idx[rows], draws.noise[rows],
                     None if draws.keep is None else draws.keep[rows],
                     draws.sr_bits)


def mesh_loss_and_grads(ctx, control_params, main_params, sem_params,
                        latents, context, tokens, rng, dit_cfg, sampler_cfg,
                        tok_cfg, sem_cfg, *, fixed_frames: int = 0,
                        compute_dtype=torch.bfloat16, remat: bool = True,
                        attn_impl="auto", ucg_rate: float = 0.0):
    """One rank's loss and control gradients on a mesh (ctx: its
    RankContext; the parameters its parts in the layout of `mesh_mode`,
    the batch WHOLE, rng a torch.Generator or the whole batch's
    LossDraws). Returns (loss of the whole batch, the control gradients
    summed over the ranks that split the batch or the tokens, the whole
    batch's draws)."""
    from landiff_tpu_torch.parallel import mesh as mesh_lib

    mode = mesh_mode(ctx.cfg)
    from landiff_tpu_torch.data.loader import data_rows
    from landiff_tpu_torch.utils import freeze_tree

    n = ctx.cfg.data
    rows = data_rows(latents.shape[0], ctx.coords["data"], n)
    main_params, sem_params = freeze_tree(main_params), \
        freeze_tree(sem_params)
    draws = _as_draws(rng, latents.shape, sampler_cfg, ucg_rate=ucg_rate)
    kw = dict(attn_impl=attn_impl, compute_dtype=compute_dtype, remat=remat)
    if mode == "sp":
        def net(main, control, x, ts, c, sem):
            return dit_lib.control_warp_forward_sp(
                main, control, x, ts, c, dit_cfg, sem,
                sp_group=ctx.time_group, **kw)
    elif mode == "tp":
        def net(main, control, x, ts, c, sem):
            return dit_lib.control_warp_forward_tp(
                main, control, x, ts, c, dit_cfg, sem,
                group=ctx.model_group, **kw)
    else:
        def net(main, control, x, ts, c, sem):
            return dit_lib.control_warp_forward(
                main, control, x, ts, c, dit_cfg, sem, **kw)
    control_params = optim.require_grad(control_params)
    loss = video_diffusion_loss(
        main_params, control_params, sem_params, latents[rows],
        context[rows], tokens[rows], _draw_rows(draws, rows), dit_cfg,
        sampler_cfg, tok_cfg, sem_cfg, fixed_frames=fixed_frames,
        compute_dtype=compute_dtype, net=net) / n
    grads = optim.grad(loss, control_params)
    groups = [ctx.data_group] + ([ctx.time_group] if mode == "sp" else [])
    grads = mesh_lib.reduce_grads(grads, groups)
    return ctx.data_group.all_reduce(loss.detach()), grads, draws


def make_train_step_mesh(optimizer, dit_cfg, sampler_cfg, tok_cfg, sem_cfg,
                         *, ctx, dims, model_split, fixed_frames: int = 0,
                         compute_dtype=torch.bfloat16, remat: bool = True,
                         attn_impl="auto", ucg_rate: float = 0.0,
                         sr_bits=None, keep=None):
    """The ControlNet step on a rank of a mesh, any `mesh_mode`: as
    make_train_step's, (control_params, opt_state, main_params,
    sem_params, latents, context, tokens, rng) -> (control_params,
    opt_state, loss), with this rank's parameter parts, its ZeRO slices
    of the state (split dimensions `dims`; model_split the control
    leaves split over `model`, in leaf order) and the WHOLE batch.
    sr_bits: sr_bits(draws) -> this rank's parts of the whole leaves'
    stochastic-rounding bits (the one-device step's draws, cut as the
    parameters are), or None for the plain add. keep: a dict that gets
    each step's summed gradients under "grads" (for inspection)."""

    def train_step(control_params, opt_state, main_params, sem_params,
                   latents, context, tokens, rng):
        loss, grads, draws = mesh_loss_and_grads(
            ctx, control_params, main_params, sem_params, latents, context,
            tokens, rng, dit_cfg, sampler_cfg, tok_cfg, sem_cfg,
            fixed_frames=fixed_frames, compute_dtype=compute_dtype,
            remat=remat, attn_impl=attn_impl, ucg_rate=ucg_rate)
        if keep is not None:
            keep["grads"] = grads
        control_params, opt_state = optim.sharded_update(
            optimizer, grads, opt_state, control_params, dims=dims,
            model_split=model_split, data_group=ctx.data_group,
            model_group=ctx.model_group,
            sr_bits=None if sr_bits is None else sr_bits(draws))
        return control_params, opt_state, loss

    return train_step


def make_train_step_sp(optimizer, dit_cfg, sampler_cfg, tok_cfg, sem_cfg,
                       *, ctx, dims, **kw):
    """The sequence-parallel ControlNet step (JAX make_train_step_sp,
    diffusion_loss.py:141-233) on a rank of a (data, time) mesh: the
    45-layer forward and backward token-sharded over `time` (ring
    attention, whole weights), the batch over `data`. The control
    parameters are whole, so no leaf is split over `model`. See
    make_train_step_mesh for the contract."""
    if mesh_mode(ctx.cfg) != "sp":
        raise ValueError(f"the sequence-parallel step needs time > 1 and "
                         f"model = 1, not {ctx.cfg}")
    n_leaves = len(tree_leaves(dims))
    return make_train_step_mesh(optimizer, dit_cfg, sampler_cfg, tok_cfg,
                                sem_cfg, ctx=ctx, dims=dims,
                                model_split=[False] * n_leaves, **kw)
