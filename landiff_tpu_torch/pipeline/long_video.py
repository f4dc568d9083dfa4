"""Long-video streaming generation (counterpart of
landiff_tpu/pipeline/long_video.py): prefix-conditioned chunked diffusion,
per-segment semantic tokens and one streaming VAE decode.

Reference mechanism: the sampler's `fixed_frames` prefix splice
(sampling.py:800-817, 834-836), the engine's prefix splice
(diffusion_video.py:287-288) and the VAE's conv-cache streaming decode
(dif_infer.py:245-271). The shipped config documents the chunking "49
frames, 13 latent, prefix 7 -> gen 25 new frames" (cogvideox yaml:213).

Stage 1 emits one 1,218-token block per 13-frame segment; each diffusion
chunk conditions on its segment's tokens and on the last `prefix_latents`
latent frames of the chunk before it. Draws come from one
torch.Generator in a fixed order (per segment: the initial latents, then
per step the sdedit prefix draw and the step's noise), or from `noises`,
the seam through which a test feeds the JAX key chain's draws.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from landiff_tpu_torch.config import LanDiffConfig
from landiff_tpu_torch.diffusion import engine

logger = logging.getLogger("landiff_tpu_torch.long_video")


def generate_long_video_latents(params, cfg: LanDiffConfig, context,
                                uc_context, codes, *,
                                generator: torch.Generator,
                                prefix_latents: int = 7,
                                sdedit: bool = False,
                                compute_dtype=torch.bfloat16,
                                noises=None, mesh=None, on_segment=None):
    """codes: flat semantic token stream, a multiple of the tokens per
    segment. Returns latents (1, T_total, C, H', W') f32 on the
    generator's device, T_total = 13 + (n_segments - 1) * (13 -
    prefix_latents).

    noises: optional list, per segment, of {"init": initial latents,
    "steps": per-step noises, "prefix": per-step sdedit prefix draws}
    replacing the generator's draws. on_segment: optional callback
    (seg_index, latents) after each segment's device work is done."""
    if mesh is not None:
        raise NotImplementedError(
            "device meshes are not ported yet: ROADMAP item 15")
    seg_tokens = cfg.tokenizer.titok.latent_tokens
    codes = np.asarray(codes).reshape(-1)
    if len(codes) % seg_tokens:
        raise ValueError(f"{len(codes)} codes are not whole segments of "
                         f"{seg_tokens}")
    n_seg = len(codes) // seg_tokens
    device = generator.device

    all_latents = None
    denoise_fn = None
    for seg in range(n_seg):
        tokens = torch.as_tensor(
            codes[seg * seg_tokens:(seg + 1) * seg_tokens]).reshape(
                1, -1).to(device)
        # one closure; per segment only the semantic feature changes
        if denoise_fn is None:
            denoise_fn = engine.make_denoise_fn(
                params["main"], params["control"], params["semantic"],
                cfg.dit, cfg.sampler, cfg.tokenizer, cfg.semantic_cond,
                context, uc_context, tokens, compute_dtype=compute_dtype)
        else:
            denoise_fn = engine.update_bundle_tokens(
                denoise_fn, params["semantic"], tokens, cfg.dit,
                cfg.tokenizer, cfg.semantic_cond,
                compute_dtype=compute_dtype)
        draws = noises[seg] if noises is not None else {}
        kw = dict(generator=generator, init_noise=draws.get("init"),
                  step_noise=draws.get("steps"))
        if all_latents is None:
            all_latents = engine.sample_latents(denoise_fn, cfg.sampler,
                                                cfg.dit, **kw)
        else:
            latents = engine.sample_latents(
                denoise_fn, cfg.sampler, cfg.dit,
                prefix=all_latents[:, -prefix_latents:], sdedit=sdedit,
                prefix_noise=draws.get("prefix"), **kw)
            all_latents = torch.cat(
                [all_latents, latents[:, prefix_latents:]], dim=1)
        if on_segment is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            on_segment(seg, all_latents)
        logger.info("segment %d/%d: latents %s", seg + 1, n_seg,
                    tuple(all_latents.shape))
    return all_latents


def generate_long_video(params, cfg: LanDiffConfig, context, uc_context,
                        codes, *, generator: torch.Generator,
                        prefix_latents: int = 7, sdedit: bool = False,
                        compute_dtype=torch.bfloat16, noises=None,
                        mesh=None, on_segment=None):
    """The whole long-video path: chunked latents -> one streaming VAE
    decode -> ((1, 3, T_rgb, H, W) video in [0, 1], latents)."""
    latents = generate_long_video_latents(
        params, cfg, context, uc_context, codes, generator=generator,
        prefix_latents=prefix_latents, sdedit=sdedit,
        compute_dtype=compute_dtype, noises=noises, mesh=mesh,
        on_segment=on_segment)
    video = engine.decode_first_stage(params["vae"], latents, cfg.vae,
                                      compute_dtype=compute_dtype)
    return engine.post_process_video(video), latents
