"""Stage-2 inference wrapper: prompt + semantic tokens -> RGB video
(counterpart of landiff_tpu/pipeline/dif_infer.py; reference
landiff/diffusion/dif_infer.py CogWrapper.forward :152-243, decode_latent
:245-271, CogModelInferWrapper :274-302).

Everything stays on one device. Under LANDIFF_DIT_INT8 (LANDIFF_FAST >= 1)
the main and control DiTs are quantized to W8A8 once, at construction;
LANDIFF_STEP_REUSE / LANDIFF_CFG_WINDOW (LANDIFF_FAST=2) reach the sampler
through engine.sample_latents. Not ported yet: the mesh / TP path, prefix
video (image-to-video) and parameter offload.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from landiff_tpu_torch.config import LanDiffConfig
from landiff_tpu_torch.diffusion import engine
from landiff_tpu_torch.models import dit as dit_lib
from landiff_tpu_torch.models import semantic_cond as sc_lib
from landiff_tpu_torch.models import t5 as t5_lib
from landiff_tpu_torch.models import vae as vae_lib
from landiff_tpu_torch.pipeline.text import T5Text
from landiff_tpu_torch.utils import env_flag, seed_from_text


@dataclass
class VideoTask:
    """Matches dif_infer.py:91-98."""

    save_file_name: str
    prompt: str
    seed: int
    fps: int = 8
    semantic_token: np.ndarray | None = None
    result: np.ndarray | None = None        # (B, 3, T, H, W) in [0, 1]
    latent: np.ndarray | None = None        # (B, T, C, H', W')


class CogModelInferWrapper:
    """params: {"main": DiT, "control": control DiT, "semantic": semantic
    conditioner, "vae": VAE, "t5": stage-2 T5}, tensors on `device`.

    After each call, `phase_seconds` holds the host seconds (synchronised
    on the device) of its phases: t5, semantic, denoise, vae."""

    def __init__(self, params, cfg: LanDiffConfig,
                 tokenizer_dir: str | None = None,
                 compute_dtype=torch.bfloat16,
                 require_real_tokenizer: bool = False, device="cuda"):
        self.params = params
        if env_flag("LANDIFF_DIT_INT8"):
            # W8A8 DiT linears (dif_infer.py:64-72): the quantized trees
            # replace main and control; the caller's trees are untouched
            self.params = dict(params)
            for k in ("main", "control"):
                self.params[k] = dit_lib.quantize_int8(params[k])
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self.phase_seconds: dict[str, float] = {}
        # stage-2 T5: max_length 226, padding to max, no attention mask
        # (encoders/modules.py:271-289)
        self.text = T5Text(tokenizer_dir or cfg.t5.model_name or None,
                           max_length=cfg.dit.text_length,
                           padding_side="right",
                           require_real=require_real_tokenizer)

    def encode_text(self, prompt: str) -> torch.Tensor:
        ids, _ = self.text([prompt], pad_to_max=True)
        # the reference passes no attention mask: pads are attended (fp32)
        return t5_lib.encode(self.params["t5"],
                             torch.from_numpy(ids).to(self.device), None,
                             self.cfg.t5, compute_dtype=torch.float32)

    def _mark(self, name: str, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.phase_seconds[name] = t1 - t0
        return t1

    @torch.inference_mode()
    def __call__(self, task: VideoTask, init_noise=None,
                 step_noise=None) -> VideoTask:
        """init_noise: optional (1, T, C, H', W') initial latents replacing
        the seeded draw (the reference `generator` seam); step_noise:
        optional per-step sampler noises (the JAX key chain's draws)."""
        cfg = self.cfg
        if task.semantic_token is None:
            raise ValueError("stage-1 codes required")
        tokens = torch.as_tensor(np.asarray(task.semantic_token)).reshape(
            1, -1).to(self.device)
        # an explicit task seed is used directly; the text-hash
        # combination only backs a missing seed (dif_infer.py:190-195)
        seed = int(task.seed) if task.seed is not None else \
            seed_from_text(str(task.prompt), 42)
        gen = torch.Generator(device=self.device).manual_seed(seed)

        t0 = time.perf_counter()
        context = self.encode_text(task.prompt)
        uc_context = torch.zeros_like(context)   # force_uc_zero_embeddings
        t0 = self._mark("t5", t0)
        denoise_fn = engine.make_denoise_fn(
            self.params["main"], self.params["control"],
            self.params["semantic"], cfg.dit, cfg.sampler, cfg.tokenizer,
            cfg.semantic_cond, context, uc_context, tokens,
            compute_dtype=self.compute_dtype)
        t0 = self._mark("semantic", t0)
        latents = engine.sample_latents(
            denoise_fn, cfg.sampler, cfg.dit, generator=gen,
            init_noise=init_noise, step_noise=step_noise)
        t0 = self._mark("denoise", t0)
        video = engine.decode_first_stage(self.params["vae"], latents,
                                          cfg.vae,
                                          compute_dtype=self.compute_dtype)
        vid8 = engine.video_to_uint8(engine.post_process_video(video))
        vid8 = vid8.cpu().numpy()
        self._mark("vae", t0)
        return dataclasses.replace(task,
                                   result=vid8.astype(np.float32) / 255.0,
                                   latent=latents.float().cpu().numpy())


def init_params(gen: torch.Generator, cfg: LanDiffConfig,
                dtype=torch.float32):
    """Random stage-2 parameters built on the generator's device."""
    return {
        "main": dit_lib.init(gen, cfg.dit, dtype=dtype),
        "control": dit_lib.init(gen, cfg.dit, control=True, dtype=dtype),
        "semantic": sc_lib.init(gen, cfg.tokenizer, cfg.semantic_cond, dtype),
        "vae": vae_lib.init(gen, cfg.vae, dtype),
        "t5": t5_lib.init(gen, cfg.t5, dtype),
    }
