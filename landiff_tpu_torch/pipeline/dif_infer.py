"""Stage-2 inference wrapper: prompt + semantic tokens -> RGB video
(counterpart of landiff_tpu/pipeline/dif_infer.py; reference
landiff/diffusion/dif_infer.py CogWrapper.forward :152-243, decode_latent
:245-271, CogModelInferWrapper :274-302).

Without a mesh everything stays on one device. Under LANDIFF_DIT_INT8
(LANDIFF_FAST >= 1) the main and control DiTs are quantized to W8A8 once,
at construction;
LANDIFF_STEP_REUSE / LANDIFF_CFG_WINDOW (LANDIFF_FAST=2) reach the sampler
through engine.sample_latents. A prefix video (image-to-video,
continuation) is VAE-encoded to the clean latents the sampler holds over
the first frames. With LANDIFF_OFFLOAD=1 the diffusion trees (main,
control, semantic) leave the device after the denoise and before the VAE
decode, and come back at the start of the next call.

With a mesh (parallel/mesh.py) the main and control DiTs are placed by
the mesh's mode (parallel/tp_infer.py): under `model` laid out for
tensor parallelism and sharded (W8A8 after that prep, never before),
under `time` alone whole on every rank (W8A8 as without a mesh), the
tokens then split over `time`; the semantic conditioner whole on every
rank. The T5 is sharded by T5_RULES under `model`, else it stays in this
process, rank 0, as does the VAE. A call sends one denoise command (the
context, the codes, the initial noise drawn here and the generator's
state after it; a T5 command before it under `model`): every rank runs
the sampler on its shards. Rank 0 decodes, but where `time` > 1 and the
latent frames split over it (vae_cp.can_decode_cp, JAX :165-176): then
the time ranks at data 0, model 0, each holding the decoder, decode the
frames context-parallel (`decode_latents`). LANDIFF_OFFLOAD moves every
rank's diffusion trees.
"""

from __future__ import annotations

import dataclasses
import os
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
from landiff_tpu_torch.parallel import mesh as mesh_lib
from landiff_tpu_torch.parallel import tp_infer, vae_cp
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
    on the device) of its phases: restage (after an offload), t5,
    vae_encode (with a prefix video), semantic (with a mesh inside
    denoise), denoise, offload (with LANDIFF_OFFLOAD=1), vae.

    mesh: a parallel.mesh.Mesh to shard onto (module docstring); the
    ranks' trees are then this wrapper's `params` but "vae" (rank 0's
    parts), and `device` is rank 0's."""

    def __init__(self, params, cfg: LanDiffConfig,
                 tokenizer_dir: str | None = None,
                 compute_dtype=torch.bfloat16,
                 require_real_tokenizer: bool = False, mesh=None,
                 device="cuda"):
        self.params = params
        self.mesh = mesh
        if mesh is not None:
            self.key = f"stage2/{id(self)}"
            _load_on_mesh(mesh, self.key, params, cfg, compute_dtype)
            state = mesh.ctx.state[self.key]
            self.params = {**state, "vae": params["vae"],
                           "t5": state.get("t5", params["t5"])}
            device = mesh.ctx.device
        elif env_flag("LANDIFF_DIT_INT8"):
            # W8A8 DiT linears (dif_infer.py:64-72): the quantized trees
            # replace main and control; the caller's trees are untouched
            self.params = dict(params)
            for k in ("main", "control"):
                self.params[k] = dit_lib.quantize_int8(params[k])
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self.phase_seconds: dict[str, float] = {}
        self.offloaded = False
        # stage-2 T5: max_length 226, padding to max, no attention mask
        # (encoders/modules.py:271-289)
        self.text = T5Text(tokenizer_dir or cfg.t5.model_name or None,
                           max_length=cfg.dit.text_length,
                           padding_side="right",
                           require_real=require_real_tokenizer)

    def offload_diffusion_params(self):
        """Move the diffusion trees (main, control, semantic) to host
        memory, freeing their device memory before the VAE decode: the
        reference's model.cpu() / cuda() swap (infer_video.py:83-85). Pinned
        host memory, so that the restage copies at full rate. The trees'
        dicts and lists stay the same objects, so a holder of a subtree
        keeps no device tensor alive; a closure over the leaves themselves
        (the denoise closure) must be dropped first. On a mesh every rank
        moves its own."""
        if self.mesh is not None:
            self.mesh.run(_move_rank, self.key, True)
            self.offloaded = True
            return
        for k in _OFFLOADED:
            if k in self.params:
                _move_tree_(self.params[k], torch.device("cpu"))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.offloaded = True

    def restage_diffusion_params(self):
        """Bring offloaded diffusion trees back to the wrapper's device
        (JAX restages host arrays at the next jitted call; the port does it
        here, at the start of a call). Idempotent; dtypes and containers
        are kept."""
        if not self.offloaded:
            return
        if self.mesh is not None:
            self.mesh.run(_move_rank, self.key, False)
            self.offloaded = False
            return
        for k in _OFFLOADED:
            if k in self.params:
                _move_tree_(self.params[k], self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.offloaded = False

    def encode_text(self, prompt: str) -> torch.Tensor:
        ids, _ = self.text([prompt], pad_to_max=True)
        ids = torch.from_numpy(ids).to(self.device)
        # the reference passes no attention mask: pads are attended (fp32)
        if self.mesh is not None and self.mesh.cfg.model > 1:
            return self.mesh.run(tp_infer.t5_encode, self.key, ids, None,
                                 self.cfg.t5, torch.float32)[0]
        return t5_lib.encode(self.params["t5"], ids, None, self.cfg.t5,
                             compute_dtype=torch.float32)

    def _mark(self, name: str, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.phase_seconds[name] = t1 - t0
        return t1

    @torch.inference_mode()
    def __call__(self, task: VideoTask, prefix_video=None, init_noise=None,
                 step_noise=None) -> VideoTask:
        """prefix_video: optional (1, 3, T0, H, W) in [0, 1], image to
        video or continuation: encoded (the posterior's mode, the whole
        clip) into prefix latents the sampler splices over the first
        frames each step (diffusion_video.py:287-288, sampling.py:800-817).
        init_noise: optional (1, T, C, H', W') initial latents replacing
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

        self.phase_seconds = {}
        t0 = time.perf_counter()
        if self.offloaded:
            self.restage_diffusion_params()
            t0 = self._mark("restage", t0)
        context = self.encode_text(task.prompt)
        uc_context = torch.zeros_like(context)   # force_uc_zero_embeddings
        t0 = self._mark("t5", t0)
        prefix = None
        if prefix_video is not None:
            pv = engine.pre_process_video(torch.as_tensor(
                np.asarray(prefix_video), dtype=torch.float32).to(
                    self.device))
            prefix = engine.encode_first_stage(
                self.params["vae"], pv, cfg.vae,
                compute_dtype=self.compute_dtype)
            t0 = self._mark("vae_encode", t0)
        if self.mesh is not None:
            # the draw sample_latents makes first, made here; the ranks
            # go on from the generator's state after it
            if init_noise is None:
                d = cfg.dit
                init_noise = torch.randn(
                    (1, d.latent_frames, d.in_channels, d.latent_height,
                     d.latent_width), generator=gen, device=self.device)
            latents = self.mesh.run(
                _denoise_rank, self.key, cfg, self.compute_dtype, context,
                uc_context, tokens, torch.as_tensor(init_noise).to(
                    self.device), gen.get_state().numpy(), step_noise,
                prefix)[0]
            denoise_fn = None
        else:
            denoise_fn = engine.make_denoise_fn(
                self.params["main"], self.params["control"],
                self.params["semantic"], cfg.dit, cfg.sampler, cfg.tokenizer,
                cfg.semantic_cond, context, uc_context, tokens,
                compute_dtype=self.compute_dtype)
            t0 = self._mark("semantic", t0)
            latents = engine.sample_latents(
                denoise_fn, cfg.sampler, cfg.dit, generator=gen,
                init_noise=init_noise, step_noise=step_noise, prefix=prefix)
        t0 = self._mark("denoise", t0)
        if os.environ.get("LANDIFF_OFFLOAD") == "1":
            del denoise_fn      # its closure holds the DiT trees
            self.offload_diffusion_params()
            t0 = self._mark("offload", t0)
        video = self.decode_latents(latents)
        vid8 = engine.video_to_uint8(engine.post_process_video(video))
        vid8 = vid8.cpu().numpy()
        self._mark("vae", t0)
        return dataclasses.replace(task,
                                   result=vid8.astype(np.float32) / 255.0,
                                   latent=latents.float().cpu().numpy())


    def decode_latents(self, latents) -> torch.Tensor:
        """latents (1, T, C, H', W') -> the f32 video in [-1, 1]: on a mesh
        with `time` > 1 whose ranks split the frames, one context-parallel
        decode command (the whole video's GroupNorm statistics); else the
        streaming decode in this process (dif_infer.py:165-176)."""
        n = self.mesh.cfg.time if self.mesh is not None else 1
        if n > 1 and vae_cp.can_decode_cp(latents.shape[1], n):
            return self.mesh.run(_decode_cp_rank, self.key, latents,
                                 self.cfg.vae, self.compute_dtype)[0]
        return engine.decode_first_stage(self.params["vae"], latents,
                                         self.cfg.vae,
                                         compute_dtype=self.compute_dtype)


_OFFLOADED = ("main", "control", "semantic")


def _move_tree_(tree, device: torch.device):
    """Move every tensor leaf of a tree of dicts and lists to `device` in
    place, into pinned host memory when it leaves a CUDA device."""
    for k, v in (tree.items() if isinstance(tree, dict)
                 else enumerate(tree)):
        if isinstance(v, (dict, list)):
            _move_tree_(v, device)
        elif isinstance(v, torch.Tensor) and v.device != device:
            if device.type == "cpu" and v.is_cuda:
                host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                tree[k] = host.copy_(v, non_blocking=True)
            else:
                tree[k] = v.to(device, non_blocking=True)


def _load_on_mesh(mesh, key, params, cfg: LanDiffConfig, compute_dtype):
    """Every rank's stage-2 trees under `key`, one part at a time: the T5
    by T5_RULES under `model` (else none: rank 0 keeps it); main and
    control by the mesh's mode (tp_infer.dit_shards; W8A8 under
    LANDIFF_DIT_INT8, after the tp prep, JAX dif_infer.py:65-72), cast to
    the compute dtype; the semantic conditioner whole; under `time` the
    VAE decoder on the time ranks at data 0, model 0 (rank 0's own)."""
    int8 = env_flag("LANDIFF_DIT_INT8")
    if mesh.cfg.model > 1:
        mesh_lib.load(mesh, key, "t5", tp_infer.t5_shards(
            params["t5"], cfg.t5, mesh.cfg, mesh.devices))
    for k in ("main", "control"):
        mesh_lib.load(mesh, key, k, tp_infer.dit_shards(
            params[k], cfg.dit, mesh.cfg, mesh.devices, int8=int8,
            dtype=compute_dtype))
    mesh_lib.load(mesh, key, "semantic",
                  tp_infer.replicated(params["semantic"], mesh.devices))
    if mesh.cfg.time > 1:
        dec = {"decoder": params["vae"]["decoder"]}
        mesh_lib.load(mesh, key, "vae", [
            dec if _decodes(mesh_lib.rank_coords(mesh.cfg, r)) else {}
            for r in range(mesh.cfg.num_devices)])


def _decodes(coords) -> bool:
    """Whether a rank takes part in the context-parallel decode: the time
    group at data 0, model 0 (JAX's decode runs replicated over the other
    axes; one group gives the same video)."""
    return coords["data"] == 0 and coords["model"] == 0


def _decode_cp_rank(ctx, key, latents, vae_cfg, compute_dtype):
    """A rank's part of a context-parallel decode: the decoding ranks'
    share of the frames (engine.decode_first_stage_cp over the time
    group); the caller's rank (ctx.caller) returns the video."""
    video = None
    if _decodes(ctx.coords):
        latents = mesh_lib.to_rank(ctx, latents)
        with torch.inference_mode():
            video = engine.decode_first_stage_cp(
                ctx.state[key]["vae"], latents, vae_cfg, ctx.time_group,
                compute_dtype=compute_dtype)
    mesh_lib.release_cache(ctx)
    return video if ctx.caller else None


def _denoise_rank(ctx, key, cfg: LanDiffConfig, compute_dtype, context,
                  uc_context, tokens, init_noise, gen_state, step_noise,
                  prefix):
    """A rank's part of a denoise command: the sampler's whole loop on its
    shards, from the same initial noise and generator state as every
    other rank; the caller's rank (ctx.caller) returns the latents."""
    st = ctx.state[key]
    context, uc_context, tokens, init_noise, step_noise, prefix = \
        mesh_lib.to_rank(ctx, [context, uc_context, tokens, init_noise,
                               step_noise, prefix])
    gen = torch.Generator(device=ctx.device)
    gen.set_state(torch.from_numpy(gen_state))
    with torch.inference_mode():
        denoise_fn = tp_infer.make_tp_denoise_fn(
            ctx, st["main"], st["control"], st["semantic"], cfg.dit,
            cfg.sampler, cfg.tokenizer, cfg.semantic_cond, context,
            uc_context, tokens, compute_dtype=compute_dtype)
        latents = engine.sample_latents(
            denoise_fn, cfg.sampler, cfg.dit, generator=gen,
            init_noise=init_noise, step_noise=step_noise, prefix=prefix)
    del denoise_fn
    mesh_lib.release_cache(ctx)
    return latents if ctx.caller else None


def _move_rank(ctx, key, to_host: bool):
    for k in _OFFLOADED:
        _move_tree_(ctx.state[key][k],
                    torch.device("cpu") if to_host else ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def init_params(gen: torch.Generator, cfg: LanDiffConfig,
                dtype=torch.float32):
    """Random stage-2 parameters built on the generator's device: the
    JAX package's tree leaf for leaf (the VAE and the conditioner's VQ
    with their encoders)."""
    return {
        "main": dit_lib.init(gen, cfg.dit, dtype=dtype),
        "control": dit_lib.init(gen, cfg.dit, control=True, dtype=dtype),
        "semantic": sc_lib.init(gen, cfg.tokenizer, cfg.semantic_cond, dtype),
        "vae": vae_lib.init(gen, cfg.vae, dtype),
        "t5": t5_lib.init(gen, cfg.t5, dtype),
    }
