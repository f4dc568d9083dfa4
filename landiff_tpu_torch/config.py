"""Typed configuration tree for the PyTorch port.

A copy of landiff_tpu/config.py (same frozen dataclasses, same defaults)
whose dtype policy holds torch dtypes: the JAX module imports its numpy
namespace, so the two packages cannot share it.

Default values reproduce the released LanDiff 5B configuration:
  - LLM:       landiff/llm/llm_cfg.py:18-81
  - Tokenizer: landiff/tokenizer/tokenizer_cfg.py:18-111
  - DiT/VAE:   landiff/diffusion/configs/*.yaml
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import torch

# ---------------------------------------------------------------------------
# dtype policy


@dataclass(frozen=True)
class DTypePolicy:
    """Mirrors the reference's `maybe_autocast` bf16 policy (utils.py:284-314):
    params live in fp32, hot matmuls run in bf16, logits/norm stats in fp32."""

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    # logits / softmax / norm statistics accumulate in fp32
    accum_dtype: Any = torch.float32


# ---------------------------------------------------------------------------
# RoPE


@dataclass(frozen=True)
class Rope1DConfig:
    dim: int = 128           # head_dim (llm_cfg.py:37)
    max_len: int = 32768
    theta_base: float = 10000.0


@dataclass(frozen=True)
class Rope3DConfig:
    dim: int = 64            # head_dim of TiTok (tokenizer_cfg.py:60-68)
    max_time: int = 100
    max_height: int = 30
    max_width: int = 45
    one_dim_max_time: int = 100_000  # separate 1-D table for t==h==w positions
    multiple: int = 16       # 16 → [t C/8 | h 3C/16 | w 3C/16] split
    theta_base: float = 10000.0


# ---------------------------------------------------------------------------
# Stage-1 LLM (landiff/llm/llm_cfg.py)


@dataclass(frozen=True)
class T5Config:
    """T5-XXL encoder (HF google/flan-t5-xxl for stage 1; local-dir T5 for
    stage 2). Reference: llm/modules/text_encoder.py:137-146."""

    model_name: str = "google/flan-t5-xxl"
    d_model: int = 4096
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    d_kv: int = 64
    vocab_size: int = 32128
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    max_length: int = 512    # stage-1 tokenizer max_length (text_encoder.py:41)


@dataclass(frozen=True)
class LLMConfig:
    """GPT backbone + vocab (llm_cfg.py:18-81, lm_model.py:62-71)."""

    hidden_size: int = 2048
    num_layers: int = 24
    num_heads: int = 16
    mlp_hidden: int = 11008       # SwiGLU intermediate
    codebook_size: int = 2048     # visual vocab
    num_special_tokens: int = 7   # EOS BOS SOI EOI SOP EOP PAD
    norm_eps: float = 1e-5
    rope: Rope1DConfig = field(default_factory=Rope1DConfig)
    # sequence structure (llm_cfg.py:56-60, lm_model.py:278-291)
    iframe_len: int = 330
    pframe_len: int = 74
    frames_per_segment: int = 13  # 13 semantic frames ≙ 49 RGB frames
    cond_dim: int = 2048
    micro_cond_keys: tuple[str, ...] = ("frames", "motion_score")
    micro_cond_embed_dim: int = 256

    @property
    def vocab_size(self) -> int:
        return self.codebook_size + self.num_special_tokens  # 2055

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class ARSampleConfig:
    """Sampling hyper-params (llm_infer.py:13-46)."""

    temperature: float = 1.0
    top_k: int = 0            # 0 = disabled
    top_p: float = 1.0
    cfg_scale: float = 7.5    # CLI default (infer_video.py)
    num_frames: int = 13      # semantic frames (≙ 49 RGB)
    motion_score: float = 0.1
    seed: int = 42


# ---------------------------------------------------------------------------
# Tokenizer (landiff/tokenizer/tokenizer_cfg.py)


@dataclass(frozen=True)
class TheiaConfig:
    """Theia DeiT backbone (theia_model.py:357-634). deit-base-patch16-224."""

    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6
    num_register_tokens: int = 0   # DeiTReg variant
    no_cls: bool = False           # DeiTNoCLS variant
    # LanDiff feature grid: frames resized so features are 30x45 (480x720/16)
    output_grid: tuple[int, int] = (30, 45)


@dataclass(frozen=True)
class TiTokConfig:
    """TiTok encoder/decoder (tokenizer/modules/blocks.py:414-976)."""

    width: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    token_size: int = 768         # encoder output dim (VQ projects to 16)
    grid_h: int = 30
    grid_w: int = 45
    temporal_size: int = 13
    iframe_latent_tokens: int = 330
    pframe_latent_tokens: int = 74
    norm_eps: float = 1e-6
    rope: Rope3DConfig = field(default_factory=Rope3DConfig)

    @property
    def latent_tokens(self) -> int:
        # 330 + 12*74 = 1218
        return self.iframe_latent_tokens + (self.temporal_size - 1) * self.pframe_latent_tokens

    @property
    def frame_tokens(self) -> int:
        return self.grid_h * self.grid_w  # 1350


@dataclass(frozen=True)
class VQConfig:
    """vector-quantize-pytorch VectorQuantize equivalent
    (tokenizer_cfg.py:89-95)."""

    codebook_size: int = 2048
    dim: int = 768
    codebook_dim: int = 16
    ema_decay: float = 0.8
    threshold_ema_dead_code: int = 2
    commitment_weight: float = 1.0
    kmeans_init: bool = True


@dataclass(frozen=True)
class TokenizerConfig:
    theia: TheiaConfig = field(default_factory=TheiaConfig)
    titok: TiTokConfig = field(default_factory=TiTokConfig)
    vq: VQConfig = field(default_factory=VQConfig)
    feature_dim: int = 768        # Theia feature channels
    segment_length: int = 13
    segment_stride: int = 13


# ---------------------------------------------------------------------------
# Stage-2 DiT (diffusion/configs/cogvideox_2b_*.yaml + dit_video_concat.py)


@dataclass(frozen=True)
class DiTConfig:
    num_layers: int = 30
    hidden_size: int = 1920
    num_heads: int = 30
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    latent_frames: int = 13
    latent_height: int = 60
    latent_width: int = 90
    text_dim: int = 4096          # T5 hidden
    text_length: int = 226
    time_embed_dim: int = 512
    adm_in_channels: int = 256    # num_classes="sequential" label_emb
    norm_eps: float = 1e-5        # elementwise_affine=False LayerNorms
    qk_ln: bool = True
    # 3D sincos position embedding interpolation (yaml pos-embed config)
    pos_interp_scale: float = 1.875
    control_layers: int = 15      # ControlDiffusionTransformer
    # positional-embedding alternative: "sincos3d" (the released config's
    # Basic3DPositionEmbeddingMixin) or "rotary3d"
    # (Rotary3DPositionEmbeddingMixin, dit_video_concat.py:275-385 —
    # unused by the shipped checkpoint but part of the reference surface)
    pos_embed: str = "sincos3d"
    rope_theta: float = 10000.0
    rot_v: bool = False           # also rotate V (dit_video_concat.py:371)
    learnable_pos_embed: bool = False  # zeros-init additive table (:336-341)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patches_per_frame(self) -> int:
        return (self.latent_height // self.patch_size) * (self.latent_width // self.patch_size)

    @property
    def video_tokens(self) -> int:
        return self.latent_frames * self.patches_per_frame  # 13*30*45 = 17550


@dataclass(frozen=True)
class SamplerConfig:
    """ZeroSNR + VPSDE-DPM++2M + DynamicCFG (yaml:226-243).

    `name` mirrors the reference's yaml-selected sampler_config target:
    vpsde_dpmpp2m (shipped default), vpode_dpmpp2m, video_ddim — routed in
    engine.sample_latents."""

    name: str = "vpsde_dpmpp2m"
    num_steps: int = 50
    num_train_timesteps: int = 1000
    shift_scale: float = 3.0
    cfg_scale: float = 6.0
    cfg_exp: float = 5.0
    linear_start: float = 0.00085
    linear_end: float = 0.012


@dataclass(frozen=True)
class VAEConfig:
    """Causal 3D VAE (vae_modules/cp_enc_dec.py:785-1072)."""

    ch: int = 128
    ch_mult: tuple[int, ...] = (1, 2, 2, 4)
    num_res_blocks: int = 3
    z_channels: int = 16
    double_z: bool = True
    in_channels: int = 3
    out_channels: int = 3
    temporal_compress_level: int = 2   # 4x temporal downsample
    gather_norm: bool = False
    norm_num_groups: int = 32
    # scale_factor applied to latents (yaml scale_factor: 1.15258426)
    scale_factor: float = 1.15258426


# ---------------------------------------------------------------------------
# Semantic conditioner (diffusion/semantic_models/condition.py)


@dataclass(frozen=True)
class SemanticCondConfig:
    z_channels: int = 768        # TiTok feature space
    upsample_ch: int = 512       # VQGAN-style upsampler base ch
    ch_mult: tuple[float, ...] = (0.25, 1.0)
    num_res_blocks: int = 4
    up_out_channels: int = 64    # upsampler out_ch (yaml out_ch: 64)
    out_channels: int = 16       # DiT latent channels


# ---------------------------------------------------------------------------
# Parallelism


@dataclass(frozen=True)
class MeshConfig:
    """Logical mesh axes. data = DP, model = TP (ICI all-reduce),
    time = temporal/sequence sharding (VAE CP, ring attention)."""

    data: int = 1
    model: int = 1
    time: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.time


# ---------------------------------------------------------------------------
# Top level


@dataclass(frozen=True)
class LanDiffConfig:
    llm: LLMConfig = field(default_factory=LLMConfig)
    t5: T5Config = field(default_factory=T5Config)
    tokenizer: TokenizerConfig = field(default_factory=TokenizerConfig)
    dit: DiTConfig = field(default_factory=DiTConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    semantic_cond: SemanticCondConfig = field(default_factory=SemanticCondConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    dtypes: DTypePolicy = field(default_factory=DTypePolicy)


def tiny_test_config() -> LanDiffConfig:
    """A small config for CPU tests: same structure, tiny dims."""
    return LanDiffConfig(
        llm=LLMConfig(
            hidden_size=64, num_layers=2, num_heads=4, mlp_hidden=128,
            codebook_size=32, iframe_len=6, pframe_len=2, frames_per_segment=3,
            cond_dim=64, micro_cond_embed_dim=32,
            rope=Rope1DConfig(dim=16, max_len=256),
        ),
        t5=T5Config(model_name="", d_model=32, d_ff=64, num_layers=2,
                    num_heads=2, d_kv=16, vocab_size=128, max_length=16),
        tokenizer=TokenizerConfig(
            theia=TheiaConfig(image_size=32, patch_size=16, hidden_size=32,
                              num_layers=2, num_heads=2, output_grid=(4, 6)),
            titok=TiTokConfig(width=32, num_layers=2, num_heads=2, token_size=32,
                              grid_h=4, grid_w=6, temporal_size=3,
                              iframe_latent_tokens=6, pframe_latent_tokens=2,
                              rope=Rope3DConfig(dim=16, max_time=8, max_height=4,
                                                max_width=6, one_dim_max_time=64)),
            vq=VQConfig(codebook_size=32, dim=32, codebook_dim=4),
            feature_dim=32,
            segment_length=3, segment_stride=3,
        ),
        dit=DiTConfig(num_layers=2, hidden_size=64, num_heads=4, patch_size=2,
                      in_channels=4, out_channels=4, latent_frames=3,
                      latent_height=8, latent_width=12, text_dim=32,
                      text_length=8, time_embed_dim=32, adm_in_channels=16,
                      control_layers=1),
        sampler=SamplerConfig(num_steps=4),
        vae=VAEConfig(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=4,
                      temporal_compress_level=1, norm_num_groups=4),
        semantic_cond=SemanticCondConfig(z_channels=32, upsample_ch=16,
                                         num_res_blocks=1, up_out_channels=8,
                                         out_channels=4),
    )


def replace(cfg, **kwargs):
    """dataclasses.replace that works on any of the frozen configs."""
    return dataclasses.replace(cfg, **kwargs)
