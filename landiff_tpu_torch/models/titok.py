"""TiTok video encoder / decoder (counterpart of landiff_tpu/models/
titok.py; reference landiff/tokenizer/modules/blocks.py TiTokEncoder
:414-656, TiTokDecoder :659-976): query-token transformers with the
I/P-frame structured attention masks and factorized 3-D RoPE.

Encoder sequence: [frame features (T*1350) | latent queries (1218)]
Decoder sequence: [mask tokens (T*1350)   | latent embeds  (1218)]
At full width their attention (S = 18,768, 12 heads of 64) goes through
the block-sparse flash kernels with the video-encoder / video-decoder
mask. The encoder's patch embedding is a 1x1 conv over the Theia
features, a per-token linear: patch_w is (C, W).

Tensor parallel (`tp=group`, the trainer's TITOK_RULES, parallel/mesh.py):
a rank holds its columns of wq, wk, wv (whole heads: a head is Dk
consecutive columns) and fc0 (with its part of fc0_b), its rows of wo and
fc1; the flash kernels run on its heads under the same mask; the
column-parallel inputs enter through mesh.copy_to and the row-parallel
sums are mesh.reduce_from, each bias added once after the sum.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from landiff_tpu_torch.config import TiTokConfig
from landiff_tpu_torch.ops import masks as masks_lib
from landiff_tpu_torch.ops import rope as rope_lib
from landiff_tpu_torch.ops.attention import attention
from landiff_tpu_torch.ops.norms import layer_norm
from landiff_tpu_torch.parallel.mesh import copy_to, reduce_from


def _mask_layout(cfg: TiTokConfig,
                 forward_t: int) -> masks_lib.VideoMaskLayout:
    return masks_lib.VideoMaskLayout(
        num_frames=forward_t, tokens_per_frame=cfg.frame_tokens,
        iframe_tokens=cfg.iframe_latent_tokens,
        pframe_tokens=cfg.pframe_latent_tokens)


@functools.lru_cache(maxsize=8)
def _rope_tables(cfg: TiTokConfig, forward_t: int):
    """(cos, sin) (seq, rope_dim/2) for the [visual grid | query tokens]
    layout (blocks.py freqs_cis:548-591): visual tokens take (t, h, w)
    grid indices, query tokens [i, i, i] (the text table)."""
    visual_idx = rope_lib.shape_to_index(forward_t, cfg.grid_h, cfg.grid_w)
    q_len = cfg.iframe_latent_tokens + (forward_t - 1) \
        * cfg.pframe_latent_tokens
    idx = np.concatenate([visual_idx, rope_lib.len_to_rope_index(q_len)],
                         axis=0)
    return rope_lib.rope_3d_by_index(cfg.rope, idx)


def _block(p, x, cos, sin, cfg: TiTokConfig, mask_fn, tp=None):
    """ResidualAttentionBlock: pre-LN attention (bias-free linears) +
    pre-LN MLP (erf gelu, biased) (blocks.py:222-304). tp: the rank's
    model Group (its heads and MLP columns)."""
    B, S, D = x.shape
    Dk = D // cfg.num_heads
    dt = x.dtype
    h = copy_to(tp, layer_norm(x, p["ln0_w"], p["ln0_b"], cfg.norm_eps))
    q = (h @ p["wq"].to(dt)).reshape(B, S, -1, Dk)
    k = (h @ p["wk"].to(dt)).reshape(B, S, -1, Dk)
    v = (h @ p["wv"].to(dt)).reshape(B, S, -1, Dk)
    q = rope_lib.apply_rope(q, cos[None], sin[None])
    k = rope_lib.apply_rope(k, cos[None], sin[None])
    attn = attention(q, k, v, mask_fn=mask_fn)
    x = x + reduce_from(tp, attn.reshape(B, S, -1) @ p["wo"].to(dt))
    h = copy_to(tp, layer_norm(x, p["ln1_w"], p["ln1_b"], cfg.norm_eps))
    h = F.gelu(h @ p["fc0_w"].to(dt) + p["fc0_b"].to(dt))
    return x + reduce_from(tp, h @ p["fc1_w"].to(dt)) + p["fc1_b"].to(dt)


def encode(params, features, cfg: TiTokConfig, *, forward_t=None,
           compute_dtype=torch.bfloat16, tp=None):
    """TiTokEncoder.forward (blocks.py:593-656): features (B, T, h, w, C)
    normalized Theia features -> (B, latent_tokens, token_size) latents
    (pre-quantizer)."""
    B, T = features.shape[:2]
    if forward_t is None:
        forward_t = T
    if T != forward_t:
        raise ValueError(f"{T} frames, forward_t {forward_t}")
    dt = compute_dtype
    x = features.to(dt).reshape(B, T * cfg.grid_h * cfg.grid_w, -1)
    x = x @ params["patch_w"].to(dt) + params["patch_b"].to(dt)
    lat = params["iframe_latent"].to(dt)
    if forward_t > 1:
        lat = torch.cat([lat, params["pframe_latent"].to(dt).repeat(
            forward_t - 1, 1)], dim=0)
    x = torch.cat([x, lat[None].expand(B, -1, -1)], dim=1)
    x = layer_norm(x, params["ln_pre_w"], params["ln_pre_b"], cfg.norm_eps)
    cos, sin = (torch.from_numpy(a).to(x.device)
                for a in _rope_tables(cfg, forward_t))
    mask_fn = masks_lib.video_encoder_mask(_mask_layout(cfg, forward_t))
    for p in params["blocks"]:
        x = _block(p, x, cos, sin, cfg, mask_fn, tp)
    lat = layer_norm(x[:, forward_t * cfg.frame_tokens:], params["ln_post_w"],
                     params["ln_post_b"], cfg.norm_eps)
    return lat @ params["proj_w"].to(dt) + params["proj_b"].to(dt)


def decode(params, latents, cfg: TiTokConfig, *, forward_t=None,
           compute_dtype=torch.bfloat16, tp=None):
    """TiTokDecoder.forward (blocks.py:906-976): latents (B, L,
    token_size) -> (B, T, h, w, C_out) feature grid."""
    B = latents.shape[0]
    if forward_t is None:
        forward_t = cfg.temporal_size
    dt = compute_dtype
    x = latents.to(dt) @ params["embed_w"].to(dt) + params["embed_b"].to(dt)
    visual_len = forward_t * cfg.frame_tokens
    mask_tok = params["mask_token"].to(dt)[None, None].expand(
        B, visual_len, x.shape[-1])
    x = torch.cat([mask_tok, x], dim=1)
    x = layer_norm(x, params["ln_pre_w"], params["ln_pre_b"], cfg.norm_eps)
    cos, sin = (torch.from_numpy(a).to(x.device)
                for a in _rope_tables(cfg, forward_t))
    mask_fn = masks_lib.video_decoder_mask(_mask_layout(cfg, forward_t))
    for p in params["blocks"]:
        x = _block(p, x, cos, sin, cfg, mask_fn, tp)
    x = layer_norm(x[:, :visual_len], params["ln_post_w"],
                   params["ln_post_b"], cfg.norm_eps)
    h = torch.tanh(x @ params["ffn0_w"].to(dt) + params["ffn0_b"].to(dt))
    x = h @ params["ffn1_w"].to(dt) + params["ffn1_b"].to(dt)
    return x.reshape(B, forward_t, cfg.grid_h, cfg.grid_w, -1)


def _init_block(gen, W, mlp, dtype):
    nrm = lambda s, std: (torch.randn(s, generator=gen, device=gen.device)
                          * std).to(dtype)
    z = lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)
    o = lambda n: torch.ones((n,), dtype=dtype, device=gen.device)
    std = W ** -0.5
    return {
        "ln0_w": o(W), "ln0_b": z(W),
        "wq": nrm((W, W), std), "wk": nrm((W, W), std),
        "wv": nrm((W, W), std), "wo": nrm((W, W), std),
        "ln1_w": o(W), "ln1_b": z(W),
        "fc0_w": nrm((W, mlp), std), "fc0_b": z(mlp),
        "fc1_w": nrm((mlp, W), mlp ** -0.5), "fc1_b": z(W),
    }


def init_encoder(gen: torch.Generator, cfg: TiTokConfig, in_channels: int,
                 dtype=torch.float32):
    W = cfg.width
    mlp = int(W * cfg.mlp_ratio)
    nrm = lambda s, std: (torch.randn(s, generator=gen, device=gen.device)
                          * std).to(dtype)
    z = lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)
    o = lambda n: torch.ones((n,), dtype=dtype, device=gen.device)
    scale = W ** -0.5
    return {
        "patch_w": nrm((in_channels, W), in_channels ** -0.5),
        "patch_b": z(W),
        "iframe_latent": nrm((cfg.iframe_latent_tokens, W), scale),
        "pframe_latent": nrm((cfg.pframe_latent_tokens, W), scale),
        "ln_pre_w": o(W), "ln_pre_b": z(W),
        "blocks": [_init_block(gen, W, mlp, dtype)
                   for _ in range(cfg.num_layers)],
        "ln_post_w": o(W), "ln_post_b": z(W),
        "proj_w": nrm((W, cfg.token_size), scale),
        "proj_b": z(cfg.token_size),
    }


def init_decoder(gen: torch.Generator, cfg: TiTokConfig, out_channels: int,
                 dtype=torch.float32):
    W = cfg.width
    mlp = int(W * cfg.mlp_ratio)
    nrm = lambda s, std: (torch.randn(s, generator=gen, device=gen.device)
                          * std).to(dtype)
    z = lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)
    o = lambda n: torch.ones((n,), dtype=dtype, device=gen.device)
    scale = W ** -0.5
    return {
        "embed_w": nrm((cfg.token_size, W), cfg.token_size ** -0.5),
        "embed_b": z(W),
        "mask_token": nrm((W,), scale),
        "ln_pre_w": o(W), "ln_pre_b": z(W),
        "blocks": [_init_block(gen, W, mlp, dtype)
                   for _ in range(cfg.num_layers)],
        "ln_post_w": o(W), "ln_post_b": z(W),
        "ffn0_w": nrm((W, 2 * W), scale), "ffn0_b": z(2 * W),
        "ffn1_w": nrm((2 * W, out_channels), (2 * W) ** -0.5),
        "ffn1_b": z(out_channels),
    }
