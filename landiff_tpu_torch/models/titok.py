"""TiTok video decoder (counterpart of the decode side of
landiff_tpu/models/titok.py; reference landiff/tokenizer/modules/
blocks.py TiTokDecoder :659-976): query-token transformer with the
I/P-frame structured attention mask and factorized 3-D RoPE.

Decoder sequence: [mask tokens (T*1350) | latent embeds (1218)]. At full
width its attention (S = 18,768, 12 heads of 64) goes through the
block-sparse flash kernel with the video-decoder mask. The encoder is not
ported yet.
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


def _block(p, x, cos, sin, cfg: TiTokConfig, mask_fn):
    """ResidualAttentionBlock: pre-LN attention (bias-free linears) +
    pre-LN MLP (erf gelu, biased) (blocks.py:222-304)."""
    B, S, D = x.shape
    H = cfg.num_heads
    Dk = D // H
    dt = x.dtype
    h = layer_norm(x, p["ln0_w"], p["ln0_b"], cfg.norm_eps)
    q = (h @ p["wq"].to(dt)).reshape(B, S, H, Dk)
    k = (h @ p["wk"].to(dt)).reshape(B, S, H, Dk)
    v = (h @ p["wv"].to(dt)).reshape(B, S, H, Dk)
    q = rope_lib.apply_rope(q, cos[None], sin[None])
    k = rope_lib.apply_rope(k, cos[None], sin[None])
    attn = attention(q, k, v, mask_fn=mask_fn)
    x = x + attn.reshape(B, S, D) @ p["wo"].to(dt)
    h = layer_norm(x, p["ln1_w"], p["ln1_b"], cfg.norm_eps)
    h = F.gelu(h @ p["fc0_w"].to(dt) + p["fc0_b"].to(dt))
    return x + h @ p["fc1_w"].to(dt) + p["fc1_b"].to(dt)


def decode(params, latents, cfg: TiTokConfig, *, forward_t=None,
           compute_dtype=torch.bfloat16):
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
        x = _block(p, x, cos, sin, cfg, mask_fn)
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
