"""Semantic conditioner (counterpart of landiff_tpu/models/
semantic_cond.py; reference landiff/diffusion/semantic_models/
condition.py :30-137 and vq_gan_blocks.py Decoder :480-606): token ids ->
TiTok-decoded Theia features -> per-frame VQGAN-style 2x upsampler ->
zero-init conv_out -> DiT latent condition. The visual path
(`semantic_feature_from_video`) makes the token ids from a video first:
pad square, Theia -> TiTok encode -> VQ, then the same decode.

Convs run NCHW with OIHW kernels (bridge.py); GroupNorm(min(32, C),
eps 1e-6) + swish; PixelShuffle(2) is torch's own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from landiff_tpu_torch.config import SemanticCondConfig, TokenizerConfig
from landiff_tpu_torch.models import vq as vq_lib
from landiff_tpu_torch.observability import named_scope
from landiff_tpu_torch.ops.norms import group_norm


def _conv(p, name, x):
    w = p[f"{name}_w"].to(x.dtype)
    out = F.conv2d(x, w, padding=w.shape[-1] // 2)
    return out + p[f"{name}_b"].to(x.dtype)[None, :, None, None]


def _swish(x):
    return x * torch.sigmoid(x)


def _gn(p, name, x):
    groups = min(32, p[f"{name}_w"].shape[0])
    return group_norm(x, p[f"{name}_w"], p[f"{name}_b"], num_groups=groups,
                      eps=1e-6)


def _resnet_block(p, x):
    h = _conv(p, "conv1", _swish(_gn(p, "norm1", x)))
    h = _conv(p, "conv2", _swish(_gn(p, "norm2", h)))
    if "nin_w" in p:
        x = _conv(p, "nin", x)
    return x + h


def upsampler_forward(p, z, cfg: SemanticCondConfig):
    """VQGAN Decoder, shipped config: z (N, z_channels, h, w) NCHW ->
    (N, up_out_channels, 2h, 2w)."""
    h = _conv(p, "conv_in", z)
    h = _resnet_block(p["mid1"], h)
    h = _resnet_block(p["mid2"], h)
    for blk in p["up1"]:              # level 1: blocks, then pixel shuffle
        h = _resnet_block(blk, h)
    h = F.pixel_shuffle(h, 2)
    h = _conv(p, "up1_conv", h)
    for blk in p["up0"]:              # level 0: blocks, no upsample
        h = _resnet_block(blk, h)
    h = _swish(_gn(p, "norm_out", h))
    return _conv(p, "conv_out", h)


def semantic_feature_from_tokens(params, indices, tok_cfg: TokenizerConfig,
                                 cfg: SemanticCondConfig, *,
                                 forward_t: int | None = None,
                                 compute_dtype=torch.bfloat16):
    """SemanticCond.forward(indexs=...): indices (B, L) ->
    (B, T, out_channels, 2*gh, 2*gw), e.g. (B, 13, 16, 60, 90)."""
    with named_scope("landiff.semantic.feature"):
        feats = vq_lib.index_to_feature(params["vq"], indices, tok_cfg,
                                        forward_t=forward_t,
                                        compute_dtype=compute_dtype)
        B, T, gh, gw, C = feats.shape
        x = feats.to(compute_dtype).reshape(B * T, gh, gw, C).permute(
            0, 3, 1, 2)
        x = upsampler_forward(params["upsampler"], x, cfg)
        x = _conv(params, "conv_out", x)            # zero-init 64 -> 16
        return x.reshape(B, T, *x.shape[1:])


def pad_to_square(x, pad_value):
    """Pad (..., H, W, C) frames square: taller -> pad LEFT columns,
    wider -> pad BOTTOM rows (condition.py:15-27, torchvision's order)."""
    h, w = x.shape[-3], x.shape[-2]
    if h == w:
        return x
    pad = (0, 0, h - w, 0, 0, 0) if h > w else (0, 0, 0, 0, 0, w - h)
    return F.pad(x, pad, value=pad_value)


def semantic_feature_from_video(params, video, tok_cfg: TokenizerConfig,
                                cfg: SemanticCondConfig, *,
                                downsample_factor: int = 16,
                                compute_dtype=torch.bfloat16,
                                theia_params=None):
    """SemanticCond's visual / training path (condition.py:86-110): video
    (B, T, 3, H, W) in [-1, 1] -> uint8 -> pad square -> VQ encode ->
    decode -> crop to (H/16, W/16) -> upsampler -> conv_out, (B, T,
    out_channels, H/8, W/8). A 480 x 720 clip pads to 720 x 720: Theia
    sees 45 x 45 patches, the decoded grid is cropped to 30 x 45. Theia's
    parameters (frozen, not in the conditioner's tree) come as
    theia_params or as params["vq"]["theia"]."""
    v = torch.clamp((video + 1.0) / 2.0, 0.0, 1.0)
    v = torch.round(v * 255.0).to(torch.uint8).permute(0, 1, 3, 4, 2)
    target_h = v.shape[2] // downsample_factor
    target_w = v.shape[3] // downsample_factor
    v = pad_to_square(v, 127)
    vq_params = dict(params["vq"])
    if theia_params is not None:
        vq_params["theia"] = theia_params
    _, idx = vq_lib.encode_to_index(vq_params, v, tok_cfg,
                                    compute_dtype=compute_dtype)
    feats = vq_lib.index_to_feature(vq_params, idx, tok_cfg,
                                    forward_t=v.shape[1],
                                    compute_dtype=compute_dtype)
    feats = feats[:, :, :target_h, :target_w]        # crop (condition.py:103)
    B, T, gh, gw, C = feats.shape
    x = feats.to(compute_dtype).reshape(B * T, gh, gw, C).permute(0, 3, 1, 2)
    x = upsampler_forward(params["upsampler"], x, cfg)
    x = _conv(params, "conv_out", x)
    return x.reshape(B, T, *x.shape[1:])


# ---------------------------------------------------------------------------
# init (random weights on the device, OIHW kernels)


def _conv_w(gen, kh, cin, cout, dtype):
    return (torch.randn((cout, cin, kh, kh), generator=gen, device=gen.device)
            * 0.02).to(dtype)


def _init_resblock(gen, cin, cout, dtype):
    z = lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)
    o = lambda n: torch.ones((n,), dtype=dtype, device=gen.device)
    p = {
        "norm1_w": o(cin), "norm1_b": z(cin),
        "conv1_w": _conv_w(gen, 3, cin, cout, dtype), "conv1_b": z(cout),
        "norm2_w": o(cout), "norm2_b": z(cout),
        "conv2_w": _conv_w(gen, 3, cout, cout, dtype), "conv2_b": z(cout),
    }
    if cin != cout:
        p["nin_w"] = _conv_w(gen, 1, cin, cout, dtype)
        p["nin_b"] = z(cout)
    return p


def init_upsampler(gen, cfg: SemanticCondConfig, dtype=torch.float32):
    z = lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)
    o = lambda n: torch.ones((n,), dtype=dtype, device=gen.device)
    block_in = int(cfg.upsample_ch * cfg.ch_mult[-1])       # 512
    block_l0 = int(cfg.upsample_ch * cfg.ch_mult[0])        # 128
    up1 = [_init_resblock(gen, block_in, block_in, dtype)
           for _ in range(cfg.num_res_blocks + 1)]
    up0 = []
    cin = block_in
    for _ in range(cfg.num_res_blocks + 1):
        up0.append(_init_resblock(gen, cin, block_l0, dtype))
        cin = block_l0
    return {
        "conv_in_w": _conv_w(gen, 3, cfg.z_channels, block_in, dtype),
        "conv_in_b": z(block_in),
        "mid1": _init_resblock(gen, block_in, block_in, dtype),
        "mid2": _init_resblock(gen, block_in, block_in, dtype),
        "up1": up1,
        "up1_conv_w": _conv_w(gen, 3, block_in // 4, block_in, dtype),
        "up1_conv_b": z(block_in),
        "up0": up0,
        "norm_out_w": o(block_l0), "norm_out_b": z(block_l0),
        "conv_out_w": _conv_w(gen, 3, block_l0, cfg.up_out_channels, dtype),
        "conv_out_b": z(cfg.up_out_channels),
    }


def init(gen: torch.Generator, tok_cfg: TokenizerConfig,
         cfg: SemanticCondConfig, dtype=torch.float32):
    return {
        "vq": vq_lib.init(gen, tok_cfg, dtype, with_theia=False),
        "upsampler": init_upsampler(gen, cfg, dtype),
        # zero-init conv_out (condition.py:49-53)
        "conv_out_w": torch.zeros((cfg.out_channels, cfg.up_out_channels, 3,
                                   3), dtype=dtype, device=gen.device),
        "conv_out_b": torch.zeros((cfg.out_channels,), dtype=dtype,
                                  device=gen.device),
    }
