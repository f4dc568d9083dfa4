"""Causal 3-D VAE decoder (counterpart of the decode side of
landiff_tpu/models/vae.py; reference landiff/diffusion/vae_modules/
cp_enc_dec.py): 8x spatial / 4x temporal upsampling, zq-conditioned
norms, and chunked streaming decode with the causal conv cache as an
explicit carry.

Layout: (B, C, T, H, W) throughout, PyTorch's own, so every conv is one
cuDNN call: the causal conv is a single F.conv3d on the front-padded
input (the JAX package's per-frame 2-D decomposition is a TPU
workaround), the per-frame 2-D upsample conv is an F.conv3d with a
(1, 3, 3) kernel. Conv kernels are OIDHW / OIHW (bridge.py). The encoder
is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from landiff_tpu_torch.config import VAEConfig
from landiff_tpu_torch.ops.norms import group_norm


def _swish(x):
    return x * torch.sigmoid(x)


def _gn(p, name, x, eps=1e-6):
    groups = min(32, p[f"{name}_w"].shape[0])
    return group_norm(x, p[f"{name}_w"], p[f"{name}_b"], num_groups=groups,
                      eps=eps)


def _bias(b, x):
    return b.to(x.dtype).reshape(1, -1, *([1] * (x.dim() - 2)))


def causal_conv3d(p, x, cache, path, updates, stream: bool):
    """x: (B, C, T, H, W); p: {"w": (co, ci, kt, kh, kw), "b"}.

    Temporal front padding of kt-1 frames: the repeated first frame, or
    cache[path], the last kt-1 frames of the previous chunk's padded input.
    With stream=True, `updates[path]` receives this chunk's tail."""
    w = p["w"]
    kt, kh, kw = w.shape[2:]
    if kt > 1:
        if cache is not None and path in cache:
            front = cache[path].to(x.dtype)
        else:
            front = x[:, :, :1].expand(-1, -1, kt - 1, -1, -1)
        xp = torch.cat([front, x], dim=2)
    else:
        xp = x
    if stream and kt > 1:
        updates[path] = xp[:, :, -(kt - 1):].clone()
    out = F.conv3d(xp, w.to(x.dtype), padding=(0, kh // 2, kw // 2))
    return out + _bias(p["b"], out)


def _nearest_resize_3d(x, t, h, w):
    """torch 'nearest' on (B, C, T, H, W): index floor(i * in / out)."""
    T, H, W = x.shape[2:]
    dev = x.device
    ti = torch.arange(t, device=dev) * T // t
    hi = torch.arange(h, device=dev) * H // h
    wi = torch.arange(w, device=dev) * W // w
    return x.index_select(2, ti).index_select(3, hi).index_select(4, wi)


def _resize_like(zq, Tf, Hf, Wf):
    """Nearest resize with the reference's odd-T first-frame split
    (cp_enc_dec.py:547-560)."""
    if Tf > 1 and Tf % 2 == 1:
        first = _nearest_resize_3d(zq[:, :, :1], 1, Hf, Wf)
        rest = _nearest_resize_3d(zq[:, :, 1:], Tf - 1, Hf, Wf)
        return torch.cat([first, rest], dim=2)
    return _nearest_resize_3d(zq, Tf, Hf, Wf)


def spatial_norm3d(p, f, zq, cache, path, updates, stream):
    """SpatialNorm3D: GroupNorm(f) * conv_y(zq~) + conv_b(zq~); the 1x1x1
    convs run at latent resolution before the nearest resize (they
    commute exactly)."""
    Tf, Hf, Wf = f.shape[2:]
    y_s = causal_conv3d(p["conv_y"], zq, cache, path + ".y", updates, stream)
    b_s = causal_conv3d(p["conv_b"], zq, cache, path + ".b", updates, stream)
    return (_gn(p, "norm", f) * _resize_like(y_s, Tf, Hf, Wf)
            + _resize_like(b_s, Tf, Hf, Wf))


def upsample3d(p, x, compress_time: bool):
    T, H, W = x.shape[2:]
    if compress_time and T > 1:
        if T % 2 == 1:
            first = _nearest_resize_3d(x[:, :, :1], 1, H * 2, W * 2)
            rest = _nearest_resize_3d(x[:, :, 1:], (T - 1) * 2, H * 2, W * 2)
            x = torch.cat([first, rest], dim=2)
        else:
            x = _nearest_resize_3d(x, T * 2, H * 2, W * 2)
    else:
        x = _nearest_resize_3d(x, T, H * 2, W * 2)
    # the 2-D conv applied per frame
    out = F.conv3d(x, p["conv_w"].to(x.dtype)[:, :, None], padding=(0, 1, 1))
    return out + _bias(p["conv_b"], out)


def resblock3d(p, x, zq, cache, path, updates, stream):
    h = spatial_norm3d(p["norm1"], x, zq, cache, path + ".n1", updates,
                       stream)
    h = causal_conv3d(p["conv1"], _swish(h), cache, path + ".c1", updates,
                      stream)
    h = spatial_norm3d(p["norm2"], h, zq, cache, path + ".n2", updates,
                       stream)
    h = causal_conv3d(p["conv2"], _swish(h), cache, path + ".c2", updates,
                      stream)
    if "nin_w" in p:
        w = p["nin_w"].to(x.dtype).t()[:, :, None, None, None]
        x = F.conv3d(x, w)
        x = x + _bias(p["nin_b"], x)
    return x + h


def decode(params, z, cfg: VAEConfig, *, cache=None, stream=False,
           compute_dtype=torch.bfloat16):
    """z: (B, z, T, H', W') latents (already un-scaled). Returns
    ((B, 3, T_out, H, W), new_cache or None)."""
    z = z.to(compute_dtype)
    zq = z
    upd = {}
    n_res = len(cfg.ch_mult)
    h = causal_conv3d(params["conv_in"], z, cache, "in", upd, stream)
    h = resblock3d(params["mid1"], h, zq, cache, "m1", upd, stream)
    h = resblock3d(params["mid2"], h, zq, cache, "m2", upd, stream)
    for i_level in reversed(range(n_res)):
        level = params["up"][i_level]
        for j, blk in enumerate(level["blocks"]):
            h = resblock3d(blk, h, zq, cache, f"u{i_level}.{j}", upd, stream)
        if i_level != 0:
            h = upsample3d(
                level["up"], h,
                compress_time=i_level >= n_res - cfg.temporal_compress_level)
    h = spatial_norm3d(params["norm_out"], h, zq, cache, "no", upd, stream)
    h = causal_conv3d(params["conv_out"], _swish(h), cache, "out", upd,
                      stream)
    return h, (upd if stream else None)


# latent frames per decode chunk: the first chunk, then the rest
# (dif_infer.py:258-266); the JAX package's defaults
FIRST_CHUNK = 3
TAIL_CHUNK = 2


def decode_streaming(params, z, cfg: VAEConfig,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Serial chunked decode (dif_infer.py:245-271): latent windows
    [0:3], then 2 at a time, conv caches carried between chunks. GroupNorm
    statistics are per chunk, so the chunking is part of the result and
    is kept exactly."""
    T = z.shape[2]
    first = min(FIRST_CHUNK, T)
    chunks = [(0, first)]
    t = first
    while t < T:
        chunks.append((t, min(t + TAIL_CHUNK, T)))
        t += TAIL_CHUNK
    outs = []
    cache = None
    for ci, (a, b) in enumerate(chunks):
        last = ci == len(chunks) - 1
        out, cache = decode(params, z[:, :, a:b], cfg, cache=cache,
                            stream=not last, compute_dtype=compute_dtype)
        outs.append(out.float())
    return torch.cat(outs, dim=2)


# ---------------------------------------------------------------------------
# init (decoder; random weights on the device, bridge layouts)


def _zeros(gen, n, dtype):
    return torch.zeros((n,), dtype=dtype, device=gen.device)


def _conv3d_init(gen, kt, kh, kw, ci, co, dtype):
    std = (1.0 / (kt * kh * kw * ci)) ** 0.5
    w = torch.randn((co, ci, kt, kh, kw), generator=gen,
                    device=gen.device) * std
    return {"w": w.to(dtype), "b": _zeros(gen, co, dtype)}


def _spatial_norm_init(gen, c, zq_ch, dtype):
    return {"norm_w": torch.ones((c,), dtype=dtype, device=gen.device),
            "norm_b": _zeros(gen, c, dtype),
            "conv_y": _conv3d_init(gen, 1, 1, 1, zq_ch, c, dtype),
            "conv_b": _conv3d_init(gen, 1, 1, 1, zq_ch, c, dtype)}


def _resblock_init(gen, cin, cout, zq_ch, dtype):
    p = {
        "norm1": _spatial_norm_init(gen, cin, zq_ch, dtype),
        "conv1": _conv3d_init(gen, 3, 3, 3, cin, cout, dtype),
        "norm2": _spatial_norm_init(gen, cout, zq_ch, dtype),
        "conv2": _conv3d_init(gen, 3, 3, 3, cout, cout, dtype),
    }
    if cin != cout:
        p["nin_w"] = (torch.randn((cin, cout), generator=gen,
                                  device=gen.device)
                      * (1.0 / cin) ** 0.5).to(dtype)
        p["nin_b"] = _zeros(gen, cout, dtype)
    return p


def init_decoder(gen: torch.Generator, cfg: VAEConfig, dtype=torch.float32):
    ch, zq = cfg.ch, cfg.z_channels
    top = ch * cfg.ch_mult[-1]
    up = []
    block_in = top
    for i_level in reversed(range(len(cfg.ch_mult))):
        cout = ch * cfg.ch_mult[i_level]
        blocks = []
        c = block_in
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(_resblock_init(gen, c, cout, zq, dtype))
            c = cout
        level = {"blocks": blocks}
        if i_level != 0:
            std = (1.0 / (9 * cout)) ** 0.5
            level["up"] = {
                "conv_w": (torch.randn((cout, cout, 3, 3), generator=gen,
                                       device=gen.device) * std).to(dtype),
                "conv_b": _zeros(gen, cout, dtype)}
        up.insert(0, level)
        block_in = cout
    return {
        "conv_in": _conv3d_init(gen, 3, 3, 3, zq, top, dtype),
        "mid1": _resblock_init(gen, top, top, zq, dtype),
        "mid2": _resblock_init(gen, top, top, zq, dtype),
        "up": up,
        "norm_out": _spatial_norm_init(gen, ch * cfg.ch_mult[0], zq, dtype),
        "conv_out": _conv3d_init(gen, 3, 3, 3, ch * cfg.ch_mult[0],
                                 cfg.out_channels, dtype),
    }


def init(gen: torch.Generator, cfg: VAEConfig, dtype=torch.float32):
    """{"decoder": ...}; the encoder is not part of the port yet."""
    return {"decoder": init_decoder(gen, cfg, dtype)}
