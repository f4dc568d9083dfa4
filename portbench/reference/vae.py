"""Plain float32 reference of the decoder of CogVideoX's causal 3-D VAE,
decoded in chunks as LanDiff's stage 2 decodes it.

Causal 3x3x3 convolutions (front padding with the first frame, or with
the previous chunk's last frames), SpatialNorm3D (GroupNorm of the
features times and plus 1x1x1 convolutions of the latents, resized to
the features' size by nearest neighbour, an odd frame count keeping its
first frame apart), ResNet blocks, 2x upsampling in space and, in the two
upper levels, in time. The chunks are the latent frames [0:3], then two
at a time; GroupNorm takes each chunk's own statistics, and the last two
frames of each causal convolution's padded input carry to the next chunk.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import group_norm, silu

BIAS = (0.0, 0.02)
GAIN = (1.0, 0.05)
FIRST_CHUNK, TAIL_CHUNK = 3, 2


def fp8_round(x):
    """x rounded to float8 e4m3 with one absmax scale per tensor, back in
    float32."""
    s = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _f32(x):
    return x


def _conv3d(ci, co, k, gain=1.0):
    return {"w": ((co, ci, k, k, k), 0.0, gain * (k ** 3 * ci) ** -0.5),
            "b": ((co,), *BIAS)}


def _snorm(c, zq):
    return {"norm_w": ((c,), *GAIN), "norm_b": ((c,), *BIAS),
            "conv_y": _conv3d(zq, c, 1), "conv_b": _conv3d(zq, c, 1)}


def _res(cin, cout, zq):
    p = {"norm1": _snorm(cin, zq), "conv1": _conv3d(cin, cout, 3),
         "norm2": _snorm(cout, zq), "conv2": _conv3d(cout, cout, 3)}
    if cin != cout:
        p["nin_w"] = ((cin, cout), 0.0, cin ** -0.5)
        p["nin_b"] = ((cout,), *BIAS)
    return p


def param_spec(v):
    """The decoder's tree as (shape, mean, std); v: the "vae" group. The
    last convolution is drawn smaller, so that the video mostly lies
    inside [-1, 1] before the clamp."""
    ch, zq = v["ch"], v["z_channels"]
    top = ch * v["ch_mult"][-1]
    up, block_in = [], top
    for i in reversed(range(len(v["ch_mult"]))):
        cout = ch * v["ch_mult"][i]
        blocks, c = [], block_in
        for _ in range(v["num_res_blocks"] + 1):
            blocks.append(_res(c, cout, zq))
            c = cout
        level = {"blocks": blocks}
        if i != 0:
            level["up"] = {"conv_w": ((cout, cout, 3, 3), 0.0,
                                      (9 * cout) ** -0.5),
                           "conv_b": ((cout,), *BIAS)}
        up.insert(0, level)
        block_in = cout
    return {"conv_in": _conv3d(zq, top, 3), "mid1": _res(top, top, zq),
            "mid2": _res(top, top, zq), "up": up,
            "norm_out": _snorm(ch * v["ch_mult"][0], zq),
            "conv_out": _conv3d(ch * v["ch_mult"][0], v["out_channels"], 3,
                                0.3)}


def _gn(p, x):
    return group_norm(x, p["norm_w"], p["norm_b"],
                      min(32, p["norm_w"].shape[0]), 1e-6)


def _causal(p, x, cache, key, new, r):
    """Front-pad kt - 1 frames (cache[key] or the first frame repeated),
    record this input's last kt - 1 frames in new[key], then convolve."""
    w = p["w"].float()
    kt, kh, kw = w.shape[2:]
    if kt > 1:
        front = cache[key] if key in cache else \
            x[:, :, :1].expand(-1, -1, kt - 1, -1, -1)
        x = torch.cat([front, x], dim=2)
        new[key] = x[:, :, -(kt - 1):]
    out = F.conv3d(r(x), r(w), padding=(0, kh // 2, kw // 2))
    return out + p["b"].float().reshape(1, -1, 1, 1, 1)


def _nearest(x, t, h, w):
    T, H, W = x.shape[2:]
    dev = x.device
    return (x.index_select(2, torch.arange(t, device=dev) * T // t)
            .index_select(3, torch.arange(h, device=dev) * H // h)
            .index_select(4, torch.arange(w, device=dev) * W // w))


def _resize(z, T, H, W):
    if T > 1 and T % 2 == 1:
        return torch.cat([_nearest(z[:, :, :1], 1, H, W),
                          _nearest(z[:, :, 1:], T - 1, H, W)], dim=2)
    return _nearest(z, T, H, W)


def _spatial_norm(p, f, zq, cache, key, new, r):
    T, H, W = f.shape[2:]
    y = _causal(p["conv_y"], zq, cache, key + ".y", new, r)
    b = _causal(p["conv_b"], zq, cache, key + ".b", new, r)
    return _gn(p, f) * _resize(y, T, H, W) + _resize(b, T, H, W)


def _block(p, x, zq, cache, key, new, r):
    h = _spatial_norm(p["norm1"], x, zq, cache, key + ".n1", new, r)
    h = _causal(p["conv1"], silu(h), cache, key + ".c1", new, r)
    h = _spatial_norm(p["norm2"], h, zq, cache, key + ".n2", new, r)
    h = _causal(p["conv2"], silu(h), cache, key + ".c2", new, r)
    if "nin_w" in p:
        x = (torch.einsum("bcthw,cd->bdthw", r(x), r(p["nin_w"].float()))
             + p["nin_b"].float().reshape(1, -1, 1, 1, 1))
    return x + h


def _upsample(p, x, in_time, r):
    T, H, W = x.shape[2:]
    if in_time and T > 1 and T % 2 == 1:
        x = torch.cat([_nearest(x[:, :, :1], 1, 2 * H, 2 * W),
                       _nearest(x[:, :, 1:], 2 * (T - 1), 2 * H, 2 * W)],
                      dim=2)
    elif in_time and T > 1:
        x = _nearest(x, 2 * T, 2 * H, 2 * W)
    else:
        x = _nearest(x, T, 2 * H, 2 * W)
    out = F.conv3d(r(x), r(p["conv_w"].float())[:, :, None],
                   padding=(0, 1, 1))
    return out + p["conv_b"].float().reshape(1, -1, 1, 1, 1)


def _decode_chunk(p, z, v, cache, r):
    new = {}
    n = len(v["ch_mult"])
    h = _causal(p["conv_in"], z, cache, "in", new, r)
    h = _block(p["mid1"], h, z, cache, "m1", new, r)
    h = _block(p["mid2"], h, z, cache, "m2", new, r)
    for i in reversed(range(n)):
        for j, b in enumerate(p["up"][i]["blocks"]):
            h = _block(b, h, z, cache, f"u{i}.{j}", new, r)
        if i != 0:
            h = _upsample(p["up"][i]["up"], h,
                          i >= n - v["temporal_compress_level"], r)
    h = _spatial_norm(p["norm_out"], h, z, cache, "no", new, r)
    return _causal(p["conv_out"], silu(h), cache, "out", new, r), new


def decode(p, latents, v, fp8: bool = False):
    """latents (B, T, z, H', W'), as the sampler leaves them (scaled) ->
    the video (B, 3, T_out, H, W) before post-processing. fp8: every
    convolution's operands rounded to fp8 (`fp8_round`), the decode's
    lower-precision control."""
    r = fp8_round if fp8 else _f32
    z = latents.float().permute(0, 2, 1, 3, 4) / v["scale_factor"]
    T = z.shape[2]
    bounds, t = [(0, min(FIRST_CHUNK, T))], min(FIRST_CHUNK, T)
    while t < T:
        bounds.append((t, min(t + TAIL_CHUNK, T)))
        t += TAIL_CHUNK
    outs, cache = [], {}
    for a, b in bounds:
        out, cache = _decode_chunk(p, z[:, :, a:b], v, cache, r)
        outs.append(out)
    return torch.cat(outs, dim=2)


def post_process(video):
    """[-1, 1] -> [0, 1]."""
    return torch.clamp((video + 1.0) / 2.0, 0.0, 1.0)
