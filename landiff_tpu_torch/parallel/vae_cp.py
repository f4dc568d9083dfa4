"""Temporal context-parallel VAE, decode and encode (counterpart of
landiff_tpu/parallel/vae_cp.py; reference vae_modules/cp_enc_dec.py's
NCCL context parallelism): the frames of one video sharded over the ranks
of a `time` group.

As JAX's layout, the FIRST frame is replicated on every rank (a "first |
rest" pair) and only the rest is split evenly, which makes every
temporal op local but three:
  - the causal conv's halo: rank 0 pads with the first frame repeated,
    rank i > 0 takes the previous rank's last kt - 1 frames by a ring
    shift (`mesh.Group.shift`, JAX's ppermute; the reference's
    isend / irecv, cp_enc_dec.py:203-246);
  - GroupNorm / SpatialNorm statistics: sums over the local frames
    all-reduced over the group, the replicated first frame counted once
    (the reference's gathered GroupNorm, :476-488);
  - the result: the rest's frames gathered in rank order.
The temporal 2x upsample doubles only the rest's frames (the odd-T
first-frame split of Upsample3D) and the downsample averages the rest's
frame pairs, both per rank.

The convs are models/vae.py's (cuDNN conv3d; the causal conv with the
halo as its front, `upsample3d` / `downsample3d`'s per-frame convs),
layout (B, C, T, H, W). Each rank decodes its shard whole, as JAX's
decode_cp_local, the same function in less memory: the convs of the
causal conv and the upsample run over runs of output frames into one
output (`_CHUNK_ELEMS`), the temporal doubling comes after the per-frame
conv, the nearest resizes of SpatialNorm broadcast, and the swish, the
modulation and the residual add write into tensors this module made. Needs (T - 1) % n == 0 and at least kt - 1 = 2 rest
frames a rank (`can_decode_cp`: 13 latents on 2, 3, 4 or 6 ranks).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from landiff_tpu_torch.config import VAEConfig
from landiff_tpu_torch.models import vae as vae_lib



# the most elements a conv call's input copy takes: a rank's share of a
# full-width video at the last level is GBs a tensor
_CHUNK_ELEMS = 1 << 29


def _swish_(x):
    """vae._swish's x * sigmoid(x) written into x (a tensor this module
    made): the same bits, no second full tensor."""
    return x.mul_(torch.sigmoid(x))


def _nearest_up(x, ft: int, fs: int):
    """vae._nearest_resize_3d to (ft T, fs H, fs W): each frame and pixel
    repeated, materialized once."""
    B, C, T, H, W = x.shape
    return x[:, :, :, None, :, None, :, None].expand(
        B, C, T, ft, H, fs, W, fs).reshape(B, C, T * ft, H * fs, W * fs)


def _mul_add_resized_(n, y, b):
    """n * resize(y) + resize(b), nearest resizes of y and b to n's frames
    and size, written into n (a tensor this module made) and rounded as
    that product and sum are, without the resized tensors: where n's
    extents are whole multiples of y's, each of y's values multiplies its
    block of n by broadcasting."""
    B, C, T, H, W = n.shape
    t, h, w = y.shape[2:]
    if T % t or H % h or W % w:
        return (n * vae_lib._nearest_resize_3d(y, T, H, W)
                + vae_lib._nearest_resize_3d(b, T, H, W))
    v = lambda a: a.reshape(B, C, t, 1, h, 1, w, 1)
    out = n.view(B, C, t, T // t, h, H // h, w, W // w)
    return out.mul_(v(y)).add_(v(b)).view(B, C, T, H, W)


def _frames_per_call(shape, co: int, extra: int) -> int:
    """Output frames a conv call takes, its input (B, C, ., H, W) of
    `shape` and co output channels: its input copy (those frames and
    `extra` more) and its output within _CHUNK_ELEMS."""
    B, C, _, H, W = shape
    return max(1, _CHUNK_ELEMS // (B * max(C, co) * H * W) - extra)


def _causal_conv(p, front, x):
    """vae.causal_conv3d of x behind `front` (its kt - 1 frames before x),
    over runs of output frames: each run's input frames copied alone, its
    output written into the whole one; the padded input is never built."""
    w = p["w"].to(x.dtype)
    co, _, kt, kh, kw = w.shape
    B, _, T, H, W = x.shape
    out = torch.empty((B, co, T, H, W), dtype=x.dtype, device=x.device)
    n = _frames_per_call(x.shape, co, kt - 1)
    for a in range(0, T, n):
        b = min(a + n, T)
        lo = a - (kt - 1)
        xin = x[:, :, max(lo, 0):b]
        if lo < 0:
            xin = torch.cat([front[:, :, front.shape[2] + lo:], xin], dim=2)
        out[:, :, a:b] = F.conv3d(xin, w, padding=(0, kh // 2, kw // 2))
    return out.add_(vae_lib._bias(p["b"], out))


def _halo_from_prev(xr, k: int, x0, group):
    """The kt - 1 frames before this rank's rest (vae_cp.py:41-50): the
    previous rank's last ones, on rank 0 the first frame repeated. Every
    rank takes part in the shift."""
    prev = group.shift(xr[:, :, -(k - 1):])
    if group.rank == 0:
        return x0.expand(-1, -1, k - 1, -1, -1)
    return prev


def causal_conv_cp(p, x0, xr, group):
    """The causal conv on the (first, rest) pair -> (y0, yr): y0 from the
    first frame padded by itself, yr from the rest behind its halo."""
    k = p["w"].shape[2]
    y0 = _causal_conv(p, x0.expand(-1, -1, k - 1, -1, -1), x0)
    front = _halo_from_prev(xr, k, x0, group) if k > 1 else None
    return y0, _causal_conv(p, front, xr)


def group_norm_cp(w, b, x0, xr, group, num_groups=None, eps=1e-6):
    """GroupNorm over the whole video (the first frame and every rank's
    rest) from local sums and one all-reduce (vae_cp.py:81-117): f32 sums
    of x and x^2, var = E[x^2] - mean^2, the normalization in f32. One
    group's f32 copy at a time: a rank's share at full width is GBs."""
    C = w.shape[0]
    g = min(32, C) if num_groups is None else num_groups

    def sums(x):
        xg = x.reshape(x.shape[0], g, -1)
        s1, s2 = [], []
        for xj in xg.unbind(1):
            xf = xj.float()
            s1.append(xf.sum(-1))
            s2.append((xf * xf).sum(-1))
        return torch.stack([torch.stack(s1, 1), torch.stack(s2, 1)]), \
            xg.shape[-1]

    rest, n_rest = sums(xr)
    rest = group.all_reduce(rest)
    first, n_first = sums(x0)
    s1, s2 = rest + first
    cnt = n_rest * group.size + n_first
    mean = s1 / cnt
    rstd = torch.rsqrt(s2 / cnt - mean * mean + eps)
    wg = w.float().reshape(g, C // g, 1)
    bg = b.float().reshape(g, C // g, 1)

    def norm(x):
        xg = x.reshape(x.shape[0], g, C // g, -1)
        out = torch.empty_like(xg)
        for j in range(g):
            y = (xg[:, j].float() - mean[:, j, None, None]) \
                * rstd[:, j, None, None]
            out[:, j] = y * wg[j] + bg[j]
        return out.reshape(x.shape)

    return norm(x0), norm(xr)


def spatial_norm_cp(p, f0, fr, zq0, zqr, group):
    """SpatialNorm3D on the pair: the gathered GroupNorm of f times
    conv_y(zq~) plus conv_b(zq~), the 1x1x1 convs at latent resolution
    before the nearest resize (they commute, models/vae.py), the first
    frame resized alone."""
    n0, nr = group_norm_cp(p["norm_w"], p["norm_b"], f0, fr, group)
    out = []
    for n, zq in ((n0, zq0), (nr, zqr)):
        y = vae_lib.causal_conv3d(p["conv_y"], zq, None, "", {}, False)
        bb = vae_lib.causal_conv3d(p["conv_b"], zq, None, "", {}, False)
        out.append(_mul_add_resized_(n, y, bb))
    return tuple(out)


def _nin(p, x):
    w = p["nin_w"].to(x.dtype).t()[:, :, None, None, None]
    y = F.conv3d(x, w)
    return y.add_(vae_lib._bias(p["nin_b"], y))


def resblock_cp(p, x0, xr, zq0, zqr, group):
    """The decoder's resblock (SpatialNorm3D) on the pair."""
    h0, hr = spatial_norm_cp(p["norm1"], x0, xr, zq0, zqr, group)
    h0, hr = causal_conv_cp(p["conv1"], _swish_(h0), _swish_(hr), group)
    h0, hr = spatial_norm_cp(p["norm2"], h0, hr, zq0, zqr, group)
    h0, hr = causal_conv_cp(p["conv2"], _swish_(h0), _swish_(hr), group)
    if "nin_w" in p:
        x0, xr = _nin(p, x0), _nin(p, xr)
    return h0.add_(x0), hr.add_(xr)


def _upsample_cp(p, x0, xr, compress_time: bool):
    """Upsample3D on the pair: 2x nearest in space and the per-frame conv
    (as vae.upsample3d), over runs of frames, then with compress_time the
    rest's frames doubled, the first frame kept single. A per-frame conv
    of two equal frames gives two equal frames, so doubling after the
    conv is the same function at half the work."""
    w = p["conv_w"].to(xr.dtype)[:, :, None]

    def up(x):
        B, _, T, H, W = x.shape
        out = torch.empty((B, w.shape[0], T, 2 * H, 2 * W), dtype=x.dtype,
                          device=x.device)
        n = _frames_per_call((B, x.shape[1], T, 2 * H, 2 * W), w.shape[0],
                             0)
        for a in range(0, T, n):
            out[:, :, a:a + n] = F.conv3d(_nearest_up(x[:, :, a:a + n], 1, 2),
                                          w, padding=(0, 1, 1))
        return out.add_(vae_lib._bias(p["conv_b"], out))

    yr = up(xr)
    if compress_time:
        yr = _nearest_up(yr, 2, 1)
    return up(x0), yr


def decode_cp_local(params, z0, zr, cfg: VAEConfig, group,
                    compute_dtype=torch.bfloat16):
    """The decoder on one rank (vae_cp.py:171-197): z0 (B, zc, 1, h, w)
    the first latent frame, zr (B, zc, c, h, w) this rank's. Returns the
    (first, rest) pair of RGB frames."""
    z0, zr = z0.to(compute_dtype), zr.to(compute_dtype)
    zq0, zqr = z0, zr
    n_res = len(cfg.ch_mult)
    h0, hr = causal_conv_cp(params["conv_in"], z0, zr, group)
    h0, hr = resblock_cp(params["mid1"], h0, hr, zq0, zqr, group)
    h0, hr = resblock_cp(params["mid2"], h0, hr, zq0, zqr, group)
    for i_level in reversed(range(n_res)):
        level = params["up"][i_level]
        for blk in level["blocks"]:
            h0, hr = resblock_cp(blk, h0, hr, zq0, zqr, group)
        if i_level != 0:
            ct = i_level >= n_res - cfg.temporal_compress_level
            h0, hr = _upsample_cp(level["up"], h0, hr, compress_time=ct)
    h0, hr = spatial_norm_cp(params["norm_out"], h0, hr, zq0, zqr, group)
    return causal_conv_cp(params["conv_out"], _swish_(h0), _swish_(hr),
                          group)


def resblock_plain_cp(p, x0, xr, group):
    """The encoder's resblock (plain gathered GroupNorm) on the pair."""
    gn = lambda q, a, b: group_norm_cp(q["norm_w"], q["norm_b"], a, b,
                                       group)
    h0, hr = gn(p["norm1"], x0, xr)
    h0, hr = causal_conv_cp(p["conv1"], _swish_(h0), _swish_(hr), group)
    h0, hr = gn(p["norm2"], h0, hr)
    h0, hr = causal_conv_cp(p["conv2"], _swish_(h0), _swish_(hr), group)
    if "nin_w" in p:
        x0, xr = _nin(p, x0), _nin(p, xr)
    return h0.add_(x0), hr.add_(xr)


def _downsample_cp(p, x0, xr, compress_time: bool):
    """DownSample3D on the pair: with compress_time the rest's frame
    pairs averaged (shard sizes stay even), the first frame kept; then
    the stride-2 per-frame conv (vae.downsample3d without its time
    rule)."""
    if compress_time:
        xr = 0.5 * (xr[:, :, 0::2] + xr[:, :, 1::2])
    return (vae_lib.downsample3d(p, x0, False),
            vae_lib.downsample3d(p, xr, False))


def encode_cp_local(params, x0, xr, cfg: VAEConfig, group,
                    compute_dtype=torch.bfloat16):
    """The encoder on one rank (vae_cp.py:247-266): x0 the first frame,
    xr this rank's frames. Returns the (first, rest) pair of moments."""
    x0, xr = x0.to(compute_dtype), xr.to(compute_dtype)
    n_res = len(cfg.ch_mult)
    h0, hr = causal_conv_cp(params["conv_in"], x0, xr, group)
    for i, level in enumerate(params["down"]):
        for blk in level["blocks"]:
            h0, hr = resblock_plain_cp(blk, h0, hr, group)
        if i != n_res - 1:
            h0, hr = _downsample_cp(
                level["down"], h0, hr,
                compress_time=i < cfg.temporal_compress_level)
    h0, hr = resblock_plain_cp(params["mid1"], h0, hr, group)
    h0, hr = resblock_plain_cp(params["mid2"], h0, hr, group)
    h0, hr = group_norm_cp(params["norm_out_w"], params["norm_out_b"],
                           h0, hr, group)
    return causal_conv_cp(params["conv_out"], _swish_(h0), _swish_(hr),
                          group)


def _split(x, group, what: str):
    """(first frame, this rank's share of the rest) of x (B, C, T, H, W)."""
    T, n = x.shape[2], group.size
    if (T - 1) % n:
        raise ValueError(f"{what}: {T} frames are not 1 + a multiple of "
                         f"time={n}")
    c = (T - 1) // n
    return x[:, :, :1], x[:, :, 1 + group.rank * c:1 + (group.rank + 1) * c]


def _gather(y0, yr, group):
    return torch.cat([y0, group.all_gather(yr.contiguous(), dim=2)], dim=2)


def encode_cp(params, x, cfg: VAEConfig, group, *,
              compute_dtype=torch.bfloat16):
    """Context-parallel encode, called by every rank of `group` with the
    whole x (B, 3, T, H, W) in [-1, 1]: moments (B, 2z, T', H/8, W/8)
    gathered on every rank. Each rank's share must stay at least 2 frames
    and pool in pairs through every temporal downsample (vae_cp.py:
    281-285)."""
    x0, xr = _split(x, group, "encode")
    f = 2 ** cfg.temporal_compress_level
    if xr.shape[2] % f or xr.shape[2] // f < 2:
        raise ValueError(f"encode: {xr.shape[2]} frames a rank do not "
                         f"pool to 2 or more by {f}")
    return _gather(*encode_cp_local(params, x0, xr, cfg, group,
                                    compute_dtype), group)


def can_decode_cp(T: int, n: int) -> bool:
    """Whether T latent frames decode context-parallel over n ranks: the
    rest splits evenly, at least kt - 1 = 2 frames a rank so that each
    halo comes from one neighbour (vae_cp.py:280-285)."""
    return (T - 1) % n == 0 and (T - 1) // n >= 2


def decode_cp(params, z, cfg: VAEConfig, group, *,
              compute_dtype=torch.bfloat16):
    """Context-parallel decode, called by every rank of `group` with the
    whole z (B, zc, T, h, w): (B, 3, T_out, H, W) in the compute dtype,
    gathered on every rank."""
    if not can_decode_cp(z.shape[2], group.size):
        raise ValueError(f"{z.shape[2]} latent frames do not decode over "
                         f"time={group.size} (can_decode_cp)")
    z0, zr = _split(z, group, "decode")
    return _gather(*decode_cp_local(params, z0, zr, cfg, group,
                                    compute_dtype), group)


def _rank_cp(ctx, fn, params, x, cfg, compute_dtype):
    """A rank's part of decode_temporal_cp / encode_temporal_cp: fn over
    its time group; the caller's rank (ctx.caller) returns the result."""
    from landiff_tpu_torch.parallel import mesh as mesh_lib

    params, x = mesh_lib.to_rank(ctx, [params, x])
    with torch.inference_mode():
        out = fn(params, x, cfg, ctx.time_group, compute_dtype=compute_dtype)
    mesh_lib.release_cache(ctx)
    return out if ctx.caller else None


def decode_temporal_cp(params, z, cfg: VAEConfig, mesh, *,
                       compute_dtype=torch.bfloat16):
    """The decoder `params` and z (B, zc, T, h, w) whole on rank 0: every
    time group of `mesh` decodes its frames (vae_cp.py:288-313); rank 0
    returns (B, 3, T_out, H, W)."""
    return mesh.run(_rank_cp, decode_cp, params, z, cfg, compute_dtype)[0]


def encode_temporal_cp(params, x, cfg: VAEConfig, mesh, *,
                       compute_dtype=torch.bfloat16):
    """The encoder `params` and x (B, 3, T, H, W) whole on rank 0: every
    time group of `mesh` encodes its frames (vae_cp.py:269-278); rank 0
    returns the moments."""
    return mesh.run(_rank_cp, encode_cp, params, x, cfg, compute_dtype)[0]
