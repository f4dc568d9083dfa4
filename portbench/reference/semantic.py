"""Plain float32 reference of LanDiff's semantic conditioner: stage-1 codes
-> codebook vectors and the quantizer's output projection -> the TiTok
decoder (pre-LN blocks with 3-D rotary q / k, under the video decoder's
attention mask) -> the per-frame VQGAN-style 2x upsampler -> conv_out,
the DiT's latent condition (B, T, 16, 2 gh, 2 gw).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import attention, gelu_erf, group_norm, \
    layer_norm, silu

GAIN = (1.0, 0.05)
BIAS = (0.0, 0.02)


def _n(std):
    return (0.0, std)


def _block_spec(Wd, mlp):
    s = Wd ** -0.5
    return {
        "ln0_w": ((Wd,), *GAIN), "ln0_b": ((Wd,), *BIAS),
        "wq": ((Wd, Wd), *_n(s)), "wk": ((Wd, Wd), *_n(s)),
        "wv": ((Wd, Wd), *_n(s)), "wo": ((Wd, Wd), *_n(s)),
        "ln1_w": ((Wd,), *GAIN), "ln1_b": ((Wd,), *BIAS),
        "fc0_w": ((Wd, mlp), *_n(s)), "fc0_b": ((mlp,), *BIAS),
        "fc1_w": ((mlp, Wd), *_n(mlp ** -0.5)), "fc1_b": ((Wd,), *BIAS),
    }


def _conv_spec(cin, cout, k, gain=1.0):
    return ((cout, cin, k, k), 0.0, gain * (k * k * cin) ** -0.5)


def _res_spec(cin, cout):
    p = {"norm1_w": ((cin,), *GAIN), "norm1_b": ((cin,), *BIAS),
         "conv1_w": _conv_spec(cin, cout, 3), "conv1_b": ((cout,), *BIAS),
         "norm2_w": ((cout,), *GAIN), "norm2_b": ((cout,), *BIAS),
         "conv2_w": _conv_spec(cout, cout, 3), "conv2_b": ((cout,), *BIAS)}
    if cin != cout:
        p["nin_w"] = _conv_spec(cin, cout, 1)
        p["nin_b"] = ((cout,), *BIAS)
    return p


def param_spec(s):
    """s: the configuration's "semantic" group."""
    t = s["titok"]
    Wd, q = t["width"], s["vq"]
    mlp = int(Wd * t["mlp_ratio"])
    feat = s["feature_dim"]
    up_ch = s["upsample_ch"]
    block_in = int(up_ch * s["ch_mult"][-1])
    block_l0 = int(up_ch * s["ch_mult"][0])
    n_res = s["num_res_blocks"] + 1
    up0, cin = [], block_in
    for _ in range(n_res):
        up0.append(_res_spec(cin, block_l0))
        cin = block_l0
    return {
        "vq": {
            "quant": {
                "out_w": ((q["codebook_dim"], q["dim"]),
                          *_n(q["codebook_dim"] ** -0.5)),
                "out_b": ((q["dim"],), *BIAS),
                "codebook": ((q["codebook_size"], q["codebook_dim"]),
                             0.0, 1.0),
            },
            "decoder": {
                "embed_w": ((t["token_size"], Wd),
                            *_n(t["token_size"] ** -0.5)),
                "embed_b": ((Wd,), *BIAS),
                "mask_token": ((Wd,), *_n(Wd ** -0.5)),
                "ln_pre_w": ((Wd,), *GAIN), "ln_pre_b": ((Wd,), *BIAS),
                "blocks": [_block_spec(Wd, mlp)
                           for _ in range(t["num_layers"])],
                "ln_post_w": ((Wd,), *GAIN), "ln_post_b": ((Wd,), *BIAS),
                "ffn0_w": ((Wd, 2 * Wd), *_n(Wd ** -0.5)),
                "ffn0_b": ((2 * Wd,), *BIAS),
                "ffn1_w": ((2 * Wd, feat), *_n((2 * Wd) ** -0.5)),
                "ffn1_b": ((feat,), *BIAS),
            },
        },
        "upsampler": {
            "conv_in_w": _conv_spec(s["z_channels"], block_in, 3),
            "conv_in_b": ((block_in,), *BIAS),
            "mid1": _res_spec(block_in, block_in),
            "mid2": _res_spec(block_in, block_in),
            "up1": [_res_spec(block_in, block_in) for _ in range(n_res)],
            "up1_conv_w": _conv_spec(block_in // 4, block_in, 3),
            "up1_conv_b": ((block_in,), *BIAS),
            "up0": up0,
            "norm_out_w": ((block_l0,), *GAIN),
            "norm_out_b": ((block_l0,), *BIAS),
            "conv_out_w": _conv_spec(block_l0, s["up_out_channels"], 3),
            "conv_out_b": ((s["up_out_channels"],), *BIAS),
        },
        "conv_out_w": _conv_spec(s["up_out_channels"], s["out_channels"], 3,
                                0.5),
        "conv_out_b": ((s["out_channels"],), *BIAS),
    }


# ---------------------------------------------------------------------------
# 3-D rotary positions of the TiTok decoder


def _axis_freqs(theta, n, denom):
    return 1.0 / theta ** (np.arange(0, 2 * n, 2, dtype=np.float64) / denom)


def _angles(r, t_pos, h_pos, w_pos):
    """(N, dim/2) angles: t over dim/8 pairs, h and w over 3 dim/16 each
    (the released layout, `multiple` 16)."""
    dim, theta = r["dim"], r["theta_base"]
    assert r["multiple"] == 16
    t_dim, hw_dim = dim // 4, dim // 8 * 3
    tf = _axis_freqs(theta, t_dim // 2, t_dim)
    hwf = _axis_freqs(theta, hw_dim // 2, hw_dim)
    return np.concatenate([np.outer(t_pos, tf), np.outer(h_pos, hwf),
                           np.outer(w_pos, hwf)], axis=-1)


def rope_tables(t, forward_t):
    """(cos, sin) (seq, dim/2) for [visual grid | query tokens]: a grid
    token at (t, h, w) takes its grid angles (indices clipped to the
    table's extent); a query token i takes the 1-D table's angles at
    (i, i, i)."""
    r = t["rope"]
    gh, gw = t["grid_h"], t["grid_w"]
    tt, hh, ww = np.meshgrid(np.arange(forward_t), np.arange(gh),
                             np.arange(gw), indexing="ij")
    tt, hh, ww = (a.reshape(-1) for a in (tt, hh, ww))
    q_len = t["iframe_latent_tokens"] + (forward_t - 1) \
        * t["pframe_latent_tokens"]
    grid = _angles(r, np.clip(tt, 0, r["max_time"] - 1),
                   np.clip(hh, 0, r["max_height"] - 1),
                   np.clip(ww, 0, r["max_width"] - 1))
    i = np.arange(q_len)
    text = _angles(r, i, i, i)
    # grid positions with t == h == w also take the 1-D table
    eq = (tt == hh) & (hh == ww)
    grid[eq] = _angles(r, tt[eq], tt[eq], tt[eq])
    ang = np.concatenate([grid, text], axis=0)
    return np.cos(ang), np.sin(ang)


def _rope(x, cos, sin):
    x0, x1 = x[..., 0::2], x[..., 1::2]
    c, s = cos[None, :, None], sin[None, :, None]
    return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c],
                       dim=-1).reshape(x.shape)


# ---------------------------------------------------------------------------
# the video decoder's attention mask


def decoder_mask(forward_t, t):
    """mask(q_idx, kv_idx): grid tokens of frame f see frame 0..f and the
    query tokens of frames 0..f; query tokens of frame f see the grid of
    frames 0..f and the query tokens of frames 0..f; frame 0's grid and
    query tokens see frame 0 and its query tokens."""
    n = t["grid_h"] * t["grid_w"]
    iq, pq = t["iframe_latent_tokens"], t["pframe_latent_tokens"]
    frames_end = forward_t * n
    iq_end = frames_end + iq
    seq = iq_end + pq * (forward_t - 1)

    def fn(q, kv):
        q_frame, kv_frame = q // n, kv // n
        p_frame = (q - iq_end) // pq + 1
        f0_iq = (kv < n) | ((kv >= frames_end) & (kv < iq_end))
        grid = (((kv < frames_end) & (kv_frame <= q_frame))
                | ((kv >= frames_end) & (kv < iq_end + q_frame * pq)))
        pquery = ((kv < (p_frame + 1) * n)
                  | ((kv >= frames_end) & (kv < iq_end + p_frame * pq)))
        return (((q < n) & f0_iq)
                | ((q >= n) & (q < frames_end) & grid)
                | ((q >= frames_end) & (q < iq_end) & f0_iq)
                | ((q >= iq_end) & (q < seq) & pquery))

    return fn


def titok_decode(p, latents, t, forward_t):
    B = latents.shape[0]
    Wd, H = t["width"], t["num_heads"]
    eps = t["norm_eps"]
    x = latents @ p["embed_w"].float() + p["embed_b"].float()
    n_vis = forward_t * t["grid_h"] * t["grid_w"]
    mask_tok = p["mask_token"].float()[None, None].expand(B, n_vis, Wd)
    x = layer_norm(torch.cat([mask_tok, x], dim=1), p["ln_pre_w"],
                   p["ln_pre_b"], eps)
    cos, sin = (torch.from_numpy(a).float().to(x.device)
                for a in rope_tables(t, forward_t))
    mask_fn = decoder_mask(forward_t, t)
    S = x.shape[1]
    for b in p["blocks"]:
        h = layer_norm(x, b["ln0_w"], b["ln0_b"], eps)
        q = _rope((h @ b["wq"].float()).reshape(B, S, H, -1), cos, sin)
        k = _rope((h @ b["wk"].float()).reshape(B, S, H, -1), cos, sin)
        v = (h @ b["wv"].float()).reshape(B, S, H, -1)
        a = attention(q, k, v, mask_fn=mask_fn).reshape(B, S, Wd)
        x = x + a @ b["wo"].float()
        h = layer_norm(x, b["ln1_w"], b["ln1_b"], eps)
        h = gelu_erf(h @ b["fc0_w"].float() + b["fc0_b"].float())
        x = x + h @ b["fc1_w"].float() + b["fc1_b"].float()
    x = layer_norm(x[:, :n_vis], p["ln_post_w"], p["ln_post_b"], eps)
    h = torch.tanh(x @ p["ffn0_w"].float() + p["ffn0_b"].float())
    x = h @ p["ffn1_w"].float() + p["ffn1_b"].float()
    return x.reshape(B, forward_t, t["grid_h"], t["grid_w"], -1)


# ---------------------------------------------------------------------------
# the upsampler


def _conv(p, name, x):
    w = p[f"{name}_w"].float()
    return (F.conv2d(x, w, padding=w.shape[-1] // 2)
            + p[f"{name}_b"].float()[None, :, None, None])


def _gn(p, name, x):
    return group_norm(x, p[f"{name}_w"], p[f"{name}_b"],
                      min(32, p[f"{name}_w"].shape[0]), 1e-6)


def _res(p, x):
    h = _conv(p, "conv1", silu(_gn(p, "norm1", x)))
    h = _conv(p, "conv2", silu(_gn(p, "norm2", h)))
    if "nin_w" in p:
        x = _conv(p, "nin", x)
    return x + h


def upsample(p, z):
    h = _conv(p, "conv_in", z)
    h = _res(p["mid2"], _res(p["mid1"], h))
    for b in p["up1"]:
        h = _res(b, h)
    h = _conv(p, "up1_conv", F.pixel_shuffle(h, 2))
    for b in p["up0"]:
        h = _res(b, h)
    return _conv(p, "conv_out", silu(_gn(p, "norm_out", h)))


def semantic_feature(params, codes, s, forward_t):
    """codes (B, L) int -> (B, T, out_channels, 2 gh, 2 gw)."""
    q = params["vq"]["quant"]
    lat = q["codebook"].float()[codes] @ q["out_w"].float() \
        + q["out_b"].float()
    feats = titok_decode(params["vq"]["decoder"], lat, s["titok"], forward_t)
    B, T, gh, gw, C = feats.shape
    x = feats.reshape(B * T, gh, gw, C).permute(0, 3, 1, 2)
    x = _conv(params, "conv_out", upsample(params["upsampler"], x))
    return x.reshape(B, T, *x.shape[1:])
