"""Plain float32 reference of the ControlNet DiT of LanDiff's stage 2
(CogVideoX's expert transformer with a control branch).

Written from the published description: per layer a 12-way adaLN
(text / video x shift, scale, gate x attention, MLP), one full
self-attention over [text | video] with LayerNorm on q and k, a tanh-GELU
MLP; the control branch takes the latents plus the semantic feature
through `control_layers` layers, each output through a bias-free linear,
added to the main stream after main layer i; a final LayerNorm, a 2-way
adaLN, a linear and the unpatchify. Positions: a 3-D sincos table added
to the input (CogVideoX-2b) or 3-D rotary q / k (CogVideoX-5b). Linear
weights are (in, out); the patch kernel is (out, in, p, p).

`param_spec` gives the tree's leaves as (shape, mean, std), from which
the benchmark draws the weights it hands to both sides.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import attention, gelu_tanh, layer_norm, \
    linear, silu, timestep_embedding

# leaf distributions: (mean, std); see PERF.md "Cells" for why each
W = (0.0, 0.02)          # linear weights
GAIN = (1.0, 0.05)       # LayerNorm gains
# the gains of the LayerNorms before the qkv and first MLP linears: one
# channel in 256 an outlier, 20 times the others, as trained transformers'
# activations have (a W8A8 product's per-token scale follows them)
PRE_GAIN = (1.0, 0.05, 256, 20.0)
BIAS = (0.0, 0.02)       # biases
QK_GAIN = (1.5, 0.2)     # q / k LayerNorm gains: attention that is peaked
ADA_B = (0.0, 0.3)       # adaLN biases: gates, shifts, scales of O(0.3)
ZERO_LINEAR = (0.0, 0.005)


def head_dim(d):
    return d["hidden_size"] // d["num_heads"]


def video_tokens(d):
    p = d["patch_size"]
    return (d["latent_frames"] * (d["latent_height"] // p)
            * (d["latent_width"] // p))


def _layer_spec(d, control: bool):
    D, TE, Dk = d["hidden_size"], d["time_embed_dim"], head_dim(d)
    M = 4 * D
    p = {
        "adaln_w": ((TE, 12 * D), *W), "adaln_b": ((12 * D,), *ADA_B),
        "ln1_w": ((D,), *PRE_GAIN), "ln1_b": ((D,), *BIAS),
        "qkv_w": ((D, 3 * D), *W), "qkv_b": ((3 * D,), *BIAS),
        "attn_out_w": ((D, D), *W), "attn_out_b": ((D,), *BIAS),
        "ln2_w": ((D,), *PRE_GAIN), "ln2_b": ((D,), *BIAS),
        "mlp0_w": ((D, M), *W), "mlp0_b": ((M,), *BIAS),
        "mlp1_w": ((M, D), *W), "mlp1_b": ((D,), *BIAS),
    }
    if d["qk_ln"]:
        p.update({"q_ln_w": ((Dk,), *QK_GAIN), "q_ln_b": ((Dk,), *BIAS),
                  "k_ln_w": ((Dk,), *QK_GAIN), "k_ln_b": ((Dk,), *BIAS)})
    if control:
        p["zero_linear_w"] = ((D, D), *ZERO_LINEAR)
    return p


def param_spec(d, control: bool = False):
    """The main (control=False) or control tree as (shape, mean, std)."""
    D, TE, P = d["hidden_size"], d["time_embed_dim"], d["patch_size"]
    n = d["control_layers"] if control else d["num_layers"]
    spec = {
        "patch_w": ((D, d["in_channels"], P, P), *W),
        "patch_b": ((D,), *BIAS),
        "text_proj_w": ((d["text_dim"], D), *W),
        "text_proj_b": ((D,), *BIAS),
        "time_mlp": {"fc0_w": ((D, TE), *W), "fc0_b": ((TE,), *BIAS),
                     "fc1_w": ((TE, TE), *W), "fc1_b": ((TE,), *BIAS)},
        "layers": [_layer_spec(d, control) for _ in range(n)],
        "final_ln_w": ((D,), *GAIN), "final_ln_b": ((D,), *BIAS),
    }
    if not control:
        spec["final"] = {
            "norm_w": ((D,), *GAIN), "norm_b": ((D,), *BIAS),
            "adaln_w": ((TE, 2 * D), *W), "adaln_b": ((2 * D,), *ADA_B),
            "linear_w": ((D, P * P * d["out_channels"]), *W),
            "linear_b": ((P * P * d["out_channels"],), *BIAS),
        }
    return spec


# ---------------------------------------------------------------------------
# positions


def _sincos_1d(embed_dim, pos):
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_table(d):
    """(text_length + video_tokens, D): zeros over the text, then the 3-D
    table: a temporal D/4 block and a spatial 3D/4 block, the spatial
    grid scaled by 1 / pos_interp_scale. As in CogVideoX's
    get_3d_sincos_pos_embed, the first spatial half encodes the w grid."""
    D, P = d["hidden_size"], d["patch_size"]
    gh_n, gw_n = d["latent_height"] // P, d["latent_width"] // P
    T = d["latent_frames"]
    s = d["pos_interp_scale"]
    dim_sp, dim_t = D // 4 * 3, D // 4
    gh = np.arange(gh_n, dtype=np.float32) / s
    gw = np.arange(gw_n, dtype=np.float32) / s
    grid = np.stack(np.meshgrid(gw, gh), axis=0).reshape(2, 1, gh_n, gw_n)
    sp = np.concatenate([_sincos_1d(dim_sp // 2, grid[0]),
                         _sincos_1d(dim_sp // 2, grid[1])], axis=1)
    pt = _sincos_1d(dim_t, np.arange(T, dtype=np.float32))
    pe = np.concatenate([np.repeat(pt[:, None], gh_n * gw_n, axis=1),
                         np.repeat(sp[None], T, axis=0)], axis=-1)
    out = np.zeros((d["text_length"] + T * gh_n * gw_n, D), np.float32)
    out[d["text_length"]:] = pe.reshape(-1, D)
    return out


def rotary_tables(d):
    """Rotary 3-D angles over the video positions, (video_tokens, Dk):
    head dims split t Dk/4, h 3Dk/8, w 3Dk/8, each axis's frequencies
    1 / theta^(2i / dim), every frequency used by one adjacent pair."""
    Dk, P = head_dim(d), d["patch_size"]
    dim_t, dim_h = Dk // 4, Dk // 8 * 3
    T = d["latent_frames"]
    hh, ww = d["latent_height"] // P, d["latent_width"] // P

    def freqs(dim):
        i = np.arange(0, dim, 2, dtype=np.float64)[: dim // 2]
        return 1.0 / d["rope_theta"] ** (i / dim)

    ang = [np.repeat(np.outer(np.arange(n, dtype=np.float64), freqs(dim)),
                     2, axis=-1)
           for n, dim in ((T, dim_t), (hh, dim_h), (ww, dim_h))]
    f = np.concatenate([
        np.broadcast_to(ang[0][:, None, None], (T, hh, ww, dim_t)),
        np.broadcast_to(ang[1][None, :, None], (T, hh, ww, dim_h)),
        np.broadcast_to(ang[2][None, None, :], (T, hh, ww, dim_h)),
    ], axis=-1).reshape(T * hh * ww, Dk)
    return np.cos(f), np.sin(f)


def _rotate(t, cos, sin, text_len):
    """Rotate each adjacent pair (x0, x1) -> (x0 c - x1 s, x1 c + x0 s) on
    the video positions; the text positions stay as they are."""
    v = t[:, text_len:]
    x0, x1 = v[..., 0::2], v[..., 1::2]
    c = cos[None, :, None, 0::2]
    s = sin[None, :, None, 0::2]
    rot = torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1)
    return torch.cat([t[:, :text_len], rot.flatten(-2)], dim=1)


# ---------------------------------------------------------------------------
# layers


def _layer(p, x, emb, d, rot):
    B, S, D = x.shape
    tl, H = d["text_length"], d["num_heads"]
    Dk = D // H
    mods = linear(p, "adaln", silu(emb)).chunk(12, dim=-1)
    is_text = (torch.arange(S, device=x.device) < tl)[None, :, None]

    def sel(i):
        return torch.where(is_text, mods[6 + i][:, None], mods[i][:, None])

    def modulate(y, ln, i_shift, i_scale):
        h = layer_norm(y, p[f"{ln}_w"], p[f"{ln}_b"], 1e-6)
        return h * (1.0 + sel(i_scale)) + sel(i_shift)

    h = modulate(x, "ln1", 0, 1)
    q, k, v = linear(p, "qkv", h).chunk(3, dim=-1)
    q, k, v = (t.reshape(B, S, H, Dk) for t in (q, k, v))
    if d["qk_ln"]:
        q = layer_norm(q, p["q_ln_w"], p["q_ln_b"], 1e-6)
        k = layer_norm(k, p["k_ln_w"], p["k_ln_b"], 1e-6)
    if rot is not None:
        q = _rotate(q, *rot, tl)
        k = _rotate(k, *rot, tl)
        if d.get("rot_v", False):
            v = _rotate(v, *rot, tl)
    a = attention(q, k, v).reshape(B, S, D)
    x = x + sel(2) * linear(p, "attn_out", a)
    h = modulate(x, "ln2", 3, 4)
    h = gelu_tanh(linear(p, "mlp0", h))
    return x + sel(5) * linear(p, "mlp1", h)


def _embed(params, x, timesteps, context, d):
    B, T, C, Hh, Ww = x.shape
    P = d["patch_size"]
    e = F.conv2d(x.reshape(B * T, C, Hh, Ww), params["patch_w"].float(),
                 stride=P)
    e = e.permute(0, 2, 3, 1) + params["patch_b"].float()
    e = e.reshape(B, -1, d["hidden_size"])
    h = torch.cat([linear(params, "text_proj", context.float()), e], dim=1)
    if d["pos_embed"] != "rotary3d":
        h = h + torch.from_numpy(sincos_table(d)).to(h.device)[None]
    t = timestep_embedding(timesteps, d["hidden_size"])
    tm = params["time_mlp"]
    return h, linear(tm, "fc1", silu(linear(tm, "fc0", t)))


def _rot(d, device):
    if d["pos_embed"] != "rotary3d":
        return None
    cos, sin = rotary_tables(d)
    return (torch.from_numpy(cos).float().to(device),
            torch.from_numpy(sin).float().to(device))


def _head(params, h, emb, d):
    h = layer_norm(h, params["final_ln_w"], params["final_ln_b"], 1e-6)
    hv = h[:, d["text_length"]:]
    f = params["final"]
    hv = layer_norm(hv, f["norm_w"], f["norm_b"], 1e-6)
    shift, scale = linear(f, "adaln", silu(emb)).chunk(2, dim=-1)
    hv = linear(f, "linear", hv * (1.0 + scale[:, None]) + shift[:, None])
    B, P = hv.shape[0], d["patch_size"]
    hh, ww = d["latent_height"] // P, d["latent_width"] // P
    out = hv.reshape(B, d["latent_frames"], hh, ww, d["out_channels"], P, P)
    return out.permute(0, 1, 4, 2, 5, 3, 6).reshape(
        B, d["latent_frames"], d["out_channels"], hh * P, ww * P)


def control_warp_forward(main, control, x, timesteps, context, d,
                         semantic_feature):
    """x (B, T, C, H, W) -> the v-prediction (B, T, C_out, H, W)."""
    x = x.float()
    rot = _rot(d, x.device)
    h, emb = _embed(control, x + semantic_feature.float(), timesteps,
                    context, d)
    taps = []
    for p in control["layers"]:
        h = _layer(p, h, emb, d, rot)
        h = h @ p["zero_linear_w"].float()
        taps.append(h)
    del h
    h, emb = _embed(main, x, timesteps, context, d)
    for i, p in enumerate(main["layers"]):
        h = _layer(p, h, emb, d, rot)
        if i < len(taps):
            h = h + taps[i]
            taps[i] = None
    return _head(main, h, emb, d)
