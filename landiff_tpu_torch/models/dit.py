"""CogVideoX-2b DiT, main 30-layer + ControlNet-style 15-layer branch
(counterpart of landiff_tpu/models/dit.py; reference
landiff/diffusion/dit_video_concat.py).

  - patchify: per-frame conv2d (p=2) + text_proj(4096 -> 1920); sequence =
    [text(226) | video(13*30*45 = 17550)]; frozen 3-D sincos table
  - per-layer 12-way adaLN (text/video x shift/scale/gate x msa/mlp), one
    full self-attention over the concatenated sequence with qk-LayerNorm
  - final: LayerNorm on the full sequence, 2-way adaLN, linear, unpatchify
  - control branch: semantic feature added to the input latent, each layer
    output through a zero-init bias-free linear (which replaces the stream)
    and added to the main stream after main layer i

Parameters keep the JAX tree; linear weights are (in, out), the patch
conv kernel is OIHW (see bridge.py). Compute dtype bf16, norms and
softmax accumulate in f32. `remat=True` recomputes each layer in the
backward (torch.utils.checkpoint, non-reentrant, so that the first
forward and the recompute see the same grad mode and take the same
attention route). `quantize_int8` turns the four per-layer matrices into
W8A8 leaves ({"q": int8 (in, out), "s": f32 (out,)}), which `_linear`
multiplies in int8 (LANDIFF_DIT_INT8, pipeline/dif_infer.py). With
LANDIFF_REMAT_SAVE_ATTN=1 the layer checkpoint keeps the flash out / lse
(`_remat_policy`). Not ported yet: TP/SP variants and rotary3d.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from landiff_tpu_torch.config import DiTConfig
from landiff_tpu_torch.ops.adaln import adaln_modulate
from landiff_tpu_torch.ops.attention import attention, \
    save_flash_residuals_context
from landiff_tpu_torch.ops.embeddings import timestep_embedding
from landiff_tpu_torch.ops.norms import layer_norm
from landiff_tpu_torch.utils import env_flag

# ---------------------------------------------------------------------------
# 3-D sincos position table (host, f64 -> f32; dit_video_concat.py:72-171)


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_3d_sincos_pos_embed(embed_dim, grid_h, grid_w, t_size,
                            interp_h=1.0, interp_w=1.0, interp_t=1.0):
    """(T, H*W, D): temporal D/4 block then spatial 3D/4 (h-half, w-half;
    the reference encodes the h-half from the w grid, reproduced)."""
    dim_sp = embed_dim // 4 * 3
    dim_t = embed_dim // 4
    gh = np.arange(grid_h, dtype=np.float32) / interp_h
    gw = np.arange(grid_w, dtype=np.float32) / interp_w
    grid = np.stack(np.meshgrid(gw, gh), axis=0).reshape(2, 1, grid_h, grid_w)
    emb_h = _sincos_1d(dim_sp // 2, grid[0])
    emb_w = _sincos_1d(dim_sp // 2, grid[1])
    pos_sp = np.concatenate([emb_h, emb_w], axis=1)          # (H*W, 3D/4)
    gt = np.arange(t_size, dtype=np.float32) / interp_t
    pos_t = _sincos_1d(dim_t, gt)                            # (T, D/4)
    pos_t = np.repeat(pos_t[:, None, :], grid_h * grid_w, axis=1)
    pos_sp = np.repeat(pos_sp[None, :, :], t_size, axis=0)
    return np.concatenate([pos_t, pos_sp], axis=-1)          # (T, H*W, D)


@functools.lru_cache(maxsize=8)
def _pos_embed_on(cfg: DiTConfig, device: str, dtype) -> torch.Tensor:
    """The table on the device in the compute dtype, copied once."""
    return torch.from_numpy(pos_embed_table(cfg)).to(device, dtype)


@functools.lru_cache(maxsize=4)
def pos_embed_table(cfg: DiTConfig) -> np.ndarray:
    """(text_length + T*n, D) float32; zeros over the text positions."""
    h = cfg.latent_height // cfg.patch_size
    w = cfg.latent_width // cfg.patch_size
    pe = get_3d_sincos_pos_embed(cfg.hidden_size, h, w, cfg.latent_frames,
                                 cfg.pos_interp_scale, cfg.pos_interp_scale)
    pe = pe.reshape(-1, cfg.hidden_size)
    out = np.zeros((cfg.text_length + pe.shape[0], cfg.hidden_size),
                   np.float32)
    out[cfg.text_length:] = pe
    return out


# ---------------------------------------------------------------------------
# layers


def _w8a8_matmul(x, q, s):
    """int8 x int8 product (dit.py:169-186): per-token dynamic absmax
    activation scales, per-output-channel weight scales, int32 sums, then
    f32(y) * sa * s rounded to x.dtype. The scale is written
    `max(...) / 127.0` inside a jitted program, which XLA compiles into a
    product by f32(1/127) (ops/attention.INV127); x / sa stays a division.
    The int32 product is torch._int_mm (an f32 matmul would round: K =
    7,680 gives sums up to 1.2e8 > 2^24)."""
    from landiff_tpu_torch.ops.attention import INV127

    xf = x.float()
    sa = (xf.abs().amax(-1, keepdim=True).clamp_min(1e-12)
          * torch.full((), INV127, dtype=torch.float32, device=x.device))
    xq = torch.clamp(torch.round(xf / sa), -127, 127).to(torch.int8)
    y = torch._int_mm(xq.reshape(-1, xq.shape[-1]), q)
    y = y.reshape(*x.shape[:-1], q.shape[-1])
    return (y.float() * sa * s).to(x.dtype)


def _linear(p, name, x):
    """x @ W + b; a W8A8 leaf {"q", "s"} runs `_w8a8_matmul` (dit.py:189)."""
    w = p[f"{name}_w"]
    if isinstance(w, dict):
        y = _w8a8_matmul(x, w["q"], w["s"])
    else:
        y = x @ w.to(x.dtype)
    return y + p[f"{name}_b"].to(x.dtype)


_INT8_LAYER_LEAVES = ("qkv_w", "attn_out_w", "mlp0_w", "mlp1_w")


def quantize_int8(params):
    """W8A8 quantization of the per-layer matrices of _INT8_LAYER_LEAVES
    (dit.py:198-220): per-output-channel absmax scales s = max(max|w|,
    1e-8) / 127 (a true division: JAX runs this eagerly, dif_infer.py:72),
    codes clip(round(w / s)). adaLN, zero_linear, the embeddings and the
    head keep their weights. Apply to main AND control. "q" is stored
    column-major ((out, in) memory viewed as (in, out)), the operand
    layout of cuBLAS's int8 product."""
    def quant(w):
        a = w.float()
        scale = a.abs().amax(0).clamp_min(1e-8) / 127.0
        codes = torch.clamp(torch.round(a / scale), -127, 127)
        return {"q": codes.to(torch.int8).t().contiguous().t(), "s": scale}

    out = dict(params)
    out["layers"] = [
        {k: (quant(v) if k in _INT8_LAYER_LEAVES else v)
         for k, v in layer.items()}
        for layer in params["layers"]]
    return out


def _layer(p, x, emb, cfg: DiTConfig, attn_impl="auto"):
    """One AdaLN DiT layer over the concatenated [text|video] sequence.
    attn_impl: a route of `attention`, or a callable (q, k, v) -> out in
    its place."""
    B, S, D = x.shape
    tl = cfg.text_length
    H, Dk = cfg.num_heads, cfg.head_dim
    dt = x.dtype
    # adaLN_modulation = Sequential(SiLU, Linear) -> 12 (B, D) pieces; the
    # text and video positions take their own shift/scale/gate
    mods = _linear(p, "adaln", F.silu(emb.to(dt))).chunk(12, dim=-1)
    is_text = (torch.arange(S, device=x.device) < tl)[None, :, None]

    def sel(i):
        return torch.where(is_text, mods[6 + i][:, None], mods[i][:, None])

    # LANDIFF_FUSED_ADALN=1: LayerNorm + modulate in one pass through the
    # fused adaLN kernel (ops/adaln.py) where its shape rule holds; off by
    # default, as in the JAX package (dit.py:261-277)
    fused = env_flag("LANDIFF_FUSED_ADALN")

    def modulate(y, ln, i_shift, i_scale):
        if fused:
            return adaln_modulate(
                y, p[f"{ln}_w"].to(dt), p[f"{ln}_b"].to(dt),
                mods[6 + i_shift], mods[6 + i_scale], mods[i_shift],
                mods[i_scale], text_len=tl, impl="auto")
        h = layer_norm(y, p[f"{ln}_w"], p[f"{ln}_b"], 1e-6)
        return h * (1.0 + sel(i_scale)) + sel(i_shift)

    gate_msa, gate_mlp = sel(2), sel(5)

    h = modulate(x, "ln1", 0, 1)
    q, k, v = _linear(p, "qkv", h).chunk(3, dim=-1)
    q = q.reshape(B, S, H, Dk)
    k = k.reshape(B, S, H, Dk)
    v = v.reshape(B, S, H, Dk).contiguous()
    if cfg.qk_ln:
        q = layer_norm(q, p["q_ln_w"], p["q_ln_b"], 1e-6)
        k = layer_norm(k, p["k_ln_w"], p["k_ln_b"], 1e-6)
    attn = (attn_impl(q, k, v) if callable(attn_impl)
            else attention(q, k, v, impl=attn_impl)).reshape(B, S, D)
    x = x + gate_msa * _linear(p, "attn_out", attn)

    h = modulate(x, "ln2", 3, 4)
    h = F.gelu(_linear(p, "mlp0", h), approximate="tanh")
    return x + gate_mlp * _linear(p, "mlp1", h)


def _embed_inputs(params, x, timesteps, context, cfg: DiTConfig,
                  compute_dtype):
    """patchify + text proj + pos table; time embedding MLP."""
    B, T, C, Hh, Ww = x.shape
    dt = compute_dtype
    P = cfg.patch_size
    emb = F.conv2d(x.to(dt).reshape(B * T, C, Hh, Ww),
                   params["patch_w"].to(dt), stride=P)  # (B*T, D, h, w)
    emb = emb.permute(0, 2, 3, 1) + params["patch_b"].to(dt)
    emb = emb.reshape(B, -1, cfg.hidden_size)
    text = _linear(params, "text_proj", context.to(dt))
    h = torch.cat([text, emb], dim=1)
    h = h + _pos_embed_on(cfg, str(h.device), dt)[None, :h.shape[1]]
    t_emb = timestep_embedding(timesteps, cfg.hidden_size, dtype=dt)
    e = _linear(params["time_mlp"], "fc0", t_emb)
    e = _linear(params["time_mlp"], "fc1", F.silu(e))
    return h, e


def _remat_policy():
    """The per-layer checkpoint's policy (JAX dit.py:469), as the
    checkpoint's context_fn: by default (None) everything in a layer is
    recomputed; LANDIFF_REMAT_SAVE_ATTN=1 keeps the flash forward's out /
    lse across the checkpoint and recomputes the rest
    (attention.save_flash_residuals_context)."""
    if os.environ.get("LANDIFF_REMAT_SAVE_ATTN") == "1":
        return save_flash_residuals_context
    return None


def _layer_fn(remat: bool):
    """`_layer`, or `_layer` recomputed in the backward. Non-reentrant: a
    reentrant checkpoint runs its first forward under no_grad, where
    `attention` would take the int8 forward, and the recompute under grad,
    where it takes the exact one: loss and gradient from two forwards."""
    if not remat:
        return _layer
    policy = _remat_policy()
    if policy is None:
        return functools.partial(checkpoint, _layer, use_reentrant=False)
    return functools.partial(checkpoint, _layer, use_reentrant=False,
                             context_fn=policy)


def forward(params, x, timesteps, context, cfg: DiTConfig, *,
            control_outputs=None, attn_impl="auto",
            compute_dtype=torch.bfloat16, remat=False):
    """Main DiT forward.

    x: (B, T, C, H, W) noisy latents; timesteps: (B,); context:
    (B, text_length, text_dim) T5 features; control_outputs: optional list
    of (B, S, D) tensors added to the full hidden sequence after layers
    0..len-1; remat: recompute each layer in the backward. Returns
    (B, T, C_out, H, W) v-prediction."""
    h, emb = _embed_inputs(params, x, timesteps, context, cfg, compute_dtype)
    layer_fn = _layer_fn(remat)
    for i, p in enumerate(params["layers"]):
        h = layer_fn(p, h, emb, cfg, attn_impl)
        if control_outputs is not None and i < len(control_outputs):
            h = h + control_outputs[i].to(h.dtype)
    return _final_head(params, h, emb, cfg)


def _final_head(params, h, emb, cfg: DiTConfig):
    """final_layernorm + FinalLayerMixin modulate / linear / unpatchify
    (dit_video_concat.py:392-460)."""
    h = layer_norm(h, params["final_ln_w"], params["final_ln_b"], 1e-6)
    hv = h[:, cfg.text_length:]
    f = params["final"]
    hv = layer_norm(hv, f["norm_w"], f["norm_b"], 1e-6)
    shift, scale = _linear(f, "adaln", F.silu(emb)).chunk(2, dim=-1)
    hv = hv * (1.0 + scale[:, None]) + shift[:, None]
    hv = _linear(f, "linear", hv)
    B = hv.shape[0]
    P = cfg.patch_size
    hh = cfg.latent_height // P
    ww = cfg.latent_width // P
    out = hv.reshape(B, cfg.latent_frames, hh, ww, cfg.out_channels, P, P)
    return out.permute(0, 1, 4, 2, 5, 3, 6).reshape(
        B, cfg.latent_frames, cfg.out_channels, hh * P, ww * P)


def control_forward(params, x, timesteps, context, cfg: DiTConfig,
                    semantic_feature, *, attn_impl="auto",
                    compute_dtype=torch.bfloat16, remat=False):
    """Control branch: x + semantic_feature through the control layers;
    each layer's stream passes through its zero-init linear. Returns the
    list of layer outputs (full [text|video] sequences)."""
    x = x.to(compute_dtype) + semantic_feature.to(compute_dtype)
    h, emb = _embed_inputs(params, x, timesteps, context, cfg, compute_dtype)
    layer_fn = _layer_fn(remat)
    outs = []
    for p in params["layers"]:
        h = layer_fn(p, h, emb, cfg, attn_impl)
        h = h @ p["zero_linear_w"].to(h.dtype)   # bias-free (1210-1218)
        outs.append(h)
    return outs


def control_warp_forward(main_params, control_params, x, timesteps, context,
                         cfg: DiTConfig, semantic_feature, *,
                         attn_impl="auto", compute_dtype=torch.bfloat16,
                         remat=False):
    """ControlDiffWarp.forward (dit_video_concat.py:1196-1200)."""
    ctrl_cfg = dataclasses.replace(cfg, num_layers=cfg.control_layers)
    ctrl = control_forward(control_params, x, timesteps, context, ctrl_cfg,
                           semantic_feature, attn_impl=attn_impl,
                           compute_dtype=compute_dtype, remat=remat)
    return forward(main_params, x, timesteps, context, cfg,
                   control_outputs=ctrl, attn_impl=attn_impl,
                   compute_dtype=compute_dtype, remat=remat)


# ---------------------------------------------------------------------------
# init (random weights built on the device; the layout the bridge gives)


def _normal(gen, shape, std, dtype):
    return (torch.randn(shape, generator=gen, device=gen.device)
            * std).to(dtype)


def _init_layer(gen, cfg: DiTConfig, control: bool, dtype):
    D, TE, Dk, M = cfg.hidden_size, cfg.time_embed_dim, cfg.head_dim, \
        cfg.hidden_size * 4
    z = lambda *s: torch.zeros(s, dtype=dtype, device=gen.device)
    o = lambda *s: torch.ones(s, dtype=dtype, device=gen.device)
    nrm = lambda *s: _normal(gen, s, 0.02, dtype)
    p = {
        "adaln_w": z(TE, 12 * D), "adaln_b": z(12 * D),   # adaLN zero-init
        "ln1_w": o(D), "ln1_b": z(D),
        "qkv_w": nrm(D, 3 * D), "qkv_b": z(3 * D),
        "attn_out_w": nrm(D, D), "attn_out_b": z(D),
        "ln2_w": o(D), "ln2_b": z(D),
        "mlp0_w": nrm(D, M), "mlp0_b": z(M),
        "mlp1_w": nrm(M, D), "mlp1_b": z(D),
    }
    if cfg.qk_ln:
        p.update({"q_ln_w": o(Dk), "q_ln_b": z(Dk),
                  "k_ln_w": o(Dk), "k_ln_b": z(Dk)})
    if control:
        p["zero_linear_w"] = z(D, D)
    return p


def init(gen: torch.Generator, cfg: DiTConfig, *, control: bool = False,
         dtype=torch.float32):
    """Random parameters with the JAX init's shapes and zero-init gates,
    drawn from `gen` on its device."""
    D, TE, P = cfg.hidden_size, cfg.time_embed_dim, cfg.patch_size
    z = lambda *s: torch.zeros(s, dtype=dtype, device=gen.device)
    o = lambda *s: torch.ones(s, dtype=dtype, device=gen.device)
    nrm = lambda *s: _normal(gen, s, 0.02, dtype)
    n_layers = cfg.control_layers if control else cfg.num_layers
    params = {
        "patch_w": nrm(D, cfg.in_channels, P, P),       # OIHW
        "patch_b": z(D),
        "text_proj_w": nrm(cfg.text_dim, D), "text_proj_b": z(D),
        "time_mlp": {"fc0_w": nrm(D, TE), "fc0_b": z(TE),
                     "fc1_w": nrm(TE, TE), "fc1_b": z(TE)},
        "layers": [_init_layer(gen, cfg, control, dtype)
                   for _ in range(n_layers)],
        "final_ln_w": o(D), "final_ln_b": z(D),
    }
    if not control:
        # the control net has no final head (EmptyFinalLayerMixin)
        params["final"] = {
            "norm_w": o(D), "norm_b": z(D),
            "adaln_w": z(TE, 2 * D), "adaln_b": z(2 * D),
            "linear_w": nrm(D, P * P * cfg.out_channels),
            "linear_b": z(P * P * cfg.out_channels),
        }
    return params
