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
W8A8 leaves ({"q": int8 (in, out), "s": f32 (out,)}), which `_product`
multiplies in int8 (LANDIFF_DIT_INT8, pipeline/dif_infer.py). With
LANDIFF_REMAT_SAVE_ATTN=1 the layer checkpoint keeps the flash out / lse
(`_remat_policy`). `pos_embed="rotary3d"` rotates q / k (and v with
`rot_v`) after qk-LN and adds no sincos table. Without a gradient on
the card, the qkv product's bias, qk-LN and rotation run as one kernel
(`_qkv`, ops/qkv_prep.py). `control_mlp_adapter_
forward` is the lighter control alternative. `forward_tp` /
`control_warp_forward_tp` run the Megatron tensor-parallel layers on one
rank's heads (parallel/tp_infer.py), with `sp_group` also on one rank's
tokens (the 2-D hybrid); `forward_sp` / `control_warp_forward_sp` run the
sequence-parallel layers on one rank's tokens with the weights whole,
attention as a ring over the `time` ranks (parallel/ring_attention.py).
Both train: their collectives carry gradients (parallel/mesh.copy_to,
reduce_from, gather_from; the ring's own backward) and `remat=True`
checkpoints each layer as `forward`'s, with no policy (JAX dit.py:
658-713 checkpoints `_layer_sp` plainly).
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
from landiff_tpu_torch.observability import named_scope
from landiff_tpu_torch.ops import qkv_prep
from landiff_tpu_torch.ops.adaln import adaln_modulate
from landiff_tpu_torch.ops.attention import attention, \
    save_flash_residuals_context
from landiff_tpu_torch.ops.embeddings import timestep_embedding
from landiff_tpu_torch.ops.norms import layer_norm
from landiff_tpu_torch.parallel.mesh import copy_to, gather_from, \
    reduce_from
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
# Rotary 3-D positions (Rotary3DPositionEmbeddingMixin, dit_video_concat.py:
# 275-385): per head-dim axis split t: Dk/4, h: 3Dk/8, w: 3Dk/8,
# pairwise-interleaved frequencies, applied to the video slice of q / k
# (and v with rot_v) after qk-LN


@functools.lru_cache(maxsize=4)
def rotary3d_tables(cfg: DiTConfig):
    """(video_tokens, head_dim) f32 cos / sin tables (dit.py:101-127):
    freqs per axis 1/theta^(2i/dim), each repeated twice in place, over the
    (T, H, W) grid."""
    Dk = cfg.head_dim
    dim_t, dim_h = Dk // 4, Dk // 8 * 3
    dim_w = dim_h

    def freqs(dim):
        idx = np.arange(0, dim, 2, dtype=np.float32)[: dim // 2]
        return (1.0 / cfg.rope_theta ** (idx / dim)).astype(np.float32)

    T = cfg.latent_frames
    hh = cfg.latent_height // cfg.patch_size
    ww = cfg.latent_width // cfg.patch_size
    ft = np.outer(np.arange(T, dtype=np.float32), freqs(dim_t))
    fh = np.outer(np.arange(hh, dtype=np.float32), freqs(dim_h))
    fw = np.outer(np.arange(ww, dtype=np.float32), freqs(dim_w))
    ft, fh, fw = (np.repeat(a, 2, axis=-1) for a in (ft, fh, fw))
    f = np.concatenate([
        np.broadcast_to(ft[:, None, None, :], (T, hh, ww, dim_t)),
        np.broadcast_to(fh[None, :, None, :], (T, hh, ww, dim_h)),
        np.broadcast_to(fw[None, None, :, :], (T, hh, ww, dim_w)),
    ], axis=-1).reshape(T * hh * ww, Dk)
    return np.cos(f), np.sin(f)


@functools.lru_cache(maxsize=8)
def _rotary3d_on(cfg: DiTConfig, device: str, dtype):
    """(text_length + video_tokens, head_dim) cos and signed-sin tables on
    the device in the compute dtype, copied once: the text rows are the
    identity (cos 1, sin 0), and each pair's first sin is negated, so that
    the rotation is t * cos + swap(t) * sin with swap the exchange within
    each pair."""
    cos, sin = rotary3d_tables(cfg)
    text = np.zeros((cfg.text_length, cfg.head_dim), np.float32)
    cos = np.concatenate([text + 1.0, cos])
    sin = np.concatenate([text, sin])
    sin[:, 0::2] = -sin[:, 0::2]
    return (torch.from_numpy(cos).to(device, dtype),
            torch.from_numpy(sin).to(device, dtype))


def _apply_rotary3d(t, cos, sin, offset: int = 0):
    """t: (B, S_local, H, Dk) holding positions [offset, offset + S_local)
    of the [text|video] sequence; cos / sin: `_rotary3d_on`'s tables
    (positions past them take the last row, as JAX clamps). JAX's t * cos
    + rotate_half(t) * sin on the video positions and t on the text ones
    (dit.py:130-149; rotate_half: (x0, x1) -> (-x1, x0) in each pair, not
    the GPT rope's half split), with the negation moved into the table and
    the select into its identity rows: the same products and sums, bit for
    bit but for the sign of a zero on a text row, in four passes over t
    instead of seven."""
    S = t.shape[1]
    rows = (offset + torch.arange(S, device=t.device)).clamp(
        max=cos.shape[0] - 1)
    swapped = t.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
    return t * cos[rows][None, :, None] + swapped * sin[rows][None, :, None]


def _maybe_rotary(q, k, v, cfg: DiTConfig, offset: int = 0):
    """Rotary3D on q / k (v with rot_v) after qk-LN (dit.py:152-162); the
    identity under the sincos table."""
    if cfg.pos_embed != "rotary3d":
        return q, k, v
    cos, sin = _rotary3d_on(cfg, str(q.device), q.dtype)
    q = _apply_rotary3d(q, cos, sin, offset)
    k = _apply_rotary3d(k, cos, sin, offset)
    if cfg.rot_v:
        v = _apply_rotary3d(v, cos, sin, offset)
    return q, k, v


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


def _product(p, name, x):
    """x @ W; a W8A8 leaf {"q", "s"} runs `_w8a8_matmul` (dit.py:189)."""
    w = p[f"{name}_w"]
    if isinstance(w, dict):
        return _w8a8_matmul(x, w["q"], w["s"])
    return x @ w.to(x.dtype)


def _linear(p, name, x):
    """x @ W + b (`_product`, then the bias)."""
    return _product(p, name, x) + p[f"{name}_b"].to(x.dtype)


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


def _adaln_sel(p, emb, x, tl: int, offset: int = 0):
    """adaLN_modulation = Sequential(SiLU, Linear) -> the 12 (B, D)
    pieces, and sel(i): piece i per position of x, the text positions
    taking their own shift/scale/gate (dit.py:228-248). offset: the
    global position of x's first token (a sequence-parallel shard holds
    [offset, offset + S) of the [text|video] sequence)."""
    mods = _linear(p, "adaln", F.silu(emb.to(x.dtype))).chunk(12, dim=-1)
    pos = offset + torch.arange(x.shape[1], device=x.device)
    is_text = (pos < tl)[None, :, None]

    def sel(i):
        return torch.where(is_text, mods[6 + i][:, None], mods[i][:, None])

    return mods, sel


def _qkv_chain(y, p, cfg: DiTConfig, offset: int = 0):
    """q, k, v (B, S, H, Dk) from the bias-free qkv product y by PyTorch
    operations: the bias, qk-LN (eps 1e-6) on the strided q / k views,
    the rotary positions (y holding positions [offset, offset + S)), v
    copied contiguous."""
    B, S, _ = y.shape
    H, Dk = cfg.num_heads, cfg.head_dim
    q, k, v = (y + p["qkv_b"].to(y.dtype)).chunk(3, dim=-1)
    q = q.reshape(B, S, H, Dk)
    k = k.reshape(B, S, H, Dk)
    v = v.reshape(B, S, H, Dk).contiguous()
    if cfg.qk_ln:
        q = layer_norm(q, p["q_ln_w"], p["q_ln_b"], 1e-6)
        k = layer_norm(k, p["k_ln_w"], p["k_ln_b"], 1e-6)
    return _maybe_rotary(q, k, v, cfg, offset)


def _qkv(p, h, cfg: DiTConfig):
    """The attention inputs q, k, v of a layer from its modulated stream
    h: the qkv product, then one pass of the qkv kernel (ops/qkv_prep.py)
    where `qkv_prep.kernel_takes` holds (CUDA, bf16 or f32, heads of 64,
    no gradient), else `_qkv_chain`."""
    dt = h.dtype
    y = _product(p, "qkv", h)
    ln = ((p["q_ln_w"], p["q_ln_b"], p["k_ln_w"], p["k_ln_b"])
          if cfg.qk_ln else ())
    if not qkv_prep.kernel_takes(y, cfg.head_dim, p["qkv_b"], *ln):
        return _qkv_chain(y, p, cfg)
    ln = [t.to(dt) for t in ln] or [None] * 4
    tables = (_rotary3d_on(cfg, str(y.device), dt)
              if cfg.pos_embed == "rotary3d" else (None, None))
    return qkv_prep.qkv_prep(y, p["qkv_b"].to(dt), *ln, *tables,
                             heads=cfg.num_heads, qk_ln=cfg.qk_ln,
                             rot_v=cfg.rot_v, eps=1e-6)


def _layer(p, x, emb, cfg: DiTConfig, attn_impl="auto"):
    """One AdaLN DiT layer over the concatenated [text|video] sequence.
    attn_impl: a route of `attention`, or a callable (q, k, v) -> out in
    its place."""
    with named_scope("landiff.dit.layer"):
        B, S, D = x.shape
        tl = cfg.text_length
        dt = x.dtype
        with named_scope("landiff.dit.modulate"):
            mods, sel = _adaln_sel(p, emb, x, tl)
            gate_msa, gate_mlp = sel(2), sel(5)

        # LANDIFF_FUSED_ADALN=1: LayerNorm + modulate in one pass through
        # the fused adaLN kernel (ops/adaln.py) where its shape rule holds;
        # off by default, as in the JAX package (dit.py:261-277)
        fused = env_flag("LANDIFF_FUSED_ADALN")

        def modulate(y, ln, i_shift, i_scale):
            with named_scope("landiff.dit.modulate"):
                if fused:
                    return adaln_modulate(
                        y, p[f"{ln}_w"].to(dt), p[f"{ln}_b"].to(dt),
                        mods[6 + i_shift], mods[6 + i_scale], mods[i_shift],
                        mods[i_scale], text_len=tl, impl="auto")
                h = layer_norm(y, p[f"{ln}_w"], p[f"{ln}_b"], 1e-6)
                return h * (1.0 + sel(i_scale)) + sel(i_shift)

        h = modulate(x, "ln1", 0, 1)
        with named_scope("landiff.dit.attn"):
            q, k, v = _qkv(p, h, cfg)
            with named_scope("landiff.dit.flash"):
                attn = (attn_impl(q, k, v) if callable(attn_impl)
                        else attention(q, k, v, impl=attn_impl)
                        ).reshape(B, S, D)
            x = x + gate_msa * _linear(p, "attn_out", attn)

        h = modulate(x, "ln2", 3, 4)
        with named_scope("landiff.dit.mlp"):
            h = F.gelu(_linear(p, "mlp0", h), approximate="tanh")
            return x + gate_mlp * _linear(p, "mlp1", h)


def _patchify(params, x, context, cfg: DiTConfig, dt):
    """Per-frame patch conv + text projection -> the [text|video]
    sequence (B, S, D)."""
    B, T, C, Hh, Ww = x.shape
    P = cfg.patch_size
    emb = F.conv2d(x.to(dt).reshape(B * T, C, Hh, Ww),
                   params["patch_w"].to(dt), stride=P)  # (B*T, D, h, w)
    emb = emb.permute(0, 2, 3, 1) + params["patch_b"].to(dt)
    emb = emb.reshape(B, -1, cfg.hidden_size)
    text = _linear(params, "text_proj", context.to(dt))
    return torch.cat([text, emb], dim=1)


def _embed_inputs(params, x, timesteps, context, cfg: DiTConfig,
                  compute_dtype):
    """patchify + text proj + pos table; time embedding MLP. Under
    rotary3d no table is added, and the learnable `pos_embedding` leaf is
    never read (dit.py:454-461; the reference's position_embedding_forward
    returns None)."""
    with named_scope("landiff.dit.embed"):
        dt = compute_dtype
        h = _patchify(params, x, context, cfg, dt)
        if cfg.pos_embed != "rotary3d":
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
            with named_scope("landiff.dit.control"):
                h = h + control_outputs[i].to(h.dtype)
    return _final_head(params, h, emb, cfg)


def _final_head(params, h, emb, cfg: DiTConfig):
    """final_layernorm + FinalLayerMixin modulate / linear / unpatchify
    (dit_video_concat.py:392-460)."""
    with named_scope("landiff.dit.head"):
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
        out = hv.reshape(B, cfg.latent_frames, hh, ww, cfg.out_channels, P,
                         P)
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
        with named_scope("landiff.dit.control"):
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
# tensor- and sequence-parallel forwards (dit.py:303-436, :582-713): run on
# every rank of a mesh, `group` the rank's `model` Group (with the rank's
# part of the tp-prepped layers, parallel/tp_infer.prep_dit_tp), `sp_group`
# its `time` Group


def _sp_slice(h, group):
    """(global offset, this rank's tokens of h): S splits evenly over the
    group (JAX asserts it), the rank's share by its member index."""
    S = h.shape[1]
    if S % group.size:
        raise ValueError(f"a sequence of {S} tokens does not split over "
                         f"time={group.size}")
    s_loc = S // group.size
    offset = group.rank * s_loc
    return offset, h[:, offset:offset + s_loc]


def _ring_impl(attn_impl) -> str:
    """The ring's hop route for a layer's attn_impl (dit.py:353-354): the
    flash forwards on the device for auto / pallas, dense hops for xla."""
    if attn_impl in ("auto", "pallas"):
        return "auto"
    if attn_impl == "xla":
        return "xla"
    raise ValueError(f"a sequence-parallel layer takes attn_impl auto, "
                     f"pallas or xla, not {attn_impl!r}")


def _attend(q, k, v, attn_impl, sp_group):
    """Attention of a layer: the dispatcher (or a callable attn_impl in
    its place), or under sequence parallelism the ring over sp_group."""
    if sp_group is None:
        return (attn_impl(q, k, v) if callable(attn_impl)
                else attention(q, k, v, impl=attn_impl))
    from landiff_tpu_torch.parallel.ring_attention import \
        ring_attention_local

    return ring_attention_local(q, k, v, sp_group,
                                impl=_ring_impl(attn_impl))


def _layer_tp(p, x, emb, cfg: DiTConfig, attn_impl, group, sp_group=None,
              offset=0):
    """Megatron variant of `_layer` on this rank's heads: qkv_w (D, 3,
    H_local, Dk) column-parallel, attn_out_w (H_local, Dk, D)
    row-parallel, mlp0 column- and mlp1 row-parallel; the hidden stream x
    is whole on every rank of the model group. Exactly two all-reduces,
    after attn-out and after mlp1, each followed by its bias, added once.
    qk-LN and Rotary3D act per head; a zero-padded head (tp_infer.
    pad_heads) has v = 0 and adds exactly nothing. As JAX's `_layer_tp`,
    LayerNorm and modulate stay unfused: LANDIFF_FUSED_ADALN is not read.
    W8A8 leaves ({q, s}, tp_infer.quantize_layer_tp) take per-token scales
    of this rank's features; the per-output scale of a row-parallel
    product applies before the all-reduce, as JAX's. Under a gradient the
    inputs of the column-parallel products and the qk-LN parameters (used
    on this rank's heads alone) enter through `copy_to` (Megatron's f) and
    the two all-reduces are `reduce_from` (g): every replicated leaf then
    gets its whole gradient on every rank. sp_group / offset:
    the 2-D hybrid, x this rank's tokens [offset, offset + S) of a
    sequence sharded over sp_group (the `time` ranks at this model
    index), attention a ring over them on the local heads."""
    B, S, D = x.shape
    dt = x.dtype
    w = p["qkv_w"]
    _, _, Hl, Dk = (w["q"] if isinstance(w, dict) else w).shape
    _, sel = _adaln_sel(p, emb, x, cfg.text_length, offset)

    h = layer_norm(x, p["ln1_w"], p["ln1_b"], 1e-6)
    h = copy_to(group, h * (1.0 + sel(1)) + sel(0))
    if isinstance(w, dict):
        qkv = _w8a8_matmul(h, w["q"].reshape(D, 3 * Hl * Dk),
                           w["s"].reshape(-1))
    else:
        qkv = h @ w.reshape(D, 3 * Hl * Dk).to(dt)
    qkv = (qkv + p["qkv_b"].reshape(-1).to(dt)).reshape(B, S, 3, Hl, Dk)
    q, k, v = qkv.unbind(2)
    v = v.contiguous()
    if cfg.qk_ln:
        ln = {n: copy_to(group, p[n]) for n in
              ("q_ln_w", "q_ln_b", "k_ln_w", "k_ln_b")}
        q = layer_norm(q, ln["q_ln_w"], ln["q_ln_b"], 1e-6)
        k = layer_norm(k, ln["k_ln_w"], ln["k_ln_b"], 1e-6)
    q, k, v = _maybe_rotary(q, k, v, cfg, offset)
    attn = _attend(q, k, v, attn_impl, sp_group).reshape(B, S, Hl * Dk)
    wo = p["attn_out_w"]
    if isinstance(wo, dict):
        attn = _w8a8_matmul(attn, wo["q"].reshape(Hl * Dk, D), wo["s"])
    else:
        attn = attn @ wo.reshape(Hl * Dk, D).to(dt)
    attn = reduce_from(group, attn) + p["attn_out_b"].to(dt)
    x = x + sel(2) * attn

    h = layer_norm(x, p["ln2_w"], p["ln2_b"], 1e-6)
    h = copy_to(group, h * (1.0 + sel(4)) + sel(3))
    h = F.gelu(_linear(p, "mlp0", h), approximate="tanh")
    w1 = p["mlp1_w"]
    h = (_w8a8_matmul(h, w1["q"], w1["s"]) if isinstance(w1, dict)
         else h @ w1.to(dt))
    h = reduce_from(group, h) + p["mlp1_b"].to(dt)
    return x + sel(5) * h


def _layer_sp(p, x, emb, cfg: DiTConfig, attn_impl, sp_group, offset):
    """Sequence-parallel variant of `_layer` (dit.py:383-436): x holds this
    rank's tokens [offset, offset + S) of the [text|video] sequence, the
    weights are whole (W8A8 leaves of quantize_int8 too: per-token
    activation scales are local rows). Every op is per token but
    attention, a ring over sp_group; no all-reduce. LayerNorm and modulate
    stay unfused, as JAX's."""
    B, S, D = x.shape
    _, sel = _adaln_sel(p, emb, x, cfg.text_length, offset)

    h = layer_norm(x, p["ln1_w"], p["ln1_b"], 1e-6)
    h = h * (1.0 + sel(1)) + sel(0)
    q, k, v = _qkv_chain(_product(p, "qkv", h), p, cfg, offset)
    attn = _attend(q, k, v, attn_impl, sp_group).reshape(B, S, D)
    x = x + sel(2) * _linear(p, "attn_out", attn)

    h = layer_norm(x, p["ln2_w"], p["ln2_b"], 1e-6)
    h = h * (1.0 + sel(4)) + sel(3)
    h = F.gelu(_linear(p, "mlp0", h), approximate="tanh")
    return x + sel(5) * _linear(p, "mlp1", h)


def _per_layer(layer, remat: bool):
    """layer(p, h, offset), or the same checkpointed (non-reentrant, no
    policy) so that the backward recomputes it."""
    if not remat:
        return layer
    return lambda p, h, off: checkpoint(layer, p, h, off,
                                        use_reentrant=False)


def _main_layers(params, h, emb, cfg, layer, sp_group, control_outputs):
    """The main stream through `layer(p, h, offset)`: embeddings whole on
    every rank, then (under sp_group) this rank's tokens through the
    layers with the control taps of the same tokens, gathered back before
    the final head (one all-gather of (B, S, D) a forward; under a
    gradient its backward is this rank's slice of the cotangent)."""
    offset = 0
    if sp_group is not None:
        offset, h = _sp_slice(h, sp_group)
    for i, p in enumerate(params["layers"]):
        h = layer(p, h, offset)
        if control_outputs is not None and i < len(control_outputs):
            h = h + control_outputs[i].to(h.dtype)
    if sp_group is not None:
        h = gather_from(sp_group, h, 1)
    return _final_head(params, h, emb, cfg)


def _control_layers(params, h, cfg, layer, sp_group):
    """The control taps through `layer(p, h, offset)`; under sp_group
    each rank's taps stay on its tokens (no gather)."""
    offset = 0
    if sp_group is not None:
        offset, h = _sp_slice(h, sp_group)
    outs = []
    for p in params["layers"]:
        h = layer(p, h, offset)
        h = h @ p["zero_linear_w"].to(h.dtype)
        outs.append(h)
    return outs


def forward_tp(params, x, timesteps, context, cfg: DiTConfig, *, group,
               control_outputs=None, attn_impl="auto",
               compute_dtype=torch.bfloat16, sp_group=None, remat=False):
    """`forward` with the tensor-parallel layers; the embeddings and the
    final head are computed whole on every rank (small beside the
    blocks). sp_group: the 2-D hybrid (tokens also over `time`); remat:
    recompute each layer in the backward."""
    h, emb = _embed_inputs(params, x, timesteps, context, cfg, compute_dtype)
    return _main_layers(
        params, h, emb, cfg, _per_layer(
            lambda p, h, off: _layer_tp(p, h, emb, cfg, attn_impl, group,
                                        sp_group, off), remat),
        sp_group, control_outputs)


def control_forward_tp(params, x, timesteps, context, cfg: DiTConfig,
                       semantic_feature, *, group, attn_impl="auto",
                       compute_dtype=torch.bfloat16, sp_group=None,
                       remat=False):
    """`control_forward` with the tensor-parallel layers; zero_linear
    stays whole on every rank (D x D a layer, and its output joins the
    whole main stream, or this rank's tokens of it under sp_group)."""
    x = x.to(compute_dtype) + semantic_feature.to(compute_dtype)
    h, emb = _embed_inputs(params, x, timesteps, context, cfg, compute_dtype)
    return _control_layers(
        params, h, cfg, _per_layer(
            lambda p, h, off: _layer_tp(p, h, emb, cfg, attn_impl, group,
                                        sp_group, off), remat),
        sp_group)


def control_warp_forward_tp(main_params, control_params, x, timesteps,
                            context, cfg: DiTConfig, semantic_feature, *,
                            group, attn_impl="auto",
                            compute_dtype=torch.bfloat16, sp_group=None,
                            remat=False):
    """ControlDiffWarp.forward under tensor parallelism: 2 x (layers +
    control layers) all-reduces (and under sp_group 2 ring shifts a layer
    and hop, one all-gather)."""
    ctrl_cfg = dataclasses.replace(cfg, num_layers=cfg.control_layers)
    ctrl = control_forward_tp(control_params, x, timesteps, context,
                              ctrl_cfg, semantic_feature, group=group,
                              attn_impl=attn_impl,
                              compute_dtype=compute_dtype, sp_group=sp_group,
                              remat=remat)
    return forward_tp(main_params, x, timesteps, context, cfg, group=group,
                      control_outputs=ctrl, attn_impl=attn_impl,
                      compute_dtype=compute_dtype, sp_group=sp_group,
                      remat=remat)


def forward_sp(params, x, timesteps, context, cfg: DiTConfig, *, sp_group,
               control_outputs=None, attn_impl="auto",
               compute_dtype=torch.bfloat16, remat=False):
    """Main DiT forward, sequence-parallel (dit.py:658-681): embeddings
    whole on every rank, this rank's tokens through `_layer_sp`, the final
    head on the gathered sequence. control_outputs: this rank's taps
    (control_forward_sp); remat: recompute each layer in the backward
    (the SP training step's: residuals of the 1 / time token shard)."""
    h, emb = _embed_inputs(params, x, timesteps, context, cfg, compute_dtype)
    return _main_layers(
        params, h, emb, cfg, _per_layer(
            lambda p, h, off: _layer_sp(p, h, emb, cfg, attn_impl,
                                        sp_group, off), remat),
        sp_group, control_outputs)


def control_forward_sp(params, x, timesteps, context, cfg: DiTConfig,
                       semantic_feature, *, sp_group, attn_impl="auto",
                       compute_dtype=torch.bfloat16, remat=False):
    """Sequence-parallel control branch (dit.py:684-698): this rank's
    (B, S_local, D) zero-linear taps."""
    x = x.to(compute_dtype) + semantic_feature.to(compute_dtype)
    h, emb = _embed_inputs(params, x, timesteps, context, cfg, compute_dtype)
    return _control_layers(
        params, h, cfg, _per_layer(
            lambda p, h, off: _layer_sp(p, h, emb, cfg, attn_impl,
                                        sp_group, off), remat),
        sp_group)


def control_warp_forward_sp(main_params, control_params, x, timesteps,
                            context, cfg: DiTConfig, semantic_feature, *,
                            sp_group, attn_impl="auto",
                            compute_dtype=torch.bfloat16, remat=False):
    """ControlDiffWarp.forward under sequence parallelism: per rank 2 x
    (time - 1) ring shifts a layer, one all-gather, no all-reduce."""
    ctrl_cfg = dataclasses.replace(cfg, num_layers=cfg.control_layers)
    ctrl = control_forward_sp(control_params, x, timesteps, context,
                              ctrl_cfg, semantic_feature, sp_group=sp_group,
                              attn_impl=attn_impl,
                              compute_dtype=compute_dtype, remat=remat)
    return forward_sp(main_params, x, timesteps, context, cfg,
                      sp_group=sp_group, control_outputs=ctrl,
                      attn_impl=attn_impl, compute_dtype=compute_dtype,
                      remat=remat)


def control_mlp_adapter_forward(params, x, context, cfg: DiTConfig, *,
                                compute_dtype=torch.bfloat16):
    """ControlMLPAdapter (dit.py:716; dit_video_concat.py:1030-1161): patch
    embed, then per layer a residual LN -> D->2D -> SiLU -> 2D->D adapter
    tapped through a zero-init linear. As in the reference, x is embedded
    without the semantic feature. Returns the list of taps (B, S, D)."""
    dt = compute_dtype
    hidden = _patchify(params, x, context, cfg, dt)
    outs = []
    for p in params["adapters"]:
        h = layer_norm(hidden, p["ln_w"], p["ln_b"], 1e-5)
        h = F.silu(_linear(p, "fc0", h))
        hidden = hidden + _linear(p, "fc1", h)
        outs.append(hidden @ p["zero_linear_w"].to(dt))
    return outs


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
    if cfg.pos_embed == "rotary3d" and cfg.learnable_pos_embed:
        # the reference's zeros (1, S, D) parameter, never added
        # (dit.py:818-827): a checkpoint key only
        params["pos_embedding"] = z(1, cfg.text_length + cfg.video_tokens, D)
    if not control:
        # the control net has no final head (EmptyFinalLayerMixin)
        params["final"] = {
            "norm_w": o(D), "norm_b": z(D),
            "adaln_w": z(TE, 2 * D), "adaln_b": z(2 * D),
            "linear_w": nrm(D, P * P * cfg.out_channels),
            "linear_b": z(P * P * cfg.out_channels),
        }
    return params


def init_mlp_adapter(gen: torch.Generator, cfg: DiTConfig,
                     dtype=torch.float32):
    """Random ControlMLPAdapter parameters (dit.py:743), zero-init taps,
    the patch kernel OIHW."""
    D, P = cfg.hidden_size, cfg.patch_size
    z = lambda *s: torch.zeros(s, dtype=dtype, device=gen.device)
    nrm = lambda *s: _normal(gen, s, 0.02, dtype)
    adapters = [{
        "ln_w": torch.ones((D,), dtype=dtype, device=gen.device),
        "ln_b": z(D),
        "fc0_w": nrm(D, 2 * D), "fc0_b": z(2 * D),
        "fc1_w": nrm(2 * D, D), "fc1_b": z(D),
        "zero_linear_w": z(D, D),
    } for _ in range(cfg.control_layers)]
    return {
        "patch_w": nrm(D, cfg.in_channels, P, P), "patch_b": z(D),
        "text_proj_w": nrm(cfg.text_dim, D), "text_proj_b": z(D),
        "adapters": adapters,
    }
