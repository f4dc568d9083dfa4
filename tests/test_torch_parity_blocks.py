"""Torch-transcription parity for the two highest-risk composite blocks:

- the SAT DiT AdaLN layer (dit_video_concat.py:490-664: 12-way modulation
  order, separate text/img modulation, qk-LayerNorm on head_dim eps 1e-6
  inside the fused attention, gelu-tanh MLP), and
- the TiTok ResidualAttentionBlock (tokenizer/modules/blocks.py:101-304:
  pre-LN, bias-free wq/wk/wv/wo per tokenizer_cfg.py:51,78, biased MLP,
  exact-erf GELU, torch.nn.LayerNorm eps 1e-5).

The oracles are straight-line f64 torch implementations written from the
reference sources, sharing weights with the JAX modules under test."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu.config import DiTConfig, TiTokConfig
from landiff_tpu.models import dit as dit_lib
from landiff_tpu.models import titok as titok_lib


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


# ---------------------------------------------------------------------------
# SAT DiT AdaLN layer


def sat_adaln_layer_torch(p, x, emb, tl, H, qk_ln=True):
    """Literal f64 transcription of AdaLNMixin.layer_forward + SAT layer
    internals (dit_video_concat.py:539-664; sat 0.4.12 attention defaults:
    fused qkv split [q|k|v], scale 1/sqrt(head_dim), pre layernorm order)."""
    D = x.shape[-1]
    Dk = D // H

    def ln(v, w, b, eps=1e-6):
        return F.layer_norm(v, (v.shape[-1],), t64(w), t64(b), eps)

    def lin(name, v):
        return v @ t64(p[f"{name}_w"]) + t64(p[f"{name}_b"])

    mods = lin("adaln", F.silu(emb)).chunk(12, dim=1)
    (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp,
     t_shift_msa, t_scale_msa, t_gate_msa, t_shift_mlp, t_scale_mlp,
     t_gate_mlp) = mods

    def modulate(v, shift, scale):
        return v * (1 + scale.unsqueeze(1)) + shift.unsqueeze(1)

    text_h, img_h = x[:, :tl], x[:, tl:]
    ti = modulate(ln(text_h, p["ln1_w"], p["ln1_b"]), t_shift_msa,
                  t_scale_msa)
    ii = modulate(ln(img_h, p["ln1_w"], p["ln1_b"]), shift_msa, scale_msa)
    h = torch.cat([ti, ii], dim=1)

    qkv = lin("qkv", h)
    q, k, v = qkv.chunk(3, dim=-1)
    B, S, _ = h.shape
    q = q.reshape(B, S, H, Dk).permute(0, 2, 1, 3)
    k = k.reshape(B, S, H, Dk).permute(0, 2, 1, 3)
    v = v.reshape(B, S, H, Dk).permute(0, 2, 1, 3)
    if qk_ln:
        q = ln(q, p["q_ln_w"], p["q_ln_b"])
        k = ln(k, p["k_ln_w"], p["k_ln_b"])
    scores = (q / Dk ** 0.5) @ k.transpose(-1, -2)
    attn = scores.softmax(dim=-1) @ v
    attn = attn.permute(0, 2, 1, 3).reshape(B, S, D)
    attn = lin("attn_out", attn)
    t_attn, i_attn = attn[:, :tl], attn[:, tl:]
    text_h = text_h + t_gate_msa.unsqueeze(1) * t_attn
    img_h = img_h + gate_msa.unsqueeze(1) * i_attn

    ti = modulate(ln(text_h, p["ln2_w"], p["ln2_b"]), t_shift_mlp,
                  t_scale_mlp)
    ii = modulate(ln(img_h, p["ln2_w"], p["ln2_b"]), shift_mlp, scale_mlp)
    h = torch.cat([ti, ii], dim=1)
    h = lin("mlp1", F.gelu(lin("mlp0", h), approximate="tanh"))
    t_mlp, i_mlp = h[:, :tl], h[:, tl:]
    text_h = text_h + t_gate_mlp.unsqueeze(1) * t_mlp
    img_h = img_h + gate_mlp.unsqueeze(1) * i_mlp
    return torch.cat([text_h, img_h], dim=1)


def test_dit_adaln_layer_matches_sat_transcription():
    cfg = DiTConfig(num_layers=1, control_layers=1, hidden_size=32,
                    num_heads=4, time_embed_dim=16, text_length=3,
                    latent_frames=2, latent_height=8, latent_width=8,
                    patch_size=2, qk_ln=True)
    rng = np.random.default_rng(0)
    p = dit_lib._init_layer(jax.random.PRNGKey(0), cfg, False, jnp.float32)
    p = dict(p)
    # randomize everything init() zeros/ones so the test has teeth
    for k in list(p):
        p[k] = jnp.asarray(rng.standard_normal(p[k].shape) * 0.2, jnp.float32)

    B, S, D = 2, 3 + 12, cfg.hidden_size
    x = rng.standard_normal((B, S, D)) * 0.7
    emb = rng.standard_normal((B, cfg.time_embed_dim))

    got = np.asarray(dit_lib._layer(
        p, jnp.asarray(x, jnp.float32), jnp.asarray(emb, jnp.float32), cfg,
        "xla"))
    want = sat_adaln_layer_torch(p, t64(x), t64(emb), cfg.text_length,
                                 cfg.num_heads).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_dit_adaln_layer_no_qkln():
    cfg = DiTConfig(num_layers=1, control_layers=1, hidden_size=32,
                    num_heads=4, time_embed_dim=16, text_length=3,
                    latent_frames=2, latent_height=8, latent_width=8,
                    patch_size=2, qk_ln=False)
    rng = np.random.default_rng(1)
    p = dit_lib._init_layer(jax.random.PRNGKey(0), cfg, False, jnp.float32)
    p = {k: jnp.asarray(rng.standard_normal(v.shape) * 0.2, jnp.float32)
         for k, v in p.items()}
    B, S = 1, 3 + 8
    x = rng.standard_normal((B, S, cfg.hidden_size))
    emb = rng.standard_normal((B, cfg.time_embed_dim))
    got = np.asarray(dit_lib._layer(
        p, jnp.asarray(x, jnp.float32), jnp.asarray(emb, jnp.float32), cfg,
        "xla"))
    want = sat_adaln_layer_torch(p, t64(x), t64(emb), cfg.text_length,
                                 cfg.num_heads, qk_ln=False).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# TiTok ResidualAttentionBlock


def titok_block_torch(p, x, H, eps=1e-5):
    """Literal f64 transcription of ResidualAttentionBlock._inner_forward +
    MultiheadAttention (blocks.py:101-219, 222-304): pre-LN, bias-free
    attention linears (tokenizer_cfg.py:51,78), sdpa full attention,
    biased MLP with exact GELU."""
    B, S, D = x.shape
    Dk = D // H

    def ln(v, w, b):
        return F.layer_norm(v, (D,), t64(w), t64(b), eps)

    h = ln(x, p["ln0_w"], p["ln0_b"])
    q = (h @ t64(p["wq"])).reshape(B, S, H, Dk).permute(0, 2, 1, 3)
    k = (h @ t64(p["wk"])).reshape(B, S, H, Dk).permute(0, 2, 1, 3)
    v = (h @ t64(p["wv"])).reshape(B, S, H, Dk).permute(0, 2, 1, 3)
    attn = F.scaled_dot_product_attention(q, k, v)
    attn = attn.permute(0, 2, 1, 3).reshape(B, S, D)
    x = x + attn @ t64(p["wo"])
    h = ln(x, p["ln1_w"], p["ln1_b"])
    h = F.gelu(h @ t64(p["fc0_w"]) + t64(p["fc0_b"]), approximate="none")
    return x + h @ t64(p["fc1_w"]) + t64(p["fc1_b"])


def test_titok_block_matches_transcription():
    cfg = TiTokConfig(width=24, num_layers=1, num_heads=4)
    rng = np.random.default_rng(2)
    D, M = 24, 24 * 4
    p = {
        "ln0_w": rng.standard_normal(D) * 0.3 + 1.0,
        "ln0_b": rng.standard_normal(D) * 0.1,
        "wq": rng.standard_normal((D, D)) * 0.2,
        "wk": rng.standard_normal((D, D)) * 0.2,
        "wv": rng.standard_normal((D, D)) * 0.2,
        "wo": rng.standard_normal((D, D)) * 0.2,
        "ln1_w": rng.standard_normal(D) * 0.3 + 1.0,
        "ln1_b": rng.standard_normal(D) * 0.1,
        "fc0_w": rng.standard_normal((D, M)) * 0.2,
        "fc0_b": rng.standard_normal(M) * 0.1,
        "fc1_w": rng.standard_normal((M, D)) * 0.2,
        "fc1_b": rng.standard_normal(D) * 0.1,
    }
    pj = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    B, S = 2, 10
    x = rng.standard_normal((B, S, D))
    # identity rotation: rope parity is pinned separately in test_rope.py
    # (apply_rope itself inserts the heads axis)
    Dk = D // cfg.num_heads
    cos = jnp.ones((S, Dk // 2), jnp.float32)
    sin = jnp.zeros((S, Dk // 2), jnp.float32)
    got = np.asarray(titok_lib._block(
        pj, jnp.asarray(x, jnp.float32), cos, sin, cfg, None, "xla"))
    want = titok_block_torch(p, t64(x), cfg.num_heads,
                             eps=cfg.norm_eps).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
