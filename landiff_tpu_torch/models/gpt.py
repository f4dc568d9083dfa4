"""Stage-1 GPT backbone (counterpart of landiff_tpu/models/gpt.py):
Llama-style blocks (RMSNorm + SwiGLU with GELU-tanh) with fused wqkv, 1-D
RoPE, causal attention and a LayerNorm + Linear head.

Reference: landiff/llm/models/transformer.py (GPT),
landiff/llm/modules/transformer_blocks.py (LlamaTransformerBlock,
local_kvcache_inference).

Inference only: `prefill` runs the prompt and fills the KV cache,
`decode_step` runs one token against it. The cache is preallocated on the
device and written IN PLACE (the JAX functions return new arrays); the
caller's loop keeps every index on the device. Blocks run in the compute
dtype, norms accumulate in f32, the head runs in f32 on the last position.
Not ported yet: `forward` / `block_forward` (the training forward) and the
weight-only int8 / int4 decode leaves.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from landiff_tpu_torch.config import LLMConfig
from landiff_tpu_torch.ops import masks as masks_lib
from landiff_tpu_torch.ops.attention import mha_reference
from landiff_tpu_torch.ops.norms import layer_norm, rms_norm
from landiff_tpu_torch.ops.rope import apply_rope


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


class KVCache(NamedTuple):
    """Per-layer stacked KV cache: (L, B, S_max, H, Dk)."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: LLMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
        shape = (cfg.num_layers, batch, max_len, cfg.num_heads, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _dot(x, w):
    """x @ w for a plain weight. The weight-only quantized leaves of the
    JAX package ({"q", "s"} int8, {"q4", "s"} int4) belong to the fast
    serving configuration, which is not ported yet."""
    if isinstance(w, dict):
        raise NotImplementedError(
            "weight-only int8 / int4 GPT leaves are not ported yet (the "
            "fast serving configuration slice)")
    return x @ w.to(x.dtype)


def _qkv(p, x, cfg: LLMConfig):
    B, S, _ = x.shape
    q, k, v = _dot(x, p["wqkv"]).chunk(3, dim=-1)
    shp = (B, S, cfg.num_heads, cfg.head_dim)
    return q.reshape(shp), k.reshape(shp), v.reshape(shp)


def _mlp(p, x):
    return _dot(gelu_tanh(_dot(x, p["w1"])) * _dot(x, p["w3"]), p["w2"])


def _bcast_rope(cos, sin):
    """cos/sin (S, Dk/2) -> (1, S, Dk/2); per-row (B, S, Dk/2) passes
    through (left-padded batched decode shifts rope positions per row)."""
    if cos.dim() == 2:
        return cos[None], sin[None]
    return cos, sin


def block_decode(p, x, cos, sin, k_cache, v_cache, pos, cfg: LLMConfig,
                 pad=None):
    """Single-token step. x: (B, 1, D); k_cache / v_cache: (B, S_max, H,
    Dk), written in place at `pos`; pos: 0-d or (1,) int64 tensor on the
    device, the index of the current token; pad: optional (B,) left-pad
    lengths (cache slots < pad[b] are masked out). Returns x."""
    B, _, D = x.shape
    h = rms_norm(x, p["norm0"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg)
    cos, sin = _bcast_rope(cos, sin)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    pos = pos.reshape(1)
    k_cache.index_copy_(1, pos, k.to(k_cache.dtype))
    v_cache.index_copy_(1, pos, v.to(v_cache.dtype))
    # attention over the whole cache, masked beyond pos
    # (transformer_blocks.py:169-184: f32 scores, f32 softmax)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * scale
    ks = torch.arange(k_cache.shape[1], device=x.device)
    valid = (ks <= pos)[None, None, None, :]
    if pad is not None:
        valid = valid & (ks[None, :] >= pad[:, None])[:, None, None, :]
    s = torch.where(valid, s, -1e30)
    w = torch.softmax(s, dim=-1)
    attn = torch.einsum("bhqk,bkhd->bqhd", w.to(v_cache.dtype), v_cache)
    x = x + _dot(attn.reshape(B, 1, D).to(x.dtype), p["wo"])
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    return x + _mlp(p, h)


def prefill(params, features, cache: KVCache, cfg: LLMConfig, cos, sin,
            compute_dtype=torch.bfloat16, pad=None):
    """Run the prompt through all blocks, filling cache[:, :, :S] in place.

    pad: optional (B,) left-pad lengths for right-aligned batched prompts
    (positions < pad[b] are masked out of the causal attention; their K/V
    lands in the cache but stays masked in every later decode step too).
    cos/sin may be per-row (B, S, Dk/2) to shift rope positions by pad.

    Returns (f32 logits of the LAST position, the cache)."""
    x = features.to(compute_dtype)
    S = x.shape[1]
    cos, sin = _bcast_rope(cos, sin)
    if pad is None:
        mask, mask_fn = None, masks_lib.causal
    else:
        qi = torch.arange(S, device=x.device)[:, None]
        ki = torch.arange(S, device=x.device)[None, :]
        mask = ((qi >= ki)[None]
                & (ki[None] >= pad[:, None, None]))[:, None]  # (B, 1, S, S)
        mask_fn = None
    for i, p in enumerate(params["blocks"]):
        h = rms_norm(x, p["norm0"], cfg.norm_eps)
        q, k, v = _qkv(p, h, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        # the dense reference, as the JAX prefill pins impl="xla"
        attn = mha_reference(q, k, v, mask=mask, mask_fn=mask_fn)
        x = x + _dot(attn.reshape(x.shape), p["wo"])
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + _mlp(p, h)
        cache.k[i, :, :S] = k.to(cache.k.dtype)
        cache.v[i, :, :S] = v.to(cache.v.dtype)
    return _head_last(params, x[:, -1:]), cache


def decode_step(params, feature, cache: KVCache, pos, cfg: LLMConfig,
                cos, sin, compute_dtype=torch.bfloat16, pad=None):
    """One AR step. feature: (B, 1, D) embedding of the token at `pos` (a
    device tensor); cos/sin: (1, Dk/2) rope angles for `pos`, or
    (B, 1, Dk/2) per-row angles with `pad` (B,) for left-padded batches.
    The cache is updated in place. Returns (f32 logits, cache)."""
    x = feature.to(compute_dtype)
    for i, p in enumerate(params["blocks"]):
        x = block_decode(p, x, cos, sin, cache.k[i], cache.v[i], pos, cfg,
                         pad=pad)
    return _head_last(params, x), cache


def _head_last(params, x_last):
    """f32 LayerNorm + head on the last position (transformer.py:112-118)."""
    x = x_last[:, -1].float()
    x = layer_norm(x, params["ln_f"]["w"], params["ln_f"]["b"])
    return x @ params["head"].float()


def cast_blocks(params, dtype):
    """The block weights in `dtype`, cast once (what `w.to(x.dtype)` gives
    at every use); ln_f and head keep their dtype for the f32 head."""
    out = dict(params)
    out["blocks"] = [{k: v.to(dtype) for k, v in blk.items()}
                     for blk in params["blocks"]]
    return out


def _trunc_normal(gen, shape, dtype):
    """trunc_normal on [-2, 2] times sqrt(2 / fan_in)
    (transformer_blocks.py:81-84)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * math.sqrt(2 / shape[0])).to(dtype)


def init(gen: torch.Generator, cfg: LLMConfig, dtype=torch.float32):
    """Random parameters with the JAX init's tree, drawn from `gen` on its
    device."""
    D, M, V = cfg.hidden_size, cfg.mlp_hidden, cfg.vocab_size
    dev = gen.device
    ones = lambda n: torch.ones((n,), dtype=dtype, device=dev)
    tn = lambda *shape: _trunc_normal(gen, shape, dtype)
    blocks = []
    for _ in range(cfg.num_layers):
        blocks.append({
            "wqkv": tn(D, 3 * D),
            "wo": tn(D, D),
            "norm0": ones(D),
            "norm1": ones(D),
            "w1": tn(D, M),
            "w3": tn(D, M),
            "w2": tn(M, D),
        })
    head = (torch.randn((D, V), generator=gen, device=dev) * 0.02).to(dtype)
    return {
        "blocks": blocks,
        "ln_f": {"w": ones(D),
                 "b": torch.zeros((D,), dtype=dtype, device=dev)},
        "head": head,
    }
