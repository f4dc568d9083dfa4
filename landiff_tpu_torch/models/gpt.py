"""Stage-1 GPT backbone (counterpart of landiff_tpu/models/gpt.py):
Llama-style blocks (RMSNorm + SwiGLU with GELU-tanh) with fused wqkv, 1-D
RoPE, causal attention and a LayerNorm + Linear head.

Reference: landiff/llm/models/transformer.py (GPT),
landiff/llm/modules/transformer_blocks.py (LlamaTransformerBlock,
local_kvcache_inference).

`forward` is the training / packed forward over a whole sequence.
At inference `prefill` runs the prompt and fills the KV cache and
`decode_step` runs one token against it. The cache is preallocated on the
device and written IN PLACE (the JAX functions return new arrays); the
caller's loop keeps every index on the device. Blocks run in the compute
dtype, norms accumulate in f32, the inference head runs in f32 on the last
position. `quantize_int8` / `quantize_int4` make the weight-only
quantized block linears of the fast decode (LANDIFF_DECODE_INT8 / _INT4,
pipeline/llm_infer.py), which `_dot` reads.

Tensor parallel (`prefill` / `decode_step` at inference, `forward` in
training, with `tp=group`; parallel/mesh.GPT_RULES): a rank holds its
heads of wqkv (split per head inside each of q, k and v: a contiguous
column split would mix q and k heads; the trainer keeps it as (D, 3,
H_local, Dk)), the matching rows of wo, its columns of w1 / w3 and rows
of w2; one all-reduce after wo and one after w2, and the KV cache holds
the rank's heads. A head that divides (vocab % model == 0) is split by
columns and its logits gathered. The heads a rank holds are read off its
weights. Under a gradient the inputs of the column-parallel products
enter through mesh.copy_to (Megatron's f), the all-reduces are
mesh.reduce_from (g) and the logits' gather mesh.gather_from.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from landiff_tpu_torch.config import LLMConfig
from landiff_tpu_torch.ops import masks as masks_lib
from landiff_tpu_torch.ops.attention import attention, mha_reference
from landiff_tpu_torch.ops.norms import layer_norm, rms_norm
from landiff_tpu_torch.ops.rope import apply_rope
from landiff_tpu_torch.parallel.mesh import copy_to, gather_from, \
    reduce_from


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


class KVCache(NamedTuple):
    """Per-layer stacked KV cache: (L, B, S_max, H, Dk)."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: LLMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda", heads: int | None = None):
        shape = (cfg.num_layers, batch, max_len, heads or cfg.num_heads,
                 cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _dot(x, w):
    """x @ w for a plain weight or a weight-only quantized leaf (gpt.py:
    54-83), in x.dtype as JAX computes it.

    int8 leaf {"q": int8 (in, out), "s": (out,)}: (x @ q) * s.
    int4 leaf {"q4": int8 (in, out / 2), "s": (G, out)}: byte j of a row
    holds columns 2j (low nibble) and 2j + 1 (high), two's complement; the
    G groups of in / G rows are contracted apart, scaled, then summed.
    The codes are cast to x.dtype at every call (a fused dequantizing
    product is no TPU kernel and is left for later)."""
    if not isinstance(w, dict):
        return x @ w.to(x.dtype)
    if "q4" not in w:
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    p, s = w["q4"], w["s"]
    lo = (p << 4) >> 4                   # sign-extend the low nibble
    hi = p >> 4                          # arithmetic shift: the high one
    q = torch.stack((lo, hi), dim=-1).reshape(p.shape[0], -1)
    G, O = s.shape
    g = p.shape[0] // G
    xg = x.reshape(*x.shape[:-1], G, g)
    part = torch.einsum("...gi,gio->...go", xg,
                        q.reshape(G, g, O).to(x.dtype))
    return (part * s.to(x.dtype)).sum(-2)


def _qkv(p, x, cfg: LLMConfig):
    B, S, _ = x.shape
    w = p["wqkv"]
    if isinstance(w, torch.Tensor) and w.dim() == 4:   # (D, 3, H, Dk)
        w = w.flatten(1)
    q, k, v = _dot(x, w).chunk(3, dim=-1)
    shp = (B, S, -1, cfg.head_dim)
    return q.reshape(shp), k.reshape(shp), v.reshape(shp)


def _reduce(y, tp):
    return reduce_from(tp, y)


def _mlp(p, x, tp=None):
    x = copy_to(tp, x)
    return _reduce(
        _dot(gelu_tanh(_dot(x, p["w1"])) * _dot(x, p["w3"]), p["w2"]), tp)


def _logits(params, x, cfg: LLMConfig, tp=None):
    """x @ head; a head split by columns gathers its logits."""
    y = x @ params["head"].float()
    if tp is not None and y.shape[-1] != cfg.vocab_size:
        y = tp.all_gather(y, dim=-1)
    return y


def block_forward(p, x, cos, sin, cfg: LLMConfig, attn_impl="auto",
                  tp=None):
    """Full-sequence causal block. x: (B, S, D); cos/sin: (S, Dk/2); tp:
    this rank's model Group (its heads and MLP columns)."""
    B, S, _ = x.shape
    h = copy_to(tp, rms_norm(x, p["norm0"], cfg.norm_eps))
    q, k, v = _qkv(p, h, cfg)
    q, k = apply_rope(q, cos[None], sin[None]), apply_rope(k, cos[None],
                                                           sin[None])
    attn = attention(q, k, v, mask_fn=masks_lib.causal, impl=attn_impl)
    x = x + _reduce(_dot(attn.reshape(B, S, -1), p["wo"]), tp)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    return x + _mlp(p, h, tp)


def forward(params, features, cfg: LLMConfig, cos, sin, *, apply_head=True,
            attn_impl="auto", compute_dtype=torch.bfloat16, tp=None):
    """Training / packed forward. features: (B, S, D) embeddings; returns
    logits (B, S, V) in the compute dtype, or the normed stream. tp: the
    rank's model Group; a head split by columns gathers its logits."""
    x = features.to(compute_dtype)
    for p in params["blocks"]:
        x = block_forward(p, x, cos, sin, cfg, attn_impl, tp)
    x = layer_norm(x, params["ln_f"]["w"], params["ln_f"]["b"])
    if not apply_head:
        return x
    head = params["head"]
    if tp is None or head.shape[-1] == cfg.vocab_size:
        return x @ head.to(x.dtype)
    return gather_from(tp, copy_to(tp, x) @ head.to(x.dtype), -1)


def _bcast_rope(cos, sin):
    """cos/sin (S, Dk/2) -> (1, S, Dk/2); per-row (B, S, Dk/2) passes
    through (left-padded batched decode shifts rope positions per row)."""
    if cos.dim() == 2:
        return cos[None], sin[None]
    return cos, sin


def block_decode(p, x, cos, sin, k_cache, v_cache, pos, cfg: LLMConfig,
                 pad=None, tp=None):
    """Single-token step. x: (B, 1, D); k_cache / v_cache: (B, S_max, H,
    Dk), written in place at `pos`; pos: 0-d or (1,) int64 tensor on the
    device, the index of the current token; pad: optional (B,) left-pad
    lengths (cache slots < pad[b] are masked out). Returns x."""
    B = x.shape[0]
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
    x = x + _reduce(_dot(attn.reshape(B, 1, -1).to(x.dtype), p["wo"]), tp)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    return x + _mlp(p, h, tp)


def prefill(params, features, cache: KVCache, cfg: LLMConfig, cos, sin,
            compute_dtype=torch.bfloat16, pad=None, tp=None):
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
        x = x + _reduce(_dot(attn.reshape(*x.shape[:2], -1), p["wo"]), tp)
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + _mlp(p, h, tp)
        cache.k[i, :, :S] = k.to(cache.k.dtype)
        cache.v[i, :, :S] = v.to(cache.v.dtype)
    return _head_last(params, x[:, -1:], cfg, tp), cache


def decode_step(params, feature, cache: KVCache, pos, cfg: LLMConfig,
                cos, sin, compute_dtype=torch.bfloat16, pad=None, tp=None):
    """One AR step. feature: (B, 1, D) embedding of the token at `pos` (a
    device tensor); cos/sin: (1, Dk/2) rope angles for `pos`, or
    (B, 1, Dk/2) per-row angles with `pad` (B,) for left-padded batches.
    The cache is updated in place. Returns (f32 logits, cache)."""
    x = feature.to(compute_dtype)
    for i, p in enumerate(params["blocks"]):
        x = block_decode(p, x, cos, sin, cache.k[i], cache.v[i], pos, cfg,
                         pad=pad, tp=tp)
    return _head_last(params, x, cfg, tp), cache


def _head_last(params, x_last, cfg: LLMConfig, tp=None):
    """f32 LayerNorm + head on the last position (transformer.py:112-118)."""
    x = x_last[:, -1].float()
    x = layer_norm(x, params["ln_f"]["w"], params["ln_f"]["b"])
    return _logits(params, x, cfg, tp)


def cast_blocks(params, dtype):
    """The block weights in `dtype`, cast once (what `w.to(x.dtype)` gives
    at every use); quantized leaves stay as they are (`_dot` casts them);
    ln_f and head keep their dtype for the f32 head."""
    out = dict(params)
    out["blocks"] = [{k: v if isinstance(v, dict) else v.to(dtype)
                      for k, v in blk.items()}
                     for blk in params["blocks"]]
    return out


_QUANT_LEAVES = ("wqkv", "wo", "w1", "w2", "w3")


def _quantize_blocks(params, quant):
    out = dict(params)
    out["blocks"] = [{k: (quant(v) if k in _QUANT_LEAVES else v)
                      for k, v in blk.items()}
                     for blk in params["blocks"]]
    return out


def quantize_int8(params):
    """Weight-only int8 block linears (gpt.py:236-253): per-output-channel
    s = max(max|w| / 127, 1e-8) (a true division: JAX runs it eagerly,
    llm_infer.py:73), codes clip(round(w / s)), s stored in bf16. Norms,
    embeddings and the f32 head are untouched."""
    def quant(w):
        a = w.float()
        s = (a.abs().amax(0) / 127.0).clamp_min(1e-8)
        q = torch.clamp(torch.round(a / s), -127, 127).to(torch.int8)
        return {"q": q, "s": s.to(torch.bfloat16)}

    return _quantize_blocks(params, quant)


def quantize_int4(params, group: int = 128):
    """Weight-only int4 block linears (gpt.py:256-288): group-wise absmax
    scales over `group` input rows (all rows where `group` does not divide
    them), s = max(max|w| / 7, 1e-8) in bf16, codes in [-7, 7] packed two
    per byte, column 2j in the low nibble of byte j."""
    def quant(w):
        a = w.float()
        I, O = a.shape
        g = group if I % group == 0 else I
        ag = a.reshape(I // g, g, O)
        s = (ag.abs().amax(1) / 7.0).clamp_min(1e-8)
        q = torch.clamp(torch.round(ag / s[:, None, :]), -7, 7).reshape(
            I, O).to(torch.int8)
        packed = (q[:, 1::2] << 4) | (q[:, 0::2] & 0x0F)
        return {"q4": packed, "s": s.to(torch.bfloat16)}

    return _quantize_blocks(params, quant)


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
