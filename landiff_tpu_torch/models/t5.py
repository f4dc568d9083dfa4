"""T5 encoder, Flan-T5-XXL class (counterpart of
landiff_tpu/models/t5.py; HF T5EncoderModel semantics):

  - T5LayerNorm: RMS (no mean subtraction), weight only, fp32 stats
  - self-attention WITHOUT 1/sqrt(d) scaling; additive relative position
    bias from a bucketed embedding on layer 0, shared by all layers
  - gated-act FF (wi_0 gelu-new gate * wi_1, then wo)

Parameters: {"embed": (V, D), "blocks": [{"attn": {"q","k","v","o"},
"ln0", "rel_bias" (layer 0), "ff": {"wi_0","wi_1","wo"}, "ln1"}, ...],
"final_ln": (D,)}, weight matrices (in, out).

Tensor parallel (`encode(..., tp=group)`, parallel/mesh.T5_RULES as JAX
llm_infer.py:87-90 and dif_infer.py:73-83 apply them): q / k / v / wi_0 /
wi_1 column-parallel, o / wo row-parallel, so each rank runs its own
heads and its part of the feed-forward, and one all-reduce closes each
pair. The relative-position bias is sliced to the rank's heads (GSPMD
does that unseen in JAX). The heads a rank holds are read off its q.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from landiff_tpu_torch.config import T5Config


def t5_layer_norm(x, weight, eps=1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def gelu_new(x):
    """HF 'gelu_new' (tanh approximation) used by flan-t5."""
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3.0))))


def relative_position_bucket(relative_position, num_buckets=32,
                             max_distance=128):
    """Bidirectional bucketing (HF T5Attention._relative_position_bucket)."""
    num_buckets //= 2
    ret = torch.where(relative_position > 0, num_buckets, 0)
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact)
        / np.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def compute_position_bias(rel_bias_table, q_len, kv_len, cfg: T5Config):
    """(1, heads, q_len, kv_len) additive bias."""
    dev = rel_bias_table.device
    ctx = torch.arange(q_len, device=dev)[:, None]
    mem = torch.arange(kv_len, device=dev)[None, :]
    buckets = relative_position_bucket(mem - ctx,
                                       cfg.relative_attention_num_buckets,
                                       cfg.relative_attention_max_distance)
    return rel_bias_table[buckets].permute(2, 0, 1)[None]


def _attn(x, p, position_bias, attn_mask, cfg: T5Config, tp=None):
    B, S, _ = x.shape
    Dk = cfg.d_kv
    H = p["q"].shape[1] // Dk
    q = (x @ p["q"].to(x.dtype)).reshape(B, S, H, Dk)
    k = (x @ p["k"].to(x.dtype)).reshape(B, S, H, Dk)
    v = (x @ p["v"].to(x.dtype)).reshape(B, S, H, Dk)
    # T5 does not scale by 1/sqrt(d_kv)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s + position_bias.float()
    if attn_mask is not None:
        s = torch.where(attn_mask[:, None, None, :], s, -1e30)
    p_attn = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p_attn, v)
    out = out.reshape(B, S, H * Dk) @ p["o"].to(x.dtype)
    return out if tp is None else tp.all_reduce(out)


def _ff(x, p, tp=None):
    h = gelu_new(x @ p["wi_0"].to(x.dtype)) * (x @ p["wi_1"].to(x.dtype))
    out = h @ p["wo"].to(x.dtype)
    return out if tp is None else tp.all_reduce(out)


def encode(params, input_ids, attn_mask, cfg: T5Config,
           compute_dtype=torch.bfloat16, tp=None):
    """T5 encoder forward: input_ids (B, S) -> (B, S, d_model) in
    compute_dtype. attn_mask: (B, S) bool (True = valid) or None.
    Out-of-range ids clamp to the table, as a JAX gather does. tp: the
    mesh.Group of the `model` ranks when params hold this rank's part
    (T5_RULES); two all-reduces a block."""
    embed = params["embed"]
    ids = input_ids.to(embed.device).long().clamp(0, embed.shape[0] - 1)
    x = embed[ids].to(compute_dtype)
    S = ids.shape[1]
    pos_bias = compute_position_bias(params["blocks"][0]["rel_bias"], S, S,
                                     cfg)
    if tp is not None:
        hl = cfg.num_heads // tp.size
        pos_bias = pos_bias[:, tp.rank * hl:(tp.rank + 1) * hl]
    for blk in params["blocks"]:
        h = t5_layer_norm(x, blk["ln0"], cfg.layer_norm_eps)
        x = x + _attn(h, blk["attn"], pos_bias, attn_mask, cfg, tp)
        h = t5_layer_norm(x, blk["ln1"], cfg.layer_norm_eps)
        x = x + _ff(h, blk["ff"], tp)
    return t5_layer_norm(x, params["final_ln"], cfg.layer_norm_eps)


def cast_matmul_weights(params, dtype):
    """The embedding and the attention / feed-forward matrices in `dtype`,
    cast once: what `encode` casts at every use, so its result in that
    compute dtype is unchanged. The norm weights and the relative-bias
    table, which `encode` reads in f32, keep their dtype."""
    blocks = []
    for blk in params["blocks"]:
        new = dict(blk)
        new["attn"] = {k: v.to(dtype) for k, v in blk["attn"].items()}
        new["ff"] = {k: v.to(dtype) for k, v in blk["ff"].items()}
        blocks.append(new)
    return {**params, "embed": params["embed"].to(dtype), "blocks": blocks}


def init(gen: torch.Generator, cfg: T5Config, dtype=torch.float32):
    """Random init with T5 scaling (real use loads HF weights)."""
    D, Fd, H, Dk = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.d_kv
    inner = H * Dk
    nrm = lambda s, std: (torch.randn(s, generator=gen, device=gen.device)
                          * std).to(dtype)
    o = lambda n: torch.ones((n,), dtype=dtype, device=gen.device)
    blocks = []
    for i in range(cfg.num_layers):
        blk = {
            "attn": {"q": nrm((D, inner), (D * Dk) ** -0.5),
                     "k": nrm((D, inner), D ** -0.5),
                     "v": nrm((D, inner), D ** -0.5),
                     "o": nrm((inner, D), inner ** -0.5)},
            "ln0": o(D),
            "ff": {"wi_0": nrm((D, Fd), D ** -0.5),
                   "wi_1": nrm((D, Fd), D ** -0.5),
                   "wo": nrm((Fd, D), Fd ** -0.5)},
            "ln1": o(D),
        }
        if i == 0:
            blk["rel_bias"] = nrm((cfg.relative_attention_num_buckets, H),
                                  D ** -0.5)
        blocks.append(blk)
    return {"embed": nrm((cfg.vocab_size, D), 1.0), "blocks": blocks,
            "final_ln": o(D)}


def params_from_hf_state_dict(sd, cfg: T5Config, dtype=torch.float32,
                              device="cpu"):
    """A HF T5EncoderModel state_dict (numpy arrays) -> the parameter tree
    above, tensors on `device` in `dtype` (JAX t5.py:151).

    Accepts keys with or without the leading 'encoder.' prefix; linear
    weights are transposed torch (out,in) -> (in,out)."""

    def get(name):
        for k in (name, "encoder." + name):
            if k in sd:
                return np.asarray(sd[k])
        raise KeyError(name)

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    t = lambda name: tensor(get(name).T)
    vec = lambda name: tensor(get(name))

    blocks = []
    for i in range(cfg.num_layers):
        pre = f"block.{i}.layer."
        blk = {
            "attn": {c: t(pre + f"0.SelfAttention.{c}.weight")
                     for c in ("q", "k", "v", "o")},
            "ln0": vec(pre + "0.layer_norm.weight"),
            "ff": {
                "wi_0": t(pre + "1.DenseReluDense.wi_0.weight"),
                "wi_1": t(pre + "1.DenseReluDense.wi_1.weight"),
                "wo": t(pre + "1.DenseReluDense.wo.weight"),
            },
            "ln1": vec(pre + "1.layer_norm.weight"),
        }
        if i == 0:
            blk["rel_bias"] = vec("block.0.layer.0.SelfAttention."
                                  "relative_attention_bias.weight")
        blocks.append(blk)
    try:
        embed = get("shared.weight")
    except KeyError:
        embed = get("embed_tokens.weight")
    return {
        "embed": tensor(embed),
        "blocks": blocks,
        "final_ln": vec("final_layer_norm.weight"),
    }
