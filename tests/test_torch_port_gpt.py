"""PyTorch port: the stage-1 GPT (models/gpt.py) and the ops it adds
(rms_norm, the 1-D rope table, the dense mask of mha_reference) held
against the JAX package at the tiny config in f32, parameters from
_torch_port_helpers.stage1_params. Tolerance 1e-4 relative + 1e-4
absolute: two layers of f32 work that sums in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import assert_close, randn, stage1_params
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu import config as jcfg
from landiff_tpu.models import gpt as jgpt
from landiff_tpu.ops import attention as jattn
from landiff_tpu.ops import norms as jnorms
from landiff_tpu.ops import rope as jrope
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.models import gpt as tgpt
from landiff_tpu_torch.ops import attention as tattn
from landiff_tpu_torch.ops import norms as tnorms
from landiff_tpu_torch.ops import rope as trope

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config().llm, tcfg.tiny_test_config().llm
T = torch.from_numpy


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_matches_jax(dtype):
    """bf16: the scale is cast before the multiply on both sides, so the
    results agree to the last bit but where the f32 mean of squares
    rounds differently: one bf16 step (2^-8 relative)."""
    x, w = randn(0, 3, 7, 64, scale=2.0), 1.0 + randn(1, 64, scale=0.1)
    jx, jw, tx, tw = jnp.asarray(x), jnp.asarray(w), T(x), T(w)
    if dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    want = jnorms.rms_norm(jx, jw, 1e-5)
    got = tnorms.rms_norm(tx, tw, 1e-5)
    assert got.dtype == tx.dtype
    tol = 1e-6 if dtype == "f32" else 2.0 ** -8
    assert_close(got, want.astype(jnp.float32), atol=tol, rtol=tol)


def test_rope_1d_table_and_per_row_apply_match_jax():
    cos, sin = trope.rope_1d_table(TC.rope)
    jcos, jsin = jrope.rope_1d_table(JC.rope)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)
    assert cos.shape == (TC.rope.max_len, TC.rope.dim // 2)
    assert cos.dtype == np.float32
    # the shapes the GPT passes: (1, S, Dk/2) and per-row (B, S, Dk/2)
    x = randn(2, 2, 5, TC.num_heads, TC.head_dim)
    pos = np.array([[0, 1, 2, 3, 4], [0, 0, 0, 1, 2]])
    for c, s in ((cos[None, :5], sin[None, :5]), (cos[pos], sin[pos])):
        want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(c),
                                jnp.asarray(s))
        got = trope.apply_rope(T(x), T(c), T(s))
        assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_mha_reference_dense_mask_matches_jax():
    """A (B, 1, S, S) mask as gpt.prefill builds it with pad, including
    rows that see nothing (-> 0)."""
    q, k, v = (randn(i, 2, 9, 3, 16) for i in range(3))
    pad = np.array([0, 4])
    qi, ki = np.arange(9)[:, None], np.arange(9)[None, :]
    mask = ((qi >= ki)[None] & (ki[None] >= pad[:, None, None]))[:, None]
    want = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), mask=jnp.asarray(mask))
    got = tattn.mha_reference(T(q), T(k), T(v), mask=T(mask))
    assert float(np.abs(np.asarray(want)[1, :4]).max()) == 0.0
    assert_close(got, want, atol=1e-5, rtol=1e-5)


def _run_jax(jp, feats, steps, pad, rope_idx):
    B, S, _ = feats.shape
    cos, sin = (jnp.asarray(t) for t in jrope.rope_1d_table(JC.rope))
    cache = jgpt.KVCache.create(JC, B, S + len(steps), jnp.float32)
    jpad = None if pad is None else jnp.asarray(pad)
    pre = (cos[:S], sin[:S]) if pad is None else \
        (cos[rope_idx[:, :S]], sin[rope_idx[:, :S]])
    logits, cache = jgpt.prefill(jp, jnp.asarray(feats), cache, JC, *pre,
                                 compute_dtype=jnp.float32, pad=jpad)
    out = [logits]
    for n, feat in enumerate(steps):
        i = S + n
        cs = (cos[i:i + 1], sin[i:i + 1]) if pad is None else \
            (cos[rope_idx[:, i:i + 1]], sin[rope_idx[:, i:i + 1]])
        logits, cache = jgpt.decode_step(jp, jnp.asarray(feat), cache, i, JC,
                                         *cs, compute_dtype=jnp.float32,
                                         pad=jpad)
        out.append(logits)
    return out, cache


def _run_port(tp, feats, steps, pad, rope_idx):
    B, S, _ = feats.shape
    cos, sin = (T(t) for t in trope.rope_1d_table(TC.rope))
    cache = tgpt.KVCache.create(TC, B, S + len(steps), torch.float32, "cpu")
    tpad = None if pad is None else T(pad)
    idx = None if pad is None else T(rope_idx)
    pre = (cos[:S], sin[:S]) if pad is None else \
        (cos[idx[:, :S]], sin[idx[:, :S]])
    logits, cache = tgpt.prefill(tp, T(feats), cache, TC, *pre,
                                 compute_dtype=torch.float32, pad=tpad)
    out = [logits]
    for n, feat in enumerate(steps):
        i = S + n
        cs = (cos[i:i + 1], sin[i:i + 1]) if pad is None else \
            (cos[idx[:, i:i + 1]], sin[idx[:, i:i + 1]])
        logits, cache = tgpt.decode_step(tp, T(feat), cache,
                                         torch.tensor([i]), TC, *cs,
                                         compute_dtype=torch.float32,
                                         pad=tpad)
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("with_pad", [False, True])
def test_prefill_and_decode_steps_match_jax(with_pad):
    """Logits of the prefill and of three decode steps, and the whole KV
    cache (written in place by the port, returned anew by JAX)."""
    jparams, tparams = stage1_params()
    B, S, n_steps = 2, 7, 3
    feats = randn(5, B, S, TC.hidden_size)
    steps = [randn(6 + n, B, 1, TC.hidden_size) for n in range(n_steps)]
    pad = rope_idx = None
    if with_pad:
        pad = np.array([0, 3])
        rope_idx = np.maximum(np.arange(S + n_steps)[None] - pad[:, None], 0)
    want, jcache = _run_jax(jparams["lm"]["gpt"], feats, steps, pad,
                            rope_idx)
    got, tcache = _run_port(tparams["lm"]["gpt"], feats, steps, pad,
                            rope_idx)
    assert got[0].shape == (B, TC.vocab_size) and got[0].dtype == torch.float32
    for g, w in zip(got, want):
        assert float(np.abs(np.asarray(w)).max()) > 1e-2
        assert_close(g, w, atol=1e-4, rtol=1e-4)
    assert_close(tcache.k, jcache.k, atol=1e-4, rtol=1e-4)
    assert_close(tcache.v, jcache.v, atol=1e-4, rtol=1e-4)


def test_cast_blocks_equals_cast_at_use():
    """The wrapper's one-time cast of the GPT blocks to bf16 gives the
    bits of the cast at use; ln_f and head stay f32."""
    _, tparams = stage1_params()
    p = tparams["lm"]["gpt"]
    cast = tgpt.cast_blocks(p, torch.bfloat16)
    assert cast["head"].dtype == torch.float32
    assert cast["ln_f"]["w"].dtype == torch.float32
    assert all(v.dtype == torch.bfloat16
               for blk in cast["blocks"] for v in blk.values())
    feats = T(randn(9, 2, 5, TC.hidden_size))
    cos, sin = (T(t)[:5] for t in trope.rope_1d_table(TC.rope))
    outs = []
    for params in (p, cast):
        cache = tgpt.KVCache.create(TC, 2, 5, torch.bfloat16, "cpu")
        outs.append(tgpt.prefill(params, feats, cache, TC, cos, sin)[0])
    assert torch.equal(outs[0], outs[1])


def test_quantized_leaves_are_refused():
    """The weight-only quantized leaves are no longer refused: `_dot`
    reads int8 {"q", "s"} and int4 {"q4", "s"} leaves (held against JAX in
    tests/test_torch_port_fast_quant.py)."""
    x = torch.ones(1, 4)
    q = torch.arange(16, dtype=torch.int8).reshape(4, 4) - 8
    s = torch.full((4,), 0.5, dtype=torch.bfloat16)
    assert torch.equal(tgpt._dot(x, {"q": q, "s": s}),
                       (x @ q.float()) * 0.5)
    q4 = tgpt.quantize_int4({"blocks": [{"wo": q.float()}]})["blocks"][0]
    assert set(q4["wo"]) == {"q4", "s"} and q4["wo"]["q4"].shape == (4, 2)
