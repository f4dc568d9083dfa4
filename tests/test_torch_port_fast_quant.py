"""PyTorch port: the quantized weights of the fast serving configuration
held against the JAX package, each function called the way the JAX
pipeline calls it: the two weight quantizers eagerly (dif_infer.py:72,
llm_infer.py:73), the products under jax.jit.

  - DiT W8A8 (dit.py:169-220): codes and scales bit for bit, the int8
    product bit for bit, and a W8A8 control_warp_forward at the tiny
    config.
  - GPT weight-only int8 / int4 (gpt.py:54-83, :236-288): codes and bf16
    scales bit for bit (bridged from JAX and made by the port), `_dot`,
    and the stage-1 codes of the whole wrapper, which are identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (assert_close, fast_compiles, fast_jit,
                                 gumbel_steps, randn, stage1_params,
                                 stage2_params)
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu import config as jcfg
from landiff_tpu.models import dit as jdit
from landiff_tpu.models import gpt as jgpt
from landiff_tpu.pipeline import llm_infer as jli
from landiff_tpu_torch import bridge
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.models import dit as tdit
from landiff_tpu_torch.models import gpt as tgpt
from landiff_tpu_torch.pipeline import llm_infer as tli

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
T = torch.from_numpy


def _leaves_equal(port_leaf, jax_leaf):
    for key, want in jax_leaf.items():
        want = np.asarray(want)
        got = port_leaf[key]
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def test_dit_quantize_int8_and_w8a8_matmul_match_jax_exactly():
    """Codes and f32 scales of every quantized leaf of the tiny main DiT
    equal JAX's (eager), and its bridged tree is the port's own; the W8A8
    product of one leaf equals JAX's jitted one in f32 and in bf16, on
    activations with exact .5 ties. (Eager, `/ 127.0` is a true division;
    jitted, XLA makes it a product by f32(1/127): both are held here, and
    the two differ in the last bit of some scales.)"""
    jparams, tparams = stage2_params()
    jq = jdit.quantize_int8(jparams["main"])
    tq = tdit.quantize_int8(tparams["main"])
    bridged = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jq),
                              device="cpu")
    n = 0
    for jl, tl, bl in zip(jq["layers"], tq["layers"], bridged["layers"]):
        for name in tdit._INT8_LAYER_LEAVES:
            _leaves_equal(tl[name], jl[name])
            assert torch.equal(bl[name]["q"], tl[name]["q"])
            n += 1
    assert n == 4 * JC.dit.num_layers
    assert tq["layers"][0]["adaln_w"] is tparams["main"]["layers"][0][
        "adaln_w"]
    w = tq["layers"][0]["mlp0_w"]
    x = randn(4, 2, 37, w["q"].shape[0], scale=3.0)
    x[0, 0, :3] = [127.0, 0.5, -1.5]           # row absmax 127: halves
    jw = jq["layers"][0]["mlp0_w"]
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jx = jnp.asarray(x, jdt)
        want = jax.jit(jdit._w8a8_matmul)(jx, jw["q"], jw["s"])
        # XLA's backend optimizations off (fast_jit) keep the same
        # arithmetic: `/ 127.0` is a product by f32(1/127) either way
        np.testing.assert_array_equal(np.asarray(want), np.asarray(
            fast_jit(jdit._w8a8_matmul, jx, jw["q"], jw["s"])(
                jx, jw["q"], jw["s"])))
        got = tdit._w8a8_matmul(T(x).to(tdt), w["q"], w["s"])
        assert got.dtype == tdt
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_w8a8_control_warp_forward_matches_jax():
    """The tiny DiT with W8A8 main and control layers, f32. Tolerance
    2e-6 of the output's largest value (reading 3.8e-7; the same DiT on
    its f32 weights is 2.3e-5 away): the activations reach each product
    after f32 work summed in another order."""
    jparams, tparams = stage2_params()
    d = JC.dit
    jm, jc = (jdit.quantize_int8(jparams[k]) for k in ("main", "control"))
    tm, tc = (tdit.quantize_int8(tparams[k]) for k in ("main", "control"))
    x = randn(0, 2, d.latent_frames, d.in_channels, d.latent_height,
              d.latent_width)
    sem = randn(1, *x.shape)
    ctx = randn(2, 2, d.text_length, d.text_dim)
    ts = np.array([999.0, 421.0], np.float32)
    args = (jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
            jnp.asarray(sem))
    fwd = fast_jit(lambda m, c, x, t, ctx, s: jdit.control_warp_forward(
        m, c, x, t, ctx, d, s, compute_dtype=jnp.float32), jm, jc, *args)
    want = np.asarray(fwd(jm, jc, *args))
    got = tdit.control_warp_forward(tm, tc, T(x), T(ts), T(ctx), TC.dit,
                                    T(sem), compute_dtype=torch.float32)
    top = float(np.abs(want).max())
    assert top > 1e-2
    assert_close(got, want, atol=2e-6 * top, rtol=0)
    plain = tdit.control_warp_forward(tparams["main"], tparams["control"],
                                      T(x), T(ts), T(ctx), TC.dit, T(sem),
                                      compute_dtype=torch.float32)
    assert not torch.equal(got, plain)       # the int8 path really ran


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_gpt_quantized_leaves_and_dot_match_jax(kind):
    """The stage-1 GPT's block linears quantized by the port equal JAX's
    (eager) bit for bit, codes and bf16 scales, and bridge across
    unchanged; `_dot` of a bridged leaf equals JAX's jitted one to 1e-6
    relative in f32 (the int4 groups: 4 of 16 rows)."""
    jparams, tparams = stage1_params()
    jquant, tquant = {"int8": (jgpt.quantize_int8, tgpt.quantize_int8),
                      "int4": (jgpt.quantize_int4,
                               tgpt.quantize_int4)}[kind]
    jq, tq = jquant(jparams["lm"]["gpt"]), tquant(tparams["lm"]["gpt"])
    bridged = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jq),
                              device="cpu")
    for jb, tb, bb in zip(jq["blocks"], tq["blocks"], bridged["blocks"]):
        for name in tgpt._QUANT_LEAVES:
            _leaves_equal(tb[name], jb[name])
            _leaves_equal(bb[name], jb[name])
        assert torch.equal(tb["norm0"], tparams["lm"]["gpt"]["blocks"][0][
            "norm0"])
    w = randn(5, 64, 48, scale=0.2)
    x = randn(6, 3, 64)
    if kind == "int4":
        jl = jgpt.quantize_int4({"blocks": [{"wo": jnp.asarray(w)}]},
                                group=16)["blocks"][0]["wo"]
        tl = tgpt.quantize_int4({"blocks": [{"wo": T(w)}]},
                                group=16)["blocks"][0]["wo"]
        assert tl["s"].shape == (4, 48)
    else:
        jl = jgpt.quantize_int8({"blocks": [{"wo": jnp.asarray(w)}]}
                                )["blocks"][0]["wo"]
        tl = tgpt.quantize_int8({"blocks": [{"wo": T(w)}]})["blocks"][0]["wo"]
    _leaves_equal(tl, jl)
    want = jax.jit(jgpt._dot)(jnp.asarray(x), jl)
    got = tgpt._dot(T(x), bridge.to_torch(
        jax.tree_util.tree_map(np.asarray, jl), device="cpu"))
    assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_stage1_codes_on_quantized_weights_match_jax(kind, monkeypatch):
    """ArModelInferWrapper with LANDIFF_DECODE_INT8 (as LANDIFF_FAST=1
    sets it) or LANDIFF_DECODE_INT4, the same parameters and Gumbel
    draws: identical codes, and other codes than the f32 weights give."""
    knob = {"int8": "LANDIFF_DECODE_INT8", "int4": "LANDIFF_DECODE_INT4"}
    monkeypatch.setenv(knob[kind], "1")
    seed, prompt = 3, "a red panda climbs a tree"
    j1, t1 = stage1_params()
    kw = dict(num_frames=TC.llm.frames_per_segment, seed=seed)
    jw = jli.ArModelInferWrapper(j1, JC.llm, JC.t5, jcfg.ARSampleConfig(**kw),
                                 compute_dtype=jnp.float32)
    tw = tli.ArModelInferWrapper(t1, TC.llm, TC.t5, tcfg.ARSampleConfig(**kw),
                                 compute_dtype=torch.float32, device="cpu")
    leaf = tw.params["lm"]["gpt"]["blocks"][0]["wqkv"]
    assert isinstance(leaf, dict) and ("q4" if kind == "int4" else "q") \
        in leaf
    with fast_compiles():
        want = jw(jli.CodeTask("x.npy", prompt))
    steps = TC.llm.iframe_len + (kw["num_frames"] - 1) * TC.llm.pframe_len \
        + 2 * kw["num_frames"]
    noise = gumbel_steps(seed, steps, TC.llm.vocab_size)
    got = tw(tli.CodeTask("x.npy", prompt), gumbel=noise)
    np.testing.assert_array_equal(got.result, np.asarray(want.result))
    monkeypatch.delenv(knob[kind])
    plain = tli.ArModelInferWrapper(
        t1, TC.llm, TC.t5, tcfg.ARSampleConfig(**kw),
        compute_dtype=torch.float32, device="cpu")(
        tli.CodeTask("x.npy", prompt), gumbel=noise)
    assert not np.array_equal(plain.result, got.result)
