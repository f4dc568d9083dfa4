"""PyTorch port: a prompt through both stages under LANDIFF_FAST=2, held
against the JAX package at the tiny config in f32 with the seams of
tests/test_torch_port_pipeline.py (the same parameters, the stage-1 draws
and the per-step SDE noise regenerated from the JAX key chains, the same
initial latents). The JAX wrappers compile with XLA's backend
optimizations off (_torch_port_helpers.fast_compiles).

LANDIFF_FAST=2 turns on W8A8 DiT linears, the weight-only int8 stage-1
decode, step reuse every 2nd middle step and the guidance window [2, 44).
At the tiny config's 4 steps reuse computes every step (3 head and 3 tail
steps) and the window makes steps 0 and 1 cond-only. Attention takes the
dense route below 2,048 positions; the kernel variants are held in
tests/test_torch_port_fast_attention.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port_helpers import (fast_compiles, gumbel_steps, randn,
                                 sampler_noises, stage1_params, stage2_params)
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu import config as jcfg
from landiff_tpu.pipeline import dif_infer as jdi
from landiff_tpu.pipeline import llm_infer as jli
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.diffusion import engine as teng
from landiff_tpu_torch.pipeline import dif_infer as tdi
from landiff_tpu_torch.pipeline import llm_infer as tli

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()


def test_fast_prompt_to_video_matches_jax(monkeypatch):
    """Identical stage-1 codes (on int8 weights); the video within one
    uint8 step and the latents within 1e-3 (a 4-step SDE over a W8A8 DiT
    in f32: sums in another order, as the default path's test); 4 model
    calls, the first two on the cond row alone."""
    for knob in ("LANDIFF_STEP_REUSE", "LANDIFF_CFG_WINDOW",
                 "LANDIFF_DIT_INT8", "LANDIFF_DECODE_INT8"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("LANDIFF_FAST", "2")
    seed, prompt = 5, "a red panda climbs a tree"
    j1, t1 = stage1_params()
    kw = dict(num_frames=TC.llm.frames_per_segment, seed=seed)
    jw = jli.ArModelInferWrapper(j1, JC.llm, JC.t5, jcfg.ARSampleConfig(**kw),
                                 compute_dtype=jnp.float32)
    tw = tli.ArModelInferWrapper(t1, TC.llm, TC.t5, tcfg.ARSampleConfig(**kw),
                                 compute_dtype=torch.float32, device="cpu")
    assert "q" in tw.params["lm"]["gpt"]["blocks"][0]["w1"]
    with fast_compiles():
        want = jw(jli.CodeTask("x.npy", prompt))
    steps = TC.llm.iframe_len + (kw["num_frames"] - 1) * TC.llm.pframe_len \
        + 2 * kw["num_frames"]
    got = tw(tli.CodeTask("x.npy", prompt),
             gumbel=gumbel_steps(seed, steps, TC.llm.vocab_size))
    np.testing.assert_array_equal(got.result, np.asarray(want.result))

    j2, t2 = stage2_params()
    d = TC.dit
    init = randn(3, 1, d.latent_frames, d.in_channels, d.latent_height,
                 d.latent_width)
    _, k_samp = jax.random.split(jax.random.PRNGKey(seed))
    step_noise = sampler_noises(k_samp, TC.sampler.num_steps, init.shape)
    with fast_compiles():
        jv = jdi.CogModelInferWrapper(j2, JC, compute_dtype=jnp.float32)(
            jdi.VideoTask("x", prompt, seed, semantic_token=want.result),
            init_noise=init)
    dif = tdi.CogModelInferWrapper(t2, TC, compute_dtype=torch.float32,
                                   device="cpu")
    assert "q" in dif.params["main"]["layers"][0]["qkv_w"]
    assert "q" in dif.params["control"]["layers"][0]["mlp1_w"]
    assert not isinstance(t2["main"]["layers"][0]["qkv_w"], dict)
    calls = []
    make = teng.make_denoise_fn

    def counted(*a, **k):
        fn = make(*a, **k)

        def full(x, step):
            calls.append(("full", x.shape[0]))
            return fn(x, step)

        def cond(x, step):
            calls.append(("cond", x.shape[0]))
            return fn.cond_only(x, step)

        full.cond_only = cond
        return full

    monkeypatch.setattr(teng, "make_denoise_fn", counted)
    tv = dif(tdi.VideoTask("x", prompt, seed, semantic_token=got.result),
             init_noise=init, step_noise=step_noise)
    assert calls == [("cond", 1), ("cond", 1), ("full", 1), ("full", 1)]
    np.testing.assert_allclose(tv.latent, jv.latent, atol=1e-3, rtol=1e-3)
    assert tv.result.shape == jv.result.shape
    apart = np.abs(np.round(tv.result * 255.0) - np.round(jv.result * 255.0))
    assert apart.max() <= 1.0
