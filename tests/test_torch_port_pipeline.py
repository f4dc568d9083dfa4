"""PyTorch port: the whole stage-2 wrapper (prompt + semantic tokens ->
video), and a prompt through both stages (prompt -> codes -> video), held
against the JAX package at the tiny config in f32, with the same initial
latents, and the stage-1 draws and the per-step SDE noise regenerated from
the JAX key chains. Both tests call the JAX stage 2 at the same shapes,
so it compiles once."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port_helpers import (gumbel_steps, randn, sampler_noises,
                                 stage1_params, stage2_params)
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu import config as jcfg
from landiff_tpu.pipeline import dif_infer as jdi
from landiff_tpu.pipeline import llm_infer as jli
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.pipeline import dif_infer as tdi
from landiff_tpu_torch.pipeline import llm_infer as tli

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()


def test_stage2_wrapper_matches_jax():
    """CogModelInferWrapper end to end on the same weights
    (_torch_port_helpers.stage2_params). Latents to 1e-3 (a 4-step SDE
    over a 3-layer DiT in f32: the two frameworks' sums differ in order),
    video within one uint8 step."""
    jparams, tparams = stage2_params()
    codes = np.random.default_rng(2).integers(
        0, TC.tokenizer.vq.codebook_size, TC.tokenizer.titok.latent_tokens)
    d = TC.dit
    noise = randn(3, 1, d.latent_frames, d.in_channels, d.latent_height,
                  d.latent_width)
    seed = 5
    # the JAX wrapper: PRNGKey(seed) -> split -> (k_noise, k_samp); the
    # sampler's carry key is k_samp (engine.py:199)
    _, k_samp = jax.random.split(jax.random.PRNGKey(seed))
    steps = sampler_noises(k_samp, TC.sampler.num_steps, noise.shape)

    jw = jdi.CogModelInferWrapper(jparams, JC, compute_dtype=jnp.float32)
    want = jw(jdi.VideoTask("x", "a red panda", seed,
                            semantic_token=codes), init_noise=noise)
    tw = tdi.CogModelInferWrapper(tparams, TC, compute_dtype=torch.float32,
                                  device="cpu")

    got = tw(tdi.VideoTask("x", "a red panda", seed, semantic_token=codes),
             init_noise=noise, step_noise=steps)

    assert got.latent.shape == want.latent.shape
    assert float(np.abs(want.latent).max()) > 1e-2
    np.testing.assert_allclose(got.latent, want.latent, atol=1e-3,
                               rtol=1e-3)
    assert got.result.shape == want.result.shape
    steps_apart = np.abs(np.round(got.result * 255.0)
                         - np.round(want.result * 255.0))
    assert steps_apart.max() <= 1.0
    assert set(tw.phase_seconds) == {"t5", "semantic", "denoise", "vae"}


def test_prompt_to_video_matches_jax():
    """Stage 1 on the same parameters (_torch_port_helpers.stage1_params)
    and the same draws: identical codes. Stage 2 on those codes: video
    within one uint8 step (the bar of tests/test_reference_oracle_e2e.py)."""
    seed, prompt = 5, "a red panda climbs a tree"
    j1, t1 = stage1_params()
    kw = dict(num_frames=TC.llm.frames_per_segment, seed=seed)
    jw = jli.ArModelInferWrapper(j1, JC.llm, JC.t5, jcfg.ARSampleConfig(**kw),
                                 compute_dtype=jnp.float32)
    tw = tli.ArModelInferWrapper(t1, TC.llm, TC.t5, tcfg.ARSampleConfig(**kw),
                                 compute_dtype=torch.float32, device="cpu")
    want = jw(jli.CodeTask("x.npy", prompt))
    steps = TC.llm.iframe_len + (kw["num_frames"] - 1) * TC.llm.pframe_len \
        + 2 * kw["num_frames"]
    noise = gumbel_steps(seed, steps, TC.llm.vocab_size)
    got = tw(tli.CodeTask("x.npy", prompt), gumbel=noise)
    assert got.result.dtype == np.int32
    assert len(got.result) == TC.tokenizer.titok.latent_tokens
    np.testing.assert_array_equal(got.result, np.asarray(want.result))
    # the text reaches the codes: another prompt, other codes
    other = tw(tli.CodeTask("y.npy", "a blue whale"), gumbel=noise)
    assert not np.array_equal(other.result, got.result)

    j2, t2 = stage2_params()
    d = TC.dit
    init = randn(3, 1, d.latent_frames, d.in_channels, d.latent_height,
                 d.latent_width)
    _, k_samp = jax.random.split(jax.random.PRNGKey(seed))
    step_noise = sampler_noises(k_samp, TC.sampler.num_steps, init.shape)
    jv = jdi.CogModelInferWrapper(j2, JC, compute_dtype=jnp.float32)(
        jdi.VideoTask("x", prompt, seed, semantic_token=want.result),
        init_noise=init)
    tv = tdi.CogModelInferWrapper(t2, TC, compute_dtype=torch.float32,
                                  device="cpu")(
        tdi.VideoTask("x", prompt, seed, semantic_token=got.result),
        init_noise=init, step_noise=step_noise)
    assert tv.result.shape == jv.result.shape
    apart = np.abs(np.round(tv.result * 255.0) - np.round(jv.result * 255.0))
    assert apart.max() <= 1.0
