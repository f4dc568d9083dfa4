"""PyTorch port: the whole stage-2 wrapper (prompt + semantic tokens ->
video) held against the JAX package at the tiny config in f32, with the
same initial latents and the per-step SDE noise regenerated from the JAX
key chain."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port_helpers import randn, sampler_noises, stage2_params
from landiff_tpu import config as jcfg
from landiff_tpu.pipeline import dif_infer as jdi
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.pipeline import dif_infer as tdi

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
