"""PyTorch port: long-video streaming (pipeline/long_video.py, the
sampler's sdedit branch, engine.update_bundle_tokens), mirroring
tests/test_long_video.py at the tiny config: two segments of latents, with
and without sdedit, against JAX's generate_long_video_latents fed the same
draws (the port is handed what the JAX key chain draws: per segment the
initial latents, per step the noise and the sdedit prefix draw); the
entry point's two-segment request and its shapes.

Tolerance: the latents within 1e-3 absolute + 1e-3 relative, as for one
segment (test_torch_port_pipeline.py: the two frameworks' f32 sums differ
in order through a 3-layer DiT); the prefix frames carried over exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import fast_compiles, fast_jit, randn, stage2_params
from landiff_tpu import config as jcfg
from landiff_tpu.pipeline import long_video as jlv
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.pipeline import infer_video
from landiff_tpu_torch.pipeline import long_video as tlv

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
PREFIX = 2          # of the tiny config's 3 latent frames
N_SEG = 2


def _shape():
    d = TC.dit
    return (1, d.latent_frames, d.in_channels, d.latent_height,
            d.latent_width)


def _jax_draws(key):
    """What generate_long_video_latents draws from `key`: per segment
    key, k_seg = split(key); k_noise, k_samp = split(k_seg); the initial
    latents normal(k_noise); per step (samplers.py:142) k, k_n, k_p =
    split(k, 3) from k_samp: the noise normal(k_n) and the sdedit prefix
    draw normal(k_p)."""
    shape, n = _shape(), TC.sampler.num_steps
    pshape = (1, PREFIX) + shape[2:]

    def draws(key):
        out = []
        for _ in range(N_SEG):
            key, k_seg = jax.random.split(key)
            k_noise, k = jax.random.split(k_seg)
            steps, prefix = [], []
            for _ in range(n):
                k, k_n, k_p = jax.random.split(k, 3)
                steps.append(jax.random.normal(k_n, shape, jnp.float32))
                prefix.append(jax.random.normal(k_p, pshape, jnp.float32))
            out.append({"init": jax.random.normal(k_noise, shape,
                                                  jnp.float32),
                        "steps": steps, "prefix": prefix})
        return out

    got = fast_jit(draws, key)(key)
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  got)


@pytest.mark.parametrize("sdedit", [False, True])
def test_two_segment_latents_match_jax(sdedit):
    jparams, tparams = stage2_params()
    codes = np.random.default_rng(4).integers(
        0, TC.tokenizer.vq.codebook_size,
        N_SEG * TC.tokenizer.titok.latent_tokens)
    ctx = randn(5, 1, TC.dit.text_length, TC.dit.text_dim)
    key = jax.random.PRNGKey(6)
    with fast_compiles():
        want = np.asarray(jlv.generate_long_video_latents(
            jparams, JC, jnp.asarray(ctx), jnp.zeros(ctx.shape), codes,
            key=key, prefix_latents=PREFIX, sdedit=sdedit,
            compute_dtype=jnp.float32))
    ctx_t = torch.from_numpy(ctx)
    got = tlv.generate_long_video_latents(
        tparams, TC, ctx_t, torch.zeros_like(ctx_t), codes,
        generator=torch.Generator().manual_seed(0), prefix_latents=PREFIX,
        sdedit=sdedit, compute_dtype=torch.float32, noises=_jax_draws(key))
    lat = TC.dit.latent_frames
    assert got.shape == want.shape == (1, lat + lat - PREFIX) + _shape()[2:]
    assert float(np.abs(want).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)
    # the second segment's prefix is the first segment's tail, exactly
    first = tlv.generate_long_video_latents(
        tparams, TC, ctx_t, torch.zeros_like(ctx_t),
        codes[:TC.tokenizer.titok.latent_tokens],
        generator=torch.Generator().manual_seed(0), prefix_latents=PREFIX,
        compute_dtype=torch.float32, noises=_jax_draws(key)[:1])
    assert torch.equal(got[:, :lat], first)


def test_entry_point_generates_two_segments():
    """generate on a prompt of two segments (num_frames = 2 segments):
    2 x latent_tokens codes, 3 + (3 - 2) latent frames, the streaming
    decode's frames (one chunk of 3 latents, then one of 1), in [0, 1]."""
    _, tparams = stage2_params()
    from _torch_port_helpers import stage1_params
    from landiff_tpu_torch.pipeline import dif_infer, llm_infer

    _, t1 = stage1_params()
    sample = tcfg.ARSampleConfig(
        seed=1, num_frames=N_SEG * TC.llm.frames_per_segment)
    llm = llm_infer.ArModelInferWrapper(t1, TC.llm, TC.t5, sample,
                                        compute_dtype=torch.float32,
                                        device="cpu")
    dif = dif_infer.CogModelInferWrapper(tparams, TC,
                                         compute_dtype=torch.float32,
                                         device="cpu")
    res = infer_video.generate(llm, dif, "a red panda", seed=3)
    lat = TC.dit.latent_frames + TC.dit.latent_frames - PREFIX
    assert res["codes"].shape == (N_SEG * TC.tokenizer.titok.latent_tokens,)
    assert res["latent"].shape == (1, lat) + _shape()[2:]
    assert res["video"].shape == (1, 3, 6, 16, 24)
    assert np.isfinite(res["video"]).all()
    assert res["video"].min() >= 0.0 and res["video"].max() <= 1.0
    assert set(res["stage2_phases"]) == {"t5", "segment_0", "segment_1",
                                         "vae"}
