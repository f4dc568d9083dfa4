"""PyTorch port: the deterministic request samplers (VPODE-DPM++2M,
Video-DDIM; JAX diffusion/samplers.py:293-387) and engine.sample_latents'
dispatch by SamplerConfig.name (JAX engine.py:210-221), held against the
JAX package.

Tolerances: 1e-5 with a closed-form denoiser (f32 elementwise work only);
through the tiny DiT in f32, 2e-4: the DiT's 1e-4 (test_torch_port_dit.py)
carried through four steps whose coefficients stay below 2. At 4 steps
the ODE sampler takes a second-order step, so the two samplers differ
(at 3 its only candidate step has alpha_prev = 0 and is DDIM's)."""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (assert_close, fast_compiles, randn,
                                 stage2_params)
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu import config as jcfg
from landiff_tpu.diffusion import engine as jeng
from landiff_tpu.diffusion import samplers as jsamp
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.diffusion import engine as teng
from landiff_tpu_torch.diffusion import samplers as tsamp
from landiff_tpu_torch.models import semantic_cond as tsc

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
T = torch.from_numpy
SAMPLERS = {"vpode_dpmpp2m": (jsamp.vpode_dpmpp2m_sample,
                              tsamp.vpode_dpmpp2m_sample),
            "video_ddim": (jsamp.video_ddim_sample,
                           tsamp.video_ddim_sample)}


def _denoisers(w):
    """One closed-form denoiser for both packages that reads the step's
    alpha, timestep and cfg scale; the port's has a cond_only twin."""
    def jden(x, step):
        return jnp.tanh(x * step["alpha"] + w) * step["cfg_scale"] \
            + step["timestep"] * 1e-3

    tw = T(w)

    def tden(x, step):
        return torch.tanh(x * step["alpha"] + tw) * step["cfg_scale"] \
            + step["timestep"] * 1e-3

    tden.cond_only = lambda x, step: torch.tanh(x - tw)
    return jden, tden


@pytest.mark.parametrize("fixed", [0, 1])
@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_matches_jax(name, fixed):
    x0 = randn(0, 1, 3, 4, 8, 12)
    jden, tden = _denoisers(randn(1, 1, 3, 4, 8, 12, scale=0.3))
    jfn, tfn = SAMPLERS[name]
    with fast_compiles():
        want = jfn(jden, jnp.asarray(x0), jcfg.SamplerConfig(num_steps=7),
                   fixed_frames=fixed)
    got = tfn(tden, T(x0), tcfg.SamplerConfig(num_steps=7),
              fixed_frames=fixed)
    assert_close(got, want, atol=1e-5, rtol=1e-5)
    if fixed:
        np.testing.assert_array_equal(got[:, :fixed].numpy(), x0[:, :fixed])


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_recovers_the_target(name):
    """A denoiser that always answers the target (test_aux.py:110): the
    last step returns it."""
    target = randn(2, 1, 2, 3, 4, 4)
    out = SAMPLERS[name][1](lambda x, step: T(target).expand(x.shape),
                            T(randn(3, *target.shape)),
                            tcfg.SamplerConfig(num_steps=8))
    assert_close(out, target, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("prefix", [False, True])
def test_sample_latents_through_the_tiny_dit_matches_jax(prefix):
    """engine.sample_latents with each deterministic sampler, 4 steps,
    through make_denoise_fn at the tiny config in f32, from the same
    initial latents; with a 1-frame clean prefix held as JAX holds it.
    JAX's closure gets the port's semantic feature (held to JAX's in
    test_torch_port_semantic.py)."""
    jparams, tparams = stage2_params()
    d = JC.dit
    ctx = randn(4, 1, d.text_length, d.text_dim)
    tok = TC.tokenizer
    codes = np.random.default_rng(5).integers(
        0, tok.vq.codebook_size, (1, tok.titok.latent_tokens))
    x0 = randn(6, 1, d.latent_frames, d.in_channels, d.latent_height,
               d.latent_width)
    pre = randn(7, 1, 1, d.in_channels, d.latent_height,
                d.latent_width) if prefix else None
    sem = tsc.semantic_feature_from_tokens(
        tparams["semantic"], T(codes), TC.tokenizer, TC.semantic_cond,
        forward_t=d.latent_frames, compute_dtype=torch.float32)
    jden, bundle = jeng.make_denoise_fn(
        jparams["main"], None, None, d, JC.sampler, JC.tokenizer,
        JC.semantic_cond, jnp.asarray(ctx), jnp.zeros_like(jnp.asarray(ctx)),
        None, compute_dtype=jnp.float32)
    bundle.update(control=jparams["control"],
                  sem_feature=jnp.asarray(sem.numpy()))
    tden = teng.make_denoise_fn(
        tparams["main"], tparams["control"], tparams["semantic"], TC.dit,
        TC.sampler, TC.tokenizer, TC.semantic_cond, T(ctx),
        torch.zeros(ctx.shape), T(codes), compute_dtype=torch.float32)
    outs = {}
    for name in sorted(SAMPLERS):
        jsc = dataclasses.replace(JC.sampler, name=name, num_steps=4)
        with fast_compiles():
            want = jeng.sample_latents(
                jden, jsc, d, key=jax.random.PRNGKey(0), bundle=bundle,
                init_noise=jnp.asarray(x0),
                prefix=None if pre is None else jnp.asarray(pre))
        got = teng.sample_latents(
            tden, dataclasses.replace(TC.sampler, name=name, num_steps=4),
            TC.dit, generator=torch.Generator().manual_seed(0),
            init_noise=T(x0), prefix=None if pre is None else T(pre))
        assert got.shape == x0.shape
        assert_close(got, np.asarray(want), atol=2e-4, rtol=2e-4)
        if prefix:
            np.testing.assert_array_equal(got[:, :1].numpy(), pre)
        outs[name] = got
    assert not torch.allclose(outs["vpode_dpmpp2m"], outs["video_ddim"])


def test_deterministic_samplers_drop_reuse_window_and_noise(monkeypatch,
                                                            caplog):
    """Under LANDIFF_FAST=2 (reuse every 2nd middle step, window [2, 44))
    a deterministic sampler calls the full denoiser at every step and
    never its cond_only twin, ignores step_noise and sdedit, and gives
    what it gives with the knobs unset, as JAX's does; a window from the
    environment without a cond_only twin is still dropped with the
    warning first (engine.py:188-198); an unknown name raises."""
    x0 = randn(8, 1, 3, 4, 8, 12)
    w = randn(9, 1, 3, 4, 8, 12, scale=0.3)
    jden, tden = _denoisers(w)
    calls = []

    def counted(x, step):
        calls.append(step["idx"])
        return tden(x, step)

    counted.cond_only = tden.cond_only
    d = dataclasses.replace(TC.dit, latent_frames=3, in_channels=4,
                            latent_height=8, latent_width=12)
    gen = lambda: torch.Generator().manual_seed(0)
    for name in sorted(SAMPLERS):
        sc = dataclasses.replace(TC.sampler, name=name, num_steps=8)
        monkeypatch.delenv("LANDIFF_FAST", raising=False)
        plain = teng.sample_latents(tden, sc, d, generator=gen(),
                                    init_noise=T(x0))
        monkeypatch.setenv("LANDIFF_FAST", "2")
        calls.clear()
        got = teng.sample_latents(
            counted, sc, d, generator=gen(), init_noise=T(x0), sdedit=True,
            step_noise=[torch.full(x0.shape, 9.0)] * 8)
        assert calls == list(range(8, 0, -1))      # step i has idx 8 - i
        assert torch.equal(got, plain)
        with fast_compiles():
            want = jeng.sample_latents(
                jden, dataclasses.replace(JC.sampler, name=name,
                                          num_steps=8),
                JC.dit, key=jax.random.PRNGKey(0), init_noise=jnp.asarray(x0))
        assert_close(got, want, atol=1e-5, rtol=1e-5)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="landiff_tpu_torch"):
            teng.sample_latents(lambda x, step: tden(x, step), sc, d,
                                generator=gen(), init_noise=T(x0))
        assert "LANDIFF_CFG_WINDOW ignored" in caplog.text
    with pytest.raises(ValueError, match="unknown sampler name"):
        teng.sample_latents(tden, dataclasses.replace(TC.sampler,
                                                      name="euler"),
                            d, generator=gen(), init_noise=T(x0))
