"""PyTorch port: the VPSDE-DPM++2M sampler against the JAX scan, with the
per-step SDE noise regenerated from the JAX key chain."""

import jax
import jax.numpy as jnp
import torch

from _torch_port_helpers import assert_close, randn, sampler_noises
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu import config as jcfg
from landiff_tpu.diffusion import samplers as jsamp
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.diffusion import samplers as tsamp

torch.set_num_threads(2)   # tier-1 runs six xdist workers


def test_vpsde_sampler_matches_jax():
    """A denoiser that depends on the step's alpha, timestep and cfg scale;
    the SDE noise as the JAX scan draws it (key -> split(key, 3) per
    step). Tolerance 1e-5: f32 elementwise work only."""
    x0 = randn(0, 1, 3, 4, 8, 12)
    w = randn(1, 1, 3, 4, 8, 12, scale=0.3)

    def jden(x, step):
        return jnp.tanh(x * step["alpha"] + w) * step["cfg_scale"] \
            + step["timestep"] * 1e-3

    def tden(x, step):
        return torch.tanh(x * step["alpha"] + torch.from_numpy(w)) \
            * step["cfg_scale"] + step["timestep"] * 1e-3

    cfg_j = jcfg.SamplerConfig(num_steps=6)
    key = jax.random.PRNGKey(11)
    want = jsamp.vpsde_dpmpp2m_sample(jden, jnp.asarray(x0), cfg_j, key=key)
    got = tsamp.vpsde_dpmpp2m_sample(
        tden, torch.from_numpy(x0), tcfg.SamplerConfig(num_steps=6),
        noises=sampler_noises(key, 6, x0.shape))
    assert_close(got, want, atol=1e-5, rtol=1e-5)
