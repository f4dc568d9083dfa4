"""PyTorch port: the VAE decoder and the T5 encoder held against the JAX
package at the tiny config, f32 compute, params from
_torch_port_helpers.stage2_params (the port's init, zero leaves filled,
in the JAX layouts for JAX and through the bridge for the port). Tolerances: 1e-4 relative + 1e-4 absolute
for f32 work that sums in another order (matmuls, and the one conv3d
against JAX's per-frame 2-D taps)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port_helpers import assert_close, randn, stage2_params
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu import config as jcfg
from landiff_tpu.models import t5 as jt5
from landiff_tpu.models import vae as jvae
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.models import t5 as tt5
from landiff_tpu_torch.models import vae as tvae

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
T = torch.from_numpy


def test_vae_decode_streaming_matches_jax():
    """Five latent frames: chunks [0:3] and [3:5] with the conv cache
    carried between them."""
    jp, tp = (p["vae"]["decoder"] for p in stage2_params())
    z = randn(5, 1, JC.vae.z_channels, 5, 4, 6)
    want = jvae.decode_streaming(jp, jnp.asarray(z), JC.vae,
                                 compute_dtype=jnp.float32, first_chunk=3)
    got = tvae.decode_streaming(tp, T(z), TC.vae,
                                compute_dtype=torch.float32)
    assert got.shape == want.shape
    assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_t5_encode_matches_jax():
    jp, tp = (p["t5"] for p in stage2_params())
    ids = np.random.default_rng(6).integers(0, JC.t5.vocab_size, (2, 12))
    mask = np.ones((2, 12), bool)
    mask[1, 9:] = False
    enc = jax.jit(functools.partial(jt5.encode, cfg=JC.t5,
                                    compute_dtype=jnp.float32))

    for m in (None, mask):
        want = enc(jp, jnp.asarray(ids),
                   None if m is None else jnp.asarray(m))
        got = tt5.encode(tp, T(ids),
                         None if m is None else T(m), TC.t5,
                         compute_dtype=torch.float32)
        assert_close(got, want, atol=1e-4, rtol=1e-4)
