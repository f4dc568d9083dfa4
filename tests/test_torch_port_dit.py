"""PyTorch port: the DiT (main + control branch) held against the JAX
package at the tiny config, params from
_torch_port_helpers.stage2_params (the port's init, zero leaves filled,
in the JAX layouts for JAX and through the bridge for the port). Tolerances: 1e-4 relative + 1e-4 absolute in f32, for work that
sums in another order."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import assert_close, randn, stage2_params
from landiff_tpu import config as jcfg
from landiff_tpu.models import dit as jdit
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.models import dit as tdit

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
T = torch.from_numpy


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dit_control_warp_forward_matches_jax(dtype):
    """bf16, the main path's compute dtype, takes the same op order on
    both sides; matmul sums still round differently: 8e-3 absolute, a
    few bf16 steps at the output's scale (about 0.5)."""
    jdt, tdt, tol = {"f32": (jnp.float32, torch.float32, 1e-4),
                     "bf16": (jnp.bfloat16, torch.bfloat16, 8e-3)}[dtype]
    jparams, tparams = stage2_params()
    d = JC.dit
    x = randn(0, 2, d.latent_frames, d.in_channels, d.latent_height,
              d.latent_width)
    sem = randn(1, *x.shape)
    ctx = randn(2, 2, d.text_length, d.text_dim)
    ts = np.array([999.0, 421.0], np.float32)
    fwd = jax.jit(functools.partial(jdit.control_warp_forward, cfg=d,
                                    compute_dtype=jdt))
    want = fwd(jparams["main"], jparams["control"], jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
               semantic_feature=jnp.asarray(sem))
    want = np.asarray(want.astype(jnp.float32))
    got = tdit.control_warp_forward(
        tparams["main"], tparams["control"], T(x), T(ts), T(ctx), TC.dit, T(sem),
        compute_dtype=tdt)
    assert got.shape == want.shape
    assert float(np.abs(want).max()) > 1e-2   # not vacuous
    assert_close(got, want, atol=tol, rtol=tol)
    np.testing.assert_array_equal(tdit.pos_embed_table(TC.dit),
                                  jdit.pos_embed_table(JC.dit))

