"""PyTorch port: the semantic conditioner (VQ lookup, TiTok decoder,
upsampler) held against the JAX package at the tiny config, f32 compute,
params from
_torch_port_helpers.stage2_params (the port's init, zero leaves filled,
in the JAX layouts for JAX and through the bridge for the port). Tolerances: 1e-4
relative + 1e-4 absolute for f32 work that sums in another order."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port_helpers import assert_close, stage2_params
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu import config as jcfg
from landiff_tpu.models import semantic_cond as jsc
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.models import semantic_cond as tsc

torch.set_num_threads(2)   # tier-1 runs six xdist workers


JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
T = torch.from_numpy


def test_semantic_feature_from_tokens_matches_jax():
    """vq.index_to_feature -> titok.decode -> upsampler -> conv_out."""
    jp, tp = (p["semantic"] for p in stage2_params())
    ids = np.random.default_rng(3).integers(
        0, JC.tokenizer.vq.codebook_size,
        (1, JC.tokenizer.titok.latent_tokens))
    fwd = jax.jit(functools.partial(
        jsc.semantic_feature_from_tokens, tok_cfg=JC.tokenizer,
        cfg=JC.semantic_cond, forward_t=JC.dit.latent_frames,
        compute_dtype=jnp.float32))
    want = fwd(jp, jnp.asarray(ids))
    got = tsc.semantic_feature_from_tokens(
        tp, T(ids), TC.tokenizer, TC.semantic_cond,
        forward_t=TC.dit.latent_frames, compute_dtype=torch.float32)
    assert got.shape == want.shape == (1, 3, 4, 8, 12)
    assert float(np.abs(np.asarray(want)).max()) > 1e-3
    assert_close(got, want, atol=1e-4, rtol=1e-4)
