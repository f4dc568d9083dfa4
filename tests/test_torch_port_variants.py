"""PyTorch port: the variants inside ported modules held against the JAX
package: the DiT's ControlMLPAdapter (JAX dit.py:716, :743), the
standalone qk_layer_norm (JAX norms.py:78), the rope tables'
multiple=6 layout (JAX rope.py:104-112) and the LM's ground-truth
first-frame prompt (JAX lm.py:108, :259).

Tolerances: the adapter 1e-4 relative + absolute in f32 (linears summed
in another order, as test_torch_port_dit.py); qk_layer_norm 1e-6 (f32
statistics); the rope tables to the bit (the same host numpy); the
prompt 1e-5 (the conditioners' f32 products, as test_torch_port_lm.py)
and the gt rows to the bit (rows of the embedding table)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (assert_close, randn, stage1_params,
                                 to_jax_layout)
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu import config as jcfg
from landiff_tpu.models import dit as jdit
from landiff_tpu.models import lm as jlm
from landiff_tpu.ops import norms as jnorms
from landiff_tpu.ops import rope as jrope
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.models import dit as tdit
from landiff_tpu_torch.models import lm as tlm
from landiff_tpu_torch.ops import norms as tnorms
from landiff_tpu_torch.ops import rope as trope
from landiff_tpu_torch.utils import fill_zero_leaves

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
T = torch.from_numpy


def test_control_mlp_adapter_matches_jax():
    """The port's init (zero taps filled) in JAX's layouts for JAX; the
    taps against JAX's, and a fresh init's zero taps give zeros."""
    d = TC.dit
    gen = torch.Generator().manual_seed(3)
    fresh = tdit.init_mlp_adapter(gen, d)
    shapes = jax.eval_shape(lambda k: jdit.init_mlp_adapter(k, JC.dit),
                            jax.random.PRNGKey(0))
    jtree = to_jax_layout(fresh)
    assert jax.tree_util.tree_structure(shapes) == \
        jax.tree_util.tree_structure(jtree)
    for a, b in zip(jax.tree_util.tree_leaves(shapes),
                    jax.tree_util.tree_leaves(jtree)):
        assert a.shape == b.shape
    x = randn(0, 2, d.latent_frames, d.in_channels, d.latent_height,
              d.latent_width)
    ctx = randn(1, 2, d.text_length, d.text_dim)
    zero = tdit.control_mlp_adapter_forward(fresh, T(x), T(ctx), d,
                                            compute_dtype=torch.float32)
    assert len(zero) == d.control_layers
    assert all(not bool(o.any()) for o in zero)

    params = fill_zero_leaves(fresh, gen)
    want = jdit.control_mlp_adapter_forward(
        jax.tree_util.tree_map(jnp.asarray, to_jax_layout(params)),
        jnp.asarray(x), jnp.asarray(ctx), JC.dit, compute_dtype=jnp.float32)
    got = tdit.control_mlp_adapter_forward(params, T(x), T(ctx), d,
                                           compute_dtype=torch.float32)
    assert len(got) == len(want) == d.control_layers
    for g, w in zip(got, want):
        assert g.shape == (2, d.text_length + d.video_tokens, d.hidden_size)
        assert float(np.abs(np.asarray(w)).max()) > 1e-3
        assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("eps", [None, 1e-6])
def test_qk_layer_norm_matches_jax(eps):
    """Default eps 1e-5, not the DiT's own 1e-6."""
    q, k = randn(2, 2, 9, 4, 16, scale=3.0), randn(3, 2, 9, 4, 16)
    aff = [randn(4 + i, 16) for i in range(4)]
    kw = {} if eps is None else {"eps": eps}
    want = jnorms.qk_layer_norm(jnp.asarray(q), jnp.asarray(k),
                                *map(jnp.asarray, aff), **kw)
    got = tnorms.qk_layer_norm(T(q), T(k), *map(T, aff), **kw)
    for g, w in zip(got, want):
        assert_close(g, w, atol=1e-6, rtol=1e-6)
    if eps is None:
        other = tnorms.qk_layer_norm(T(q) * 1e-3, T(k), *map(T, aff),
                                     eps=1e-6)[0]
        assert not torch.allclose(
            tnorms.qk_layer_norm(T(q) * 1e-3, T(k), *map(T, aff))[0], other)


@pytest.mark.parametrize("dim", [48, 64])
def test_rope_multiple6_tables_equal_jax(dim):
    """Interleaved (t, h, w) triples over dim // 6 bands: (T, H, W,
    3 * (dim // 6)), 30 wide at dim 64 (not dim / 2 = 32), as JAX's."""
    kw = dict(dim=dim, max_time=3, max_height=4, max_width=5,
              one_dim_max_time=10, multiple=6)
    tc, jc = tcfg.Rope3DConfig(**kw), jcfg.Rope3DConfig(**kw)
    for tf, jf in ((trope.rope_3d_grid_table, jrope.rope_3d_grid_table),
                   (trope.rope_3d_text_table, jrope.rope_3d_text_table)):
        for a, b in zip(tf(tc), jf(jc)):
            np.testing.assert_array_equal(a, b)
    assert trope.rope_3d_grid_table(tc)[0].shape == (3, 4, 5, 3 * (dim // 6))
    idx = np.array([[0, 1, 2], [2, 2, 2], [7, 7, 7], [1, 3, 4]])
    for a, b in zip(trope.rope_3d_by_index(tc, idx),
                    jrope.rope_3d_by_index(jc, idx)):
        np.testing.assert_array_equal(a, b)


def test_rope_other_multiples_raise():
    kw = dict(dim=32, max_time=2, max_height=2, max_width=2,
              one_dim_max_time=4, multiple=8)
    with pytest.raises(ValueError, match="multiple must be 6 or 16"):
        trope.rope_3d_grid_table(tcfg.Rope3DConfig(**kw))
    with pytest.raises(ValueError, match="multiple must be 6 or 16"):
        jrope.rope_3d_grid_table(jcfg.Rope3DConfig(**kw))


def test_gt_iframe_prompt_matches_jax():
    jparams, tparams = stage1_params()
    jl, tl = jparams["lm"], tparams["lm"]
    values = {"frames": 3, "motion_score": 0.37}
    jm = jlm.micro_cond_features(jl, JC.llm, values, jnp.float32)
    tm = tlm.micro_cond_features(tl, TC.llm, values, torch.float32)
    text = randn(0, 6, TC.t5.d_model)
    jt = jlm.text_cond_features(jl, jnp.asarray(text), jnp.float32)
    tt = tlm.text_cond_features(tl, T(text), torch.float32)
    gt = np.random.default_rng(4).integers(0, TC.llm.codebook_size,
                                           TC.llm.iframe_len)
    want = jlm.assemble_prompt_with_gt_iframe(jl, JC.llm, jt, jm, gt,
                                              jnp.float32)
    got = tlm.assemble_prompt_with_gt_iframe(tl, TC.llm, tt, tm, gt,
                                             torch.float32)
    soi = 1 + 2 + 6
    assert got.shape == (soi + 1 + TC.llm.iframe_len + 2,
                         TC.llm.hidden_size)
    assert got.shape[0] == tlm.gt_first_frame_prefix_len(TC.llm, soi) == \
        jlm.gt_first_frame_prefix_len(JC.llm, soi)
    assert_close(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got[soi + 1:].numpy(),
                                  np.asarray(want)[soi + 1:])
    vocab = tlm.Vocab(TC.llm.codebook_size)
    assert torch.equal(got[-1], tl["tok_emb"][vocab.START_OF_PFRAME])
