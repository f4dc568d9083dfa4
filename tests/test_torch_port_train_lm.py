"""PyTorch port: the stage-1 trainer (gpt.forward, lm_loss, lm_cond_loss,
make_cond_train_step) held against the JAX package at the tiny config in
f32. Both get the same parameters (zero leaves filled, learned null
embeddings added), the same batch and the same dropout masks, regenerated
from the JAX key chain (_torch_port_helpers.lm_cond_draws).

Tolerances: logits 1e-4 + 1e-4 relative (two layers of f32 work summed in
another order); losses 1e-5 relative; gradients 1e-4 of the leaf's
largest entry + 1e-5 relative + 1e-9; parameters after three updates
2e-5 absolute (Adam turns a relative gradient difference d into an update
difference of about lr * d, lr 1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (assert_close, fast_jit, lm_cond_draws,
                                 randn, train_lm_params)
from landiff_tpu import config as jcfg
from landiff_tpu.models import gpt as jgpt
from landiff_tpu.models import lm as jlm
from landiff_tpu.ops.rope import rope_1d_table as jrope_table
from landiff_tpu.training import lm_train as jlt
from landiff_tpu.training import train as jtrain
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.models import gpt as tgpt
from landiff_tpu_torch.models import lm as tlm
from landiff_tpu_torch.ops.rope import rope_1d_table as trope_table
from landiff_tpu_torch.training import lm_train as tlt
from landiff_tpu_torch.training import optim as toptim
from landiff_tpu_torch.training import train as ttrain
from landiff_tpu_torch.utils import tree_leaves, tree_map

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config().llm, tcfg.tiny_test_config().llm
T = torch.from_numpy
B, N_TEXT, T5_DIM = 2, 8, 32
MICRO = {"frames": TC.frames_per_segment, "motion_score": 0.1}
DROPS = {"frames": 0.5, "motion_score": 0.5}
LR, STEPS = 1e-3, 3


def _batch(step):
    sched = tlm.build_schedule(TC, 1 + 2 + N_TEXT + 1, TC.frames_per_segment)
    t5 = randn(400 + step, B, N_TEXT, T5_DIM)
    codes = np.random.default_rng(500 + step).integers(
        0, TC.codebook_size, (B, sched.num_visual), dtype=np.int32)
    return t5, codes


def _pairs(got, jwant):
    pairs = []
    tree_map(lambda t, w: pairs.append((t, np.asarray(w))), got, jwant)
    assert pairs
    return pairs


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_gpt_forward_matches_jax(impl):
    """The training forward, dense and through the flash route (JAX's
    Pallas kernel in interpret mode, the port's plain version), with and
    without the head."""
    jp, tp = train_lm_params()
    S = 40
    x = randn(1, B, S, TC.hidden_size)
    cos, sin = trope_table(TC.rope)
    jcos, jsin = jrope_table(JC.rope)
    for head in (True, False):
        want = jgpt.forward(jp["gpt"], jnp.asarray(x), JC,
                            jnp.asarray(jcos[:S]), jnp.asarray(jsin[:S]),
                            apply_head=head, attn_impl=impl,
                            compute_dtype=jnp.float32)
        got = tgpt.forward(tp["gpt"], T(x), TC, T(cos[:S]), T(sin[:S]),
                           apply_head=head, attn_impl=impl,
                           compute_dtype=torch.float32)
        assert got.shape == want.shape
        assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_lm_loss_on_an_assembled_row_matches_jax():
    jp, tp = train_lm_params()
    t5, codes = _batch(0)
    jtext = jlm.text_cond_features(jp, jnp.asarray(t5[0]), jnp.float32)
    jmic = jlm.micro_cond_features(jp, JC, MICRO, jnp.float32)
    jrow = jlt.build_training_batch(jp, JC, jtext, jmic, codes[0])
    ttext = tlm.text_cond_features(tp, T(t5[0]), torch.float32)
    tmic = tlm.micro_cond_features(tp, TC, MICRO, torch.float32)
    trow = tlt.build_training_batch(tp, TC, ttext, tmic, codes[0])
    assert_close(trow[0], jrow[0], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(trow[1].numpy(), np.asarray(jrow[1]))
    np.testing.assert_array_equal(trow[2].numpy(), np.asarray(jrow[2]))
    want = float(fast_jit(lambda p, *row: jlt.lm_loss(p, JC, *row), jp,
                          *jrow)(jp, *jrow))
    assert float(tlt.lm_loss(tp, TC, *trow)) == pytest.approx(want, rel=1e-5)
    # the plain step on assembled rows moves the parameters as JAX's does
    jopt, topt = jtrain.make_optimizer(LR, STEPS), ttrain.make_optimizer(LR, STEPS)
    jstep, tstep = jlt.make_train_step(jopt, JC), tlt.make_train_step(topt, TC)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    detached = tuple(t.detach() for t in trow)
    jstep = fast_jit(jstep, jp, jstate, *jrow)
    for _ in range(2):
        jp, jstate, jloss = jstep(jp, jstate, *jrow)
        tp, tstate, tloss = tstep(tp, tstate, *detached)
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    for t, w in _pairs(tp, jp):
        assert_close(t, w, atol=2e-5, rtol=0)


def test_lm_cond_loss_and_grads_match_jax():
    """Dropout on: the gradients reach the text projection, the micro
    MLPs, the token embedding and both kinds of null embedding."""
    jp, tp = train_lm_params(DROPS)
    t5, codes = _batch(0)
    # this key drops a text block and, per micro key, a sample
    key = jax.random.PRNGKey(29)
    draws = lm_cond_draws(key, B, TC.micro_cond_keys, DROPS)(0.5)
    assert not bool(draws.text.all()) and bool(draws.text.any())
    assert all(not bool(m.all()) for m in draws.micro.values())

    def jloss(p):
        return jlt.lm_cond_loss(p, JC, jnp.asarray(t5), jnp.asarray(codes),
                                MICRO, key=key, cfg_drop_prob=0.5,
                                micro_drop_probs=DROPS)

    want_loss, want = fast_jit(jax.value_and_grad(jloss), jp)(jp)
    params = toptim.require_grad(tp)
    loss = tlt.lm_cond_loss(params, TC, T(t5), T(codes), MICRO, rng=draws,
                            cfg_drop_prob=0.5, micro_drop_probs=DROPS)
    got = toptim.grad(loss, params)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    for g, w in _pairs(got, want):
        assert_close(g, w, atol=1e-4 * float(np.abs(w).max()) + 1e-9,
                     rtol=1e-5)
    for name in ("null_text_embedding", "tok_emb"):
        assert bool(got[name].any()), name
    for tree in (got["text_proj"], got["micro"], got["micro_null"]):
        assert all(bool(g.any()) for g in tree_leaves(tree))
    # eval: no rng, no dropout, on both sides
    want_eval = float(fast_jit(
        lambda p, t5, codes: jlt.lm_cond_loss(p, JC, t5, codes, MICRO),
        jp, jnp.asarray(t5), jnp.asarray(codes))(
            jp, jnp.asarray(t5), jnp.asarray(codes)))
    got_eval = float(tlt.lm_cond_loss(tp, TC, T(t5), T(codes), MICRO))
    assert got_eval == pytest.approx(want_eval, rel=1e-5)
    assert got_eval != pytest.approx(float(want_loss), rel=1e-4)


def test_three_cond_train_steps_match_jax():
    jp, tp = train_lm_params(DROPS)
    start = tp
    jopt, topt = jtrain.make_optimizer(LR, STEPS), ttrain.make_optimizer(LR, STEPS)
    jstep = jlt.make_cond_train_step(jopt, JC, MICRO, cfg_drop_prob=0.5,
                                     micro_drop_probs=DROPS)
    tstep = tlt.make_cond_train_step(topt, TC, MICRO, cfg_drop_prob=0.5,
                                     micro_drop_probs=DROPS)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for i in range(STEPS):
        t5, codes = _batch(i)
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        jargs = (jp, jstate, jnp.asarray(t5), jnp.asarray(codes), key)
        if i == 0:
            jstep = fast_jit(jstep, *jargs)
        jp, jstate, jloss = jstep(*jargs)
        draws = lm_cond_draws(key, B, TC.micro_cond_keys, DROPS)(0.5)
        tp, tstate, tloss = tstep(tp, tstate, T(t5), T(codes), draws)
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    for t, w in _pairs(tp, jp):
        assert_close(t, w, atol=2e-5, rtol=0)
    moved = [float((a - b).abs().max()) for a, b in
             zip(tree_leaves(tp), tree_leaves(start))]
    assert max(moved) > 1e-4


def test_dropouts_draw_from_a_generator():
    _, tp = train_lm_params(DROPS)
    gen = torch.Generator().manual_seed(0)
    text = torch.zeros(64, 3, TC.hidden_size)
    out = tlm.text_dropout(tp, text, gen, 0.5)
    dropped = (out != 0).any(-1).any(-1)
    assert 8 < int(dropped.sum()) < 56                  # about half
    null = tp["null_text_embedding"]
    assert torch.equal(out[dropped][0, 0], null)
    assert tlm.text_dropout(tp, text, gen, 0.0) is text
    mic = tlm.micro_cond_features_batch(tp, TC, MICRO, 64, drop_rng=gen,
                                        drop_probs=DROPS,
                                        compute_dtype=torch.float32)
    plain = tlm.micro_cond_features_batch(tp, TC, MICRO, 64,
                                          compute_dtype=torch.float32)
    assert mic.shape == plain.shape == (64, 2, TC.hidden_size)
    rows = (mic != plain).any(-1)
    assert 8 < int(rows[:, 0].sum()) < 56 and 8 < int(rows[:, 1].sum()) < 56
    single = tlm.micro_cond_features(tp, TC, MICRO, torch.float32)
    assert_close(plain[0], single.numpy(), atol=1e-6, rtol=1e-6)


def test_init_adds_micro_null_only_where_asked():
    gen = torch.Generator().manual_seed(0)
    base = tlm.init(gen, TC, t5_dim=T5_DIM)
    assert "micro_null" not in base
    tree = tlm.init(gen, TC, t5_dim=T5_DIM,
                    micro_drop_probs={"frames": 0.1, "motion_score": 0.0})
    assert list(tree["micro_null"]) == ["frames"]
    assert tree["micro_null"]["frames"].shape == (TC.micro_cond_embed_dim,)
    want = jax.eval_shape(lambda k: jlm.init(
        k, JC, t5_dim=T5_DIM, micro_drop_probs={"frames": 0.1}),
        jax.random.PRNGKey(0))
    assert (jax.tree_util.tree_structure(want)
            == jax.tree_util.tree_structure(
                jax.tree_util.tree_map(lambda t: 0, tree)))
