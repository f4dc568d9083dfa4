"""PyTorch port: the stage-1 LM (models/lm.py) held against the JAX
package at the tiny config in f32: the structural schedule, the
conditioners, the sampling filters, and the constrained sampler with the
Gumbel noise of the JAX key chain injected (_torch_port_helpers.
gumbel_steps), so that the codes must be IDENTICAL. A flipped code and a
wrong model are told apart by the teacher-forced logits, compared with a
tolerance (1e-4: two f32 layers summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_port_helpers import (assert_close, gumbel_steps, randn,
                                 stage1_params)
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu import config as jcfg
from landiff_tpu import utils as jutils
from landiff_tpu.models import gpt as jgpt
from landiff_tpu.models import lm as jlm
from landiff_tpu.ops import rope as jrope
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch import utils as tutils
from landiff_tpu_torch.models import gpt as tgpt
from landiff_tpu_torch.models import lm as tlm
from landiff_tpu_torch.ops import rope as trope

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
T = torch.from_numpy
F32 = dict(compute_dtype=torch.float32, cache_dtype=torch.float32)
JF32 = dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32)


# ---------------------------------------------------------------------------
# schedule, vocab


@pytest.mark.parametrize("which", ["tiny", "full"])
@pytest.mark.parametrize("prefix_len,frames,soi", [
    (5, 1, None), (12, 3, None), (9, 6, None), (20, 7, None),
    (40, 13, None), (17, 26, None), (30, 6, 20)])
def test_build_schedule_matches_jax(which, prefix_len, frames, soi):
    jc, tc = ((JC.llm, TC.llm) if which == "tiny"
              else (jcfg.LLMConfig(), tcfg.LLMConfig()))
    want = jlm.build_schedule(jc, prefix_len, frames, soi_index=soi)
    got = tlm.build_schedule(tc, prefix_len, frames, soi_index=soi)
    assert (got.prefix_len, got.full_len, got.num_visual) == \
        (want.prefix_len, want.full_len, want.num_visual)
    for name in ("forced", "visual", "allow_eos"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
        assert getattr(got, name).dtype == getattr(want, name).dtype
    assert tlm.video_frames_to_code_len(tc, frames) == \
        jlm.video_frames_to_code_len(jc, frames)


def test_full_schedule_gives_1218_codes_and_vocab_matches():
    sched = tlm.build_schedule(tcfg.LLMConfig(), 30, 13)
    assert sched.num_visual == 1218
    jv, tv = jlm.Vocab(2048), tlm.Vocab(2048)
    for name in ("EOS", "BOS", "START_OF_IFRAME", "END_OF_IFRAME",
                 "START_OF_PFRAME", "END_OF_PFRAME", "PAD", "size"):
        assert getattr(jv, name) == getattr(tv, name)


# ---------------------------------------------------------------------------
# conditioners


def test_conditioners_and_prompt_match_jax():
    jparams, tparams = stage1_params()
    jl, tl = jparams["lm"], tparams["lm"]
    values = {"frames": 3, "motion_score": 0.37}
    jm = jlm.micro_cond_features(jl, JC.llm, values, jnp.float32)
    tm = tlm.micro_cond_features(tl, TC.llm, values, torch.float32)
    assert tm.shape == (2, TC.llm.hidden_size)
    # the zero-init output linear is filled: the features depend on values
    other = tlm.micro_cond_features(tl, TC.llm, {"frames": 3,
                                                 "motion_score": 0.9},
                                    torch.float32)
    assert float((other - tm).abs().max()) > 1e-4
    assert_close(tm, jm, atol=1e-5, rtol=1e-5)
    text = randn(0, 6, TC.t5.d_model)
    jt = jlm.text_cond_features(jl, jnp.asarray(text), jnp.float32)
    tt = tlm.text_cond_features(tl, T(text), torch.float32)
    assert_close(tt, jt, atol=1e-5, rtol=1e-5)
    jn = jlm.null_text_features(jl, 6, jnp.float32)
    tn = tlm.null_text_features(tl, 6, torch.float32)
    assert_close(tn, jn, atol=0, rtol=0)
    jp = jlm.assemble_prompt(jl, JC.llm, jt, jm, jnp.float32)
    tp = tlm.assemble_prompt(tl, TC.llm, tt, tm, torch.float32)
    assert tp.shape == (1 + 2 + 6 + 1, TC.llm.hidden_size)
    assert_close(tp, jp, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# filters


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 10_000), k=st.integers(0, 16),
       top_p=st.floats(0.05, 1.0), ties=st.booleans())
def test_top_k_top_p_filters_match_jax(seed, k, top_p, ties):
    """Same kept set and same values; ties (equal logits) exercise the
    `< kth` and `>= thresh` rules."""
    x = np.random.default_rng(seed).standard_normal((3, 16)).astype(
        np.float32)
    if ties:
        x = np.round(x)
    want = jutils.top_k_filter_logits(jnp.asarray(x), k)
    got = tutils.top_k_filter_logits(T(x), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1))
    want = np.asarray(jutils.top_p_filter_probs(jnp.asarray(probs), top_p))
    got = tutils.top_p_filter_probs(T(probs.copy()), top_p).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# the sampler


def _prompt_rows(seed, prefix_len, rows):
    return randn(seed, rows, prefix_len, TC.llm.hidden_size, scale=0.5)


_PLAIN = dict(cfg_scale=7.5)                         # CFG on
_FILTERED = dict(cfg_scale=1.0, top_k=5, top_p=0.9,  # CFG off
                 temperature=0.8)
_MODES = {
    "plain_cfg": (_PLAIN, 3, False, False),
    "topk_topp_nocfg": (_FILTERED, 3, False, False),
    "teacher_forcing": (_PLAIN, 3, True, False),
    "predict_eos": (_PLAIN, 6, False, True),
}


@pytest.mark.parametrize("mode", list(_MODES))
def test_sample_codes_identical_to_jax(mode):
    """The same noise through both samplers: identical codes. The JAX
    sampler compiles once per static configuration, so the modes share
    two of them (teacher forcing is an array argument)."""
    kw, frames, teacher, predict_eos = _MODES[mode]
    jparams, tparams = stage1_params()
    seed = 11
    jsc = jcfg.ARSampleConfig(num_frames=frames, seed=seed, **kw)
    tsc = tcfg.ARSampleConfig(num_frames=frames, seed=seed, **kw)
    rows = 2 if kw["cfg_scale"] != 1.0 else 1
    prefix_len = 9
    feats = _prompt_rows(3, prefix_len, rows)
    jsched = jlm.build_schedule(JC.llm, prefix_len, frames)
    tsched = tlm.build_schedule(TC.llm, prefix_len, frames)
    teach = None
    if teacher:
        teach = np.random.default_rng(4).integers(
            0, TC.llm.codebook_size, tsched.full_len)
        teach = np.where(tsched.forced >= 0, tsched.forced, teach)
    want = jlm.sample(jparams["lm"], JC.llm, jsched, jnp.asarray(feats), jsc,
                      rng_key=jax.random.PRNGKey(seed), teacher_tokens=teach,
                      predict_eos=predict_eos, **JF32)
    noise = gumbel_steps(seed, tsched.full_len - prefix_len,
                         TC.llm.vocab_size)
    got = tlm.sample(tparams["lm"], TC.llm, tsched, T(feats), tsc,
                     gumbel=noise, teacher_tokens=teach,
                     predict_eos=predict_eos, **F32)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len(set(got.tolist())) > 1
    if predict_eos:
        # with this seed EOS fires inside the second segment
        assert tsched.num_visual // 2 <= len(got) < tsched.num_visual
    else:
        assert len(got) == tsched.num_visual
    if mode == "plain_cfg":
        # a torch.Generator in place of the noise: valid, repeatable,
        # and another stream than another seed's
        gen = lambda s: torch.Generator().manual_seed(s)
        a, b, c = (tlm.sample(tparams["lm"], TC.llm, tsched, T(feats), tsc,
                              generator=gen(s), **F32) for s in (1, 1, 2))
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)
        assert a.min() >= 0 and a.max() < TC.llm.codebook_size
        with pytest.raises(ValueError):
            tlm.sample(tparams["lm"], TC.llm, tsched, T(feats), tsc, **F32)


def test_teacher_forced_logits_match_jax():
    """The logits that the sampler draws from, step by step under teacher
    forcing, within 1e-4: the model is right even where a near-tie of
    logits + noise could flip a code."""
    jparams, tparams = stage1_params()
    prefix_len, frames = 9, 3
    sched = tlm.build_schedule(TC.llm, prefix_len, frames)
    feats = _prompt_rows(3, prefix_len, 2)
    teach = np.random.default_rng(4).integers(0, TC.llm.codebook_size,
                                              sched.full_len)
    teach = np.where(sched.forced >= 0, sched.forced, teach)
    n = sched.full_len

    jcos, jsin = (jnp.asarray(t[:n]) for t in jrope.rope_1d_table(JC.llm.rope))
    jcache = jgpt.KVCache.create(JC.llm, 2, n, jnp.float32)
    step = jax.jit(lambda feat, cache, i, c, s: jgpt.decode_step(
        jparams["lm"]["gpt"], feat, cache, i, JC.llm, c, s,
        compute_dtype=jnp.float32))
    jl, jcache = jgpt.prefill(jparams["lm"]["gpt"], jnp.asarray(feats),
                              jcache, JC.llm, jcos[:prefix_len],
                              jsin[:prefix_len], compute_dtype=jnp.float32)
    want = [jl]
    for i in range(prefix_len, n - 1):
        feat = jnp.broadcast_to(jparams["lm"]["tok_emb"][teach[i]],
                                (2, 1, TC.llm.hidden_size))
        jl, jcache = step(feat, jcache, i, jcos[i:i + 1], jsin[i:i + 1])
        want.append(jl)

    tcos, tsin = (T(t[:n]) for t in trope.rope_1d_table(TC.llm.rope))
    tcache = tgpt.KVCache.create(TC.llm, 2, n, torch.float32, "cpu")
    tl_, tcache = tgpt.prefill(tparams["lm"]["gpt"], T(feats), tcache,
                               TC.llm, tcos[:prefix_len], tsin[:prefix_len],
                               compute_dtype=torch.float32)
    got = [tl_]
    for i in range(prefix_len, n - 1):
        feat = tparams["lm"]["tok_emb"][teach[i]].expand(
            2, 1, TC.llm.hidden_size)
        tl_, tcache = tgpt.decode_step(
            tparams["lm"]["gpt"], feat, tcache, torch.tensor([i]), TC.llm,
            tcos[i:i + 1], tsin[i:i + 1], compute_dtype=torch.float32)
        got.append(tl_)
    assert len(got) == n - prefix_len
    assert_close(torch.stack(got), np.stack([np.asarray(w) for w in want]),
                 atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("predict_eos", [False, True])
def test_sample_batch_equals_single_runs_and_jax(predict_eos):
    """Two right-aligned prompts of different length in one decode: each
    prompt's codes equal its single run's (same noise stream) and JAX's
    sample_batch's."""
    jparams, tparams = stage1_params()
    frames = 6 if predict_eos else 3
    seeds = (11, 12)
    lens = (9, 6)
    prefix = 16                                    # the padded prefix
    kw = dict(cfg_scale=7.5, num_frames=frames)
    jsc, tsc = jcfg.ARSampleConfig(**kw), tcfg.ARSampleConfig(**kw)
    singles = [_prompt_rows(20 + n, lens[n], 2) for n in range(2)]
    stacked = np.concatenate([
        np.pad(r, ((0, 0), (prefix - r.shape[1], 0), (0, 0)))
        for r in singles])
    pad = np.repeat(prefix - np.asarray(lens), 2)
    tsched = tlm.build_schedule(TC.llm, prefix, frames)
    steps = tsched.full_len - prefix
    noise = torch.stack([gumbel_steps(s, steps, TC.llm.vocab_size)
                         for s in seeds])
    got = tlm.sample_batch(tparams["lm"], TC.llm, tsched, T(stacked), pad,
                           tsc, gumbel=noise, predict_eos=predict_eos, **F32)
    want = jlm.sample_batch(
        jparams["lm"], JC.llm, jlm.build_schedule(JC.llm, prefix, frames),
        jnp.asarray(stacked), pad, jsc,
        rng_keys=jnp.stack([jax.random.PRNGKey(s) for s in seeds]),
        predict_eos=predict_eos, **JF32)
    assert len(got) == 2
    for n in range(2):
        np.testing.assert_array_equal(got[n], np.asarray(want[n]))
        single = tlm.sample(
            tparams["lm"], TC.llm, tlm.build_schedule(TC.llm, lens[n],
                                                      frames),
            T(singles[n]), tsc, gumbel=noise[n], predict_eos=predict_eos,
            **F32)
        np.testing.assert_array_equal(got[n], single)
    if not predict_eos:
        gens = [torch.Generator().manual_seed(5) for _ in range(2)]
        a = tlm.sample_batch(tparams["lm"], TC.llm, tsched, T(stacked), pad,
                             tsc, generators=gens, **F32)
        one = tlm.sample(tparams["lm"], TC.llm,
                         tlm.build_schedule(TC.llm, lens[0], frames),
                         T(singles[0]), tsc,
                         generator=torch.Generator().manual_seed(5), **F32)
        np.testing.assert_array_equal(a[0], one)
