"""PyTorch port: the tokenizer trainer (training/vq_train.py, ema.py and
train --model vq) held against the JAX package at the tiny config in f32.
Both get the same parameters (the port's VideoVQ init without Theia,
zero leaves filled, in the JAX layouts for JAX and through the bridge for
the port), the same features and the same draws: the k-means permutation
and the dead-code sample indices regenerated from the JAX keys and
handed to the port as tensors.

Tolerances: k-means means and input, EMA codebook and LitEma shadow
1e-5 + 1e-5 relative (f32 sums in another order); losses after
each step 1e-5 relative; parameters after three updates 2e-5 absolute
(Adam turns a relative gradient difference d into an update difference
of about lr * d, lr 1e-3; the stage-1 trainer's bar); code indices
exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port_helpers import (assert_close, fast_compiles, fast_jit,
                                 randn, to_jax_layout)
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu import config as jcfg
from landiff_tpu.training import ema as jema
from landiff_tpu.training import train as jtrain
from landiff_tpu.training import vq_train as jvt
from landiff_tpu_torch import bridge
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.models import vq as tvq
from landiff_tpu_torch.training import ema as tema
from landiff_tpu_torch.training import train as ttrain
from landiff_tpu_torch.training import vq_train as tvt
from landiff_tpu_torch.utils import fill_zero_leaves, tree_map

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JT, TT = jcfg.tiny_test_config().tokenizer, tcfg.tiny_test_config().tokenizer
T = torch.from_numpy
B, LR, STEPS = 2, 1e-3, 3
K = TT.vq.codebook_size


@functools.lru_cache(maxsize=1)
def params():
    gen = torch.Generator().manual_seed(41)
    arrays = to_jax_layout(fill_zero_leaves(
        tvq.init(gen, TT, with_theia=False), gen))
    return arrays


def _pair():
    arrays = params()
    return (jax.tree_util.tree_map(jnp.asarray, arrays),
            bridge.to_torch(arrays, device="cpu"))


def _features(step):
    t = TT.titok
    return randn(600 + step, B, t.temporal_size, t.grid_h, t.grid_w,
                 TT.feature_dim)


def _close_tree(got, want, **tol):
    pairs = []
    tree_map(lambda a, b: pairs.append((a, b)), got, want)
    assert pairs
    for a, b in pairs:
        assert_close(a, np.asarray(b), **tol)


def test_kmeans_and_ema_codebook_update_match_jax():
    """k-means from the same permutation; then one EMA update from an
    empty state (every code is dead: replaced by the drawn rows) and a
    second from the first's state."""
    jp, tp = _pair()
    zin = randn(42, B, 20, TT.vq.codebook_dim)
    key = jax.random.PRNGKey(7)
    n = B * 20
    perm = jax.random.permutation(key, n)
    want = fast_jit(lambda z: jvt.kmeans_init_codebook(z, K, key),
                    zin)(zin)
    got = tvt.kmeans_init_codebook(T(zin), K, T(np.array(perm)))
    assert_close(got, want, atol=1e-5, rtol=1e-5)

    jq, tq = dict(jp["quant"]), dict(tp["quant"])
    jq["codebook"], tq["codebook"] = want, got
    jstate = jvt.init_codebook_state(JT)
    tstate = tvt.init_codebook_state(TT, "cpu")
    for i in range(2):
        k = jax.random.fold_in(key, i)
        z = randn(43 + i, B, 20, TT.vq.dim)
        _, jzin, jidx, _ = jvt.quantize_ste(jq, jnp.asarray(z))
        _, tzin, tidx, _ = tvt.quantize_ste(tq, T(z))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        assert_close(tzin, jzin, atol=1e-6, rtol=1e-6)
        rand_idx = jax.random.randint(k, (K,), 0, n)
        jq, jstate = jvt.ema_codebook_update(jq, jstate, jzin, jidx, key=k)
        tq, tstate = tvt.ema_codebook_update(tq, tstate, tzin, tidx,
                                             rng=T(np.array(rand_idx)))
        assert_close(tq["codebook"], jq["codebook"], atol=1e-5, rtol=1e-5)
        assert_close(tstate["cluster_size"], jstate.cluster_size,
                     atol=1e-5, rtol=1e-5)
        assert_close(tstate["embed_avg"], jstate.embed_avg, atol=1e-5,
                     rtol=1e-5)
    assert bool(tstate["initted"]) and bool(jstate.initted)


def test_ema_update_matches_jax():
    jp, tp = _pair()
    for use_n in (True, False):
        js = jema.init_ema(jp["quant"], use_num_updates=use_n)
        ts = tema.init_ema(tp["quant"], use_num_updates=use_n)
        jq, tq = dict(jp["quant"]), dict(tp["quant"])
        for i in range(3):
            moved = randn(44 + i, *params()["quant"]["in_w"].shape)
            jq["in_w"], tq["in_w"] = jnp.asarray(moved), T(moved)
            js = jema.ema_update(js, jq, decay=0.99)
            ts = tema.ema_update(ts, tq, decay=0.99)
        assert ts["num_updates"] == int(js.num_updates)
        _close_tree(ts["shadow"], js.shadow, atol=1e-6, rtol=1e-6)
        _close_tree(tema.copy_to(ts, tq), jema.copy_to(js, jq), atol=1e-6,
                    rtol=1e-6)


def test_three_train_steps_match_jax():
    """Three steps of make_train_step with a LitEma shadow: losses,
    metrics, parameters (the EMA-owned codebook too), codebook state and
    shadow, on the same batches and dead-code draws."""
    jp, tp = _pair()
    jopt = jtrain.make_optimizer(LR, STEPS)
    topt = ttrain.make_optimizer(LR, STEPS)
    decay = 0.9
    with fast_compiles():
        jstep = jvt.make_train_step(jopt, JT, compute_dtype=jnp.float32,
                                    ema_decay=decay)
    tstep = tvt.make_train_step(topt, TT, compute_dtype=torch.float32,
                                ema_decay=decay)
    jstate = (jp, jopt.init(jp), jvt.init_codebook_state(JT),
              jema.init_ema(jp))
    tstate = (tp, topt.init(tp), tvt.init_codebook_state(TT, "cpu"),
              tema.init_ema(tp))
    n = B * TT.titok.latent_tokens
    for i in range(STEPS):
        feats = _features(i)
        key = jax.random.fold_in(jax.random.PRNGKey(8), i)
        with fast_compiles():
            *jstate, jm = jstep(*jstate, jnp.asarray(feats), key)
        rand_idx = T(np.array(jax.random.randint(key, (K,), 0, n)))
        *tstate, tm = tstep(*tstate, T(feats), rand_idx)
        assert set(tm) == set(jm)
        for name in tm:
            assert_close(tm[name], np.asarray(jm[name]), atol=1e-7,
                         rtol=1e-5)
    assert float(jm["re_loss"]) > 0.0 and float(jm["commit_loss"]) > 0.0
    _close_tree(tstate[0], jstate[0], atol=2e-5, rtol=0)
    assert_close(tstate[2]["cluster_size"], jstate[2].cluster_size,
                 atol=1e-5, rtol=1e-5)
    _close_tree(tstate[3]["shadow"], jstate[3].shadow, atol=2e-5, rtol=0)
    moved = float(np.abs(np.asarray(jstate[0]["encoder"]["patch_w"])
                         - params()["encoder"]["patch_w"]).max())
    assert moved > 1e-4
    # the tokenizer loss alone, whose zin the JAX driver's first-batch
    # k-means reads; the port's driver takes it from the encoder half
    jl, jaux = jvt.tokenizer_loss(jstate[0], jnp.asarray(feats), JT)
    tl, taux = tvt.tokenizer_loss(tstate[0], T(feats), TT)
    np.testing.assert_array_equal(taux["idx"].numpy(),
                                  np.asarray(jaux["idx"]))
    assert_close(tl, jl, atol=1e-7, rtol=1e-5)
    zin = tvt.kmeans_input(tstate[0], T(feats), TT)
    assert torch.equal(zin, taux["zin"])
    assert_close(zin, jaux["zin"], atol=1e-5, rtol=1e-5)


def test_train_vq_driver_smoke(tmp_path):
    """train --model vq: the CLI on synthesized features; the first batch's
    k-means init, a checkpoint after step 2, and a run resumed from it
    equal to the uninterrupted one."""
    import shutil

    data = tmp_path / "d"
    ttrain.main(["--model", "vq", "--data", str(data), "--synth", "4",
                 "--tiny", "--device", "cpu", "--steps", "2",
                 "--batch-size", "2", "--log-every", "1"])
    kw = dict(steps=4, batch_size=2, tiny=True, device="cpu", log_every=1,
              save_every=2)
    whole, last = ttrain.train("vq", str(data), ckpt_dir=str(tmp_path / "a"),
                               **kw)
    assert all(np.isfinite(float(v)) for v in last.values())
    (tmp_path / "b").mkdir()
    shutil.copy(tmp_path / "a" / "step_2.pt", tmp_path / "b" / "step_2.pt")
    resumed, rlast = ttrain.train("vq", str(data), ckpt_dir=str(
        tmp_path / "b"), resume=True, **kw)
    assert float(rlast["total_loss"]) == float(last["total_loss"])
    pairs = []
    tree_map(lambda a, b: pairs.append((a, b)), resumed[0], whole[0])
    assert pairs and all(torch.equal(a, b) for a, b in pairs)
    assert torch.equal(resumed[2]["embed_avg"], whole[2]["embed_avg"])
    assert bool(resumed[2]["initted"]) and resumed[3] is False
