"""PyTorch port: the trainer's entry point and what it stands on: the optimizer
against the optax chain the JAX package builds, the loader against the
JAX loader, the checkpoint, the metrics logger, and `train` end to end on
the CPU at the tiny config (smoke, resume, what is not ported raises).

Tolerances, f32: each update 5e-5 relative, the parameters after ten
updates 5e-6 relative + 1e-6 (readings 1e-5 and 1.6e-6: the schedule and
the bias corrections are taken in f64 here and in f32 by optax, and
m / (sqrt(v) + eps) amplifies a last-bit difference of the moments).
bf16 moments: within two bf16 steps (optax rounds after each of its two
operations, the port once)."""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_helpers import randn
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu.data import loader as jloader
from landiff_tpu.training import eval_log as jeval
from landiff_tpu.training import train as jtrain
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch import observability as tobs
from landiff_tpu_torch.data import loader as tloader
from landiff_tpu_torch.training import checkpoint as tckpt
from landiff_tpu_torch.training import eval_log as teval
from landiff_tpu_torch.training import optim as toptim
from landiff_tpu_torch.training import train as ttrain
from landiff_tpu_torch.utils import tree_leaves

torch.set_num_threads(2)   # tier-1 runs six xdist workers

T = torch.from_numpy


def _tree(seed, scale=1.0):
    return {"w": randn(seed, 4, 6, scale=scale),
            "sub": [randn(seed + 1, 5, scale=scale),
                    {"b": randn(seed + 2, 3, 2, scale=scale)}]}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, fn) for v in tree]
    return fn(tree)


def _sorted_leaves(tree):
    """Leaves with dict keys in sorted order (JAX returns dicts sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _run_optimizers(steps, grad_scale, grad_accum=1, n_updates=10):
    jopt = jtrain.make_optimizer(1e-2, steps, grad_accum=grad_accum)
    topt = ttrain.make_optimizer(1e-2, steps, grad_accum=grad_accum)
    jp, tp = _to(_tree(0), jnp.asarray), _to(_tree(0), lambda a: T(a.copy()))
    jstate, tstate = jopt.init(jp), topt.init(tp)
    norms = []
    for i in range(n_updates):
        g = _tree(10 + 3 * i, scale=grad_scale)
        ju, jstate = jopt.update(_to(g, jnp.asarray), jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tg = _to(g, lambda a: T(a.copy()))
        norms.append(float(toptim.global_norm(tg)))
        tu, tstate = topt.update(tg, tstate, tp)
        tp = toptim.apply_updates(tp, tu)
        for a, b in zip(_sorted_leaves(tu), _sorted_leaves(ju)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-5,
                                       atol=1e-9)
    for a, b in zip(_sorted_leaves(tp), _sorted_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-6,
                                   atol=1e-6)
    return norms, tp


@pytest.mark.parametrize("grad_scale,clipped", [(0.05, False), (3.0, True)])
def test_optimizer_matches_optax_over_ten_steps(grad_scale, clipped):
    """steps=30: three warmup updates from rate 0, then the cosine."""
    norms, tp = _run_optimizers(30, grad_scale)
    assert all((n > 1.0) == clipped for n in norms)
    start = tree_leaves(_to(_tree(0), T))
    assert max(float((a - b).abs().max())
               for a, b in zip(tree_leaves(tp), start)) > 1e-3


def test_optimizer_first_update_changes_nothing():
    topt = ttrain.make_optimizer(1e-2, 30)
    tp = _to(_tree(0), lambda a: T(a.copy()))
    upd, _ = topt.update(_to(_tree(1), T), topt.init(tp), tp)
    assert all(float(u.abs().max()) == 0.0 for u in tree_leaves(upd))


def test_clip_is_optax_not_clip_grad_norm():
    """At norm = 4 the clip scales by exactly 1 / 4; torch's
    clip_grad_norm_ would scale by 1 / (4 + 1e-6)."""
    g = {"w": torch.full((4, 4), 1.0)}                   # norm 4
    opt = toptim.ClipAdamW(lambda c: 1.0, weight_decay=0.0, clip=1.0,
                           b1=0.0, b2=0.0, eps=0.0)
    p = {"w": torch.zeros(4, 4)}
    state = opt.init(p)
    opt.update(g, state, p)
    assert torch.equal(state["mu"]["w"], torch.full((4, 4), 0.25))


@pytest.mark.parametrize("k", [2, 4])
def test_grad_accum_matches_optax_multisteps(k):
    _run_optimizers(12 * k, 0.5, grad_accum=k, n_updates=3 * k)


def test_grad_accum_intermediate_steps_are_noops():
    params = {"w": torch.ones(4, 4)}
    acc = ttrain.make_optimizer(1e-3, steps=8, grad_accum=2)
    st = acc.init(params)
    g = {"w": torch.full((4, 4), 0.5)}
    upd, st = acc.update(g, st, params)      # cycle 1 accumulate
    assert float(upd["w"].abs().max()) == 0.0
    upd, st = acc.update(g, st, params)      # cycle 1 apply (warmup rate 0)
    upd, st = acc.update(g, st, params)      # cycle 2 accumulate
    assert float(upd["w"].abs().max()) == 0.0
    upd, st = acc.update(g, st, params)      # cycle 2 apply, rate > 0 now
    assert float(upd["w"].abs().max()) > 0.0
    assert st["gradient_step"] == 2 and st["inner"]["count"] == 2


def test_adam_moments_keep_the_parameter_dtype():
    p = {"w": T(randn(0, 8, 8)).bfloat16()}
    opt = ttrain.make_optimizer(1e-2, 30)
    state = opt.init(p)
    g = {"w": T(randn(1, 8, 8)).bfloat16()}
    for _ in range(2):
        upd, state = opt.update(g, state, p)
    assert state["mu"]["w"].dtype == state["nu"]["w"].dtype == torch.bfloat16
    assert upd["w"].dtype == torch.bfloat16
    jopt = jtrain.make_optimizer(1e-2, 30)
    jp = {"w": jnp.asarray(randn(0, 8, 8), jnp.bfloat16)}
    jstate = jopt.init(jp)
    jg = {"w": jnp.asarray(randn(1, 8, 8), jnp.bfloat16)}
    for _ in range(2):
        _, jstate = jopt.update(jg, jstate, jp)
    jmu = np.asarray(jstate[1][0].mu["w"].astype(jnp.float32))
    np.testing.assert_allclose(state["mu"]["w"].float().numpy(), jmu,
                               rtol=2 ** -6, atol=1e-6)


def test_schedule_matches_optax():
    for steps in (3, 30, 2000):
        wu = min(100, max(1, steps // 10))
        want = optax.warmup_cosine_decay_schedule(
            0.0, 1e-4, wu, max(steps, wu + 1), 1e-5)
        got = toptim.warmup_cosine_decay_schedule(
            0.0, 1e-4, wu, max(steps, wu + 1), 1e-5)
        for c in (0, 1, wu - 1, wu, wu + 1, steps // 2, steps, steps + 50):
            assert got(max(c, 0)) == pytest.approx(float(want(max(c, 0))),
                                                   rel=1e-5, abs=1e-12)


# ---------------------------------------------------------------------------
# data, checkpoint, observability


def test_loader_batches_equal_the_jax_loaders(tmp_path):
    data = {"x": randn(0, 13, 3, 2), "y": np.arange(13, dtype=np.int32)}
    tloader.write_npz_shards(data, tmp_path / "t", 4)
    jloader.write_npz_shards(data, tmp_path / "j", 4)
    for kw in ({}, {"dp_rank": 1, "dp_size": 2}, {"drop_remainder": False}):
        tds = tloader.ShardedNpzDataset(tmp_path / "t", 3, seed=5, **kw)
        jds = jloader.ShardedNpzDataset(tmp_path / "j", 3, seed=5, **kw)
        for epoch in (0, 1):
            got, want = list(tds.iter_epoch(epoch)), list(jds.iter_epoch(epoch))
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                assert list(a) == list(b)
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
    staged = list(tloader.prefetch_to_device(
        tloader.ShardedNpzDataset(tmp_path / "t", 3, seed=5).iter_epoch(0),
        device="cpu"))
    plain = list(tloader.ShardedNpzDataset(tmp_path / "t", 3,
                                           seed=5).iter_epoch(0))
    assert len(staged) == len(plain)
    for a, b in zip(staged, plain):
        assert all(isinstance(a[k], torch.Tensor) for k in a)
        np.testing.assert_array_equal(a["x"].numpy(), b["x"])
        assert a["y"].dtype == torch.int32


def test_checkpoint_round_trip_and_latest(tmp_path):
    params = {"w": T(randn(0, 3, 3)).bfloat16(), "l": [T(randn(1, 2))]}
    opt_state = {"count": 3, "mu": {"w": T(randn(2, 3, 3))}}
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(tmp_path / "none")
    tckpt.save_checkpoint(tmp_path, 2, params, opt_state)
    tckpt.save_checkpoint(tmp_path, 10, params, opt_state,
                          extra={"rest": [True]})
    assert tckpt.latest_step(tmp_path) == 10
    assert not list(tmp_path.glob("*.tmp"))
    template = {"params": {"w": torch.zeros(3, 3, dtype=torch.bfloat16),
                           "l": [torch.zeros(2)]},
                "opt_state": {"count": 0, "mu": {"w": torch.zeros(3, 3)}},
                "extra": {"rest": [False]}}
    step, got = tckpt.restore_checkpoint(tmp_path, template=template)
    assert step == 10 and got["extra"]["rest"] == [True]
    assert got["opt_state"]["count"] == 3
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"], params["w"])
    assert torch.equal(got["opt_state"]["mu"]["w"], opt_state["mu"]["w"])
    step, got = tckpt.restore_checkpoint(tmp_path, step=2)
    assert step == 2 and "extra" not in got


def test_observability_pieces(tmp_path):
    log = tobs.MetricsLogger(str(tmp_path / "m.jsonl"))
    log.log(1, loss=torch.tensor(2.5), lr=np.float32(0.5))
    log.log(2, loss=1.5)
    rows = [json.loads(l) for l in (tmp_path / "m.jsonl").read_text()
            .splitlines()]
    assert rows == [{"step": 1, "loss": 2.5, "lr": 0.5},
                    {"step": 2, "loss": 1.5}]
    assert log.last() == rows[-1] and tobs.MetricsLogger().last() == {}
    g1, g2 = tobs.set_deterministic(7), tobs.set_deterministic(7)
    assert torch.equal(torch.rand(3, generator=g1),
                       torch.rand(3, generator=g2))


def test_eval_log_matches_jax(tmp_path):
    video = np.random.default_rng(0).random((2, 3, 9, 4, 6)).astype(np.float32)
    np.testing.assert_array_equal(teval.video_grid(video),
                                  jeval.video_grid(video))
    png = teval.log_video(video, ["a", "b"], tmp_path, 7,
                          metrics={"loss": torch.tensor(1.0)})
    assert png.exists() and png.name == "step_00000007.png"
    side = json.loads((tmp_path / "step_00000007.json").read_text())
    assert side == {"step": 7, "prompts": ["a", "b"],
                    "metrics": {"loss": 1.0}}


# ---------------------------------------------------------------------------
# the trainer end to end


@pytest.mark.parametrize("model", ["lm", "dit"])
def test_train_smoke(model, tmp_path):
    cfg = tcfg.tiny_test_config()
    data_dir = tmp_path / "data"
    ttrain.synthesize(model, cfg, 6, data_dir, shard_size=3)
    metrics = tmp_path / "metrics.jsonl"
    state, last = ttrain.train(
        model, str(data_dir), steps=3, batch_size=2, lr=1e-3, log_every=1,
        metrics_path=str(metrics), tiny=True, device="cpu")
    assert np.isfinite(float(last["loss"]))
    rows = [json.loads(l) for l in metrics.read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3] and "loss" in rows[-1]
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(state[0]))
    assert state[1]["count"] == 3


def test_synthesized_data_equals_the_jax_trainers(tmp_path):
    from landiff_tpu import config as jcfg

    for model in ("dit", "lm", "vq"):
        ttrain.synthesize(model, tcfg.tiny_test_config(), 5,
                          tmp_path / f"t_{model}", seed=3, shard_size=4)
        jtrain.synthesize(model, jcfg.tiny_test_config(), 5,
                          tmp_path / f"j_{model}", seed=3, shard_size=4)
        for a, b in zip(sorted((tmp_path / f"t_{model}").glob("*.npz")),
                        sorted((tmp_path / f"j_{model}").glob("*.npz"))):
            with np.load(a) as za, np.load(b) as zb:
                assert list(za) == list(zb)
                for k in za:
                    np.testing.assert_array_equal(za[k], zb[k])


def test_train_resume_equals_an_uninterrupted_run(tmp_path):
    cfg = tcfg.tiny_test_config()
    data_dir = tmp_path / "data"
    ttrain.synthesize("lm", cfg, 6, data_dir, shard_size=3)
    kw = dict(steps=4, batch_size=2, lr=1e-3, save_every=2, log_every=1,
              tiny=True, device="cpu")
    whole, whole_last = ttrain.train("lm", str(data_dir),
                                     ckpt_dir=str(tmp_path / "a"), **kw)
    # a run that was cut after step 2: only that checkpoint exists
    (tmp_path / "b").mkdir()
    shutil.copy(tmp_path / "a" / "step_2.pt", tmp_path / "b" / "step_2.pt")
    resumed, resumed_last = ttrain.train(
        "lm", str(data_dir), ckpt_dir=str(tmp_path / "b"), resume=True, **kw)
    assert float(resumed_last["loss"]) == float(whole_last["loss"])
    for a, b in zip(tree_leaves(resumed[0]), tree_leaves(whole[0])):
        assert torch.equal(a, b)
    assert resumed[1]["count"] == whole[1]["count"] == 4
    # resume with nothing to resume from starts at step 0
    _, last = ttrain.train("lm", str(data_dir), steps=1, batch_size=2,
                           ckpt_dir=str(tmp_path / "none"), resume=True,
                           tiny=True, device="cpu", log_every=1)
    assert np.isfinite(float(last["loss"]))


def test_step_generator_depends_on_seed_and_step_only():
    a = torch.rand(4, generator=ttrain.step_generator(0, 5, "cpu"))
    b = torch.rand(4, generator=ttrain.step_generator(0, 5, "cpu"))
    c = torch.rand(4, generator=ttrain.step_generator(0, 6, "cpu"))
    d = torch.rand(4, generator=ttrain.step_generator(1, 5, "cpu"))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


def test_train_grad_accum_smoke(tmp_path):
    cfg = tcfg.tiny_test_config()
    data_dir = tmp_path / "data"
    ttrain.synthesize("lm", cfg, 8, data_dir, shard_size=4)
    state, last = ttrain.train("lm", str(data_dir), steps=4, batch_size=2,
                               log_every=1, tiny=True, grad_accum=2,
                               device="cpu")
    assert np.isfinite(float(last["loss"]))
    assert state[1]["gradient_step"] == 2 and state[1]["mini_step"] == 0


def test_what_is_not_ported_raises(tmp_path):
    """--model vq synthesizes and trains (the tokenizer's encode side is
    ported); a mesh of one device is the single-device run (larger
    meshes: tests/test_torch_port_train_mesh.py)."""
    cfg = tcfg.tiny_test_config()
    ttrain.synthesize("vq", cfg, 2, tmp_path / "vq", shard_size=2)
    state, last = ttrain.train("vq", str(tmp_path / "vq"), steps=1,
                               batch_size=2, tiny=True, device="cpu",
                               log_every=1)
    assert np.isfinite(float(last["total_loss"]))
    assert state[3] is False and bool(state[2]["initted"])
    ttrain.synthesize("lm", cfg, 2, tmp_path / "lm", shard_size=2)
    assert ttrain.parse_mesh("data=2,model=4") == {"data": 2, "model": 4}
    # a mesh of one device is the single-device run
    _, last = ttrain.train("lm", str(tmp_path / "lm"), steps=1, batch_size=2,
                           tiny=True, mesh_spec="data=1", device="cpu",
                           log_every=1)
    assert np.isfinite(float(last["loss"]))


def test_main_runs_the_tiny_config_on_the_cpu(tmp_path):
    metrics = tmp_path / "m.jsonl"
    ttrain.main(["--model", "dit", "--data", str(tmp_path / "d"), "--synth",
                 "6", "--tiny", "--device", "cpu", "--steps", "2",
                 "--batch-size", "2", "--log-every", "1", "--metrics",
                 str(metrics), "--ckpt-dir", str(tmp_path / "c")])
    rows = [json.loads(l) for l in metrics.read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert tckpt.latest_step(tmp_path / "c") == 2
