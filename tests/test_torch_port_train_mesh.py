"""PyTorch port: the trainer on a mesh (training/mesh_train.py, the ring
attention backward, the sequence- and tensor-parallel steps, ZeRO) at the
tiny config on the CPU: the ranks are worker processes joined by gloo,
one mesh per layout for the module (time=2, data=2,time=2,
data=2,model=2). The JAX sides run unsharded, in this process only.

Tolerances (f32): the ring's gradients against JAX's dense attention
gradient on the gathered sequence at rtol 2e-4, atol 2e-5 (JAX
test_sp_infer.py:169); the sequence-parallel loss against JAX's
unsharded loss at 1e-5 relative and its control gradients at 1e-4 of the
leaf's largest entry + 1e-5 relative (test_torch_port_train_dit.py's
limits: sums in another order, here also over two ranks); remat against
no remat exactly; the mesh steps against the port's one-device steps at
2e-5 absolute on the parameters after two updates (Adam turns a relative
gradient difference d into about lr * d, lr 1e-3) and 1e-5 relative on
the losses."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (assert_close, dit_loss_draws, fast_jit,
                                 randn, to_jax_layout, train_dit_params)
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu import config as jcfg
from landiff_tpu.ops import attention as jattn
from landiff_tpu.parallel import mesh as jmesh
from landiff_tpu.training import diffusion_loss as jdl
from landiff_tpu.training import zero as jzero
from landiff_tpu_torch import bridge
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.parallel import mesh as tmesh
from landiff_tpu_torch.parallel import ring_attention as tring
from landiff_tpu_torch.parallel import tp_infer as ttp
from landiff_tpu_torch.pipeline import dif_infer as tdi
from landiff_tpu_torch.training import diffusion_loss as tdl
from landiff_tpu_torch.training import mesh_train as tmt
from landiff_tpu_torch.training import train as ttrain
from landiff_tpu_torch.training import zero as tzero
from landiff_tpu_torch.utils import fill_zero_leaves, tree_leaves, tree_map

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
T = torch.from_numpy
LR, STEPS, B = 1e-3, 3, 2
OPT = {"lr": LR, "steps": STEPS, "grad_accum": 1}
SMALL = 256     # the smallest leaf whose optimizer state ZeRO splits here


def _mesh(data=1, model=1, time=1):
    return tmesh.make_mesh(tcfg.MeshConfig(data=data, model=model,
                                           time=time),
                           devices=["cpu"] * (data * model * time),
                           timeout_s=120)


@pytest.fixture(scope="module")
def mesh_t2():
    m = _mesh(time=2)
    yield m
    m.close()


@pytest.fixture(scope="module")
def mesh_d2t2():
    m = _mesh(data=2, time=2)
    yield m
    m.close()


@pytest.fixture(scope="module")
def mesh_d2m2():
    m = _mesh(data=2, model=2)
    yield m
    m.close()


def _dit_batch(seed, cfg=TC):
    d, t = cfg.dit, cfg.tokenizer.titok
    n_sem = t.iframe_latent_tokens + (t.temporal_size - 1) * \
        t.pframe_latent_tokens
    return {"latents": T(randn(100 + seed, B, d.latent_frames,
                                d.in_channels, d.latent_height,
                                d.latent_width)),
            "context": T(randn(200 + seed, B, d.text_length, d.text_dim)),
            "tokens": torch.from_numpy(np.random.default_rng(300 + seed)
                                       .integers(0, cfg.tokenizer.vq
                                                 .codebook_size, (B, n_sem)))}


def _close_trees(got, want, atol, rtol=0.0):
    pairs = []
    tree_map(lambda a, b: pairs.append((a, b)), got, want)
    assert pairs
    for a, b in pairs:
        if isinstance(a, torch.Tensor):
            assert_close(a, b.float().numpy(), atol=atol, rtol=rtol)
        else:
            assert a == b


# ---------------------------------------------------------------------------
# (1) the collectives and the ring backward


@pytest.mark.parametrize("kind", ["copy_to", "reduce_from", "gather_from",
                                  "ring_shift"])
def test_collectives_carry_their_gradients(kind, mesh_t2):
    """On rank 0 of time=2, with every rank's x and cotangent r + 1 times
    rank 0's: f is the identity with the summed gradient, g the sum with
    the gradient passed, the gather's gradient the rank's slice of its
    cotangent, the shift's the reverse shift of the cotangent."""
    x, cot = randn(1, 3, 4), randn(2, 3, 8 if kind == "gather_from" else 4)
    out = mesh_t2.run(tmesh.collective_vjp, kind, "time",
                      per_rank=[(T(x * (r + 1)), T(cot * (r + 1)))
                                for r in range(2)])[0]
    y, g = out
    want = {"copy_to": (x, cot[..., :4] * 3),
            "reduce_from": (x * 3, cot),
            "gather_from": (np.concatenate([x, 2 * x], -1), cot[..., :4]),
            "ring_shift": (2 * x, 2 * cot)}[kind]
    np.testing.assert_allclose(y.numpy(), want[0], rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), want[1], rtol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ring_gradient_matches_jax_dense(impl, mesh_t2):
    """dq, dk, dv of sum(ring(q, k, v) * w) at time=2, (1, 64, 2, 16),
    through the ranks' autograd (dense hops, or the flash hops: on the CPU
    the kernels' plain versions with their log2 lse) against jax.grad of
    the dense attention over the whole sequence (JAX
    test_sp_infer.py:169); each rank makes 4n - 2 = 6 shifts in the
    backward after the forward's 2."""
    q, k, v, w = (randn(s, 1, 64, 2, 16) for s in (10, 11, 12, 13))

    def loss(q, k, v):
        return jnp.sum(jattn.mha_reference(q, k, v) * w)

    want = fast_jit(jax.grad(loss, argnums=(0, 1, 2)), q, k, v)(q, k, v)
    mesh_t2.run(ttp.rank_report, True)
    got = tring.ring_attention_vjp(T(q), T(k), T(v), T(w), mesh_t2,
                                   impl=impl)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5, err_msg=name)
    for rep in mesh_t2.run(ttp.rank_report, True):
        assert rep["collectives"]["ring_shift"] == 2 + 6, rep


def test_ring_backward_from_a_given_lse_equals_autograd(mesh_t2):
    """ring_attention_bwd (the backward alone, from the global output and
    lse of the dense attention) gives the autograd ring's gradients."""
    q, k, v, w = (T(randn(s, 1, 64, 2, 16)) for s in (20, 21, 22, 23))
    out, lse = tring._local_attn(q, k, v, 0.25)
    got = tring.ring_attention_bwd(q, k, v, out, lse * tring.LOG2E, w,
                                   mesh_t2, impl="xla")
    want = tring.ring_attention_vjp(q, k, v, w, mesh_t2, impl="xla")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# (2) the sequence-parallel step


def _dit_state(tp, opt, cfg=TC):
    """The stage-2 trainer's state and frozen trees from port trees."""
    ctrl = tp["control"]
    return (ctrl, opt.init(ctrl)), {"main": tp["main"],
                                    "sem": tp["semantic"]}


@functools.lru_cache(maxsize=2)
def _jax_loss_and_grads(fixed_frames):
    jp, _ = train_dit_params()
    batch = _dit_batch(0)
    key = jax.random.PRNGKey(5)

    def loss(control, main, sem, lat, ctx, tokens, key):
        return jdl.video_diffusion_loss(
            main, control, sem, lat, ctx, tokens, key, JC.dit, JC.sampler,
            JC.tokenizer, JC.semantic_cond, fixed_frames=fixed_frames,
            compute_dtype=jnp.float32)

    args = (jp["control"], jp["main"], jp["semantic"],
            jnp.asarray(batch["latents"].numpy()),
            jnp.asarray(batch["context"].numpy()),
            jnp.asarray(batch["tokens"].numpy().astype(np.int32)), key)
    return fast_jit(jax.value_and_grad(loss), *args)(*args)


def _mesh_dit_grads(mesh, fixed_frames=0, remat=True):
    _, tp = train_dit_params()
    batch = _dit_batch(0)
    draws = dit_loss_draws(jax.random.PRNGKey(5), batch["latents"].shape,
                           JC.sampler.num_train_timesteps)
    state, frozen = _dit_state(tp, ttrain.make_optimizer(**OPT))
    trainer = tmt.MeshTrainer(mesh, "dit", TC, OPT, torch.float32, state,
                              frozen, step_kw={"fixed_frames": fixed_frames,
                                               "remat": remat},
                              keep_grads=True)
    try:
        loss = trainer.step(batch, draws)["loss"]
        return float(loss), trainer.grads()
    finally:
        trainer.close()


@pytest.mark.parametrize("fixed_frames", [0, 1])
def test_sp_step_matches_jax_unsharded(fixed_frames, mesh_t2):
    """make_train_step_sp's loss and control gradients at time=2 (the
    tokens over two ranks, attention a ring, the gradients summed over
    `time`) against JAX's unsharded loss and gradients from the same
    draws (JAX test_training_sp.py:43)."""
    want_loss, want = _jax_loss_and_grads(fixed_frames)
    loss, got = _mesh_dit_grads(mesh_t2, fixed_frames)
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    want = bridge.to_torch(jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(np.float32), want), device="cpu")
    pairs = []
    tree_map(lambda g, w: pairs.append((g, w.numpy())), got, want)
    reached = 0
    for g, w in pairs:
        assert_close(g, w, atol=1e-4 * float(np.abs(w).max()) + 1e-9,
                     rtol=1e-5)
        reached += bool(np.abs(w).max() > 0)
    assert reached == len(pairs) - 2   # the unused final LayerNorm


def test_sp_remat_equals_no_remat(mesh_t2):
    """Per-layer checkpointing of the SP layers changes no value (JAX
    test_training_sp.py:74)."""
    a_loss, a = _mesh_dit_grads(mesh_t2, remat=False)
    b_loss, b = _mesh_dit_grads(mesh_t2, remat=True)
    assert a_loss == b_loss
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _one_device_dit(tp, n_steps, cfg=TC, seed0=40):
    """n_steps of the port's one-device step, without remat (its first use
    in a process costs seconds of imports; remat's own test is above)."""
    opt = ttrain.make_optimizer(**OPT)
    step = tdl.make_train_step(opt, cfg.dit, cfg.sampler, cfg.tokenizer,
                               cfg.semantic_cond, compute_dtype=torch.float32,
                               remat=False)
    (ctrl, state), frozen = _dit_state(tp, opt, cfg)
    losses = []
    for i in range(n_steps):
        b = _dit_batch(i, cfg)
        ctrl, state, loss = step(ctrl, state, frozen["main"], frozen["sem"],
                                 b["latents"], b["context"], b["tokens"],
                                 torch.Generator().manual_seed(seed0 + i))
        losses.append(float(loss))
    return ctrl, state, losses


@functools.lru_cache(maxsize=1)
def _one_device_dit_two_steps():
    return _one_device_dit(train_dit_params()[1], 2)


def _mesh_dit(mesh, tp, n_steps, cfg=TC, seed0=40, step_kw=None):
    state, frozen = _dit_state(tp, ttrain.make_optimizer(**OPT), cfg)
    trainer = tmt.MeshTrainer(mesh, "dit", cfg, OPT, torch.float32, state,
                              frozen, zero_min_size=SMALL,
                              step_kw={"remat": False, **(step_kw or {})})
    try:
        losses = [float(trainer.step(_dit_batch(i, cfg), seed0 + i)["loss"])
                  for i in range(n_steps)]
        return trainer.state(), losses, trainer
    finally:
        trainer.close()


@pytest.mark.parametrize("layout", ["data2_time2", "data2_model2"])
def test_dit_mesh_steps_equal_one_device(layout, request):
    """Two steps of the stage-2 trainer on data=2,time=2 (SP, the batch
    over data, the moments split over data) and on data=2,model=2 (TP on
    the head-major layout, ZeRO) against the port's one-device steps from
    the same generator seeds: each rank draws the whole batch's noise and
    takes its rows."""
    mesh = request.getfixturevalue("mesh_d2t2" if layout == "data2_time2"
                                   else "mesh_d2m2")
    _, tp = train_dit_params()
    ctrl, state, losses = _one_device_dit_two_steps()
    (mctrl, mstate), mlosses, _ = _mesh_dit(mesh, tp, 2)
    assert mlosses == pytest.approx(losses, rel=1e-5)
    _close_trees(mctrl, ctrl, atol=2e-5)
    _close_trees(mstate["mu"], state["mu"], atol=2e-6)
    assert mstate["count"] == state["count"] == 2


def test_padded_heads_stay_zero(mesh_d2m2):
    """3 heads of 16 over model=2 pad to 4 (tp_infer.prep_dit_tp): after
    two steps the padded head of the control layers is exactly 0 on its
    rank (no gradient, no decay, zero moments), and the gathered tree
    drops it and equals the one-device steps."""
    dc = dataclasses.replace(TC.dit, hidden_size=48, num_heads=3)
    cfg = dataclasses.replace(TC, dit=dc)
    gen = torch.Generator().manual_seed(3)
    p = fill_zero_leaves(tdi.init_params(gen, cfg), gen)
    ctrl, _, losses = _one_device_dit(p, 2, cfg)
    state, frozen = _dit_state(p, ttrain.make_optimizer(**OPT), cfg)
    trainer = tmt.MeshTrainer(mesh_d2m2, "dit", cfg, OPT, torch.float32,
                              state, frozen, zero_min_size=SMALL,
                              step_kw={"remat": False})
    try:
        mlosses = [float(trainer.step(_dit_batch(i, cfg), 40 + i)["loss"])
                   for i in range(2)]
        local = trainer.local_params()
        mctrl = trainer.state()[0]
    finally:
        trainer.close()
    assert mlosses == pytest.approx(losses, rel=1e-5)
    _close_trees(mctrl, ctrl, atol=2e-5)
    for coords, tree in local:
        for layer in tree["layers"]:
            assert layer["qkv_w"].shape[2] == 2
            if coords["model"] == 1:     # heads 2 and 3, 3 the padded one
                assert not layer["qkv_w"][:, :, 1].any()
                assert not layer["qkv_b"][:, 1].any()
                assert not layer["attn_out_w"][1].any()
                assert layer["qkv_w"][:, :, 0].any()


# ---------------------------------------------------------------------------
# (3) lm and vq under tensor parallelism and ZeRO


def _lm_batch(i):
    sched = ttrain._lm_schedule(TC)
    rng = np.random.default_rng(500 + i)
    return {"t5_feats": T(randn(600 + i, B, 8, TC.t5.d_model)),
            "codes": torch.from_numpy(rng.integers(
                0, TC.llm.codebook_size, (B, sched.num_visual)))}


def _vq_batch(i):
    t = TC.tokenizer.titok
    return {"features": T(randn(700 + i, B, t.temporal_size, t.grid_h,
                                t.grid_w, TC.tokenizer.feature_dim))}


@pytest.mark.parametrize("model", ["lm", "vq"])
def test_tp_zero_steps_equal_one_device(model, mesh_d2m2):
    """Two steps of the stage-1 (GPT_RULES, moments split over data) and
    tokenizer (TITOK_RULES, replicated state; the whole batch's k-means
    and EMA statistics) trainers on data=2,model=2 against train.py's
    one-device steps from the same seeds."""
    batch = _lm_batch if model == "lm" else _vq_batch
    opt = ttrain.make_optimizer(**OPT)
    state, run, _ = ttrain.SETUPS[model](TC, opt, torch.device("cpu"),
                                         torch.float32)
    start = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                     else x, state)
    losses = []
    for i in range(2):
        state, m = run(state, batch(i), torch.Generator().manual_seed(60 + i))
        losses.append(float(m["loss" if model == "lm" else "total_loss"]))
    trainer = tmt.MeshTrainer(mesh_d2m2, model, TC, OPT, torch.float32,
                              start, zero_min_size=SMALL)
    try:
        got = [trainer.step(batch(i), 60 + i) for i in range(2)]
        mstate = trainer.state()
        report = trainer.report()
    finally:
        trainer.close()
    key = "loss" if model == "lm" else "total_loss"
    assert [float(m[key]) for m in got] == pytest.approx(losses, rel=1e-5)
    _close_trees(mstate[0], state[0], atol=2e-5)
    if model == "vq":
        _close_trees(mstate[2], state[2], atol=1e-5)
        assert mstate[3] is False
    # per rank: its model part of the parameters; the state split over
    # data too for lm (zero.opt_state_bytes_per_device at the local shapes)
    for r in report:
        assert r["param_bytes"] < tmesh.tree_nbytes(state[0])
        full_opt = r["param_bytes"] * 2
        assert r["opt_bytes"] < full_opt if model == "lm" \
            else r["opt_bytes"] == full_opt


def test_zero_spec_and_rules_match_jax():
    """_zero_spec equals JAX's on a list of shapes; param_specs under
    DIT_RULES and TITOK_RULES equal JAX's param_specs(mesh=None) on the
    stage-2 and tokenizer trees."""
    for shape in [(), (7,), (300, 300), (4096,), (256, 512), (512, 256),
                  (3, 65536), (2, 3, 1024, 64), (255, 257), (64, 64, 16)]:
        for n in (2, 4):
            got = tzero._zero_spec(shape, n)
            want = tuple(jzero._zero_spec(np.zeros(shape, np.int8), "data",
                                          n, 2 ** 16))
            assert got == (None if not any(want) else want.index("data")), \
                (shape, n, want)
    jp, tp = train_dit_params()
    from landiff_tpu_torch.models import vq as tvq
    vq = tvq.init(torch.Generator().manual_seed(0), TC.tokenizer,
                  with_theia=False)
    for tree, rules in ((tp["control"], "DIT_RULES"), (vq, "TITOK_RULES")):
        arrays = to_jax_layout(tree)
        want = jmesh.param_specs(arrays, getattr(jmesh, rules))
        got = tmesh.param_specs(tree, getattr(tmesh, rules))
        got_d = {}
        tmesh.map_with_path(
            lambda p, s: got_d.__setitem__("/".join(p), s), got)
        want_d = {jmesh._path_str(p): tuple(s) for p, s in
                  jax.tree_util.tree_flatten_with_path(
                      want, is_leaf=lambda s: isinstance(
                          s, jax.sharding.PartitionSpec))[0]}
        assert got_d == want_d and any(any(s) for s in got_d.values())
    sharded, total = tzero.opt_state_bytes_per_device(
        {"mu": {"a": torch.zeros(512, 256), "b": torch.zeros(8)}}, 2)
    assert (sharded, total) == (512 * 256 * 2 + 32, 512 * 256 * 4 + 32)


# ---------------------------------------------------------------------------
# (4) train.py


@pytest.mark.parametrize("model,layout", [("dit", "mesh_t2"),
                                          ("lm", "mesh_d2m2"),
                                          ("vq", "mesh_d2m2")])
def test_train_mesh_smoke(model, layout, tmp_path, request):
    """train(mesh_spec=a Mesh) for the three components (as the JAX
    package's trainer smoke tests): finite metrics, the state back in one
    device's layout, the mesh left open for the caller. (dit's
    tensor-parallel step, the same MeshTrainer, is held to one device
    above.)"""
    mesh = request.getfixturevalue(layout)
    ttrain.synthesize(model, TC, 4, tmp_path / "d", shard_size=4)
    state, last = ttrain.train(model, str(tmp_path / "d"), steps=2,
                               batch_size=2, tiny=True, mesh_spec=mesh,
                               device="cpu", log_every=1)
    assert all(np.isfinite(float(v)) for v in last.values())
    opt = ttrain.make_optimizer(1e-4, 2)
    ref, _, _ = ttrain.SETUPS[model](TC, opt, torch.device("cpu"),
                                     torch.float32)
    for a, b in zip(tree_leaves(state[0]), tree_leaves(ref[0])):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert not mesh._closed


def test_mesh_checkpoint_resumes_on_one_device(tmp_path, mesh_d2m2):
    """Two lm steps on data=2,model=2 with a checkpoint, then the third
    resumed on one device, equal the three steps uninterrupted on one
    device: the gathered step_2.pt is the file one device writes."""
    ttrain.synthesize("lm", TC, 8, tmp_path / "d", shard_size=4)
    kw = dict(batch_size=2, tiny=True, device="cpu", log_every=1, lr=LR)
    ref, _ = ttrain.train("lm", str(tmp_path / "d"), steps=3, **kw)
    ttrain.train("lm", str(tmp_path / "d"), steps=2, mesh_spec=mesh_d2m2,
                 ckpt_dir=str(tmp_path / "c"), **kw)
    got, _ = ttrain.train("lm", str(tmp_path / "d"), steps=3, resume=True,
                          ckpt_dir=str(tmp_path / "c"), **kw)
    _close_trees(got[0], ref[0], atol=2e-5)
    assert got[1]["count"] == 3


def test_vq_mesh_resume_keeps_its_codebook(tmp_path, mesh_d2m2):
    """A vq step on the mesh, a checkpoint, then a resumed step on the
    mesh: the k-means flag comes back False, so the resumed step does not
    re-initialise the codebook, and the run equals two uninterrupted mesh
    steps (as the JAX package's vq resume test)."""
    ttrain.synthesize("vq", TC, 4, tmp_path / "d", shard_size=4)
    kw = dict(batch_size=2, tiny=True, device="cpu", log_every=1,
              mesh_spec=mesh_d2m2)
    ref, _ = ttrain.train("vq", str(tmp_path / "d"), steps=2, **kw)
    one, _ = ttrain.train("vq", str(tmp_path / "d"), steps=1,
                          ckpt_dir=str(tmp_path / "c"), **kw)
    assert one[3] is False and bool(one[2]["initted"])
    got, _ = ttrain.train("vq", str(tmp_path / "d"), steps=2, resume=True,
                          ckpt_dir=str(tmp_path / "c"), **kw)
    _close_trees(got[0], ref[0], atol=1e-6)
    assert not torch.equal(got[0]["quant"]["codebook"],
                           one[0]["quant"]["codebook"])


def test_mesh_grad_accum_matches_one_device(tmp_path, mesh_d2m2):
    """grad_accum=2 on data=2,model=2: MultiSteps' accumulator split over
    data like the moments; four micro-steps make two updates equal to one
    device's."""
    ttrain.synthesize("lm", TC, 8, tmp_path / "d", shard_size=4)
    kw = dict(steps=4, batch_size=2, tiny=True, device="cpu", log_every=1,
              grad_accum=2, lr=LR)
    ref, _ = ttrain.train("lm", str(tmp_path / "d"), **kw)
    got, _ = ttrain.train("lm", str(tmp_path / "d"), mesh_spec=mesh_d2m2,
                          **kw)
    assert got[1]["gradient_step"] == 2 and got[1]["mini_step"] == 0
    _close_trees(got[0], ref[0], atol=2e-5)


def test_main_takes_mesh_on_the_cpu(tmp_path):
    """The CLI: --mesh data=2 --device cpu makes two CPU ranks, trains and
    closes them."""
    metrics = tmp_path / "m.jsonl"
    ttrain.main(["--model", "lm", "--data", str(tmp_path / "d"), "--synth",
                 "4", "--tiny", "--device", "cpu", "--mesh", "data=2",
                 "--steps", "2", "--batch-size", "2", "--log-every", "1",
                 "--metrics", str(metrics)])
    assert len(metrics.read_text().splitlines()) == 2


def test_sr_updates_on_a_mesh_draw_the_whole_leaves_bits(mesh_d2m2):
    """bf16 masters with stochastic rounding on data=2,model=2: every rank
    draws the bits of the whole one-device leaves from the step's seed (in
    the one-device step's order) and takes its part, so two steps give
    the one-device step's parameters but where an update lands within a
    rounding of a bf16 boundary (the gradients are summed in another
    order) and where such an element then moves the second update.
    Readings: 1.5 % of the elements differ, by at most 3.25 bf16 steps of
    the larger of the element and the learning rate; limits 3 % and six
    steps (test_torch_port_train_dit.py's step limit against JAX)."""
    _, tp = train_dit_params(control_dtype=(jnp.bfloat16, torch.bfloat16))
    opt = ttrain.make_optimizer(**OPT)
    step = tdl.make_train_step(opt, TC.dit, TC.sampler, TC.tokenizer,
                               TC.semantic_cond, compute_dtype=torch.float32,
                               remat=False, sr_updates=True)
    (ctrl, state), frozen = _dit_state(tp, opt)
    for i in range(2):
        b = _dit_batch(i)
        ctrl, state, _ = step(ctrl, state, frozen["main"], frozen["sem"],
                              b["latents"], b["context"], b["tokens"],
                              torch.Generator().manual_seed(40 + i))
    (mctrl, _), _, _ = _mesh_dit(mesh_d2m2, tp, 2,
                                 step_kw={"sr_updates": True})
    diff = total = worst = 0
    for a, b in zip(tree_leaves(mctrl), tree_leaves(ctrl)):
        assert a.dtype == b.dtype == torch.bfloat16
        a, b = a.float().numpy(), b.float().numpy()
        step_size = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), LR))) - 7)
        worst = max(worst, float((np.abs(a - b) / step_size).max()))
        diff += int((a != b).sum())
        total += a.size
    assert worst <= 6.0 and diff <= 0.03 * total, (worst, diff / total)
    moved = [not torch.equal(a, b) for a, b in
             zip(tree_leaves(mctrl), tree_leaves(tp["control"]))]
    assert any(moved)


def test_freeze_tree_and_tree_cast():
    """utils.freeze_tree cuts the gradient of a subtree (JAX's
    stop_gradient at use); tree_cast casts the floating leaves alone
    (JAX utils.py:124-157)."""
    from landiff_tpu_torch.utils import freeze_tree, tree_cast

    w = torch.ones(3, requires_grad=True)
    tree = {"w": w, "n": torch.arange(3), "s": "name"}
    frozen = freeze_tree(tree)
    assert not frozen["w"].requires_grad and frozen["s"] == "name"
    loss = (frozen["w"] * w).sum()
    (g,) = torch.autograd.grad(loss, w)
    assert torch.equal(g, torch.ones(3))      # one path, not two
    cast = tree_cast(tree, torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16
    assert cast["n"].dtype == torch.int64 and cast["s"] == "name"
