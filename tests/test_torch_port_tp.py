"""PyTorch port: tensor-parallel inference over a (data, model) mesh of
ranks (landiff_tpu_torch/parallel/) held against the JAX package's
parallel/ at the tiny config, on the CPU: the ranks are worker processes
on the CPU joined by gloo (make_mesh(..., devices=["cpu"] * n)), one
mesh per layout for the module. The JAX sides run in this process only.

Tolerances: the TP model call against JAX's unsharded one at JAX's own
2e-4 (test_tp_infer.py:84); W8A8 against JAX's forward_tp run per shard
(jax.vmap over a `model` axis) at 2e-6 absolute; a whole request under the mesh
against the port's unsharded one: codes equal, latents to 5e-4, video
within one uint8 step (test_tp_infer.py:162-183)."""

import dataclasses
import functools
import logging
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import gumbel_steps, randn, stage1_params, \
    stage2_params, to_jax_layout
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu import config as jcfg
from landiff_tpu.models import dit as jdit
from landiff_tpu.models import gpt as jgpt
from landiff_tpu.parallel import mesh as jmesh
from landiff_tpu.parallel import plan as jplan
from landiff_tpu.parallel import tp_infer as jtp
from landiff_tpu.pipeline import llm_infer as jli
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.diffusion import engine as teng
from landiff_tpu_torch.models import dit as tdit
from landiff_tpu_torch.models import gpt as tgpt
from landiff_tpu_torch.parallel import mesh as tmesh
from landiff_tpu_torch.parallel import plan as tplan
from landiff_tpu_torch.parallel import tp_infer as ttp
from landiff_tpu_torch.pipeline import dif_infer as tdi
from landiff_tpu_torch.pipeline import infer_video as tiv
from landiff_tpu_torch.pipeline import llm_infer as tli
from landiff_tpu_torch.utils import fill_zero_leaves

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
T = torch.from_numpy
PROMPT = "a red panda climbs a tree"


def _mesh(data, model):
    return tmesh.make_mesh(tcfg.MeshConfig(data=data, model=model),
                           devices=["cpu"] * (data * model), timeout_s=120)


@pytest.fixture(scope="module")
def mesh2():
    m = _mesh(1, 2)
    yield m
    m.close()


@pytest.fixture(scope="module")
def mesh22():
    m = _mesh(2, 2)
    yield m
    m.close()


def _padded_cfgs():
    """3 heads of 16 (hidden 48): the production 30-over-4 padding in
    miniature (test_tp_infer.py:93-100)."""
    return (dataclasses.replace(JC.dit, hidden_size=48, num_heads=3),
            dataclasses.replace(TC.dit, hidden_size=48, num_heads=3))


@functools.lru_cache(maxsize=2)
def _dit_params(padded: bool):
    """(JAX, port) main + control DiT trees, zero leaves filled; the
    padding case's from the port's init at 3 heads."""
    if not padded:
        jp, tp = stage2_params()
        return ({k: jp[k] for k in ("main", "control", "semantic")},
                {k: tp[k] for k in ("main", "control", "semantic")})
    _, tdc = _padded_cfgs()
    gen = torch.Generator().manual_seed(3)
    tp = fill_zero_leaves({"main": tdit.init(gen, tdc),
                           "control": tdit.init(gen, tdc, control=True)},
                          gen)
    jp = jax.tree_util.tree_map(jnp.asarray, to_jax_layout(tp))
    return jp, tp


def _jslice(a, spec, coords, sizes):
    a = np.asarray(a)
    for d, ax in enumerate(tuple(spec)):
        if ax is not None:
            n = a.shape[d] // sizes[ax]
            a = np.take(a, range(coords[ax] * n, (coords[ax] + 1) * n),
                        axis=d)
    return a


def _bits(a):
    """bfloat16 as its bits, to compare bit for bit."""
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _flat(tree):
    return [_bits(x) for x in jax.tree_util.tree_leaves(tree)]


def _port_np(tree):
    """The port's tree as numpy in JAX's layouts: only the patch conv
    kernel is a conv (OIHW -> HWIO); the tp layout's 4-D qkv_w is not."""
    def leaf(path, t):
        a = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        return np.transpose(a, (2, 3, 1, 0)) if path[-1] == "patch_w" else a

    return tmesh.map_with_path(leaf, tree)


def _assert_trees_equal(port_tree, jax_tree):
    got = _flat(_port_np(port_tree))
    want = _flat(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# (1) the prep, (2) the shards, (3) the plan


@pytest.mark.parametrize("tp,padded", [(2, False), (4, False), (4, True)])
def test_prep_and_quantize_match_jax_bit_for_bit(tp, padded):
    jp, tp_ = _dit_params(padded)
    jdc, tdc = _padded_cfgs() if padded else (JC.dit, TC.dit)
    for int8 in (False, True):
        want = jtp.prep_dit_tp(jp["main"], jdc, tp, int8=int8)
        got = ttp.prep_dit_tp(tp_["main"], tdc, tp, int8=int8)
        _assert_trees_equal(got, want)
    lay = got["layers"][0]
    assert lay["qkv_w"]["q"].shape[2] == ttp.pad_heads(tdc.num_heads, tp)
    if padded:          # the pad head's codes are zero
        assert not lay["qkv_w"]["q"][:, :, -1].any()
    # the int8 codes of a shard are the column-major operand of _int_mm
    q = ttp.dit_shards(tp_["main"], tdc, tcfg.MeshConfig(model=tp),
                       ["cpu"] * tp, int8=True)[1]["layers"][0]["qkv_w"]["q"]
    assert q.reshape(tdc.hidden_size, -1).stride(0) == 1


@pytest.mark.parametrize("tp", [2, 4])
def test_rank_shards_equal_the_jax_tree_sliced_by_its_specs(tp):
    """DiT: prep_dit_tp sliced by dit_tp_specs (bf16 and W8A8); T5 and the
    GPT (plain and int8 {q, s}) by param_specs over a JAX mesh, the GPT's
    wqkv per head inside q, k and v (a contiguous column split would mix
    q and k heads), its head (vocab 39) whole as _fit_spec leaves it."""
    mcfg = tcfg.MeshConfig(model=tp)
    jm = jmesh.make_mesh(jcfg.MeshConfig(model=tp), jax.devices()[:tp])
    sizes = {"data": 1, "model": tp, "time": 1}
    jp, tparams = _dit_params(False)
    for int8 in (False, True):
        prepped = jtp.prep_dit_tp(jp["main"], JC.dit, tp, int8=int8)
        specs = jtp.dit_tp_specs(prepped)
        shards = ttp.dit_shards(tparams["main"], TC.dit, mcfg, ["cpu"] * tp,
                                int8=int8)
        for r in range(tp):
            want = jax.tree_util.tree_map(
                lambda a, s: _jslice(a, s, {"model": r}, sizes), prepped,
                specs)
            _assert_trees_equal(shards[r], want)
    j1, t1 = stage1_params()
    t5_specs = jmesh.param_specs(j1["t5"], jmesh.T5_RULES, jm)
    t5 = ttp.t5_shards(t1["t5"], TC.t5, mcfg, ["cpu"] * tp)
    whole = TC.t5.num_heads % tp != 0        # 2 heads over 4: replicated
    for r in range(tp):
        want = j1["t5"] if whole else jax.tree_util.tree_map(
            lambda a, s: _jslice(a, s, {"model": r}, sizes), j1["t5"],
            t5_specs)
        _assert_trees_equal(t5[r], want)
    for quant in (False, True):
        jl, tl = dict(j1["lm"]), dict(t1["lm"])
        if quant:
            jl["gpt"], tl["gpt"] = (jgpt.quantize_int8(jl["gpt"]),
                                    tgpt.quantize_int8(tl["gpt"]))
        specs = jmesh.param_specs(jl, jmesh.GPT_RULES, jm)
        H, Dk = JC.llm.num_heads, JC.llm.head_dim
        shards = ttp.lm_shards(tl, TC.llm, mcfg, ["cpu"] * tp)
        for r in range(tp):
            def cut(path, a, s):
                keys = [str(getattr(k, "key", k)) for k in path]
                if "wqkv" in keys[-2:]:      # per head in q, k and v
                    a = np.asarray(a)
                    h = a.reshape(*a.shape[:-1], 3, H, Dk)
                    return h[..., r * H // tp:(r + 1) * H // tp, :].reshape(
                        *a.shape[:-1], -1)
                return _jslice(a, s, {"model": r}, sizes)

            want = jax.tree_util.tree_map_with_path(cut, jl, specs)
            _assert_trees_equal(shards[r], want)
            assert tuple(shards[r]["gpt"]["head"].shape) == (
                TC.llm.hidden_size, TC.llm.vocab_size)


@pytest.mark.parametrize("model", [1, 2, 4, 8])
def test_plan_matches_jax_plan(model):
    """Per component, total and per rank, at the full config: equal to
    JAX's plan but where the port places the DiT otherwise (JAX's plan
    counts DIT_RULES on unpadded shapes): dit_control per rank carries
    zero_linear whole, (1 - 1/model) of its bytes more; at a model that
    does not divide 30 heads, each layer's padded heads add their q, k, v
    columns, biases and attn-out rows per rank, and JAX's padded config
    shrinks qk-LN to head_dim 60 (total and per rank)."""
    mcfg = tcfg.MeshConfig(model=model)
    got = tplan.plan(mcfg)
    want = jplan.plan(jcfg.MeshConfig(model=model))
    d = tcfg.LanDiffConfig().dit
    D, H, Dk, b = d.hidden_size, d.num_heads, d.head_dim, 2
    Hp = ttp.pad_heads(H, model)
    pad_per_layer = (D * 3 + 3 + D) * (Hp - H) * Dk * b // model
    qk_ln = 4 * (Dk - D // Hp) * b if model > 1 else 0
    zl = D * D * b - D * D * b // model
    for name, w in want["components"].items():
        g = got["components"][name]
        if name.startswith("dit") and model > 1:
            layers = d.num_layers if name == "dit_main" else d.control_layers
            extra = layers * (pad_per_layer + qk_ln) + (
                layers * zl if name == "dit_control" else 0)
            assert g["per_chip_bytes"] == w["per_chip_bytes"] + extra, name
            assert g["total_bytes"] == w["total_bytes"] + layers * qk_ln
        else:
            assert g == w, name
    assert got["h100_hbm_fraction"] > 0


# ---------------------------------------------------------------------------
# (4) the model call, (5) its collectives


def _cfg_batch(dc, seed=0):
    x = randn(seed, 1, dc.latent_frames, dc.in_channels, dc.latent_height,
              dc.latent_width)
    ctx = randn(seed + 1, 1, dc.text_length, dc.text_dim)
    sem = randn(seed + 2, *x.shape)
    return (np.concatenate([x, x]), np.array([421.0, 421.0], np.float32),
            np.concatenate([np.zeros_like(ctx), ctx]),
            np.concatenate([sem, sem]))


@functools.lru_cache(maxsize=2)
def _jax_model_call(padded: bool):
    jp, _ = _dit_params(padded)
    jdc = _padded_cfgs()[0] if padded else JC.dit
    x2, ts, c2, s2 = _cfg_batch(jdc)
    out = jax.jit(functools.partial(jdit.control_warp_forward, cfg=jdc,
                                    compute_dtype=jnp.float32))(
        jp["main"], jp["control"], x2, ts, c2, semantic_feature=s2)
    return np.asarray(out)


def _load_dit(mesh, key, padded=False, int8=False):
    _, tp = _dit_params(padded)
    tdc = _padded_cfgs()[1] if padded else TC.dit
    for k in ("main", "control"):
        tmesh.load(mesh, key, k, ttp.dit_shards(
            tp[k], tdc, mesh.cfg, mesh.devices, int8=int8,
            dtype=torch.float32))
    return tdc


def _tp_call(mesh, key, tdc):
    mesh.run(ttp.rank_report, True)
    x2, ts, c2, s2 = (T(a) for a in _cfg_batch(tdc))
    out = mesh.run(ttp.model_call, key, x2, ts, c2, s2, tdc,
                   torch.float32)[0]
    return out.numpy(), mesh.run(ttp.rank_report, True)


@pytest.mark.parametrize("layout,padded", [("model2", False),
                                           ("data2_model2", False),
                                           ("model2", True)])
def test_tp_model_call_matches_jax_and_counts_collectives(
        layout, padded, request):
    """The sharded CFG-batch model call (rows on `data` where data=2)
    against JAX's unsharded control_warp_forward in f32; every rank reads
    exactly 2 (L + Lc) all-reduces (test_tp_infer.py:109-125) and, with
    data=2, one all-gather of the rows."""
    mesh = request.getfixturevalue("mesh22" if layout == "data2_model2"
                                   else "mesh2")
    tdc = _load_dit(mesh, f"dit/{padded}", padded)
    got, reports = _tp_call(mesh, f"dit/{padded}", tdc)
    want = _jax_model_call(padded)
    assert float(np.abs(want).max()) > 1e-2
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    for rep in reports:
        assert rep["collectives"]["all_reduce"] == 2 * (
            tdc.num_layers + tdc.control_layers), rep
        assert rep["collectives"]["all_gather"] == mesh.cfg.data - 1, rep


def test_tp_w8a8_matches_jax_forward_tp_per_shard(mesh2):
    """W8A8 after the prep: the port's sharded call against JAX's
    forward_tp on the same int8 shards, run per shard with
    jax.vmap(axis_name="model") in place of a mesh."""
    tp = 2
    jp, _ = _dit_params(False)
    x2, ts, c2, s2 = _cfg_batch(JC.dit)

    def stacked(tree):
        specs = jtp.dit_tp_specs(tree)
        split = lambda a, s: (jnp.stack(jnp.split(a, tp, tuple(s).index(
            "model"))) if "model" in tuple(s) else a)
        axes = lambda a, s: 0 if "model" in tuple(s) else None
        return (jax.tree_util.tree_map(split, tree, specs),
                jax.tree_util.tree_map(axes, tree, specs))

    (mp, ma), (cp, ca) = (stacked(jtp.prep_dit_tp(jp[k], JC.dit, tp,
                                                  int8=True))
                          for k in ("main", "control"))
    fwd = jax.vmap(
        lambda m, c: jdit.control_warp_forward_tp(
            m, c, x2, ts, c2, JC.dit, s2, axis="model",
            compute_dtype=jnp.float32),
        in_axes=(ma, ca), axis_name="model")
    want = np.asarray(jax.jit(fwd)(mp, cp))
    np.testing.assert_array_equal(want[0], want[1])
    _load_dit(mesh2, "dit/int8", int8=True)
    got, _ = _tp_call(mesh2, "dit/int8", TC.dit)
    # 6e-7 apart here, while the quantization moves the output 1.2e-5
    np.testing.assert_allclose(got, want[0], rtol=0, atol=2e-6)
    assert np.abs(got - _jax_model_call(False)).max() > 5e-6


# ---------------------------------------------------------------------------
# (6) T5 and stage 1


@pytest.mark.parametrize("quant", ["f32", "int8"])
def test_stage1_t5_and_codes_under_model2_match_jax(quant, mesh2,
                                                    monkeypatch, caplog):
    """The stage-1 wrapper on the mesh: its T5 features (the relative
    bias sliced to each rank's heads) and its codes from the same Gumbel
    draws equal JAX's unsharded ones, with the blocks in f32 and as int8
    {q, s} leaves (LANDIFF_DECODE_INT8); LANDIFF_DECODE_INT4 is ignored
    under the mesh with JAX's warning."""
    if quant == "int8":
        monkeypatch.setenv("LANDIFF_DECODE_INT8", "1")
    seed = 3
    j1, t1 = stage1_params()
    kw = dict(num_frames=TC.llm.frames_per_segment, seed=seed)
    jw = jli.ArModelInferWrapper(j1, JC.llm, JC.t5, jcfg.ARSampleConfig(**kw),
                                 compute_dtype=jnp.float32)
    with caplog.at_level(logging.WARNING):
        tw = tli.ArModelInferWrapper(
            t1, TC.llm, TC.t5, tcfg.ARSampleConfig(**kw),
            compute_dtype=torch.float32, mesh=mesh2,
            int4_decode=quant == "int8", device="cpu")
    assert ("LANDIFF_DECODE_INT4 ignored" in caplog.text) == (quant == "int8")
    local = tw.params["lm"]["gpt"]["blocks"][0]["wqkv"]
    local = local["q"] if quant == "int8" else local
    assert local.shape[1] == 3 * TC.llm.hidden_size // 2
    want_feats, n = jw.encode_text(PROMPT)
    got_feats, n_got = tw.encode_text(PROMPT)
    assert n == n_got
    np.testing.assert_allclose(got_feats.numpy(), np.asarray(want_feats),
                               rtol=1e-4, atol=1e-4)
    want = jw(jli.CodeTask("x.npy", PROMPT))
    steps = TC.llm.iframe_len + (kw["num_frames"] - 1) * TC.llm.pframe_len \
        + 2 * kw["num_frames"]
    got = tw(tli.CodeTask("x.npy", PROMPT),
             gumbel=gumbel_steps(seed, steps, TC.llm.vocab_size))
    np.testing.assert_array_equal(got.result, np.asarray(want.result))
    assert len(set(got.result.tolist())) > 1
    batch = tw.infer_batch([tli.CodeTask("x.npy", PROMPT)])
    seeded = tw(tli.CodeTask("x.npy", PROMPT))
    np.testing.assert_array_equal(batch[0].result, seeded.result)


def test_stage1_head_split_over_model_gathers_logits(mesh2):
    """A vocab that divides `model` (codebook 33: 40 entries) splits the
    head by columns (GPT_RULES) and gathers the logits: the codes equal
    the unsharded wrapper's (f32, the same seeded draws)."""
    llm_cfg = dataclasses.replace(TC.llm, codebook_size=33)
    gen = torch.Generator().manual_seed(8)
    params = fill_zero_leaves(tli.init_params(gen, llm_cfg, TC.t5), gen)
    sc = tcfg.ARSampleConfig(num_frames=llm_cfg.frames_per_segment, seed=2)
    kw = dict(compute_dtype=torch.float32, device="cpu")
    want = tli.ArModelInferWrapper(params, llm_cfg, TC.t5, sc, **kw)(
        tli.CodeTask("x.npy", PROMPT))
    tw = tli.ArModelInferWrapper(params, llm_cfg, TC.t5, sc, mesh=mesh2,
                                 **kw)
    assert tuple(tw.params["lm"]["gpt"]["head"].shape) == (
        llm_cfg.hidden_size, llm_cfg.vocab_size // 2)
    got = tw(tli.CodeTask("x.npy", PROMPT))
    np.testing.assert_array_equal(got.result, want.result)


# ---------------------------------------------------------------------------
# (7) prompt -> video, (8) long video, (10) the guidance window


def _filled_init(monkeypatch):
    """build_pipeline's random init with its zero leaves filled, so that
    attention, the MLPs and the control path all reach the output."""
    for mod in (tli, tdi):
        orig = mod.init_params
        monkeypatch.setattr(
            mod, "init_params",
            lambda gen, *a, _o=orig: fill_zero_leaves(_o(gen, *a), gen))


def _pipelines(monkeypatch, mesh, frames):
    _filled_init(monkeypatch)
    sc = tcfg.ARSampleConfig(num_frames=frames, seed=4)
    kw = dict(seed=0, compute_dtype=torch.float32, device="cpu")
    return (tiv.build_pipeline(TC, sc, **kw),
            tiv.build_pipeline(TC, sc, mesh=mesh, **kw))


def _assert_same_request(got, want):
    np.testing.assert_array_equal(got["codes"], want["codes"])
    assert float(np.abs(want["latent"]).max()) > 1e-2
    np.testing.assert_allclose(got["latent"], want["latent"], rtol=5e-4,
                               atol=5e-4)
    steps = np.abs(np.round(got["video"] * 255.0)
                   - np.round(want["video"] * 255.0))
    assert steps.max() <= 1.0


@pytest.mark.parametrize("segments", [1, 2])
def test_pipeline_under_mesh_equals_unsharded(segments, mesh2, monkeypatch):
    """build_pipeline(mesh=...) prompt -> codes -> video (segments=2: the
    long-video loop as one command, its closures sharing the sharded
    net) equals the port's unsharded request; every rank's codes agree
    (the wrapper raises otherwise)."""
    (llm, dif), (tllm, tdif) = _pipelines(
        monkeypatch, mesh2, segments * TC.llm.frames_per_segment)
    assert tdif.mesh is mesh2 and tdif.params["main"]["layers"][0][
        "qkv_w"].shape[2] == TC.dit.num_heads // 2
    want = tiv.generate(llm, dif, PROMPT, seed=3)
    got = tiv.generate(tllm, tdif, PROMPT, seed=3)
    assert len(got["codes"]) == segments * TC.tokenizer.titok.latent_tokens
    _assert_same_request(got, want)
    if segments == 1:
        monkeypatch.setenv("LANDIFF_OFFLOAD", "1")
        again = tiv.generate(tllm, tdif, PROMPT, seed=3)
        assert tdif.offloaded and "offload" in again["stage2_phases"]
        again = tiv.generate(tllm, tdif, PROMPT, seed=3)
        assert "restage" in again["stage2_phases"]
        np.testing.assert_array_equal(again["video"], got["video"])


def test_cfg_window_under_mesh(mesh2, monkeypatch, caplog):
    """An environment LANDIFF_CFG_WINDOW is dropped with a warning and the
    request runs full CFG (JAX engine.py:182-197); an explicit cfg_window
    on the sharded closure raises."""
    jp, tp = stage2_params()
    dif = tdi.CogModelInferWrapper(tp, TC, compute_dtype=torch.float32,
                                   mesh=mesh2, device="cpu")
    codes = np.random.default_rng(2).integers(
        0, TC.tokenizer.vq.codebook_size, TC.tokenizer.titok.latent_tokens)
    task = tdi.VideoTask("x", PROMPT, 5, semantic_token=codes)
    full = dif(task)
    monkeypatch.setenv("LANDIFF_CFG_WINDOW", "1,3")
    with caplog.at_level(logging.WARNING):
        windowed = dif(task)
    assert "LANDIFF_CFG_WINDOW ignored" in caplog.text
    np.testing.assert_array_equal(windowed.latent, full.latent)
    st = mesh2.ctx.state[dif.key]
    ctx = torch.zeros(1, TC.dit.text_length, TC.dit.text_dim)
    fn = ttp.make_tp_denoise_fn(
        mesh2.ctx, st["main"], st["control"], st["semantic"], TC.dit,
        TC.sampler, TC.tokenizer, TC.semantic_cond, ctx, ctx,
        T(codes).reshape(1, -1), compute_dtype=torch.float32)
    assert getattr(fn, "cond_only", None) is None
    with pytest.raises(ValueError, match="cond_only"):
        teng.sample_latents(fn, TC.sampler, TC.dit,
                            generator=torch.Generator().manual_seed(0),
                            cfg_window=(1, 3))


# ---------------------------------------------------------------------------
# (9) serving, (11) failures


def test_serving_engine_on_a_mesh():
    """ServingEngine.build(mesh_spec="model=2") serves a request, equal to
    the unsharded engine's; shutdown stops the mesh's worker."""
    from landiff_tpu_torch.serving.scheduler import ServingEngine

    eng = ServingEngine.build(tiny=True, mesh_spec="model=2", device="cpu",
                              linger_s=0.0)
    try:
        got = eng.generate(PROMPT, seed=3)
        procs = list(eng.dif.mesh._procs)
    finally:
        eng.shutdown()
    assert not any(p.is_alive() for p in procs)
    ref = ServingEngine.build(tiny=True, device="cpu", linger_s=0.0)
    try:
        want = ref.generate(PROMPT, seed=3)
    finally:
        ref.shutdown()
    np.testing.assert_array_equal(got["codes"], want["codes"])
    np.testing.assert_allclose(got["video"], want["video"], atol=1 / 255.0)


def test_a_failing_rank_makes_rank_0_raise():
    """A worker that raises makes rank 0 raise with the worker's
    traceback, within seconds, and closes the mesh; so does a worker that
    is gone."""
    mesh = _mesh(1, 2)
    t0 = time.monotonic()
    with pytest.raises(tmesh.MeshError, match="(?s)rank 1.*AttributeError"):
        mesh.run(getattr, per_rank=["rank", "no_such_attribute"])
    assert time.monotonic() - t0 < 30
    with pytest.raises(tmesh.MeshError, match="closed"):
        mesh.run(getattr, "rank")
    mesh = _mesh(1, 2)
    assert mesh.run(getattr, "rank") == [0, 1]
    mesh._procs[0].kill()
    t0 = time.monotonic()
    with pytest.raises(tmesh.MeshError, match="rank 1"):
        mesh.run(getattr, "rank")
    assert time.monotonic() - t0 < 30
