"""PyTorch port: sequence- and context-parallel inference over the `time`
axis of a mesh (landiff_tpu_torch/parallel/ring_attention.py, vae_cp.py,
the sequence-parallel DiT and the 2-D hybrid) held against the JAX
package's unsharded functions at the tiny config, on the CPU: the ranks
are worker processes on the CPU joined by gloo, one mesh per layout for
the module. The JAX sides run unsharded, in this process only.

Tolerances (f32): the ring against dense attention at 2e-5 (JAX
test_vae_cp.py:56-73); the flash route's hops (the kernels' plain
versions, log2 lse) against the dense ring at 2e-5, the int8 hops against
one int8 call over the whole sequence at 2e-4 (JAX test_sp_infer.py:
213-247); the sequence-parallel denoise against JAX's unsharded one at
2e-4 (test_sp_infer.py:28-61), the W8A8 hybrid by corr > 0.999 and mean
relative drift < 0.03; the CP decode and encode at 2e-4
(test_vae_cp.py:22-55); a request under time=2 against the unsharded
one: codes equal, latents to 2e-4, video within one uint8 step."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import fast_jit, randn, stage2_params, \
    to_jax_layout
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu import config as jcfg
from landiff_tpu.diffusion import engine as jeng
from landiff_tpu.diffusion import schedule as jsched
from landiff_tpu.models import vae as jvae
from landiff_tpu.ops import attention as jattn
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.diffusion import engine as teng
from landiff_tpu_torch.models import dit as tdit
from landiff_tpu_torch.models import vae as tvae
from landiff_tpu_torch.ops import attention as tattn
from landiff_tpu_torch.parallel import mesh as tmesh
from landiff_tpu_torch.parallel import plan as tplan
from landiff_tpu_torch.parallel import ring_attention as tring
from landiff_tpu_torch.parallel import tp_infer as ttp
from landiff_tpu_torch.parallel import vae_cp as tcp
from landiff_tpu_torch.pipeline import dif_infer as tdi
from landiff_tpu_torch.pipeline import infer_video as tiv
from landiff_tpu_torch.pipeline import llm_infer as tli
from landiff_tpu_torch.utils import fill_zero_leaves

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
T = torch.from_numpy
PROMPT = "a red panda climbs a tree"
# test_vae_cp.py's small VAE
VAE_CFGS = [c(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=4,
              in_channels=3, out_channels=3, temporal_compress_level=1,
              norm_num_groups=4) for c in (jcfg.VAEConfig, tcfg.VAEConfig)]


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
def mesh_t4():
    m = _mesh(time=4)
    yield m
    m.close()


@pytest.fixture(scope="module")
def mesh_d2t2():
    m = _mesh(data=2, time=2)
    yield m
    m.close()


@pytest.fixture(scope="module")
def mesh_m2t2():
    m = _mesh(model=2, time=2)
    yield m
    m.close()


# ---------------------------------------------------------------------------
# (1) the layout, the plan, the split rules


def test_groups_follow_rank_coords():
    """Every rank's data, model and time groups are the ranks that share
    its other coordinates, in the order of their own (rank = (d * model +
    m) * time + t, JAX's (data, model, time) reshape)."""
    cfg = tcfg.MeshConfig(data=2, model=3, time=2)
    for r in range(cfg.num_devices):
        c = tmesh.rank_coords(cfg, r)
        assert tmesh.coords_rank(cfg, c) == r
        for axis in tmesh.AXES:
            members = tmesh.group_members(cfg, r, axis)
            assert members[c[axis]] == r
            for j, g in enumerate(members):
                assert tmesh.rank_coords(cfg, g) == {**c, axis: j}


@pytest.mark.parametrize("spec", ["data=1,time=2", "model=2,time=2"])
def test_plan_under_time(spec):
    """A time axis shards no weight: under "sp" the DiT per rank is the
    whole DiT, under "tpsp" the tp part of model=2 alone."""
    mcfg = tmesh.parse_mesh(spec)
    got = tplan.plan(mcfg, TC)["components"]
    base = tplan.plan(tcfg.MeshConfig(model=mcfg.model), TC)["components"]
    assert got == base
    if mcfg.model == 1:
        for name in ("dit_main", "dit_control"):
            assert got[name]["per_chip_bytes"] == got[name]["total_bytes"]
    assert ttp.mode(mcfg) == ("sp" if mcfg.model == 1 else "tpsp")


@pytest.mark.parametrize("n,ok", [(2, True), (3, True), (4, True),
                                  (6, True), (8, False), (12, False)])
def test_can_decode_cp_13_latents(n, ok):
    """13 latents decode context-parallel over 2, 3, 4 and 6 ranks, not 8
    (JAX vae_cp.py:280-285) nor 12 (one frame a rank, under the halo)."""
    assert tcp.can_decode_cp(13, n) is ok


def test_a_time_axis_that_does_not_divide_the_sequence_raises():
    """S % T != 0 is a ValueError (JAX asserts it): 80 tokens over 3
    ranks, and the full config's 17,776 over 3."""
    class Group:
        size, rank = 3, 0

    for S in (80, 17776):
        with pytest.raises(ValueError, match="does not split"):
            tdit._sp_slice(torch.zeros(1, S, 2), Group())


# ---------------------------------------------------------------------------
# (2) the ring


def test_ring_attention_matches_jax_dense(mesh_t4):
    """Ring attention over time=4 at (2, 32, 3, 8): JAX's unsharded
    mha_reference to 2e-5; every rank shifts k and v 3 times each."""
    q, k, v = (randn(s, 2, 32, 3, 8) for s in (0, 1, 2))
    want = np.asarray(jattn.mha_reference(q, k, v))
    mesh_t4.run(ttp.rank_report, True)
    got = tring.ring_attention(T(q), T(k), T(v), mesh_t4)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    for rep in mesh_t4.run(ttp.rank_report, True):
        assert rep["collectives"]["ring_shift"] == 2 * 3, rep
        assert rep["collectives"]["all_gather"] == 1, rep


@pytest.mark.parametrize("int8", [False, True])
def test_flash_hops_merge_in_log2(int8, mesh_t2, monkeypatch):
    """The flash route's hops (on the CPU the kernels' plain versions,
    with their log2 lse) merged in log2, at 640 positions a rank (the
    int8 form's "cached" rule holds): exact hops against the port's
    dense ring to 2e-5; int8 hops (LANDIFF_ATTN_INT8 default) against one
    int8 call over the whole kv to 2e-4 and correlated with the exact
    output. The route picks the hops by the env knob, as JAX's."""
    if not int8:
        monkeypatch.setenv("LANDIFF_ATTN_INT8", "0")
    q, k, v = (T(randn(s, 1, 1280, 2, 16)) for s in (3, 4, 5))
    dense = tring.ring_attention(q, k, v, mesh_t2, impl="xla")
    np.testing.assert_allclose(
        dense.numpy(), tattn.mha_reference(q, k, v).numpy(), rtol=2e-5,
        atol=2e-5)
    flash = tring.ring_attention(q, k, v, mesh_t2, impl="pallas")
    if int8:
        whole, _ = tattn.flash_int8_plain(q, k, v)
        np.testing.assert_allclose(flash.numpy(), whole.numpy(),
                                   rtol=2e-4, atol=2e-4)
        corr = np.corrcoef(flash.numpy().ravel(), dense.numpy().ravel())
        assert corr[0, 1] > 0.999
        assert np.abs(flash.numpy() - dense.numpy()).max() > 1e-5
    else:
        np.testing.assert_allclose(flash.numpy(), dense.numpy(), rtol=2e-5,
                                   atol=2e-5)


# ---------------------------------------------------------------------------
# (3) the sequence-parallel denoise and the hybrid


def _padded():
    """3 heads of 16 (hidden 48) with every stage-2 tree at that width:
    30 heads over model=4 in miniature (test_sp_infer.py:78-86)."""
    dc = dataclasses.replace(TC.dit, hidden_size=48, num_heads=3)
    return (dataclasses.replace(JC, dit=dataclasses.replace(
        JC.dit, hidden_size=48, num_heads=3)),
        dataclasses.replace(TC, dit=dc))


@functools.lru_cache(maxsize=2)
def _trees(padded: bool):
    """(JAX, port) main / control / semantic trees, zero leaves filled."""
    if not padded:
        jp, tp = stage2_params()
        return ({k: jp[k] for k in ("main", "control", "semantic")},
                {k: tp[k] for k in ("main", "control", "semantic")})
    _, tc = _padded()
    gen = torch.Generator().manual_seed(3)
    _, tp = stage2_params()
    tp = {"main": fill_zero_leaves(tdit.init(gen, tc.dit), gen),
          "control": fill_zero_leaves(tdit.init(gen, tc.dit, control=True),
                                      gen),
          "semantic": tp["semantic"]}
    return _jax_copy(tp), tp


def _jax_copy(tree):
    """The JAX package's layout of a port tree, copied: a CPU tensor sent
    to the ranks moves into shared memory, and a numpy view of it taken
    before would then read freed memory."""
    return jax.tree_util.tree_map(jnp.array, to_jax_layout(tree))


def _denoise_inputs(cfg):
    d = cfg.dit
    x = randn(11, 1, d.latent_frames, d.in_channels, d.latent_height,
              d.latent_width)
    ctx = randn(12, 1, d.text_length, d.text_dim)
    tokens = np.random.default_rng(13).integers(
        0, cfg.tokenizer.vq.codebook_size,
        (1, cfg.tokenizer.titok.latent_tokens)).astype(np.int32)
    t = jsched.sampler_tables(JC.sampler)
    step = {"alpha": np.float32(t["alpha"][1]),
            "timestep": np.int32(t["timestep"][1]),
            "cfg_scale": np.float32(t["cfg_scale"][1])}
    return x, ctx, tokens, step


@functools.lru_cache(maxsize=2)
def _jax_denoise(padded: bool):
    jc = _padded()[0] if padded else JC
    jp, _ = _trees(padded)
    x, ctx, tokens, step = _denoise_inputs(jc)
    fn, b = jeng.make_denoise_fn(
        jp["main"], jp["control"], jp["semantic"], jc.dit, jc.sampler,
        jc.tokenizer, jc.semantic_cond, ctx, np.zeros_like(ctx), tokens,
        compute_dtype=jnp.float32, attn_impl="xla")
    jstep = {"alpha": jnp.float32(step["alpha"]),
             "timestep": jnp.int32(step["timestep"]),
             "idx": jnp.int32(1), "cfg_scale": jnp.float32(step["cfg_scale"])}
    return np.asarray(jax.jit(fn)(x, jstep, b))


def _sp_denoise(mesh, padded=False, int8=False):
    """The denoise closure on every rank of `mesh` from dit_shards trees
    (the mesh's mode); rank 0's prediction and every rank's report."""
    tc = _padded()[1] if padded else TC
    _, tp = _trees(padded)
    key = f"sp/{padded}/{int8}"
    for k in ("main", "control"):
        tmesh.load(mesh, key, k, ttp.dit_shards(
            tp[k], tc.dit, mesh.cfg, mesh.devices, int8=int8,
            dtype=torch.float32))
    tmesh.load(mesh, key, "semantic",
               ttp.replicated(tp["semantic"], mesh.devices))
    x, ctx, tokens, step = _denoise_inputs(tc)
    step = {k: float(v) for k, v in step.items()}
    mesh.run(ttp.rank_report, True)
    out = mesh.run(ttp.denoise_call, key, tc, T(ctx), torch.zeros(
        ctx.shape), T(tokens).long(), T(x), step, torch.float32)[0]
    return out.numpy(), mesh.run(ttp.rank_report, True)


@pytest.mark.parametrize("layout", ["data2_time2", "time4"])
def test_sp_denoise_matches_jax(layout, request):
    """The sequence-parallel denoise (weights whole, 80 tokens over time,
    the text / video boundary 8 inside shard 0; the CFG rows over data)
    against JAX's unsharded engine.make_denoise_fn to 2e-4. Per rank: 2
    ring shifts a layer and hop (L + Lc layers), one all-gather of the
    main stream's tokens (the control taps stay on their rank) and, with
    data=2, one of the rows; no all-reduce."""
    mesh = request.getfixturevalue("mesh_d2t2" if layout == "data2_time2"
                                   else "mesh_t4")
    got, reports = _sp_denoise(mesh)
    want = _jax_denoise(False)
    assert float(np.abs(want).max()) > 1e-2
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    layers = TC.dit.num_layers + TC.dit.control_layers
    for rep in reports:
        c = rep["collectives"]
        assert c["ring_shift"] == 2 * (mesh.cfg.time - 1) * layers, rep
        assert c["all_gather"] == 1 + (mesh.cfg.data > 1), rep
        assert c["all_reduce"] == 0, rep


@pytest.mark.parametrize("int8", [False, True])
def test_hybrid_model2_time2_padded_heads(int8, mesh_m2t2):
    """The 2-D hybrid (heads over model=2, tokens over time=2) with 3
    heads padded to 4: against JAX's unsharded denoise to 2e-4, and with
    W8A8 after the tp prep within corr > 0.999, mean relative < 0.03
    (test_sp_infer.py:78-86); 2 all-reduces a layer besides the ring."""
    got, reports = _sp_denoise(mesh_m2t2, padded=True, int8=int8)
    want = _jax_denoise(True)
    if int8:
        corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
        rel = np.abs(got - want).mean() / (np.abs(want).mean() + 1e-9)
        assert corr > 0.999 and rel < 0.03, (corr, rel)
        assert np.abs(got - want).max() > 1e-5
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    layers = TC.dit.num_layers + TC.dit.control_layers
    for rep in reports:
        assert rep["collectives"]["all_reduce"] == 2 * layers, rep
        assert rep["collectives"]["ring_shift"] == 2 * layers, rep


# ---------------------------------------------------------------------------
# (4) the context-parallel VAE


@functools.lru_cache(maxsize=1)
def _vae():
    gen = torch.Generator().manual_seed(5)
    tp = tvae.init(gen, VAE_CFGS[1])
    return _jax_copy(tp), tp


@pytest.mark.parametrize("n", [2, 4])
def test_cp_decode_matches_jax(n, request):
    """decode_temporal_cp over time=n of 1 + 2n latent frames against
    JAX's unsharded vae.decode to 2e-4 (test_vae_cp.py:22-38); per rank
    one halo shift per 3-frame causal conv."""
    mesh = request.getfixturevalue(f"mesh_t{n}")
    jp, tp = _vae()
    z = randn(20 + n, 1, 4, 1 + 2 * n, 4, 4)
    want = fast_jit(lambda p, z: jvae.decode(
        p, z, VAE_CFGS[0], compute_dtype=jnp.float32)[0], jp["decoder"], z)(
            jp["decoder"], z)
    got = tcp.decode_temporal_cp(tp["decoder"], T(z), VAE_CFGS[1], mesh,
                                 compute_dtype=torch.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_cp_encode_matches_jax(mesh_t2):
    """encode_temporal_cp over time=2 of 9 frames against JAX's unsharded
    vae.encode to 2e-4 (test_vae_cp.py:41-55)."""
    jp, tp = _vae()
    x = randn(30, 1, 3, 9, 16, 16)
    want = fast_jit(lambda p, x: jvae.encode(
        p, x, VAE_CFGS[0], compute_dtype=jnp.float32), jp["encoder"], x)(
            jp["encoder"], x)
    got = tcp.encode_temporal_cp(tp["encoder"], T(x), VAE_CFGS[1], mesh_t2,
                                 compute_dtype=torch.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# (5) requests under time=2


def _filled_init(monkeypatch):
    """build_pipeline's random init with its zero leaves filled, so that
    attention, the MLPs and the control path all reach the output."""
    for mod in (tli, tdi):
        orig = mod.init_params
        monkeypatch.setattr(
            mod, "init_params",
            lambda gen, *a, _o=orig: fill_zero_leaves(_o(gen, *a), gen))


def _assert_same_request(got, want):
    np.testing.assert_array_equal(got["codes"], want["codes"])
    assert float(np.abs(want["latent"]).max()) > 1e-2
    np.testing.assert_allclose(got["latent"], want["latent"], rtol=2e-4,
                               atol=2e-4)
    steps = np.abs(np.round(got["video"] * 255.0)
                   - np.round(want["video"] * 255.0))
    assert steps.max() <= 1.0


@pytest.mark.parametrize("segments", [1, 3])
def test_request_under_time2_equals_unsharded(segments, mesh_t2,
                                              monkeypatch):
    """build_pipeline(mesh=data=1,time=2) prompt -> codes -> video: stage
    1 unsharded in rank 0 (no `model`), its codes those of the unsharded
    request bit for bit; stage 2 sequence-parallel, each rank's DiT whole
    (the caller's tree on rank 0). segments=3: the long-video loop as one
    command, its 5 latent frames decoded context-parallel (3 do not split
    over 2 ranks: the single request decodes in rank 0)."""
    _filled_init(monkeypatch)
    sc = tcfg.ARSampleConfig(num_frames=segments * TC.llm.frames_per_segment,
                             seed=4)
    kw = dict(seed=0, compute_dtype=torch.float32, device="cpu")
    llm, dif = tiv.build_pipeline(TC, sc, **kw)
    tllm, tdif = tiv.build_pipeline(TC, sc, mesh=mesh_t2, **kw)
    assert tllm.mesh is None and tdif.mesh is mesh_t2
    assert tdif.params["main"]["layers"][0]["qkv_w"].shape == (
        TC.dit.hidden_size, 3 * TC.dit.hidden_size)
    want = tiv.generate(llm, dif, PROMPT, seed=3)
    mesh_t2.run(ttp.rank_report, True)
    got = tiv.generate(tllm, tdif, PROMPT, seed=3)
    reports = mesh_t2.run(ttp.rank_report, True)
    assert len(got["codes"]) == segments * TC.tokenizer.titok.latent_tokens
    lat = got["latent"].shape[1]
    assert tcp.can_decode_cp(lat, 2) == (segments == 3)
    if segments == 3:
        # the CP decode takes the whole video's GroupNorm statistics, the
        # streaming one each chunk's: its counterpart is the whole decode
        z = T(want["latent"]).permute(0, 2, 1, 3, 4) / TC.vae.scale_factor
        whole, _ = tvae.decode(dif.params["vae"]["decoder"], z, TC.vae,
                               compute_dtype=torch.float32)
        want = dict(want, video=teng.post_process_video(whole).numpy())
    _assert_same_request(got, want)
    # the decode's all-gather besides one a model call
    calls = segments * TC.sampler.num_steps
    gathers = calls + (segments == 3)
    assert all(r["collectives"]["all_gather"] == gathers for r in reports)


def test_serving_and_run_on_a_time_mesh(tmp_path, monkeypatch):
    """ServingEngine.build(mesh_spec="data=1,time=2") and
    infer_video.run(mesh_spec="data=1,time=2") serve a request equal to
    the unsharded one's; shutdown / run stop the mesh's worker."""
    from landiff_tpu_torch.serving.scheduler import ServingEngine

    _filled_init(monkeypatch)
    eng = ServingEngine.build(tiny=True, mesh_spec="data=1,time=2",
                              device="cpu", linger_s=0.0, seed=3)
    try:
        assert eng.dif.mesh.cfg.time == 2
        got = eng.generate(PROMPT, seed=3)
        procs = list(eng.dif.mesh._procs)
    finally:
        eng.shutdown()
    assert not any(p.is_alive() for p in procs)
    want = tiv.run(PROMPT, str(tmp_path / "a"), seed=3, tiny=True,
                   device="cpu")
    np.testing.assert_array_equal(got["codes"], want["codes"])
    np.testing.assert_allclose(got["video"], want["video"], atol=1 / 255.0)
    again = tiv.run(PROMPT, str(tmp_path / "b"), seed=3, tiny=True,
                    device="cpu", mesh_spec="data=1,time=2")
    _assert_same_request(again, want)
