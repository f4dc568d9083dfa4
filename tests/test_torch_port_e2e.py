"""PyTorch port: the stage-1 wrapper (pipeline/llm_infer.py) held against
the JAX package at the tiny config in f32 on the same parameters, with the
draws regenerated from the JAX key chain, and the infer_video entry point
on the CPU. The prompt -> codes -> video comparison with JAX is in
tests/test_torch_port_pipeline.py, beside the stage-2 wrapper's test, so
that the two share one compiled JAX stage 2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import gumbel_steps, stage1_params
from landiff_tpu import config as jcfg
from landiff_tpu.pipeline import llm_infer as jli
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch import utils as tutils
from landiff_tpu_torch.pipeline import dif_infer as tdi
from landiff_tpu_torch.pipeline import infer_video as tiv
from landiff_tpu_torch.pipeline import llm_infer as tli
from landiff_tpu_torch.video_io import read_mjpeg_avi

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
PROMPT = "a red panda climbs a tree"


def _wrappers(seed):
    j1, t1 = stage1_params()
    kw = dict(num_frames=TC.llm.frames_per_segment, seed=seed)
    jw = jli.ArModelInferWrapper(j1, JC.llm, JC.t5, jcfg.ARSampleConfig(**kw),
                                 compute_dtype=jnp.float32)
    tw = tli.ArModelInferWrapper(t1, TC.llm, TC.t5, tcfg.ARSampleConfig(**kw),
                                 compute_dtype=torch.float32, device="cpu")
    return jw, tw


def _steps(tw):
    return tw.llm_cfg.iframe_len + (tw.sample_cfg.num_frames - 1) * \
        tw.llm_cfg.pframe_len + 2 * tw.sample_cfg.num_frames


def test_stage1_tree_matches_jax_init():
    """The port's stage-1 init, handed to JAX, has exactly the leaves of
    the JAX init's tree (jax.eval_shape, nothing compiled), shape and
    dtype; the bridge returns the port's tensors unchanged; and the
    wrapper's compute-dtype copy keeps ln_f, head and the T5 norms f32."""
    jtree = jax.eval_shape(
        lambda key: jli.init_params(key, JC.llm, JC.t5),
        jax.random.PRNGKey(0))

    def leaves(tree):
        return {jax.tree_util.keystr(path): (tuple(leaf.shape),
                                             str(leaf.dtype))
                for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}

    jparams, bridged = stage1_params()
    assert leaves(jparams) == leaves(jtree)
    gen = torch.Generator().manual_seed(1)
    tparams = tutils.fill_zero_leaves(
        tli.init_params(gen, TC.llm, TC.t5), gen)
    flat = jax.tree_util.tree_leaves_with_path
    assert [k for k, _ in flat(bridged)] == [k for k, _ in flat(tparams)]
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(flat(bridged), flat(tparams)))
    assert bool(tparams["lm"]["micro"]["frames"]["fc1_w"].any())

    tw = tli.ArModelInferWrapper(bridged, TC.llm, TC.t5, device="cpu")
    gpt, t5 = tw.params["lm"]["gpt"], tw.params["t5"]
    assert gpt["blocks"][0]["wqkv"].dtype == torch.bfloat16
    assert gpt["head"].dtype == gpt["ln_f"]["w"].dtype == torch.float32
    assert t5["blocks"][0]["attn"]["q"].dtype == torch.bfloat16
    assert t5["embed"].dtype == torch.bfloat16
    assert t5["blocks"][0]["ln0"].dtype == torch.float32
    assert t5["blocks"][0]["rel_bias"].dtype == torch.float32
    assert bridged["t5"]["embed"].dtype == torch.float32   # not in place


def test_infer_batch_matches_single_calls_and_jax():
    """Two prompts of different length in one batched decode: the codes of
    the single calls, and of JAX's infer_batch."""
    seed = 9
    jw, tw = _wrappers(seed)
    prompts = [PROMPT, "fog"]
    tasks = [tli.CodeTask(f"{i}.npy", p) for i, p in enumerate(prompts)]
    one = gumbel_steps(seed, _steps(tw), TC.llm.vocab_size)
    got = tw.infer_batch(tasks, gumbel=torch.stack([one, one]))
    want = jw.infer_batch([jli.CodeTask(f"{i}.npy", p)
                           for i, p in enumerate(prompts)])
    for g, w, task in zip(got, want, tasks):
        np.testing.assert_array_equal(g.result, np.asarray(w.result))
        np.testing.assert_array_equal(g.result, tw(task, gumbel=one).result)
    assert not np.array_equal(got[0].result, got[1].result)
    # seeded: the batch draws each prompt's stream as the single call does
    seeded = tw.infer_batch(tasks)
    np.testing.assert_array_equal(seeded[1].result, tw(tasks[1]).result)
    assert tw.infer_batch([]) == []


def test_unported_options_are_refused(monkeypatch):
    """What is not ported raises, naming its ROADMAP item. The fast
    configuration's options (int8_decode, int4_decode, LANDIFF_FAST) are
    ported and build quantized wrappers instead."""
    _, t1 = stage1_params()
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        tli.ArModelInferWrapper(t1, TC.llm, TC.t5, device="cpu",
                                mesh=object())
    for kw, key in ((dict(int8_decode=True), "q"),
                    (dict(int4_decode=True), "q4")):
        w = tli.ArModelInferWrapper(t1, TC.llm, TC.t5, device="cpu", **kw)
        assert key in w.params["lm"]["gpt"]["blocks"][0]["wo"]
    sc = tcfg.ARSampleConfig()
    # checkpoints (item 10) are ported: a missing tree is a missing file
    with pytest.raises(FileNotFoundError, match="nowhere"):
        tiv.build_pipeline(TC, sc, ckpt_dir="/nowhere", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        tiv.build_pipeline(TC, sc, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        tiv.run("x", tiny=True, mesh_spec="data=2", device="cpu")
    # two segments of codes: the long-video path (item 11) is ported; its
    # offload branch is not
    llm, dif = tiv.build_pipeline(
        TC, tcfg.ARSampleConfig(num_frames=2 * TC.llm.frames_per_segment),
        compute_dtype=torch.float32, device="cpu")
    monkeypatch.setenv("LANDIFF_OFFLOAD", "1")
    with pytest.raises(NotImplementedError, match="ROADMAP item 16"):
        tiv.generate(llm, dif, "x")


def test_run_and_main_write_codes_and_video(tmp_path, monkeypatch, capsys):
    """run(tiny=True, device="cpu") writes <stem>_codes.npy and a video
    file (mp4, or MJPEG AVI without an ffmpeg backend); main parses
    --device; the same seed gives the same result."""
    monkeypatch.setenv("LANDIFF_NATIVE_CACHE", str(tmp_path / "native"))
    res = tiv.run(PROMPT, str(tmp_path / "a"), seed=3, tiny=True,
                  device="cpu")
    stem = tiv.file_stem(PROMPT)
    codes = np.load(tmp_path / "a" / f"{stem}_codes.npy")
    np.testing.assert_array_equal(codes, res["codes"])
    assert len(codes) == TC.tokenizer.titok.latent_tokens
    assert codes.min() >= 0 and codes.max() < TC.llm.codebook_size
    video = res["video"]
    frames = 2 ** TC.vae.temporal_compress_level * (
        TC.dit.latent_frames - 1) + 1
    assert video.shape[:3] == (1, 3, frames)
    assert np.isfinite(video).all() and 0.0 <= video.min() <= video.max() <= 1
    path = res["video_path"]
    assert path.exists() and path.stat().st_size > 0
    assert path.parent == tmp_path / "a" and path.stem == stem
    if path.suffix == ".avi":
        back, fps = read_mjpeg_avi(path)
        assert back.shape == (frames, *video.shape[3:], 3) and fps == 8
    assert set(res) >= {"codes", "video", "stage1_s", "stage2_s"}

    again = tiv.main(["--prompt", PROMPT, "--tiny", "--device", "cpu",
                      "--seed", "3", "--output-dir", str(tmp_path / "b")])
    np.testing.assert_array_equal(again["codes"], res["codes"])
    np.testing.assert_array_equal(again["video"], res["video"])
    assert (tmp_path / "b" / f"{stem}_codes.npy").exists()
    assert "stage1" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tiv.main(["--tiny"])                     # --prompt is required
