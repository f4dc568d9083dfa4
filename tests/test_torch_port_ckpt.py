"""PyTorch port: checkpoint conversion and loading (ckpt/convert.py,
manifests.py, resolve.py, load.py, synth.py), mirroring test_convert.py,
test_ckpt_load.py, test_manifests.py and test_resolve.py at the tiny
config. The port's converter gives arrays bit-equal to the JAX package's
on the same state dicts; on a synthetic tree in the release's layout
(f32 safetensors, SAT / Lightning .pt, a two-shard bf16 T5) its loaders
give tensors equal to `bridge` of the JAX loaders' trees; a request from
the tree through build_pipeline(ckpt_dir=...) equals one from the same
tensors handed to the wrappers. Every comparison is exact: the values
only move between layouts and containers (bf16 -> f32 is exact)."""

import hashlib

import jax
import numpy as np
import pytest
import torch

from landiff_tpu import config as jcfg
from landiff_tpu.ckpt import convert as jconvert
from landiff_tpu.ckpt import load as jload
from landiff_tpu.ckpt import manifests as jmanifests
from landiff_tpu_torch import bridge
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.ckpt import convert, manifests, resolve, synth
from landiff_tpu_torch.ckpt import load as tload
from landiff_tpu_torch.pipeline import dif_infer, infer_video, llm_infer
from landiff_tpu_torch.pipeline.text import T5Text
from landiff_tpu_torch.utils import tree_leaves, tree_map

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()


def _rand_sd(manifest, seed):
    return synth.random_state_dict(manifest, torch.Generator().manual_seed(
        seed))


def _assert_same_tree(got, want):
    """numpy trees of the same structure, every leaf bit-equal."""
    got_l = jax.tree_util.tree_leaves(got)
    want_l = jax.tree_util.tree_leaves(want)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(got_l, want_l):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(
            a.astype(np.float32), b.astype(np.float32))


def _assert_bridged(got, jtree):
    """port tensors == bridge of a JAX tree, leaf for leaf."""
    want = bridge.to_torch(jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(np.float32), jtree), device="cpu")
    pairs = []
    tree_map(lambda a, b: pairs.append((a, b)), got, want)
    assert pairs
    for a, b in pairs:
        assert a.shape == b.shape and torch.equal(a.float(), b)


def test_manifests_match_jax():
    for jc, tc in ((JC, TC), (jcfg.LanDiffConfig(), tcfg.LanDiffConfig())):
        assert manifests.llm_safetensors(tc.llm, t5_dim=tc.t5.d_model) == \
            jmanifests.llm_safetensors(jc.llm, t5_dim=jc.t5.d_model)
        assert manifests.tokenizer_safetensors(tc.tokenizer) == \
            jmanifests.tokenizer_safetensors(jc.tokenizer)
        assert manifests.dit_sat(tc.dit) == jmanifests.dit_sat(jc.dit)
        assert manifests.engine_ckpt(tc) == jmanifests.engine_ckpt(jc)
        assert manifests.vae_state_dict(tc.vae) == \
            jmanifests.vae_state_dict(jc.vae)
        assert manifests.t5_hf_safetensors(tc.t5) == \
            jmanifests.t5_hf_safetensors(jc.t5)


def test_converters_bit_equal_to_jax():
    cases = [
        ("convert_llm", manifests.llm_safetensors(TC.llm, t5_dim=24),
         (TC.llm.num_layers,)),
        ("convert_tokenizer", manifests.tokenizer_safetensors(TC.tokenizer),
         ()),
        ("convert_dit", manifests.dit_sat(TC.dit), (TC.dit.num_layers,)),
        ("convert_vae", manifests.vae_state_dict(TC.vae),
         (TC.vae.num_res_blocks, len(TC.vae.ch_mult)))]
    for i, (fn, manifest, args) in enumerate(cases):
        sd = _rand_sd(manifest, i)
        _assert_same_tree(getattr(convert, fn)(sd, *args),
                          getattr(jconvert, fn)(sd, *args))
    engine = _rand_sd(manifests.engine_ckpt(TC), 9)
    tparts, jparts = (m.split_engine_state(engine)
                      for m in (convert, jconvert))
    _assert_same_tree(convert.convert_dit(tparts["control"], 1, control=True),
                      jconvert.convert_dit(jparts["control"], 1,
                                           control=True))
    _assert_same_tree(
        convert.convert_semantic_cond(tparts["semantic"],
                                      TC.semantic_cond.num_res_blocks),
        jconvert.convert_semantic_cond(jparts["semantic"],
                                       JC.semantic_cond.num_res_blocks))
    # key tracking: nothing of a manifest left unconsumed
    _, unconsumed = convert.convert_tracked(
        lambda sd: convert.convert_vae(sd, TC.vae.num_res_blocks,
                                       len(TC.vae.ch_mult)),
        _rand_sd(manifests.vae_state_dict(TC.vae), 3))
    assert not {k for k in unconsumed if not k.startswith("loss.")}


def test_safetensors_writer_and_reader_agree_with_jax(tmp_path):
    sd = {"a": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
          "b": np.array([1, -2, 3], np.int64),
          "c": np.linspace(-3, 3, 10, dtype=np.float32)}
    path = tmp_path / "x.safetensors"
    size = convert.save_safetensors(path, sd, bf16=("c",))
    assert size == path.stat().st_size
    got = convert.load_safetensors_views(path)
    want = jconvert.load_safetensors_views(path)   # ml_dtypes bf16
    for k in sd:
        assert got[k].dtype == (np.float32 if k == "c" else sd[k].dtype)
        np.testing.assert_array_equal(got[k], np.asarray(want[k]).astype(
            got[k].dtype))
    np.testing.assert_array_equal(got["a"], sd["a"])
    np.testing.assert_array_equal(got["c"], convert.round_to_bf16(sd["c"]))
    t = torch.from_numpy(sd["c"]).bfloat16()
    np.testing.assert_array_equal(got["c"], t.float().numpy())


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("LanDiff")
    return root, synth.write_tree(root, TC, seed=5)


def test_loaders_equal_the_bridge_of_the_jax_loaders(tree):
    root, _ = tree
    got2 = tload.load_stage2(root, TC, device="cpu")
    want2 = jload.load_stage2(root, JC)
    for k in ("main", "control", "semantic", "vae", "t5"):
        _assert_bridged(got2[k], want2[k])
    got1 = tload.load_stage1(root, TC, device="cpu")
    want1 = jload.load_stage1(root, JC)
    _assert_bridged(got1, want1)
    _assert_bridged(tload.load_tokenizer(root, TC, with_theia=False,
                                         device="cpu"),
                    jload.load_tokenizer(root, JC, with_theia=False))
    with pytest.raises(NotImplementedError, match="item 13"):
        tload.load_tokenizer(root, TC, device="cpu")
    # bf16 asked: floating leaves cast, integer leaves kept
    half = tload.load_vae(root, TC, dtype=torch.bfloat16, device="cpu")
    assert {t.dtype for t in tree_leaves(half)} == {torch.bfloat16}


def test_request_from_the_tree_equals_one_from_the_tensors(tree):
    root, _ = tree
    sample = tcfg.ARSampleConfig(seed=2,
                                 num_frames=TC.llm.frames_per_segment)
    llm, dif = infer_video.build_pipeline(
        TC, sample, ckpt_dir=str(root), compute_dtype=torch.float32,
        device="cpu", require_real_tokenizer=False)
    from_dir = infer_video.generate(llm, dif, "a red panda", seed=4)
    llm2 = llm_infer.ArModelInferWrapper(
        tload.load_stage1(root, TC, device="cpu"), TC.llm, TC.t5, sample,
        compute_dtype=torch.float32, device="cpu")
    dif2 = dif_infer.CogModelInferWrapper(
        tload.load_stage2(root, TC, device="cpu"), TC,
        compute_dtype=torch.float32, device="cpu")
    direct = infer_video.generate(llm2, dif2, "a red panda", seed=4)
    np.testing.assert_array_equal(from_dir["codes"], direct["codes"])
    np.testing.assert_array_equal(from_dir["video"], direct["video"])
    # a tree holds no tokenizer files: real weights refuse the fallback
    with pytest.raises(RuntimeError, match="T5 tokenizer"):
        infer_video.build_pipeline(TC, sample, ckpt_dir=str(root),
                                   compute_dtype=torch.float32, device="cpu")


def test_require_real_tokenizer_raises():
    with pytest.raises(RuntimeError, match="missing"):
        T5Text("/nonexistent/t5-dir", require_real=True)
    with pytest.raises(RuntimeError, match="none was given"):
        T5Text(None, require_real=True)
    ids, mask = T5Text("/nonexistent/t5-dir")(["hello"])
    assert ids.shape == mask.shape and mask.any()


def test_verify_mode_on_the_synthetic_tree(tree):
    root, _ = tree
    report = convert.verify_ckpt_tree(root, TC)
    for name, r in report.items():
        assert r["status"] == "ok", (name, r)
        for field in ("missing_vs_manifest", "extra_vs_manifest",
                      "shape_mismatch", "unconsumed_unexpected"):
            assert not r.get(field), (name, field, r[field][:5])
    assert report["dit_base"]["layer0_torch_parity"].startswith("skipped")


def test_stage1_without_t5_raises_and_names_the_local_dirs(tmp_path):
    convert.save_safetensors(tmp_path / "llm" / "model.safetensors",
                             _rand_sd(manifests.llm_safetensors(
                                 TC.llm, t5_dim=TC.t5.d_model), 1))
    with pytest.raises(FileNotFoundError, match="flan-t5-xxl"):
        tload.load_stage1(tmp_path, TC, device="cpu")


# ---------------------------------------------------------------------------
# resolve (test_resolve.py's contract; no network)


def _make_tree(root, files):
    lines = []
    for rel, content in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(content)
        lines.append(f"{hashlib.md5(content).hexdigest()}  ./{rel}")
    (root / "CHECKSUM.md5").write_text("\n".join(lines) + "\n")


def test_md5_manifest_rules(tmp_path):
    f = tmp_path / "m.md5"
    f.write_text("abc123  ./a/b.bin\n\ndef456  c.safetensors\n")
    assert resolve.parse_md5_manifest(f) == {"a/b.bin": "abc123",
                                             "c.safetensors": "def456"}
    d = tmp_path / "t"
    _make_tree(d, {"w/a.bin": b"hello", "b.bin": b"world" * 100})
    assert resolve.verify_md5_checksum(d, d / "CHECKSUM.md5") is True
    (d / "b.bin").write_bytes(b"tampered")
    assert resolve.verify_md5_checksum(d, d / "CHECKSUM.md5") is False
    (d / "b.bin").unlink()
    assert resolve.verify_md5_checksum(d, d / "CHECKSUM.md5") is False
    with pytest.raises(FileNotFoundError):
        resolve.verify_md5_checksum(d, d / "nope.md5")


def test_landiff_home_wins_and_links_the_workspace(tmp_path, monkeypatch):
    model = tmp_path / "model"
    _make_tree(model, {"stage1.pt": b"s1" * 10, "vae/v.bin": b"v" * 7})
    repo = tmp_path / "repo"
    (repo / "ckpts").mkdir(parents=True)
    monkeypatch.setattr(resolve, "_repo_root", lambda: repo)
    monkeypatch.setattr(resolve, "_MODEL_PATH", None)
    monkeypatch.setenv("LANDIFF_HOME", str(model))
    monkeypatch.delenv("LANDIFF_SKIP_HASH_CHECK", raising=False)
    assert resolve.initialize_landiff_model_path() == model
    link = repo / "ckpts" / "LanDiff"
    assert link.is_symlink() and link.resolve() == model.resolve()
    assert resolve.initialize_model_path() == str(model)


def test_no_local_tree_raises_offline_and_names_the_paths(tmp_path,
                                                          monkeypatch):
    """Where the reference would download from the hub, the port raises
    and names the local paths; it never imports huggingface_hub."""
    import sys

    model = tmp_path / "model"
    _make_tree(model, {"a.bin": b"good"})
    (model / "a.bin").write_bytes(b"bad!")        # corrupt: refused
    repo = tmp_path / "repo"
    (repo / "ckpts").mkdir(parents=True)
    monkeypatch.setattr(resolve, "_repo_root", lambda: repo)
    monkeypatch.setattr(resolve, "_MODEL_PATH", None)
    monkeypatch.setenv("LANDIFF_HOME", str(model))
    monkeypatch.delenv("LANDIFF_SKIP_HASH_CHECK", raising=False)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(FileNotFoundError, match="LanDiff") as e:
        resolve.initialize_landiff_model_path()
    assert str(model) in str(e.value) and "hub" in str(e.value)
    assert resolve.initialize_model_path(required=False) is None
    with pytest.raises(FileNotFoundError):
        resolve.initialize_model_path(required=True)
