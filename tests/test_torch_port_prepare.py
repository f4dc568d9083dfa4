"""PyTorch port: training-data preparation (data/prepare.py) held against
the JAX package at the tiny config in f32: the same clip directory (two
seeded .npy clips and a caption file) through both `prepare`s gives
shards with the same keys, the same codes and captions exactly, and
features, latents and text context within 1e-4 relative + 1e-4 absolute
(f32 work summed in another order, the encoder tests' bar). Both run on
the same weights: each package's random init (VideoVQ with Theia, the
VAE, the stage-2 T5) is replaced by the port's filled init, in the JAX
layouts for JAX and through the bridge for the port. The clip readers
(.npy, MJPEG-AVI, a folder of frames) give the same arrays."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import fast_compiles, to_jax_layout
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu.data import prepare as jprep
from landiff_tpu.models import t5 as jt5
from landiff_tpu.models import vae as jvae
from landiff_tpu.models import vq as jvq
from landiff_tpu_torch import bridge
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.data import loader as tloader
from landiff_tpu_torch.data import prepare as tprep
from landiff_tpu_torch.models import t5 as tt5
from landiff_tpu_torch.models import vae as tvae
from landiff_tpu_torch.models import vq as tvq
from landiff_tpu_torch.utils import fill_zero_leaves

torch.set_num_threads(2)   # tier-1 runs six xdist workers

TC = tcfg.tiny_test_config()
TOL = dict(atol=1e-4, rtol=1e-4)


def _weights(monkeypatch):
    """Both packages' inits return the same filled parameters."""
    gen = torch.Generator().manual_seed(51)
    made = {
        "vq": tvq.init(gen, TC.tokenizer, with_theia=True),
        "vae": tvae.init(gen, TC.vae),
        "t5": tt5.init(gen, TC.t5)}
    arrays = to_jax_layout(fill_zero_leaves(made, gen))
    for name, jmod, tmod in (("vq", jvq, tvq), ("vae", jvae, tvae),
                             ("t5", jt5, tt5)):
        jtree = jax.tree_util.tree_map(jnp.asarray, arrays[name])
        ttree = bridge.to_torch(arrays[name], device="cpu")
        monkeypatch.setattr(jmod, "init", lambda *a, _t=jtree, **k: _t)
        monkeypatch.setattr(tmod, "init", lambda *a, _t=ttree, **k: _t)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(52)
    for name in ("a", "b"):
        np.save(root / f"{name}.npy",
                rng.integers(0, 256, (7, 64, 96, 3), dtype=np.uint8))
    (root / "captions.json").write_text(json.dumps({"a": "a red panda"}))
    return root


def _shards(d):
    out = {}
    for f in sorted(d.glob("*.npz")):
        with np.load(f) as z:
            for k in z:
                out.setdefault(k, []).append(z[k])
    return {k: np.concatenate(v) for k, v in out.items()}


@pytest.mark.parametrize("model", ["vq", "lm", "dit"])
def test_prepare_shards_match_jax(model, clips, tmp_path, monkeypatch):
    _weights(monkeypatch)
    with fast_compiles():
        jprep.prepare(str(clips), str(tmp_path / "j"), model=model,
                      tiny=True, shard_size=3, compute_dtype=jnp.float32)
    tprep.prepare(str(clips), str(tmp_path / "t"), model=model, tiny=True,
                  shard_size=3, compute_dtype=torch.float32, device="cpu")
    want, got = _shards(tmp_path / "j"), _shards(tmp_path / "t")
    assert sorted(got) == sorted(want)
    n = {"vq": 4, "lm": 4, "dit": 2}[model]   # 7 frames: 2 x 3 or 1 x 5
    for k in got:
        assert got[k].shape == want[k].shape and len(got[k]) == n, k
        assert got[k].dtype == want[k].dtype, k
        if k in ("codes", "tokens", "caption"):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            np.testing.assert_allclose(got[k], want[k], **TOL)
    if model == "lm":
        assert list(got["caption"]) == ["a red panda"] * 2 + [""] * 2
    # the trainer's reader takes them
    batch = next(tloader.ShardedNpzDataset(tmp_path / "t", 2).iter_epoch(0))
    assert len(next(iter(batch.values()))) == 2


def test_clip_readers_match_jax(tmp_path):
    from landiff_tpu_torch import video_io

    frames = np.random.default_rng(53).integers(0, 256, (3, 16, 24, 3),
                                                dtype=np.uint8)
    np.save(tmp_path / "c.npy", frames)
    video_io.write_mjpeg_avi(frames, tmp_path / "c.avi")
    folder = tmp_path / "c_frames"
    folder.mkdir()
    from PIL import Image

    for i, f in enumerate(frames):
        Image.fromarray(f).save(folder / f"{i:03d}.png")
    for path in ("c.npy", "c.avi", "c_frames"):
        got = tprep.load_clip(tmp_path / path)
        want = jprep.load_clip(tmp_path / path)
        assert got.dtype == np.uint8 and got.shape == frames.shape
        np.testing.assert_array_equal(got, want)
    assert [n for n, _ in tprep.iter_clips(tmp_path)] == \
        [n for n, _ in jprep.iter_clips(tmp_path)]
    assert [s.shape[0] for s in tprep.segment(frames, 2, 1)] == [2, 2]
    with pytest.raises(ValueError):
        tprep.load_clip(tmp_path / "missing.txt")


def test_main_runs_on_the_cpu(clips, tmp_path):
    tprep.main(["--clips", str(clips), "--out", str(tmp_path / "o"),
                "--model", "lm", "--tiny", "--device", "cpu"])
    got = _shards(tmp_path / "o")
    assert got["codes"].shape == (4, TC.tokenizer.titok.latent_tokens)
    assert got["codes"].min() >= 0
    assert got["codes"].max() < TC.tokenizer.vq.codebook_size
