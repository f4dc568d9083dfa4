"""PyTorch port: configuration tree, dispatcher path choice, and the rule
that the port never imports JAX or the JAX package."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import stage2_params
from landiff_tpu import config as jcfg
from landiff_tpu import utils as jutils
from landiff_tpu.pipeline import dif_infer as jdi
from landiff_tpu.pipeline import text as jtext
from landiff_tpu.ops import attention as jattn
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch import utils as tutils
from landiff_tpu_torch.pipeline import dif_infer as tdi
from landiff_tpu_torch.pipeline import text as ttext
from landiff_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)   # tier-1 runs six xdist workers

REPO = Path(__file__).resolve().parents[1]
_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _as_dict(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _as_dict(v)
        elif v in _DTYPES:
            out[f.name] = _DTYPES[v]
        else:
            out[f.name] = v
    return out


def test_port_init_tree_matches_jax_init():
    """The port's stage-2 init, in the JAX layouts, has every leaf of the
    JAX init's tree (traced by jax.eval_shape, nothing compiled) with the
    same shape and dtype, but the parts not ported yet (the encoders); and
    the bridge maps those arrays back to the port's tensors exactly."""
    jtree = jax.eval_shape(
        lambda key: jdi.init_params(key, jcfg.tiny_test_config()),
        jax.random.PRNGKey(0))

    def leaves(tree):
        return {jax.tree_util.keystr(path): (tuple(leaf.shape),
                                             str(leaf.dtype))
                for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}

    want, (jparams, bridged) = leaves(jtree), stage2_params()
    got = leaves(jparams)
    assert {k: want[k] for k in got} == got
    unported = ("['vae']['encoder']", "['semantic']['vq']['encoder']",
                "['semantic']['vq']['mean']", "['semantic']['vq']['std']")
    assert all(k.startswith(unported) for k in set(want) - set(got))

    gen = torch.Generator().manual_seed(0)
    tparams = tutils.fill_zero_leaves(
        tdi.init_params(gen, tcfg.tiny_test_config()), gen)
    flat = lambda tree: jax.tree_util.tree_leaves_with_path(tree)
    assert [k for k, _ in flat(bridged)] == [k for k, _ in flat(tparams)]
    for (_, a), (_, b) in zip(flat(bridged), flat(tparams)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["LanDiffConfig", "tiny_test_config"])
def test_config_equal_field_for_field(which):
    if which == "LanDiffConfig":
        j, t = jcfg.LanDiffConfig(), tcfg.LanDiffConfig()
    else:
        j, t = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    assert _as_dict(j) == _as_dict(t)
    # derived properties too
    for sub in ("llm", "tokenizer", "dit"):
        for name in dir(type(getattr(j, sub))):
            if isinstance(getattr(type(getattr(j, sub)), name), property):
                assert getattr(getattr(j, sub), name) == \
                    getattr(getattr(t, sub), name)
    assert t.dit.video_tokens == j.dit.video_tokens
    assert t.tokenizer.titok.latent_tokens == j.tokenizer.titok.latent_tokens


def test_seeds_and_fallback_tokenizer_match_jax():
    for text, seed in (("a cat", 42), ("", 0), ("長い プロンプト", 7)):
        assert tutils.stable_hash(text) == jutils.stable_hash(text)
        assert tutils.seed_from_text(text, seed) == \
            jutils.seed_from_text(text, seed)
    kw = dict(max_length=226, padding_side="right")
    want = jtext.T5Text(None, **kw)(["a corgi on a beach"], pad_to_max=True)
    got = ttext.T5Text(None, **kw)(["a corgi on a beach"], pad_to_max=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# (Sq, Skv, D, dtype, LANDIFF_ATTN_INT8, LANDIFF_ATTN_CACHED)
_PATH_TABLE = [
    (17776, 17776, 64, "bf16", None, None),    # DiT
    (18768, 18768, 64, "bf16", None, None),    # TiTok decoder
    (18768, 18768, 64, "bf16", "0", None),
    (17776, 17776, 64, "bf16", None, "0"),
    (17776, 17776, 64, "f32", None, None),
    (20000, 20000, 64, "f32", None, None),     # f32 K+V over the budget
    (40000, 40000, 64, "bf16", None, None),    # bf16 K+V over the budget
    (2048, 2048, 128, "bf16", None, None),
    (2048, 300, 64, "bf16", None, None),
    (2100, 2100, 64, "bf16", None, None),
    (512, 4096, 64, "bf16", None, None),       # short q: reference
    (2047, 2047, 64, "f32", None, None),
]


def _jax_path(monkeypatch, Sq, Skv, D, dtype):
    """What JAX's attention(impl="auto") on the TPU runs for this shape:
    the Pallas call is replaced by a recorder."""
    seen = {}

    def fake_call(q, k, v, *a, int8_scores=False, cached=False, **kw):
        seen["path"] = "int8" if int8_scores else "exact"
        seen["cached"] = cached
        return (jnp.zeros_like(q),
                jnp.zeros(q.shape[:2] + (8,), jnp.float32))

    def fake_ref(q, *a, **kw):
        seen["path"] = "reference"
        return q

    monkeypatch.setattr(jattn, "_flash_call", fake_call)
    monkeypatch.setattr(jattn, "mha_reference", fake_ref)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    dt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    q = jnp.zeros((1, Sq, 1, D), dt)
    kv = jnp.zeros((1, Skv, 1, D), dt)
    jattn.attention(q, kv, kv)
    return seen["path"]


@pytest.mark.parametrize("Sq,Skv,D,dtype,int8_env,cached_env", _PATH_TABLE)
def test_dispatcher_path_matches_jax(monkeypatch, Sq, Skv, D, dtype,
                                     int8_env, cached_env):
    for name, val in (("LANDIFF_ATTN_INT8", int8_env),
                      ("LANDIFF_ATTN_CACHED", cached_env)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    itemsize = 2 if dtype == "bf16" else 4
    want = _jax_path(monkeypatch, Sq, Skv, D, dtype)
    assert tattn.select_path(Sq, Skv, D, itemsize) == want


def test_dispatcher_refuses_unported_variants(monkeypatch):
    q = torch.zeros(1, 2048, 1, 64)
    monkeypatch.setenv("LANDIFF_ATTN_INT8_PV", "1")
    with pytest.raises(NotImplementedError):
        tattn.attention(q, q, q)


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|landiff_tpu)(\.|\s|$)",
                        re.M)


def test_port_sources_import_no_jax():
    files = sorted((REPO / "landiff_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f} imports {hits}"


def test_port_imports_without_jax_in_a_subprocess():
    """Every port module imports in a process where jax and landiff_tpu
    cannot be imported."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "landiff_tpu_torch").rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "landiff_tpu"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import importlib

for m in {mods!r}:
    importlib.import_module(m)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "landiff_tpu")]
assert not bad, bad
print("imported", len({mods!r}))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout
