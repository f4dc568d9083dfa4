"""PyTorch port: the GeneralConditioner (diffusion/conditioner.py) held
against the JAX package, mirroring tests/test_conditioner.py: rank
routing and concatenation, ucg dropout (output zeroing and the legacy
input replacement), correlated cor_embs / cor_p dropout, force-zero uc
rows, frozen embedders, the (c, uc) pair. The dropout cases run twice:
with JAX's own draws passed in (ConditionerDraws, the key chain of
conditioner.py:147-169 replayed), where the outputs must equal JAX's, and
with a torch.Generator, where the rates must hold. Tolerance: exact (the
same f32 products, or none), 1e-5 relative + 1e-6 absolute on matrix
products (sums in another order).
test_conditioner.py's test_jit_traceable has no counterpart: the port
runs eagerly and has no tracing step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu.diffusion import conditioner as jcond
from landiff_tpu_torch.diffusion import conditioner as tcond

torch.set_num_threads(2)   # tier-1 runs six xdist workers


def _specs(mod):
    return [
        mod.EmbedderSpec(name="txt", input_key="txt",
                         apply=lambda p, x: x @ p["w"], ucg_rate=0.5),
        mod.EmbedderSpec(name="fps", input_key="fps",
                         apply=lambda p, x: x[:, None] * p["w"][None, :],
                         ucg_rate=0.5),
        mod.EmbedderSpec(name="img", input_key="img", apply=lambda p, x: x,
                         ucg_rate=0.5),
    ]


def _params_np():
    return {"txt": {"w": np.random.default_rng(0).standard_normal(
                (8, 16)).astype(np.float32)},
            "fps": {"w": np.ones((6,), np.float32)}}


def _batch_np(B=4):
    rng = np.random.default_rng(1)
    return {"txt": rng.standard_normal((B, 5, 8)).astype(np.float32),
            "fps": rng.uniform(1, 30, (B,)).astype(np.float32),
            "img": rng.standard_normal((B, 3, 2, 4, 4)).astype(np.float32)}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def jax_draws(specs, key, B, cor_embs=(), cor_p=()):
    """The draws JAX's apply_conditioner takes from `key`: the correlated
    outcome first, then one Bernoulli mask per other ucg embedder in
    processing order."""
    draws = tcond.ConditionerDraws()
    if cor_embs:
        key, k_cor = jax.random.split(key)
        draws.cor_idx = torch.from_numpy(np.array(jax.random.choice(
            k_cor, len(cor_p), (B,), p=jnp.asarray(cor_p, jnp.float32))))
    for i in tuple(cor_embs) + tuple(j for j in range(len(specs))
                                     if j not in cor_embs):
        if i not in cor_embs and specs[i].ucg_rate > 0.0:
            key, k_i = jax.random.split(key)
            draws.ucg[i] = torch.from_numpy(np.array(jax.random.bernoulli(
                k_i, specs[i].ucg_rate, (B,))))
    return draws


def _assert_outputs_equal(got, want, rtol=0.0):
    """Exact, or with rtol (a matrix product) 1e-6 absolute beside it."""
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=rtol,
                                   atol=1e-6 if rtol else 0.0)


def test_rank_routing_and_catdims_match_jax():
    want = jcond.apply_conditioner(_specs(jcond), _j(_params_np()),
                                   _j(_batch_np()))
    got = tcond.apply_conditioner(_specs(tcond), _t(_params_np()),
                                  _t(_batch_np()))
    assert got["crossattn"].shape == (4, 5, 16)   # 3-D
    assert got["vector"].shape == (4, 6)          # 2-D
    assert got["concat"].shape == (4, 3, 2, 4, 4)  # 5-D
    _assert_outputs_equal(got, want, rtol=1e-5)
    # two embedders on one key concatenate along KEY2CATDIM
    two = _specs(tcond) + [tcond.EmbedderSpec(
        name="txt2", input_key="txt",
        apply=lambda p, x: x @ torch.ones((8, 4)))]
    out2 = tcond.apply_conditioner(two, _t(_params_np()), _t(_batch_np()))
    assert out2["crossattn"].shape == (4, 5, 20)  # axis 2
    assert torch.equal(out2["crossattn"][..., :16], got["crossattn"])


def test_tuple_output_and_input_keys():
    spec = tcond.EmbedderSpec(
        name="multi", input_key="fps",
        apply=lambda p, x: (x[:, None].repeat(1, 3),
                            x[:, None, None].repeat(1, 2, 4)))
    out = tcond.apply_conditioner([spec], {}, _t(_batch_np()))
    assert out["vector"].shape == (4, 3)
    assert out["crossattn"].shape == (4, 2, 4)
    pair = lambda mod: mod.EmbedderSpec(
        name="pair", input_keys=("fps", "txt"),
        apply=lambda p, f, t: t.mean(1) * f[:, None])
    got = tcond.apply_conditioner([pair(tcond)], {}, _t(_batch_np()))
    want = jcond.apply_conditioner([pair(jcond)], {}, _j(_batch_np()))
    assert got["vector"].shape == (4, 8)
    _assert_outputs_equal(got, want, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_ucg_dropout_with_jax_draws_matches_jax(seed):
    """Output zeroing (txt, fps, img) and the legacy input replacement,
    one draw chain."""
    specs = {mod: _specs(mod) + [mod.EmbedderSpec(
        name="fps_legacy", input_key="fps",
        apply=lambda p, x: x[:, None] * 2.0, ucg_rate=0.5,
        legacy_ucg_val=0.0)] for mod in (jcond, tcond)}
    key = jax.random.PRNGKey(seed)
    B = 16
    want = jcond.apply_conditioner(specs[jcond], _j(_params_np()),
                                   _j(_batch_np(B)), train=True, key=key)
    draws = jax_draws(specs[tcond], key, B)
    got = tcond.apply_conditioner(specs[tcond], _t(_params_np()),
                                  _t(_batch_np(B)), train=True, draws=draws)
    _assert_outputs_equal(got, want, rtol=1e-5)
    dropped = draws.ucg[3].numpy()
    assert 0 < dropped.sum() < B
    np.testing.assert_array_equal(got["vector"][:, 6].numpy() == 0.0,
                                  dropped)


def test_ucg_zeroes_rows_at_rate_with_a_generator():
    spec = tcond.EmbedderSpec(name="txt", input_key="txt",
                              apply=lambda p, x: x @ p["w"], ucg_rate=0.3)
    B = 512
    batch = {"txt": torch.ones((B, 2, 8))}
    params = _t(_params_np())
    out = tcond.apply_conditioner([spec], params, batch, train=True,
                                  generator=torch.Generator().manual_seed(0))
    rows = out["crossattn"].reshape(B, -1)
    zero = rows.abs().amax(1) == 0.0
    assert 0.22 * B < int(zero.sum()) < 0.38 * B
    keep = (torch.ones((1, 2, 8)) @ params["txt"]["w"]).reshape(-1)
    torch.testing.assert_close(rows[~zero][0], keep, rtol=1e-6, atol=0)
    # no dropout at inference (train=False), even with a generator
    out_inf = tcond.apply_conditioner(
        [spec], params, batch, generator=torch.Generator().manual_seed(0))
    assert bool((out_inf["crossattn"].abs().amax(dim=(1, 2)) > 0).all())


def test_legacy_ucg_replaces_input_with_a_generator():
    spec = tcond.EmbedderSpec(name="fps", input_key="fps",
                              apply=lambda p, x: x[:, None] * torch.ones(
                                  (1, 4)), ucg_rate=0.5, legacy_ucg_val=0.0)
    B = 256
    out = tcond.apply_conditioner([spec], {}, {"fps": torch.full((B,), 24.0)},
                                  train=True,
                                  generator=torch.Generator().manual_seed(1))
    v = out["vector"]
    dropped, kept = (v == 0.0).all(1), (v == 24.0).all(1)
    assert bool((dropped | kept).all())
    assert 0.4 * B < int(dropped.sum()) < 0.6 * B


def test_cor_embs_with_jax_draws_matches_jax():
    specs = {mod: _specs(mod) for mod in (jcond, tcond)}
    key, B = jax.random.PRNGKey(4), 32
    cor = dict(cor_embs=(0, 1), cor_p=(0.4, 0.2, 0.1, 0.3))
    want = jcond.apply_conditioner(specs[jcond], _j(_params_np()),
                                   _j(_batch_np(B)), train=True, key=key,
                                   **cor)
    draws = jax_draws(specs[tcond], key, B, **cor)
    got = tcond.apply_conditioner(specs[tcond], _t(_params_np()),
                                  _t(_batch_np(B)), train=True, draws=draws,
                                  **cor)
    _assert_outputs_equal(got, want, rtol=1e-5)
    assert len(set(draws.cor_idx.tolist())) == 4


def test_cor_embs_joint_distribution_with_a_generator():
    """cor_p = [0,0,0,1] drops both always, [1,0,0,0] never; rand_idx % 2
    drops cor_embs[0], // 2 then % 2 cor_embs[1] (modules.py:188-203)."""
    specs = _specs(tcond)[:2]

    def run(cor_p):
        out = tcond.apply_conditioner(
            specs, _t(_params_np()), _t(_batch_np(64)), train=True,
            generator=torch.Generator().manual_seed(2), cor_embs=(0, 1),
            cor_p=cor_p)
        return (out["crossattn"].reshape(64, -1).abs().amax(1) == 0,
                out["vector"].abs().amax(1) == 0)

    t, f = run((0.0, 0.0, 0.0, 1.0))
    assert t.all() and f.all()
    t, f = run((1.0, 0.0, 0.0, 0.0))
    assert not t.any() and not f.any()
    t, f = run((0.0, 1.0, 0.0, 0.0))
    assert t.all() and not f.any()
    t, f = run((0.0, 0.0, 1.0, 0.0))
    assert not t.any() and f.all()


def test_force_zero_and_uc_pair_match_jax():
    want = jcond.get_unconditional_conditioning(
        _specs(jcond), _j(_params_np()), _j(_batch_np()),
        force_uc_zero_embeddings=["txt"])
    c, uc = tcond.get_unconditional_conditioning(
        _specs(tcond), _t(_params_np()), _t(_batch_np()),
        force_uc_zero_embeddings=["txt"])
    assert bool((uc["crossattn"] == 0).all())
    assert not bool((c["crossattn"] == 0).all())
    assert torch.equal(c["vector"], uc["vector"])
    assert torch.equal(c["concat"], uc["concat"])
    for got, w in zip((c, uc), want):
        _assert_outputs_equal(got, w, rtol=1e-5)


def test_frozen_embedder_stops_gradient():
    specs = [
        tcond.EmbedderSpec(name="txt", input_key="txt",
                           apply=lambda p, x: x @ p["w"], is_trainable=True),
        tcond.EmbedderSpec(name="fps", input_key="fps",
                           apply=lambda p, x: x[:, None] * p["w"][None, :]),
    ]
    params = jax.tree_util.tree_map(lambda a: torch.from_numpy(a)
                                    .requires_grad_(), _params_np())
    out = tcond.apply_conditioner(specs, params, _t(_batch_np()))
    sum(v.square().sum() for v in out.values()).backward()
    assert float(params["txt"]["w"].grad.abs().max()) > 0
    assert params["fps"]["w"].grad is None


def test_cor_first_processing_order():
    fill = lambda v: (lambda p, x: torch.full((x.shape[0], 2), v))
    specs = [tcond.EmbedderSpec(name="a", input_key="fps", apply=fill(1.0)),
             tcond.EmbedderSpec(name="b", input_key="fps", apply=fill(2.0))]
    out = tcond.apply_conditioner(specs, {}, _t(_batch_np()), train=True,
                                  generator=torch.Generator().manual_seed(0),
                                  cor_embs=(1,), cor_p=(1.0, 0.0))
    assert out["vector"][0].tolist() == [2.0, 2.0, 1.0, 1.0]


def test_spec_validation():
    with pytest.raises(ValueError):
        tcond.EmbedderSpec(name="x", apply=lambda p: 0)
    with pytest.raises(ValueError):
        tcond.EmbedderSpec(name="x", apply=lambda p: 0, input_key="a",
                           input_keys=("b",))
    with pytest.raises(ValueError):
        tcond.apply_conditioner(_specs(tcond), _t(_params_np()),
                                _t(_batch_np()), train=True,
                                generator=torch.Generator(), cor_embs=(0,),
                                cor_p=(1.0,))
