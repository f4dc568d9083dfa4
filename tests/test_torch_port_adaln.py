"""PyTorch port: the fused adaLN modulate (ops/adaln.py) held against the
JAX package. The plain version of the CUDA kernel is compared with the
Pallas kernel in interpret mode (as tests/test_fused_adaln.py runs it),
the unfused reference with JAX's `_xla`, the autograd.Function's gradients
with jax.grad of `_xla`, and the DiT with LANDIFF_FUSED_ADALN=1 with
JAX's. Inputs come from numpy seeds and go to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import assert_close, randn, stage2_params
from landiff_tpu import config as jcfg
from landiff_tpu.models import dit as jdit
from landiff_tpu.ops import adaln as jadaln
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.models import dit as tdit
from landiff_tpu_torch.ops import adaln as tadaln

torch.set_num_threads(2)   # tier-1 runs six xdist workers

T = torch.from_numpy


def _inputs(B, S, D, seed):
    x = randn(seed, B, S, D)
    w = 1.0 + randn(seed + 1, D, scale=0.1)
    b = randn(seed + 2, D, scale=0.1)
    pairs = [randn(seed + 3 + i, B, D, scale=0.2) for i in range(4)]
    return [x, w, b, *pairs]


def _bf16_steps(got: torch.Tensor, want: np.ndarray) -> float:
    """max |got - want| per element in bf16 steps at the element's size
    (the spacing of bf16 numbers at |want|, not below that at 2^-7: under
    it an f32 rounding of the sums is worth more than a step)."""
    want = torch.from_numpy(np.asarray(want, np.float32))
    mag = want.abs().clamp_min(2.0 ** -7)
    step = torch.exp2(torch.frexp(mag)[1] - 8.0)
    return float(((got.float() - want).abs() / step).max())


# (B, S, D, text_len, block_s): ragged S (a full block and a 188-row tail),
# the text boundary inside a block, text_len 0 and text_len >= S
_CASES = [(2, 700, 128, 226, 512), (2, 256, 128, 100, 128),
          (1, 130, 256, 0, 128), (1, 96, 64, 200, 32)]


@pytest.mark.parametrize("B,S,D,text_len,block_s", _CASES)
def test_adaln_plain_matches_pallas_interpret_f32(B, S, D, text_len,
                                                  block_s):
    """f32: 1e-5 relative + 1e-5 absolute (the sums of a row run in
    another order)."""
    args = _inputs(B, S, D, seed=10)
    want = jadaln._fused(*map(jnp.asarray, args), text_len, 1e-6, block_s,
                         interpret=True)
    got = tadaln.adaln_modulate(*map(T, args), text_len=text_len,
                                impl="kernel")
    assert got.dtype == torch.float32
    assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,S,D,text_len,block_s", _CASES[:2])
def test_adaln_plain_matches_pallas_interpret_bf16(B, S, D, text_len,
                                                   block_s):
    """bf16 I/O: both compute in f32 and round once, so they agree within
    one bf16 step per element."""
    args = [a.astype(jnp.bfloat16) for a in map(jnp.asarray,
                                                _inputs(B, S, D, seed=20))]
    want = jadaln._fused(*args, text_len, 1e-6, block_s, interpret=True)
    targs = [T(np.array(a.astype(jnp.float32))).bfloat16() for a in args]
    got = tadaln.adaln_modulate(*targs, text_len=text_len, impl="kernel")
    assert got.dtype == torch.bfloat16
    assert _bf16_steps(got, want.astype(jnp.float32)) <= 1.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adaln_reference_matches_xla(dtype):
    """The unfused chain rounds where JAX's `_xla` rounds: 1e-5 in f32,
    two bf16 steps in bf16 (a row sum that lands on another side of a
    rounding boundary moves the normalised value by a step, and the
    modulate can double it)."""
    args = _inputs(2, 300, 128, seed=30)
    jargs = list(map(jnp.asarray, args))
    targs = list(map(T, args))
    if dtype == "bf16":
        jargs = [a.astype(jnp.bfloat16) for a in jargs]
        targs = [T(np.array(a.astype(jnp.float32))).bfloat16()
                 for a in jargs]
    want = jadaln._xla(*jargs, 100, 1e-6).astype(jnp.float32)
    for impl in ("xla", "auto"):        # auto on a CPU tensor: the reference
        got = tadaln.adaln_modulate(*targs, text_len=100, impl=impl)
        if dtype == "f32":
            assert_close(got, want, atol=1e-5, rtol=1e-5)
        else:
            assert got.dtype == torch.bfloat16
            assert _bf16_steps(got, want) <= 2.0


def test_adaln_gradients_match_jax():
    """Backward of the fused function = autograd of the reference
    expression, against jax.grad of `_xla` (2e-4, the bar of
    tests/test_fused_adaln.py)."""
    args = _inputs(2, 256, 128, seed=40)

    def f_xla(*a):
        return jnp.sum(jadaln._xla(*a, 100, 1e-6) ** 2)

    want = jax.grad(f_xla, argnums=tuple(range(7)))(*map(jnp.asarray, args))
    targs = [T(a).requires_grad_(True) for a in args]
    out = tadaln.adaln_modulate(*targs, text_len=100, impl="kernel")
    out.square().sum().backward()
    for t, g in zip(targs, want):
        assert float(np.abs(np.asarray(g)).max()) > 1e-3
        assert_close(t.grad, g, atol=2e-4, rtol=2e-4)
    # only the inputs that need a gradient get one
    targs = [T(a) for a in args]
    targs[0].requires_grad_(True)
    tadaln.adaln_modulate(*targs, text_len=100,
                          impl="kernel").sum().backward()
    assert targs[0].grad is not None and targs[1].grad is None


def test_adaln_refuses_unknown_impl_and_counts_no_cpu_launch():
    args = list(map(T, _inputs(1, 16, 8, seed=50)))
    with pytest.raises(ValueError):
        tadaln.adaln_modulate(*args, text_len=4, impl="pallas")
    before = tadaln.adaln_fused.launches
    tadaln.adaln_modulate(*args, text_len=4, impl="kernel")
    assert tadaln.adaln_fused.launches == before   # the plain version ran


def test_dit_with_fused_adaln_knob_matches_jax(monkeypatch):
    """LANDIFF_FUSED_ADALN=1 routes the layer's two modulations through
    adaln_modulate in both packages; on the CPU both fall to the unfused
    chain, so the port equals its own knob-off result bit for bit and
    JAX's within the DiT test's f32 tolerance (1e-4)."""
    JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    jparams, tparams = stage2_params()
    d = JC.dit
    x = randn(0, 2, d.latent_frames, d.in_channels, d.latent_height,
              d.latent_width)
    ctx = randn(2, 2, d.text_length, d.text_dim)
    ts = np.array([999.0, 421.0], np.float32)
    calls = []
    real = tdit.adaln_modulate
    monkeypatch.setattr(tdit, "adaln_modulate",
                        lambda *a, **k: calls.append(k) or real(*a, **k))

    def port():
        return tdit.forward(tparams["main"], T(x), T(ts), T(ctx), TC.dit,
                            compute_dtype=torch.float32)

    monkeypatch.delenv("LANDIFF_FUSED_ADALN", raising=False)
    base = port()
    assert not calls
    monkeypatch.setenv("LANDIFF_FUSED_ADALN", "1")
    fused = port()
    assert len(calls) == 2 * d.num_layers
    assert all(k["impl"] == "auto" and k["text_len"] == d.text_length
               for k in calls)
    assert torch.equal(base, fused)
    want = jdit.forward(jparams["main"], jnp.asarray(x), jnp.asarray(ts),
                        jnp.asarray(ctx), d, attn_impl="xla",
                        compute_dtype=jnp.float32)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    assert_close(fused, want, atol=1e-4, rtol=1e-4)


def test_dit_layer_with_kernel_route_close_to_unfused(monkeypatch):
    """What the card runs under the knob at the main shapes: the fused
    function (here its plain version) in place of the unfused chain.
    In f32 the two differ only in the order of sums: 1e-4."""
    TC = tcfg.tiny_test_config()
    _, tparams = stage2_params()
    d = TC.dit
    x = randn(3, 2, d.latent_frames, d.in_channels, d.latent_height,
              d.latent_width)
    ctx = randn(4, 2, d.text_length, d.text_dim)
    ts = np.array([500.0, 20.0], np.float32)
    fwd = lambda: tdit.forward(tparams["main"], T(x), T(ts), T(ctx), d,
                               compute_dtype=torch.float32)
    monkeypatch.delenv("LANDIFF_FUSED_ADALN", raising=False)
    base = fwd()
    monkeypatch.setenv("LANDIFF_FUSED_ADALN", "1")
    monkeypatch.setattr(
        tdit, "adaln_modulate",
        lambda *a, impl, **k: tadaln.adaln_modulate(*a, impl="kernel", **k))
    fused = fwd()
    assert_close(fused, base.numpy(), atol=1e-4, rtol=1e-4)
