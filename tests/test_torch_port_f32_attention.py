"""PyTorch port: the flash kernels in f32. The plain versions, which the
f32 CUDA kernels (csrc/flash_f32.cu) are held to on the card and which the
CPU runs, against the JAX Pallas kernels in interpret mode given f32
inputs, tile for tile (block_q = block_kv = 16), with a causal and a
video-decoder mask; the kernels' input check; the route rule at the DiT
and TiTok shapes in f32.

Tolerances: f32 sums in another order, 2e-5 absolute + 2e-5 relative;
the log2 lse to 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import assert_close, fast_jit, randn
from landiff_tpu.ops import attention as JA
from landiff_tpu.ops import masks as JM
from landiff_tpu_torch.ops import attention as TA
from landiff_tpu_torch.ops import masks as TM

torch.set_num_threads(2)   # tier-1 runs six xdist workers

_LAYOUT = dict(num_frames=3, tokens_per_frame=8, iframe_tokens=5,
               pframe_tokens=2)
_MASKS = {"causal": (JM.causal, TM.causal),
          "decoder": (JM.video_decoder_mask(JM.VideoMaskLayout(**_LAYOUT)),
                      TM.video_decoder_mask(TM.VideoMaskLayout(**_LAYOUT)))}
# the decoder layout's sequence is 33: rows past it see nothing
_S = 41
_TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed):
    return (randn(seed, 1, _S, 2, 32, scale=2.0), randn(seed + 1, 1, _S, 2, 32),
            randn(seed + 2, 1, _S, 2, 32), randn(seed + 3, 1, _S, 2, 32))


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """The JAX forwards (exact and int8 scores) and the Pallas backward
    from the exact forward's out / lse, in f32, interpret mode."""
    jm = _MASKS[name][0]
    args = tuple(jnp.asarray(a) for a in _inputs(20))

    def run(q, k, v, do):
        fwd = functools.partial(
            JA.flash_attention, mask_fn=jm, block_q=16, block_kv=16,
            interpret=True, exp_bf16=False, int8_pv=False, return_lse=True)
        out, lse = fwd(q, k, v, int8_scores=False)
        out8, lse8 = fwd(q, k, v, int8_scores=True)
        grads = JA._flash_bwd_pallas(q, k, v, out, lse, do, jm, None,
                                     block_q=16, block_kv=16, interpret=True)
        return out, lse, out8, lse8, grads

    return jax.tree_util.tree_map(np.asarray, fast_jit(run, *args)(*args))


@pytest.mark.parametrize("name", ["causal", "decoder"])
@pytest.mark.parametrize("int8", [False, True])
def test_f32_plain_forward_matches_jax_interpret(name, int8):
    out, lse, out8, lse8, _ = _jax_case(name)
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(20))
    plain = TA.flash_int8_plain if int8 else TA.flash_exact_plain
    got, got_lse = plain(q, k, v, mask_fn=_MASKS[name][1], block_kv=16)
    assert got.dtype == torch.float32
    assert_close(got, out8 if int8 else out, **_TOL)
    want_lse = lse8 if int8 else lse
    rows = np.isfinite(want_lse) & (want_lse > -1e29)
    assert_close(got_lse[torch.from_numpy(rows)], want_lse[rows],
                 atol=1e-5, rtol=1e-6)
    if name == "decoder":   # rows past the layout: 0, lse -1e30
        assert float(got[:, 33:].abs().max()) == 0.0
        assert float(got_lse[..., 33:].max()) == float(np.float32(TA.NEG_INF))


@pytest.mark.parametrize("name", ["causal", "decoder"])
def test_f32_plain_backward_matches_jax_interpret(name):
    out, lse, _, _, grads = _jax_case(name)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(20))
    got = TA.flash_bwd_plain(q, k, v, torch.from_numpy(out),
                             torch.from_numpy(lse), do,
                             mask_fn=_MASKS[name][1], block_q=16,
                             block_kv=16)
    for g, w in zip(got, grads):
        assert g.dtype == torch.float32
        assert_close(g, w, **_TOL)


def test_kernel_input_check_takes_f32_and_refuses_f16():
    """bf16 and f32 pass the dtype check (on the CPU the next check, for a
    CUDA tensor, is what refuses them); f16 and mixed dtypes do not."""
    x = torch.zeros((1, 8, 1, 64))
    for dt in (torch.float32, torch.bfloat16):
        t = x.to(dt)
        with pytest.raises(ValueError, match="CUDA"):
            TA._check_inputs(t, t, t)
    h = x.half()
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        TA._check_inputs(h, h, h)
    with pytest.raises(TypeError, match="one dtype"):
        TA._check_inputs(x, x.bfloat16(), x)


@pytest.mark.parametrize("itemsize,dit,titok", [(2, "int8", "int8"),
                                                (4, "int8", "exact")])
def test_select_path_at_the_dit_and_titok_shapes(itemsize, dit, titok):
    """At f32 the DiT's kv (17,776 -> 18,432 rows) fills the 9 MiB budget
    of the "cached" rule exactly, so the int8-score form is taken; the
    TiTok decoder's (18,768 -> 19,456) misses it: the exact form."""
    assert TA.select_path(17776, 17776, 64, itemsize) == dit
    assert TA.select_path(18768, 18768, 64, itemsize) == titok
    assert 2 * 64 * 18432 * 4 == TA._KV_CACHE_VMEM_BUDGET


def test_f32_wrappers_run_the_plain_versions_on_the_cpu():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(21))
    out, lse = TA.flash_fwd_int8(q, k, v, mask_fn=TM.causal)
    want, want_lse = TA.flash_int8_plain(q, k, v, mask_fn=TM.causal)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    before = dict(TA.LAUNCHES)
    TA.flash_bwd(q, k, v, out, lse, do, mask_fn=TM.causal)
    assert TA.LAUNCHES == before     # nothing is launched on the CPU
