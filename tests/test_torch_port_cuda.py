"""PyTorch port: the CUDA flash kernels against their plain versions, on
the card only (skipped elsewhere; run them where the card is, with
`python -m pytest -m cuda tests/test_torch_port_cuda.py`).

Tolerance (attention.kernel_error): max |kernel - plain| within one bf16
step at the largest |plain| output, relative RMS error within 3e-4, lse
within 1e-5 (log2 units): about twice the readings on an H100 (0.5 steps,
9.4e-5, 1.9e-6). Both round p to bf16 at the same running max; exp2 and
the order of the f32 sums differ, which can move a p or an output across
a bf16 rounding boundary."""

import pytest
import torch

from landiff_tpu_torch.ops import attention as TA
from landiff_tpu_torch.ops import masks as TM

torch.set_num_threads(2)   # tier-1 runs six xdist workers


pytestmark = pytest.mark.cuda

_TOL_STEPS = 1.0
_TOL_RMS = 3e-4
_LSE_TOL = 1e-5
_LAYOUT = TM.VideoMaskLayout(num_frames=3, tokens_per_frame=150,
                             iframe_tokens=70, pframe_tokens=20)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _qkv(dev, B, Sq, Skv, H, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    return ((r(B, Sq, H, 64) * 2).bfloat16(), r(B, Skv, H, 64).bfloat16(),
            r(B, Skv, H, 64).bfloat16())


_CASES = [(None, 256, 256), (None, 300, 187), ("causal", 333, 333),
          ("decoder", _LAYOUT.seq_len, _LAYOUT.seq_len),
          ("decoder", _LAYOUT.seq_len + 40, _LAYOUT.seq_len + 40),
          ("encoder", _LAYOUT.seq_len, _LAYOUT.seq_len)]
_MASKS = {None: None, "causal": TM.causal,
          "decoder": TM.video_decoder_mask(_LAYOUT),
          "encoder": TM.video_encoder_mask(_LAYOUT)}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("mask,Sq,Skv", _CASES)
def test_kernel_matches_plain(dev, int8, mask, Sq, Skv):
    mf = _MASKS[mask]
    q, k, v = _qkv(dev, 2, Sq, Skv, 3)
    fn, plain = ((TA.flash_fwd_int8, TA.flash_int8_plain) if int8
                 else (TA.flash_fwd_exact, TA.flash_exact_plain))
    before = fn.launches
    out, lse = fn(q, k, v, mask_fn=mf)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref, ref_lse = plain(q, k, v, mask_fn=mf)
    steps, rel_rms = TA.kernel_error(out, ref)
    assert steps <= _TOL_STEPS and rel_rms <= _TOL_RMS, (steps, rel_rms)
    assert (lse - ref_lse).abs().max().item() <= _LSE_TOL
    if mask == "decoder" and Sq > _LAYOUT.seq_len:   # rows that see nothing
        assert out[:, _LAYOUT.seq_len:].abs().max().item() == 0.0
        assert lse[:, :, _LAYOUT.seq_len:].max().item() == \
            torch.tensor(TA.NEG_INF, dtype=torch.float32).item()


def test_kernel_refuses_what_it_does_not_take(dev):
    q, k, v = _qkv(dev, 1, 128, 128, 2)
    with pytest.raises(TypeError):
        TA.flash_fwd_exact(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        TA.flash_fwd_exact(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous())
    with pytest.raises(ValueError):
        TA.flash_fwd_int8(q.transpose(1, 2), k, v)
