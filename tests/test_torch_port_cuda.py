"""PyTorch port: the CUDA kernels (flash forwards, fused adaLN) against
their plain versions, on the card only (skipped elsewhere; run them where
the card is, with
`python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py`).

Tolerance (attention.kernel_error): max |kernel - plain| within one bf16
step at the largest |plain| output, relative RMS error within 3e-4, lse
within 1e-5 (log2 units): about twice the readings on an H100 (0.5 steps,
9.4e-5, 1.9e-6). Both round p to bf16 at the same running max; exp2 and
the order of the f32 sums differ, which can move a p or an output across
a bf16 rounding boundary.

The adaLN kernel and its plain version both compute in f32 and round
once: within one bf16 step per element in bf16 (steps taken at the
element's own size, not below that at 2^-7) and 1e-5 relative + 1e-5
absolute in f32."""

import pytest
import torch

from landiff_tpu_torch.ops import adaln as TN
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


def _adaln_inputs(dev, B, S, D, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    x = (r(B, S, D) * 1.5 + 0.3).to(dtype)
    w, b = (1.0 + 0.1 * r(D)).to(dtype), (0.1 * r(D)).to(dtype)
    # the four (B, D) pairs as the DiT hands them over: slices of one
    # (B, 4 D) tensor, rows not contiguous
    mods = (0.3 * r(B, 4 * D)).to(dtype).chunk(4, dim=-1)
    return x, w, b, *mods


def adaln_steps(out, ref):
    mag = ref.float().abs().clamp_min(2.0 ** -7)
    step = torch.exp2(torch.frexp(mag)[1] - 8.0)
    return ((out.float() - ref.float()).abs() / step).max().item()


# D: 3 of the 4 register tiers in each dtype, ragged last chunk (D = 200
# is 25 chunks of bf16, 50 of f32); S: ragged last block of 4 rows
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,D,text_len", [
    (2, 515, 128, 226), (1, 7, 200, 3), (2, 66, 1920, 0), (1, 33, 3072, 40),
    (3, 5, 4096, 2)])
def test_adaln_kernel_matches_plain(dev, dtype, B, S, D, text_len):
    args = _adaln_inputs(dev, B, S, D, dtype)
    before = TN.adaln_fused.launches
    out = TN.adaln_modulate(*args, text_len=text_len, impl="kernel")
    torch.cuda.synchronize()
    assert TN.adaln_fused.launches == before + 1
    ref = TN.adaln_plain(*args, text_len=text_len)
    assert out.dtype == dtype and out.shape == ref.shape
    if dtype == torch.bfloat16:
        assert adaln_steps(out, ref) <= 1.0
    else:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_adaln_auto_rule_and_refusals(dev):
    args = _adaln_inputs(dev, 1, 512, 128, torch.bfloat16)
    before = TN.adaln_fused.launches
    TN.adaln_modulate(*args, text_len=9)                 # D % 128, S >= 512
    assert TN.adaln_fused.launches == before + 1
    small = _adaln_inputs(dev, 1, 64, 128, torch.bfloat16)
    TN.adaln_modulate(*small, text_len=9)                # S < 512: reference
    assert TN.adaln_fused.launches == before + 1
    with pytest.raises(TypeError):
        TN.adaln_modulate(args[0].half(), *(a.half() for a in args[1:]),
                          text_len=9, impl="kernel")
    with pytest.raises(TypeError):                       # w in another dtype
        TN.adaln_modulate(args[0], args[1].float(), *args[2:], text_len=9,
                          impl="kernel")
    odd = _adaln_inputs(dev, 1, 8, 12, torch.bfloat16)
    with pytest.raises(ValueError):                      # D % 8
        TN.adaln_modulate(*odd, text_len=2, impl="kernel")


def test_adaln_kernel_backward_is_the_reference(dev):
    args = [a.float().requires_grad_(True)
            for a in _adaln_inputs(dev, 2, 40, 64, torch.float32)]
    TN.adaln_modulate(*args, text_len=11, impl="kernel").square().sum() \
        .backward()
    ref = [a.detach().clone().requires_grad_(True) for a in args]
    TN.adaln_reference(*ref, text_len=11).square().sum().backward()
    for a, r in zip(args, ref):
        torch.testing.assert_close(a.grad, r.grad, atol=2e-4, rtol=2e-4)
