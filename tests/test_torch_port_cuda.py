"""PyTorch port: the CUDA kernels (flash forwards, flash backward, fused
adaLN) against their plain versions, on the card only (skipped elsewhere; run them where
the card is, with
`python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py`).

Tolerance (attention.kernel_error): max |kernel - plain| within one bf16
step at the largest |plain| output, relative RMS error within 3e-4, lse
within 1e-5 (log2 units): about twice the readings on an H100 (0.5 steps,
9.4e-5, 1.9e-6). Both round p to bf16 at the same running max; exp2 and
the order of the f32 sums differ, which can move a p or an output across
a bf16 rounding boundary.

The backward kernel takes the forward kernel's own out and lse; dq, dk and
dv are each held to its plain version within two bf16 steps at the largest
|plain| value and a relative RMS error of 2e-3: p and scale*ds are rounded
to bf16 in both, from exp2 results and f32 sums that differ in their last
bits, and dq is summed by bulk reduce-adds in an order that changes from
run to run. Rows that see nothing give exactly 0; dk and dv are the same
from call to call. Its prologue gives q' and the padded lse exactly and
delta within 1e-5 (the order of a 64-term f32 sum).

The int8_pv and exp_bf16 variants of the forward are held to their plain
versions with the forward's limits widened by what each variant's
arithmetic can move (attention.variant_limits, as chip_smoke.py holds
them); the W8A8 product of the DiT to its CPU result bit for bit.

The f32 kernels are held within attention.F32_TOL: the 3xTF32 exact
forward and backward to the plain version in float64
(attention.f64_reference), the SIMT int8-score forms to the f32 one; their
variants within attention.f32_variant_limits.

The adaLN kernel and its plain version both compute in f32 and round
once: within one bf16 step per element in bf16 (steps taken at the
element's own size, not below that at 2^-7) and 1e-5 relative + 1e-5
absolute in f32."""

import functools

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
# beside them, shapes that straddle the forward's 192 x 128 tiles: Skv mod
# 128 = 0, 64, 112, 1; Sq mod 128 = 0, 1, 127 and Sq mod 192 = 0, 1, 191;
# Sq != Skv both ways; and two whole q tiles past the decoder layout,
# which see no kv tile at all
_FWD_CASES = _CASES + [
    (None, 128, 384), (None, 129, 320), (None, 255, 240), (None, 384, 129),
    (None, 1, 130), (None, 193, 192), (None, 383, 448), ("causal", 513, 513),
    ("decoder", _LAYOUT.seq_len + 256, _LAYOUT.seq_len + 256)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("mask,Sq,Skv", _FWD_CASES)
def test_kernel_matches_plain(dev, int8, mask, Sq, Skv):
    mf = _MASKS[mask]
    q, k, v = _qkv(dev, 2, Sq, Skv, 3)
    fn, plain = ((TA.flash_fwd_int8, TA.flash_int8_plain) if int8
                 else (TA.flash_fwd_exact, TA.flash_exact_plain))
    name = TA.variant_name(int8)
    before = TA.LAUNCHES[name]
    out, lse = fn(q, k, v, mask_fn=mf)
    torch.cuda.synchronize()
    assert TA.LAUNCHES[name] == before + 1
    ref, ref_lse = plain(q, k, v, mask_fn=mf)
    steps, rel_rms = TA.kernel_error(out, ref)
    assert steps <= _TOL_STEPS and rel_rms <= _TOL_RMS, (steps, rel_rms)
    assert (lse - ref_lse).abs().max().item() <= _LSE_TOL
    if mask == "decoder" and Sq > _LAYOUT.seq_len:   # rows that see nothing
        assert out[:, _LAYOUT.seq_len:].abs().max().item() == 0.0
        assert lse[:, :, _LAYOUT.seq_len:].max().item() == \
            torch.tensor(TA.NEG_INF, dtype=torch.float32).item()


# (int8_pv, exp_bf16) of the int8 kernel, and exp_bf16 of the exact one
_VARIANTS = [(True, True, False), (True, True, True), (True, False, True),
             (False, False, True)]


@pytest.mark.parametrize("int8", [False, True])
def test_kernel_matches_plain_at_the_titok_encoder_mask(dev, int8):
    """The video encoder mask at the full TiTok layout (18,768 positions),
    B * H = 2: until now held only at small layouts."""
    from landiff_tpu_torch.config import TiTokConfig

    c = TiTokConfig()
    layout = TM.VideoMaskLayout(num_frames=c.temporal_size,
                                tokens_per_frame=c.frame_tokens,
                                iframe_tokens=c.iframe_latent_tokens,
                                pframe_tokens=c.pframe_latent_tokens)
    mf = TM.video_encoder_mask(layout)
    S = layout.seq_len
    q, k, v = _qkv(dev, 1, S, S, 2, seed=7)
    fn, plain = ((TA.flash_fwd_int8, TA.flash_int8_plain) if int8
                 else (TA.flash_fwd_exact, TA.flash_exact_plain))
    out, lse = fn(q, k, v, mask_fn=mf)
    ref, ref_lse = plain(q, k, v, mask_fn=mf)
    steps, rel_rms = TA.kernel_error(out, ref)
    print("titok encoder", int8, "steps", steps, "rms", rel_rms)
    assert steps <= _TOL_STEPS and rel_rms <= _TOL_RMS, (steps, rel_rms)
    assert (lse - ref_lse).abs().max().item() <= _LSE_TOL


@pytest.mark.parametrize("S", [1, 130, 256])
def test_k_quantization_prologue_matches_plain(dev, S):
    """The int8 forward's prologue kernel (attention.quantize_k): the K
    codes and the padded (B*H, Skv_pad) scales exactly as the plain
    version gives them, a row of zeros included."""
    _, k, _ = _qkv(dev, 2, S, S, 3, seed=6)
    k[1, 0, 2] = 0.0
    got, want = TA.quantize_k(k), TA.quantize_k_plain(k)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


def test_card_exp2_is_within_its_bound(dev):
    """ex2.approx.ftz.bf16x2 on every bf16 input: within 2^-7 relative of
    2^x where 2^x is normal, 1 at 0, 0 at -inf."""
    e, differ = TA.card_exp2_error(str(dev))
    print("card exp2 max relative error", e, "not rounded", differ)
    assert e <= 2.0 ** -7
    x = torch.tensor([0.0, float("-inf")], device=dev).bfloat16()
    t = TA.card_exp2_table(str(dev))
    got = t[x.view(torch.int16).long() & 0xffff].float().tolist()
    assert got == [1.0, 0.0]


def _max_abs(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("int8,int8_pv,exp_bf16", _VARIANTS)
@pytest.mark.parametrize("mask,Sq,Skv", _FWD_CASES)
def test_variant_kernel_matches_plain(dev, int8, int8_pv, exp_bf16, mask, Sq,
                                      Skv):
    """The int8_pv and exp_bf16 variants against their plain versions at
    the kernel's kv tile (128) and V block (v_block_rows), with the base limits
    widened by what each variant's arithmetic moves
    (attention.variant_limits): the exp_bf16 ones both against the plain
    version with the card's own exp2 and against the true 2^x."""
    mf = _MASKS[mask]
    q, k, v = _qkv(dev, 2, Sq, Skv, 3, seed=3)
    name = TA.variant_name(int8, int8_pv, exp_bf16)
    before = TA.LAUNCHES[name]
    if int8:
        out, lse = TA.flash_fwd_int8(q, k, v, mask_fn=mf, int8_pv=int8_pv,
                                     exp_bf16=exp_bf16)
        plain = lambda **kw: TA.flash_int8_plain(
            q, k, v, mask_fn=mf, int8_pv=int8_pv, exp_bf16=exp_bf16, **kw)
    else:
        out, lse = TA.flash_fwd_exact(q, k, v, mask_fn=mf, exp_bf16=exp_bf16)
        plain = lambda **kw: TA.flash_exact_plain(
            q, k, v, mask_fn=mf, exp_bf16=exp_bf16, **kw)
    torch.cuda.synchronize()
    assert TA.LAUNCHES[name] == before + 1
    ref, ref_lse = plain()
    lim = TA.variant_limits(ref, v, int8_pv=int8_pv, exp_bf16=exp_bf16,
                            tol_steps=_TOL_STEPS, tol_rms=_TOL_RMS,
                            lse_tol=_LSE_TOL)
    err, lse_err = _max_abs(out, ref), _max_abs(lse, ref_lse)
    steps, rel_rms = TA.kernel_error(out, ref)
    print(name, mask, Sq, Skv, "max", err, "steps", steps, "rms", rel_rms,
          "lse", lse_err)
    assert err <= lim["max_abs"] and rel_rms <= lim["rel_rms"], (err, rel_rms,
                                                                 lim)
    assert lse_err <= lim["lse"], (lse_err, lim)
    if exp_bf16:
        card, card_lse = plain(exp2_table=TA.card_exp2_table(str(dev)))
        c_err, c_lse = _max_abs(out, card), _max_abs(lse, card_lse)
        c_rms = TA.kernel_error(out, card)[1]
        print(name, "vs card exp2: max", c_err, "rms", c_rms, "lse", c_lse)
        c = lim["card"]
        assert c_err <= c["max_abs"] and c_rms <= c["rel_rms"], (c_err, c_rms)
        assert c_lse <= c["lse"], c_lse
    if mask == "decoder" and Sq > _LAYOUT.seq_len:   # rows that see nothing
        assert out[:, _LAYOUT.seq_len:].abs().max().item() == 0.0


@pytest.mark.parametrize("gate", ["int8", "int8_pv", "w8a8"])
def test_quantized_dit_drift_on_the_card(dev, gate):
    """The drift gates of tests/test_torch_port_drift.py in bf16 through
    the kernels (diffusion/drift.py, JAX's thresholds and the share of
    attention's contribution); each quantized run launches only its
    variant, once per layer and step (3 steps x 3 layers)."""
    from landiff_tpu_torch.diffusion import drift

    res = drift.run_gate(gate, device="cuda", dtype=torch.bfloat16)
    print(gate, res)
    assert res["passed"], res
    want = {"int8": {"flash_fwd_int8": 9},
            "int8_pv": {"flash_fwd_int8_pv": 9}, "w8a8": {}}[gate]
    assert res["launches"] == want, res["launches"]


def test_w8a8_matmul_on_the_card(dev):
    """The W8A8 product (torch._int_mm) on the card equals the same
    arithmetic on the CPU bit for bit, for the column-major codes
    dit.quantize_int8 makes and for row-major ones (bridged from JAX)."""
    from landiff_tpu_torch.models import dit as TD

    g = torch.Generator(device=dev).manual_seed(4)
    w = torch.randn((192, 320), generator=g, device=dev) * 0.05
    leaf = TD.quantize_int8({"layers": [{"qkv_w": w}]})["layers"][0]["qkv_w"]
    assert leaf["q"].stride() == (1, 192)
    x = (torch.randn((2, 37, 192), generator=g, device=dev) * 2).bfloat16()
    want = TD._w8a8_matmul(x.cpu(), leaf["q"].cpu(), leaf["s"].cpu())
    for q in (leaf["q"], leaf["q"].contiguous()):
        got = TD._w8a8_matmul(x, q, leaf["s"])
        assert torch.equal(got.cpu(), want)


_BWD_TOL_STEPS = 2.0
_BWD_TOL_RMS = 2e-3


# beside the forward's cases: kv lengths at the backward's 128-row kv tile
# (Skv mod 128 = 0, 64, 112, 1), Sq != Skv both ways, one q row
@pytest.mark.parametrize("mask,Sq,Skv", _CASES + [
    (None, 64, 64), (None, 1, 130), (None, 192, 192), (None, 240, 240),
    (None, 129, 129), (None, 100, 369), (None, 512, 384)])
def test_bwd_kernel_matches_plain(dev, mask, Sq, Skv):
    """dq, dk, dv against the plain version (at the kernel's 64 x 128
    tiles), B * H = 6; dk and dv bit-identical from a second call."""
    mf = _MASKS[mask]
    q, k, v = _qkv(dev, 2, Sq, Skv, 3, seed=1)
    out, lse = TA.flash_fwd_exact(q, k, v, mask_fn=mf)
    do = torch.randn(out.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(2)
                     ).bfloat16()
    before = TA.LAUNCHES["flash_bwd"]
    got = TA.flash_bwd(q, k, v, out, lse, do, mask_fn=mf)
    torch.cuda.synchronize()
    assert TA.LAUNCHES["flash_bwd"] == before + 1
    want = TA.flash_bwd_plain(q, k, v, out, lse, do, mask_fn=mf)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert bool(torch.isfinite(g.float()).all()), name
        steps, rel_rms = TA.kernel_error(g, w)
        assert steps <= _BWD_TOL_STEPS and rel_rms <= _BWD_TOL_RMS, \
            (name, steps, rel_rms)
    again = TA.flash_bwd(q, k, v, out, lse, do, mask_fn=mf)
    assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])
    if mask == "decoder" and Sq > _LAYOUT.seq_len:   # rows that see nothing
        assert got[0][:, _LAYOUT.seq_len:].abs().max().item() == 0.0
        # and no row sees the kv positions past the layout
        assert got[1][:, _LAYOUT.seq_len:].abs().max().item() == 0.0
        assert got[2][:, _LAYOUT.seq_len:].abs().max().item() == 0.0


@pytest.mark.parametrize("Sq", [1, 187, 256])
def test_bwd_prologue_matches_plain(dev, Sq):
    """q' and the padded lse exactly, delta within the order of its f32
    sums, the dq workspace zeroed (rows past Sq too)."""
    q, k, v = _qkv(dev, 2, Sq, Sq, 3, seed=5)
    out, lse = TA.flash_fwd_exact(q, k, v)
    do = (torch.randn(out.shape, device=dev) * 0.5).bfloat16()
    # NaN in the memory the allocator hands out next: the zeros are written
    junk = torch.full((2, 3, -(-Sq // 64) * 64, 64), float("nan"), device=dev)
    del junk
    got = TA.flash_bwd_prep(q, out, lse, do)
    torch.cuda.synchronize()
    want = TA.flash_bwd_prep_plain(q, out, lse, do)
    names = ("qs", "lse_pad", "delta", "ws")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], atol=1e-5, rtol=1e-5)
    assert torch.equal(got[3], want[3])


def test_attention_under_grad_takes_the_exact_forward_and_the_bwd_kernel(
        dev, monkeypatch):
    monkeypatch.setenv("LANDIFF_ATTN_INT8", "1")
    q, k, v = (t.requires_grad_() for t in _qkv(dev, 1, 2112, 2112, 2))
    TA.reset_launch_counts()
    out = TA.attention(q, k, v)
    assert out.grad_fn is not None
    assert (TA.LAUNCHES["flash_fwd_exact"],
            TA.LAUNCHES["flash_fwd_int8"]) == (1, 0)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert TA.LAUNCHES["flash_bwd"] == 1
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    TA.mha_reference(*ref).float().square().sum().backward()
    for t, r in zip((q, k, v), ref):
        steps, rel_rms = TA.kernel_error(t.grad, r.grad)
        assert rel_rms <= 2e-2, (steps, rel_rms)     # bf16 p and ds
    with torch.no_grad():                            # today's selection
        TA.attention(q, k, v)
    assert TA.LAUNCHES["flash_fwd_int8"] == 1


def test_bwd_knob_selects_the_plain_version(dev, monkeypatch):
    monkeypatch.setenv("LANDIFF_ATTN_BWD", "xla")
    q, k, v = (t.requires_grad_() for t in _qkv(dev, 1, 128, 128, 2))
    TA.reset_launch_counts()
    TA.attention(q, k, v, impl="pallas").float().sum().backward()
    assert TA.LAUNCHES["flash_bwd"] == 0 and q.grad is not None


def test_kernel_refuses_what_it_does_not_take(dev):
    q, k, v = _qkv(dev, 1, 128, 128, 2)
    with pytest.raises(TypeError):      # bf16 and f32 only, one dtype
        TA.flash_fwd_exact(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        TA.flash_fwd_exact(q.float(), k, v)
    with pytest.raises(ValueError):
        TA.flash_fwd_exact(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous())
    with pytest.raises(ValueError):
        TA.flash_fwd_int8(q.transpose(1, 2), k, v)
    out, lse = TA.flash_fwd_exact(q, k, v)
    with pytest.raises(ValueError):     # out in another dtype than q
        TA.flash_bwd(q.float(), k.float(), v.float(), out, lse, out)
    with pytest.raises(ValueError):
        TA.flash_bwd(q, k, v, out, lse[:, :, :-1].contiguous(), out)


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


# ---------------------------------------------------------------------------
# the f32 kernels (csrc/flash_f32.cu), held to their plain versions (in
# float64 for the 3xTF32 kernels, attention.f64_reference) within
# attention.F32_TOL, which a TF32 product would miss by far


def _qkv32(dev, B, Sq, Skv, H, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    return r(B, Sq, H, 64) * 2, r(B, Skv, H, 64), r(B, Skv, H, 64)


_F32_CASES = [(None, 256, 256), (None, 300, 187), (None, 1, 130),
              (None, 129, 65), ("causal", 333, 333),
              ("decoder", _LAYOUT.seq_len, _LAYOUT.seq_len),
              ("decoder", _LAYOUT.seq_len + 100, _LAYOUT.seq_len + 100),
              ("encoder", _LAYOUT.seq_len, _LAYOUT.seq_len)]


@pytest.fixture
def f32_matmul(dev):
    """the plain versions in f32 products, not TF32"""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("mask,Sq,Skv", _F32_CASES)
def test_f32_kernel_matches_plain(dev, f32_matmul, int8, mask, Sq, Skv):
    mf = _MASKS[mask]
    q, k, v = _qkv32(dev, 2, Sq, Skv, 3)
    fn, plain = ((TA.flash_fwd_int8, TA.flash_int8_plain) if int8
                 else (TA.flash_fwd_exact, TA.flash_exact_plain))
    name = TA.variant_name(int8, f32=True)
    before = TA.LAUNCHES[name]
    out, lse = fn(q, k, v, mask_fn=mf)
    torch.cuda.synchronize()
    assert TA.LAUNCHES[name] == before + 1 and out.dtype == torch.float32
    # the 3xTF32 exact form against the plain version in float64
    ref, ref_lse = (plain if int8 else functools.partial(
        TA.f64_reference, plain))(q, k, v, mask_fn=mf,
                                  block_kv=TA.F32_BLOCK_KV)
    tol = TA.F32_TOL["fwd"]
    max_rel, rel_rms = TA.kernel_error_rel(out, ref)
    assert max_rel <= tol["max_rel"] and rel_rms <= tol["rel_rms"], \
        (max_rel, rel_rms)
    assert (lse - ref_lse).abs().max().item() <= tol["lse"]
    if mask == "decoder" and Sq > _LAYOUT.seq_len:   # rows that see nothing
        assert out[:, _LAYOUT.seq_len:].abs().max().item() == 0.0


def test_f32_k_quantization_prologue_matches_plain(dev):
    k = _qkv32(dev, 2, 1, 300, 3)[1]
    got, want = TA.quantize_k(k), TA.quantize_k_plain(k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("int8,int8_pv,exp_bf16", [
    (True, True, False), (True, True, True), (True, False, True),
    (False, False, True)])
@pytest.mark.parametrize("mask,Sq,Skv", [(None, 300, 187), ("causal", 333, 333),
                                         ("decoder", _LAYOUT.seq_len + 100,
                                          _LAYOUT.seq_len + 100)])
def test_f32_variants_of_the_fast_path_match_plain(dev, f32_matmul, int8,
                                                   int8_pv, exp_bf16, mask,
                                                   Sq, Skv):
    """The int8_pv and exp_bf16 forms in f32 run their kernels and match
    their plain versions (at the f32 kernels' kv tile) within
    attention.f32_variant_limits; the exp_bf16 ones also the plain version
    with the card's own exp2. f16 is refused."""
    mf = _MASKS[mask]
    q, k, v = _qkv32(dev, 2, Sq, Skv, 3, seed=4)
    opts = dict(exp_bf16=exp_bf16, **({"int8_pv": int8_pv} if int8 else {}))
    fn, plain = ((TA.flash_fwd_int8, TA.flash_int8_plain) if int8
                 else (TA.flash_fwd_exact, TA.flash_exact_plain))
    name = TA.variant_name(int8, int8_pv, exp_bf16, f32=True)
    before = TA.LAUNCHES[name]
    out, lse = fn(q, k, v, mask_fn=mf, **opts)
    torch.cuda.synchronize()
    assert TA.LAUNCHES[name] == before + 1 and out.dtype == torch.float32
    if not int8:   # the 3xTF32 exact form: the plain version in float64
        plain = functools.partial(TA.f64_reference, plain)
    ref, ref_lse = plain(q, k, v, mask_fn=mf, block_kv=TA.F32_BLOCK_KV,
                         **opts)
    lim = TA.f32_variant_limits(ref, v, int8=int8, int8_pv=int8_pv,
                                exp_bf16=exp_bf16)
    assert (out - ref).abs().max().item() <= lim["max_abs"]
    assert TA.kernel_error_rel(out, ref)[1] <= lim["rel_rms"]
    assert (lse - ref_lse).abs().max().item() <= lim["lse"]
    if exp_bf16:
        card, card_lse = plain(q, k, v, mask_fn=mf, block_kv=TA.F32_BLOCK_KV,
                               exp2_table=TA.card_exp2_table("cuda"), **opts)
        assert (out - card).abs().max().item() <= lim["card"]["max_abs"]
        assert TA.kernel_error_rel(out, card)[1] <= lim["card"]["rel_rms"]
        assert (lse - card_lse).abs().max().item() <= lim["card"]["lse"]
    with pytest.raises(TypeError):
        TA.flash_fwd_exact(q.half(), k.half(), v.half())


def test_f32_dispatcher_launches_int8_pv(dev, f32_matmul, monkeypatch):
    """attention() on f32 inputs under LANDIFF_ATTN_INT8_PV=1 takes the
    int8_pv kernel on its int8 route (640 positions: two 512-row q
    blocks) and gives what flash_fwd_int8(int8_pv=True) gives."""
    monkeypatch.setenv("LANDIFF_ATTN_INT8_PV", "1")
    q, k, v = _qkv32(dev, 1, 640, 640, 2, seed=6)
    TA.reset_launch_counts()
    got = TA.attention(q, k, v, impl="pallas")
    torch.cuda.synchronize()
    assert TA.LAUNCHES["flash_fwd_int8_pv_f32"] == 1
    assert sum(TA.LAUNCHES.values()) == 1
    want = TA.flash_fwd_int8(q, k, v, int8_pv=True)[0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,S,H,s_pad", [(2, 300, 3, 320), (1, 64, 1, 64),
                                         (1, 17, 2, 128)])
def test_tf32_split_prologues_match_plain(dev, B, S, H, s_pad):
    """The 3xTF32 kernels' prologues (csrc/flash_f32.cu landiff_tf32_split,
    landiff_tf32_split_t) give their plain versions bit for bit."""
    x = torch.randn((B, S, H, 64), device=dev) * 3
    x[0, 0, 0, :4] = torch.tensor([0.0, -0.0, 1.0 + 2.0 ** -11, 2.0 ** -126])
    for got, want in ((TA.tf32_split(x), TA.tf32_split_plain(x)),
                      (TA.tf32_split_t(x, s_pad),
                       TA.tf32_split_t_plain(x, s_pad))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("mask,Sq,Skv", _F32_CASES + [(None, 64, 64),
                                                      (None, 100, 369)])
def test_f32_bwd_kernel_matches_plain(dev, f32_matmul, mask, Sq, Skv):
    """dq, dk, dv in f32 against the plain version in float64; dk and dv
    bit-identical from a second call (dq is summed by bulk reduce-adds in
    no fixed order)."""
    mf = _MASKS[mask]
    q, k, v = _qkv32(dev, 2, Sq, Skv, 3, seed=1)
    out, lse = TA.flash_fwd_exact(q, k, v, mask_fn=mf)
    do = torch.randn(out.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(2))
    before = TA.LAUNCHES["flash_bwd_f32"]
    got = TA.flash_bwd(q, k, v, out, lse, do, mask_fn=mf)
    torch.cuda.synchronize()
    assert TA.LAUNCHES["flash_bwd_f32"] == before + 1
    want = TA.f64_reference(TA.flash_bwd_plain, q, k, v, out, lse, do,
                            mask_fn=mf)
    tol = TA.F32_TOL["bwd"]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        max_rel, rel_rms = TA.kernel_error_rel(g, w)
        assert max_rel <= tol["max_rel"] and rel_rms <= tol["rel_rms"], \
            (name, max_rel, rel_rms)
    again = TA.flash_bwd(q, k, v, out, lse, do, mask_fn=mf)
    assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])


def test_f32_bwd_prologue_matches_plain(dev):
    """The f32 prologue gives the padded lse exactly, delta within 1e-5
    and a zeroed float64 dq workspace; q' is left to the main kernel
    (None)."""
    q, k, v = _qkv32(dev, 2, 187, 187, 3, seed=5)
    out, lse = TA.flash_fwd_exact(q, k, v)
    do = torch.randn(out.shape, device=dev) * 0.5
    got = TA.flash_bwd_prep(q, out, lse, do)
    want = TA.flash_bwd_prep_plain(q, out, lse, do)
    assert got[0] is None and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], atol=1e-5, rtol=1e-5)
    assert got[3].dtype == torch.float64
    assert torch.equal(got[3], want[3].double())


def test_remat_save_attn_on_the_card(dev, monkeypatch):
    """LANDIFF_REMAT_SAVE_ATTN=1 on the card: the recompute launches no
    exact forward and the gradients equal those without the knob (dq's
    atomics aside: within the bf16 backward's own run-to-run spread)."""
    from landiff_tpu_torch import config as tcfg
    from landiff_tpu_torch.models import dit as tdit
    from landiff_tpu_torch.pipeline import dif_infer as tdi
    from landiff_tpu_torch.training import optim
    from landiff_tpu_torch.utils import fill_zero_leaves, tree_map

    import dataclasses

    full = tcfg.tiny_test_config()   # one head of 64, the kernels' width
    full = dataclasses.replace(full, dit=dataclasses.replace(full.dit,
                                                              num_heads=1))
    cfg = full.dit
    gen = torch.Generator().manual_seed(0)
    params = fill_zero_leaves(tdi.init_params(gen, full), gen)
    params = tree_map(lambda t: t.to(dev), params)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((1, cfg.latent_frames, cfg.in_channels,
                     cfg.latent_height, cfg.latent_width), generator=g,
                    device=dev)
    sem = torch.randn(x.shape, generator=g, device=dev)
    ctx = torch.randn((1, cfg.text_length, cfg.text_dim), generator=g,
                      device=dev)

    def step():
        ctrl = optim.require_grad(params["control"])
        TA.reset_launch_counts()
        out = tdit.control_warp_forward(
            params["main"], ctrl, x, torch.tensor([321.0], device=dev), ctx,
            cfg, sem, attn_impl="pallas", compute_dtype=torch.float32,
            remat=True)
        grads = optim.grad(out.square().mean(), ctrl)
        torch.cuda.synchronize()
        return dict(TA.LAUNCHES), grads

    plain_counts, plain = step()
    monkeypatch.setenv("LANDIFF_REMAT_SAVE_ATTN", "1")
    saved_counts, saved = step()
    exact = TA.variant_name(False, f32=True)
    n_grad = cfg.control_layers + cfg.num_layers - 1
    assert plain_counts[exact] - saved_counts[exact] == n_grad
    for name in plain["layers"][0]:
        a, b = plain["layers"][0][name], saved["layers"][0][name]
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6), name


def test_loader_on_the_card(dev, tmp_path):
    """A synthetic tiny checkpoint tree loaded straight onto the card
    (ckpt/load.py): every tensor on the device, equal to the CPU load."""
    from landiff_tpu_torch import config as tcfg
    from landiff_tpu_torch.ckpt import load as tload
    from landiff_tpu_torch.ckpt import synth
    from landiff_tpu_torch.utils import tree_leaves

    cfg = tcfg.tiny_test_config()
    synth.write_tree(tmp_path, cfg, seed=3)
    for fn in (tload.load_stage1, tload.load_stage2):
        on_card = tree_leaves(fn(tmp_path, cfg, device="cuda"))
        on_cpu = tree_leaves(fn(tmp_path, cfg, device="cpu"))
        assert on_card and all(t.is_cuda for t in on_card)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu))
    half = tree_leaves(tload.load_vae(tmp_path, cfg, dtype=torch.bfloat16,
                                      device="cuda"))
    assert all(t.dtype == torch.bfloat16 and t.is_cuda for t in half)
