"""PyTorch port: the DiT layer's qkv preparation (ops/qkv_prep.py,
models/dit.py `_qkv`) on the CPU. The kernel (csrc/qkv_prep.cu) runs on
the card only; tests/test_torch_port_cuda.py holds it to
`qkv_prep_plain` there.

  - `qkv_prep_plain` against the chain it replaces (the bias add,
    `layer_norm` on the q / k views, `_maybe_rotary`, the copy of v), at 3
    heads of 64 and S = 37 (13 text + 24 video positions, a multiple of
    no tile). In f32 both run the same operations in the same order:
    within 1e-6. In bf16 the chain rounds after each of about six steps
    (each <= half a step) and the plain version once: within 4 bf16 steps
    at the largest |plain| value and a relative RMS error of 2^-7 (one
    bf16 step at 1). Readings here: 2 steps, 4.7e-3; v without rotation
    is the same bits.
  - `qkv_prep_plain` rounds once: in bf16 within half a bf16 step (at each
    element's own size) of the same function in float64.
  - The dispatch rule: on the CPU, under a gradient or not, `_layer` runs
    the chain, and its output (and gradients) equal, bit for bit, those of
    the layer with the chain written out as it stood before the kernel."""

import dataclasses

import pytest
import torch

from landiff_tpu_torch.config import DiTConfig
from landiff_tpu_torch.models import dit
from landiff_tpu_torch.ops import attention as TA
from landiff_tpu_torch.ops import qkv_prep as QP
from landiff_tpu_torch.ops.norms import layer_norm
from landiff_tpu_torch.utils import fill_zero_leaves

torch.set_num_threads(2)   # tier-1 runs six xdist workers

CFG = DiTConfig(num_layers=1, hidden_size=192, num_heads=3, latent_frames=2,
                latent_height=6, latent_width=8, text_length=13)
S = CFG.text_length + CFG.video_tokens          # 37
POS = {"sincos3d": {}, "rotary3d": {"pos_embed": "rotary3d"},
       "rotary3d_rot_v": {"pos_embed": "rotary3d", "rot_v": True}}
LN = ("q_ln_w", "q_ln_b", "k_ln_w", "k_ln_b")


def _cfg(pos):
    return dataclasses.replace(CFG, **POS[pos])


def parent_chain(y, p, cfg):
    """The layer's chain from the bias-free product, as `_layer` ran it
    before the kernel."""
    B, S, _ = y.shape
    H, Dk = cfg.num_heads, cfg.head_dim
    q, k, v = (y + p["qkv_b"].to(y.dtype)).chunk(3, dim=-1)
    q = q.reshape(B, S, H, Dk)
    k = k.reshape(B, S, H, Dk)
    v = v.reshape(B, S, H, Dk).contiguous()
    if cfg.qk_ln:
        q = layer_norm(q, p["q_ln_w"], p["q_ln_b"], 1e-6)
        k = layer_norm(k, p["k_ln_w"], p["k_ln_b"], 1e-6)
    return dit._maybe_rotary(q, k, v, cfg)


def _inputs(dtype, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g)
    D3 = 3 * CFG.hidden_size
    y = (r(2, S, D3) + 0.2).to(dtype)
    p = {"qkv_b": 0.1 * r(D3), "q_ln_w": 1.5 + 0.2 * r(64),
         "q_ln_b": 0.1 * r(64), "k_ln_w": 1.5 + 0.2 * r(64),
         "k_ln_b": 0.1 * r(64)}
    return y, p


def _plain(y, p, cfg, dtype=None):
    dt = dtype or y.dtype
    tables = (dit._rotary3d_on(cfg, "cpu", y.dtype)
              if cfg.pos_embed == "rotary3d" else (None, None))
    return QP.qkv_prep_plain(
        y.to(dt), p["qkv_b"].to(y.dtype).to(dt),
        *(p[n].to(y.dtype).to(dt) for n in LN),
        *(t if t is None else t.to(dt) for t in tables),
        heads=cfg.num_heads, qk_ln=cfg.qk_ln, rot_v=cfg.rot_v)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pos", list(POS))
def test_plain_matches_the_chain(pos, dtype, seed):
    cfg = _cfg(pos)
    y, p = _inputs(dtype, seed)
    got, want = _plain(y, p, cfg), parent_chain(y, p, cfg)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == (2, S, 3, 64)
        assert a.is_contiguous()
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        else:
            steps, rel_rms = TA.kernel_error(a, b)
            assert steps <= 4 and rel_rms <= 2.0 ** -7, (name, steps,
                                                          rel_rms)
    if not cfg.rot_v:
        assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("pos", list(POS))
def test_plain_rounds_once(pos):
    cfg = _cfg(pos)
    y, p = _inputs(torch.bfloat16, 5)
    exact = _plain(y, p, cfg, torch.float64)
    for a, e in zip(_plain(y, p, cfg), exact):
        mag = e.abs().clamp_min(2.0 ** -7)
        step = torch.exp2(torch.frexp(mag)[1] - 8.0)
        assert ((a.double() - e).abs() / step).max().item() <= 0.51


def test_fused_function_on_the_cpu_is_the_plain_version():
    cfg = _cfg("rotary3d_rot_v")
    y, p = _inputs(torch.bfloat16, 2)
    before = QP.qkv_prep.launches
    got = QP.qkv_prep(y, p["qkv_b"].bfloat16(),
                      *(p[n].bfloat16() for n in LN),
                      *dit._rotary3d_on(cfg, "cpu", torch.bfloat16),
                      heads=3, rot_v=True)
    for a, b in zip(got, _plain(y, p, cfg)):
        assert torch.equal(a, b)
    assert QP.qkv_prep.launches == before


def test_kernel_rule_refuses_the_cpu_and_other_widths():
    y = torch.zeros(1, 4, 3 * 128)
    assert not QP.kernel_takes(y, 64)
    assert not QP.kernel_takes(y.bfloat16(), 64)
    assert not QP.kernel_takes(y, 32)


def _layer_inputs(pos, mode, w8a8):
    cfg = _cfg(pos)
    gen = torch.Generator().manual_seed(7)
    p = fill_zero_leaves(dit._init_layer(gen, cfg, False, torch.float32),
                         gen, scale=0.05)
    if w8a8:
        p = dit.quantize_int8({"layers": [p]})["layers"][0]
    x = torch.randn((2, S, cfg.hidden_size), generator=gen).bfloat16()
    emb = torch.randn((2, cfg.time_embed_dim), generator=gen).bfloat16()
    if mode == "grad_params":
        for t in p.values():
            if isinstance(t, torch.Tensor):
                t.requires_grad_(True)
    if mode == "grad_input":
        x.requires_grad_(True)
    return cfg, p, x, emb


def _run_layer(cfg, p, x, emb, mode):
    if mode == "inference":
        with torch.inference_mode():
            return dit._layer(p, x, emb, cfg), []
    out = dit._layer(p, x, emb, cfg)
    leaves = [t for t in (x, *p.values())
              if isinstance(t, torch.Tensor) and t.requires_grad]
    grads = torch.autograd.grad(out.float().square().sum(), leaves)
    return out, grads


def _parent_qkv(p, h, cfg):
    return parent_chain(dit._product(p, "qkv", h), p, cfg)


@pytest.mark.parametrize("pos,mode,w8a8", [
    *((pos, mode, False) for pos in POS
      for mode in ("inference", "grad_params", "grad_input")),
    ("sincos3d", "inference", True), ("rotary3d", "grad_input", True)])
def test_layer_keeps_the_chain_where_the_kernel_does_not_serve(
        monkeypatch, pos, mode, w8a8):
    cfg, p, x, emb = _layer_inputs(pos, mode, w8a8)

    def no_kernel(*a, **kw):
        raise AssertionError("the qkv kernel's function was called")

    monkeypatch.setattr(QP, "qkv_prep", no_kernel)
    out, grads = _run_layer(cfg, p, x, emb, mode)
    monkeypatch.setattr(dit, "_qkv", _parent_qkv)
    want, want_grads = _run_layer(cfg, p, x, emb, mode)
    assert torch.equal(out, want)
    assert len(grads) == len(want_grads)
    assert bool(grads) == (mode != "inference")
    for g, w in zip(grads, want_grads):
        assert torch.equal(g, w)
