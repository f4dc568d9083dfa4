"""Fused adaLN modulate (counterpart of landiff_tpu/ops/adaln.py):
LayerNorm with affine, then h * (1 + scale) + shift, the text pair for
rows below `text_len` and the video pair after, in one pass over device
memory.

  - `adaln_fused`: the fused function. On a CUDA tensor it launches the
    hand-written kernel (csrc/adaln.cu, which replaces the Pallas
    `_kernel`, adaln.py:33) and counts the launch in `adaln_fused.launches`;
    on a CPU tensor it runs `adaln_plain`, the same arithmetic in PyTorch
    (everything in f32, one rounding at the end). Differentiable: the
    backward is autograd of the reference expression, as JAX's `_diff_bwd`.
  - `adaln_reference`: the unfused chain of the DiT layer (JAX's `_xla`),
    which rounds to the activation dtype after the LayerNorm and again in
    the modulate.
  - `adaln_modulate`: the dispatcher, with the JAX selection rule.
"""

from __future__ import annotations

import torch

from landiff_tpu_torch.ops.norms import layer_norm

KERNEL_MAX_D = 4096      # csrc/adaln.cu kMaxD


def _select(x, t, v, text_len):
    """(B, D) text / video pair -> per-row (B, S, D) by position."""
    is_text = (torch.arange(x.shape[1], device=x.device)
               < text_len)[None, :, None]
    return torch.where(is_text, t[:, None], v[:, None])


def adaln_reference(x, w, b, t_shift, t_scale, v_shift, v_scale, *,
                    text_len: int, eps: float = 1e-6):
    """The unfused chain (adaln.py:88-97): layer_norm in the activation
    dtype, then the modulate with the position-selected pair."""
    h = layer_norm(x, w, b, eps)
    shift = _select(x, t_shift, v_shift, text_len)
    scale = _select(x, t_scale, v_scale, text_len)
    return h * (1.0 + scale.to(h.dtype)) + shift.to(h.dtype)


def adaln_plain(x, w, b, t_shift, t_scale, v_shift, v_scale, *,
                text_len: int, eps: float = 1e-6):
    """Plain version of the kernel: statistics and arithmetic in f32 in the
    kernel's order, rounded once to x.dtype."""
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    var = (xc * xc).mean(-1, keepdim=True)
    h = xc * torch.rsqrt(var + eps)
    h = h * w.float() + b.float()
    shift = _select(x, t_shift.float(), v_shift.float(), text_len)
    scale = _select(x, t_scale.float(), v_scale.float(), text_len)
    return (h * (1.0 + scale) + shift).to(x.dtype)


def _launch(x, w, b, pairs, text_len: int, eps: float):
    from landiff_tpu_torch.ops import kernels

    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the adaLN kernel takes bfloat16 or float32, x is "
                        f"{x.dtype}")
    if x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous, 16-byte aligned (B, S, D) "
                         "tensor")
    B, S, D = x.shape
    if D % 8 or D > KERNEL_MAX_D:
        raise ValueError(f"the adaLN kernel takes D a multiple of 8 up to "
                         f"{KERNEL_MAX_D}, got {D}")
    if B * S >= 2 ** 31:
        raise ValueError("B * S exceeds the kernel's row index")
    for name, t, shape in (("w", w, (D,)), ("b", b, (D,)),
                           *((f"pair {i}", p, (B, D))
                             for i, p in enumerate(pairs))):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"{name} must match x's device and dtype "
                            f"({x.dtype}), got {t.device} {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{shape}")
    step = 16 // x.element_size()

    def rows16(t):
        # rows the kernel can read with 16-byte loads; the DiT's slices of
        # one (B, 12 D) tensor already are
        ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
              and (t.dim() == 1 or t.stride(0) % step == 0))
        return t if ok else t.contiguous()

    w, b = rows16(w), rows16(b)
    pairs = [rows16(p) for p in pairs]
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = kernels.adaln_library()
    with torch.cuda.device(x.device):
        rc = lib.landiff_adaln_modulate(
            x.data_ptr(), w.data_ptr(), b.data_ptr(),
            *(p.data_ptr() for p in pairs), out.data_ptr(), B, S, D,
            int(text_len), *(p.stride(0) for p in pairs), float(eps),
            int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"adaLN kernel launch failed: cudaError {rc}")
    return out


def _forward(x, w, b, t_shift, t_scale, v_shift, v_scale, text_len, eps):
    if x.device.type == "cpu":
        return adaln_plain(x, w, b, t_shift, t_scale, v_shift, v_scale,
                           text_len=text_len, eps=eps)
    if x.numel() == 0:
        return torch.empty_like(x)
    out = _launch(x, w, b, (t_shift, t_scale, v_shift, v_scale), text_len,
                  eps)
    adaln_fused.launches += 1
    return out


class _AdalnFused(torch.autograd.Function):
    """Forward: the fused function. Backward: autograd of the reference
    expression (adaln.py:114-120); the kernel serves inference and needs
    no backward of its own."""

    @staticmethod
    def forward(ctx, x, w, b, t_shift, t_scale, v_shift, v_scale, text_len,
                eps):
        ctx.save_for_backward(x, w, b, t_shift, t_scale, v_shift, v_scale)
        ctx.text_len, ctx.eps = text_len, eps
        return _forward(x, w, b, t_shift, t_scale, v_shift, v_scale,
                        text_len, eps)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            args = [t.detach().requires_grad_(True)
                    for t in ctx.saved_tensors]
            out = adaln_reference(*args, text_len=ctx.text_len, eps=ctx.eps)
        needed = [a for a, need in zip(args, ctx.needs_input_grad) if need]
        grads = iter(torch.autograd.grad(out, needed, g))
        return (*(next(grads) if need else None
                  for need in ctx.needs_input_grad[:7]), None, None)


def adaln_fused(x, w, b, t_shift, t_scale, v_shift, v_scale, *,
                text_len: int, eps: float = 1e-6):
    """The fused function: CUDA tensors launch the kernel (or raise), CPU
    tensors run `adaln_plain`."""
    return _AdalnFused.apply(x, w, b, t_shift, t_scale, v_shift, v_scale,
                             int(text_len), float(eps))


adaln_fused.launches = 0


def adaln_modulate(x, w, b, t_shift, t_scale, v_shift, v_scale, *,
                   text_len: int, eps: float = 1e-6, impl: str = "auto"):
    """LayerNorm(x) * (1 + scale_sel) + shift_sel with the text / video
    pair selected by token position (< text_len -> text pair).

    x: (B, S, D); w, b: (D,) LayerNorm affine; *_shift / *_scale: (B, D).
    impl: 'kernel' (the fused function), 'xla' (the unfused reference
    chain) or 'auto': the kernel for CUDA tensors whose shape meets the
    JAX rule (D % 128 == 0 and S >= 512, adaln.py:139), else the
    reference."""
    if impl == "auto":
        ok = x.shape[-1] % 128 == 0 and x.shape[1] >= 512
        impl = "kernel" if (x.is_cuda and ok) else "xla"
    if impl == "xla":
        return adaln_reference(x, w, b, t_shift, t_scale, v_shift, v_scale,
                               text_len=text_len, eps=eps)
    if impl != "kernel":
        raise ValueError(f"impl must be 'auto', 'kernel' or 'xla', got "
                         f"{impl!r}")
    return adaln_fused(x.contiguous(), w, b, t_shift, t_scale, v_shift,
                       v_scale, text_len=text_len, eps=eps)
