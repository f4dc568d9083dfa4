"""The DiT layer's qkv preparation in one pass: from the bias-free qkv
product (B, S, 3 D) to the three contiguous (B, S, H, 64) inputs of
`attention`, with the bias, qk-LayerNorm (per head, affine, statistics in
f32) and the Rotary3D positions applied on the way (models/dit.py
`_qkv`). No TPU kernel has this job: the JAX package leaves the chain to
XLA, which fuses it; PyTorch runs it as some 45 passes over a (B, S, D)
activation a layer.

  - `qkv_prep`: the fused function. On a CUDA tensor it launches the
    hand-written kernel (csrc/qkv_prep.cu) and counts the launch in
    `qkv_prep.launches`; on a CPU tensor it runs `qkv_prep_plain`. The
    kernel has no backward: under a gradient it raises.
  - `qkv_prep_plain`: the kernel's arithmetic in PyTorch, everything in
    f32 and one rounding at the end, where the chain rounds about six
    times.
  - `kernel_takes`: the rule by which `_layer` picks the kernel over the
    chain, from what it sees in its input alone.
"""

from __future__ import annotations

import torch

HEAD_DIM = 64                    # csrc/qkv_prep.cu kHeadDim
DTYPES = (torch.bfloat16, torch.float32)


def _grad_needed(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def kernel_takes(y, head_dim: int, *leaves) -> bool:
    """Whether the kernel serves the product y and the float leaves it
    reads (the bias, the qk-LN affine): y on CUDA in bf16 or f32, heads of
    64, and no gradient needed (`attention`'s rule for its route). Else
    the layer keeps its chain of PyTorch operations."""
    return (y.is_cuda and y.dtype in DTYPES and head_dim == HEAD_DIM
            and not _grad_needed(y, *leaves))


def _layer_norm(t, w, b, eps):
    tc = t - t.mean(-1, keepdim=True)
    var = (tc * tc).mean(-1, keepdim=True)
    return tc * torch.rsqrt(var + eps) * w.to(t.dtype) + b.to(t.dtype)


def _rotate(t, cos, sin):
    """t (B, S, H, 64) by the tables' rows for positions 0..S-1 (the last
    row past their end), as models/dit.py `_apply_rotary3d`."""
    rows = torch.arange(t.shape[1], device=t.device).clamp(
        max=cos.shape[0] - 1)
    swapped = t.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
    return (t * cos[rows].to(t.dtype)[None, :, None]
            + swapped * sin[rows].to(t.dtype)[None, :, None])


def qkv_prep_plain(y, bias, q_w=None, q_b=None, k_w=None, k_b=None,
                   cos=None, sin=None, *, heads: int, qk_ln: bool = True,
                   rot_v: bool = False, eps: float = 1e-6):
    """Plain version of the kernel: y (B, S, 3 D) + bias, qk-LN on q and k,
    the rotation by cos / sin (`_rotary3d_on`'s tables; None: none) on q
    and k (and v with rot_v), all in f32 (float64 for float64 inputs) in
    the kernel's order, rounded once to y.dtype. Returns contiguous q, k,
    v (B, S, heads, D / heads)."""
    acc = torch.promote_types(y.dtype, torch.float32)
    t = (y.to(acc) + bias.to(acc)).unflatten(-1, (3, heads, -1))
    q, k, v = t.unbind(2)
    if qk_ln:
        q = _layer_norm(q, q_w, q_b, eps)
        k = _layer_norm(k, k_w, k_b, eps)
    if cos is not None:
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
        if rot_v:
            v = _rotate(v, cos, sin)
    return tuple(a.to(y.dtype).contiguous() for a in (q, k, v))


def _launch(y, bias, ln, cos, sin, heads, qk_ln, rot_v, eps):
    from landiff_tpu_torch.ops import kernels

    if y.dtype not in DTYPES:
        raise TypeError(f"the qkv kernel takes bfloat16 or float32, y is "
                        f"{y.dtype}")
    if y.dim() != 3 or y.shape[-1] != 3 * heads * HEAD_DIM:
        raise ValueError(f"y must be (B, S, 3 * {heads} * {HEAD_DIM}), got "
                         f"{tuple(y.shape)}")
    B, S, D3 = y.shape
    D = D3 // 3
    if B * S * D3 * y.element_size() // 16 >= 2 ** 31:
        raise ValueError("y exceeds the kernel's chunk index")
    named = [("y", y, tuple(y.shape)), ("bias", bias, (D3,))]
    if qk_ln:
        named += [(n, t, (HEAD_DIM,))
                  for n, t in zip(("q_w", "q_b", "k_w", "k_b"), ln)]
    if cos is not None:
        named += [(n, t, (t.shape[0], HEAD_DIM))
                  for n, t in (("cos", cos), ("sin", sin))]
        if cos.shape != sin.shape or cos.dim() != 2 or cos.shape[0] < 1:
            raise ValueError(f"cos / sin must be one (n, {HEAD_DIM}) shape, "
                             f"got {tuple(cos.shape)}, {tuple(sin.shape)}")
    for name, t, shape in named:
        if t.device != y.device or t.dtype != y.dtype:
            raise TypeError(f"{name} must match y's device and dtype "
                            f"({y.dtype}), got {t.device} {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    q, k, v = (torch.empty((B, S, heads, HEAD_DIM), dtype=y.dtype,
                           device=y.device) for _ in range(3))
    ptr = lambda t: None if t is None else t.data_ptr()
    ln = ln if qk_ln else (None,) * 4
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        rc = kernels.qkv_prep_library().landiff_qkv_prep(
            y.data_ptr(), bias.data_ptr(), *(ptr(t) for t in ln), ptr(cos),
            ptr(sin), q.data_ptr(), k.data_ptr(), v.data_ptr(), B, S, D,
            0 if cos is None else cos.shape[0], int(qk_ln), int(rot_v),
            float(eps), int(y.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"qkv kernel launch failed: cudaError {rc}")
    return q, k, v


def qkv_prep(y, bias, q_w=None, q_b=None, k_w=None, k_b=None, cos=None,
             sin=None, *, heads: int, qk_ln: bool = True,
             rot_v: bool = False, eps: float = 1e-6):
    """The fused function (arguments as `qkv_prep_plain`'s): CUDA tensors
    launch the kernel (or raise), CPU tensors run `qkv_prep_plain`."""
    if y.device.type == "cpu":
        return qkv_prep_plain(y, bias, q_w, q_b, k_w, k_b, cos, sin,
                              heads=heads, qk_ln=qk_ln, rot_v=rot_v, eps=eps)
    if _grad_needed(y, bias, q_w, q_b, k_w, k_b, cos, sin):
        raise RuntimeError("the qkv kernel has no backward; under a "
                           "gradient the layer runs its chain")
    out = _launch(y, bias, (q_w, q_b, k_w, k_b), cos, sin, heads, qk_ln,
                  rot_v, eps)
    qkv_prep.launches += 1
    return out


qkv_prep.launches = 0
