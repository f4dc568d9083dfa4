"""Plain float32 building blocks of the reference.

Every function computes in float32 with PyTorch's own operations; no
kernel, cache or lower precision of the program under test is used. The
callers switch TF32 off (`exact_f32`), so a float32 product on the card is
a float32 product.
"""

from __future__ import annotations

import contextlib
import math

import torch


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matmuls and cuDNN convolutions while the reference
    runs; the previous settings come back afterwards."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def layer_norm(x, weight=None, bias=None, eps=1e-5):
    """LayerNorm over the last axis."""
    mean = x.mean(-1, keepdim=True)
    xc = x - mean
    out = xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out


def group_norm(x, weight, bias, num_groups=32, eps=1e-6):
    """GroupNorm with channels at axis 1."""
    shp = x.shape
    xg = x.reshape(shp[0], num_groups, -1)
    mean = xg.mean(-1, keepdim=True)
    xc = xg - mean
    xg = xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    bshape = (1, shp[1]) + (1,) * (len(shp) - 2)
    return (xg.reshape(shp) * weight.float().reshape(bshape)
            + bias.float().reshape(bshape))


def linear(p, name, x):
    return x @ p[f"{name}_w"].float() + p[f"{name}_b"].float()


def silu(x):
    return x * torch.sigmoid(x)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def gelu_erf(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def timestep_embedding(timesteps, dim, max_period=10000.0):
    """Sinusoidal embedding, cos block then sin block."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def attention(q, k, v, mask_fn=None, block_q=1024):
    """Softmax attention in float32, q / k / v (B, S, H, D), over blocks
    of query rows so that one block's scores fit in memory. mask_fn(q_idx,
    kv_idx) -> bool, True where a query row sees a key."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    qh = q.float().permute(0, 2, 1, 3)            # (B, H, Sq, D)
    kt = k.float().permute(0, 2, 3, 1)            # (B, H, D, Skv)
    vh = v.float().permute(0, 2, 1, 3)            # (B, H, Skv, D)
    out = torch.empty((B, H, Sq, D), dtype=torch.float32, device=q.device)
    kv_idx = torch.arange(Skv, device=q.device)
    for b in range(B):
        for a in range(0, Sq, block_q):
            e = min(a + block_q, Sq)
            s = (qh[b, :, a:e] @ kt[b]) * scale       # (H, bq, Skv)
            if mask_fn is not None:
                q_idx = torch.arange(a, e, device=q.device)
                vis = mask_fn(q_idx[:, None], kv_idx[None, :])
                s = s.masked_fill(~vis[None], float("-inf"))
            out[b, :, a:e] = torch.softmax(s, dim=-1) @ vh[b]
            del s
    return out.permute(0, 2, 1, 3)


def rel_rms(x, ref):
    """RMS of (x - ref) over the RMS of ref, in float64."""
    d = (x.double() - ref.double()).square().mean().sqrt()
    return float(d / ref.double().square().mean().sqrt().clamp_min(1e-30))
