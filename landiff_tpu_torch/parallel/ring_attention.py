"""Ring attention: sequence-parallel full attention over the `time`
ranks of a mesh (counterpart of landiff_tpu/parallel/ring_attention.py).

Queries stay on their rank while the K / V blocks go round the ring
(`mesh.Group.shift`, JAX's ppermute to (i + 1) % n): at hop j rank i holds
the block of rank i - j. Each hop computes attention of the local queries
over that block and merges it into the running result by its logsumexp.

The hop's route is picked as JAX's (`ring_attention_diff` :128-138,
dit.py :353-354): on a CUDA device the flash forward with its log2 lse
(ops/attention.flash_attention: the hand-written kernels, int8 scores by
default, exact with LANDIFF_ATTN_INT8=0, int8_pv with
LANDIFF_ATTN_INT8_PV=1, the f32 forms for f32 inputs), merged in log2;
elsewhere dense f32 hops (`_local_attn`, natural log), as JAX's run off a
TPU. The bf16 / f32 K and V rotate, never int8 codes: each hop quantizes
its own block inside the forward. Hop outputs are widened to f32 for the
merge and the result goes back to q's dtype.

Under a gradient the ring is `_RingDiff` (JAX's `ring_attention_diff`
custom VJP): the forward takes exact hops whatever the int8 knobs say and
saves q, k, v, the output in q's dtype and the global log2 lse; the
backward (`ring_backward`) is a second ring of n hops, each the flash
backward (`ops.attention.flash_bwd`, the kernel on a CUDA device) or its
dense counterpart from the GLOBAL output and lse, so that each hop's p is
the globally normalized probability block. dq accumulates in f32 on its
rank; the dk / dv accumulators rotate in f32 with k and v, so after n hops
every block's gradient is back on its home rank.

Layout: (B, S, H, Dh), S sharded over the ring; full (unmasked) attention.
"""

from __future__ import annotations

import math
import os

import torch

from landiff_tpu_torch.ops.attention import LOG2E
from landiff_tpu_torch.parallel import mesh as mesh_lib


def _local_attn(q, k, v, scale):
    """Dense local attention -> (normalized out (B, Sq, H, Dh) f32, lse
    (B, Sq, H) f32, natural log)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, v.float())
    lse = (m + torch.log(l))[..., 0].transpose(1, 2)
    return out, lse


def _merge(o1, lse1, o2, lse2, base2: bool = False):
    """Two normalized partial attentions over disjoint key sets combined
    by their lse: natural log, or base 2 (the flash forwards' lse)."""
    exp, log = (torch.exp2, torch.log2) if base2 else (torch.exp, torch.log)
    m = torch.maximum(lse1, lse2)
    w1 = exp(lse1 - m)
    w2 = exp(lse2 - m)
    denom = w1 + w2
    out = (o1 * w1[..., None] + o2 * w2[..., None]) / denom[..., None]
    return out, m + log(denom)


def _local_attn_flash(q, k, v, scale, int8_scores=False, int8_pv=False):
    """A hop through the flash forward: (out f32, lse (B, Sq, H) log2 from
    the kernel's (B, H, Sq)). The int8 forms' lse is approximate like
    their out, which is what the merge needs. exp_bf16 is read from
    LANDIFF_ATTN_EXP_BF16, as JAX's hop reads it."""
    from landiff_tpu_torch.ops.attention import flash_attention

    out, lse = flash_attention(q, k, v, scale=scale, int8_scores=int8_scores,
                               int8_pv=int8_pv, return_lse=True)
    return out.float(), lse.transpose(1, 2)


def hop_route(q: torch.Tensor, impl: str = "auto") -> str:
    """"pallas" (the flash forwards; JAX's name) or "xla" (dense f32):
    auto takes the flash forwards on a CUDA device, dense hops elsewhere
    (JAX: pallas only on a TPU backend)."""
    if impl == "auto":
        return "pallas" if q.is_cuda else "xla"
    if impl not in ("pallas", "xla"):
        raise ValueError(f"impl must be auto, pallas or xla, got {impl!r}")
    return impl


def int8_knobs(int8_scores=None, int8_pv=None) -> tuple[bool, bool]:
    """The flash hops' (int8_scores, int8_pv): where not given, JAX's
    inference rule (ring_attention_diff :134-136), LANDIFF_ATTN_INT8 on
    unless "0", LANDIFF_ATTN_INT8_PV=1, int8_pv only with int8 scores."""
    if int8_scores is None:
        int8_scores = os.environ.get("LANDIFF_ATTN_INT8", "1") == "1"
    if int8_pv is None:
        int8_pv = os.environ.get("LANDIFF_ATTN_INT8_PV") == "1"
    return bool(int8_scores), bool(int8_scores and int8_pv)


def ring_forward(q, k, v, group, *, scale=None, impl="auto",
                 int8_scores: bool | None = None,
                 int8_pv: bool | None = None):
    """The ring forward on this rank's shard (JAX `_ring_fwd`): (out f32
    (B, Sq, H, Dh), lse (B, Sq, H) in log2). group: the `time` Group.
    int8_scores / int8_pv: the flash hops' forms (`int8_knobs`)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if hop_route(q, impl) == "pallas":
        int8_scores, int8_pv = int8_knobs(int8_scores, int8_pv)

        def local(kr, vr):
            return _local_attn_flash(q, kr, vr, scale, int8_scores, int8_pv)
        base2 = True
    else:
        def local(kr, vr):
            return _local_attn(q, kr, vr, scale)
        base2 = False
    out, lse = local(k, v)
    kr, vr = k, v
    for _ in range(group.size - 1):
        kr = group.shift(kr)
        vr = group.shift(vr)
        o2, lse2 = local(kr, vr)
        out, lse = _merge(out, lse, o2, lse2, base2)
    if not base2:
        lse = lse * LOG2E         # natural -> log2: one convention
    return out, lse


def _hop_bwd_dense(q, kr, vr, do, lse2, delta, scale):
    """Dense hop backward from the GLOBAL log2 lse (JAX `_hop_bwd_dense`,
    :100-110): p is the globally normalized probability block, so dv, ds,
    dq and dk follow the flash gradient identities. All f32; lse2 (B, Sq,
    H), delta (B, H, Sq)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) * (scale * LOG2E)
    p = torch.exp2(s - lse2.transpose(1, 2)[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vr)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    return dq, dk, dv


def ring_backward(q, k, v, out, lse, do, group, *, scale=None,
                  impl="auto"):
    """The ring backward on this rank's shard (JAX `_ring_diff_bwd`):
    (dq, dk, dv) in the inputs' dtypes. out: the global output in q's
    dtype, lse (B, Sq, H) its global log2 lse, do its cotangent. n hops:
    a flash backward (or dense) hop against the K / V block held, dq
    summed here in f32, the f32 dk / dv accumulators and K / V shifted on
    after each hop (K / V not after the last): 4n - 2 shifts for n > 1."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    pallas = hop_route(q, impl) == "pallas"
    if pallas:
        from landiff_tpu_torch.ops.attention import flash_bwd

        lse_bhs = lse.transpose(1, 2).contiguous()
        do = do.to(q.dtype).contiguous()

        def hop(kr, vr):
            return flash_bwd(q, kr, vr, out, lse_bhs, do, scale=scale)
    else:
        q32, do32 = q.float(), do.float()
        delta = (do32 * out.float()).sum(-1).transpose(1, 2)

        def hop(kr, vr):
            return _hop_bwd_dense(q32, kr.float(), vr.float(), do32, lse,
                                  delta, scale)
    n = group.size
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kr, vr = k, v
    for j in range(n):
        dq_j, dk_j, dv_j = hop(kr, vr)
        dq += dq_j.float()
        dk += dk_j.float()
        dv += dv_j.float()
        if n > 1:
            # the accumulators go on with their block: home after n hops
            dk, dv = group.shift(dk), group.shift(dv)
            if j < n - 1:
                kr, vr = group.shift(kr), group.shift(vr)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingDiff(torch.autograd.Function):
    """The differentiable ring (JAX `ring_attention_diff`, `_ring_diff_fwd`
    and `_ring_diff_bwd`): exact hops forward, `ring_backward` backward."""

    @staticmethod
    def forward(fctx, q, k, v, group, scale, impl):
        out, lse = ring_forward(q, k, v, group, scale=scale, impl=impl,
                                int8_scores=False, int8_pv=False)
        out = out.to(q.dtype)
        fctx.save_for_backward(q, k, v, out, lse)
        fctx.group, fctx.scale, fctx.impl = group, scale, impl
        return out

    @staticmethod
    def backward(fctx, do):
        q, k, v, out, lse = fctx.saved_tensors
        dq, dk, dv = ring_backward(q, k, v, out, lse, do, fctx.group,
                                   scale=fctx.scale, impl=fctx.impl)
        return dq, dk, dv, None, None, None


def ring_attention_local(q, k, v, group, *, scale=None, impl="auto",
                         int8_scores=None, int8_pv=None):
    """Per-rank ring attention (JAX `ring_attention_local`): q, k, v this
    rank's (B, S_local, H, Dh) shard of a sequence sharded over `group`'s
    ranks in member order. Returns the local output shard in q's dtype.
    Differentiable: where a gradient is needed the ring is `_RingDiff`
    (exact hops; int8_scores / int8_pv are not read), else the forward of
    the forms `int8_knobs` picks."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _RingDiff.apply(q, k, v, group, scale, impl)
    out, _ = ring_forward(q, k, v, group, scale=scale, impl=impl,
                          int8_scores=int8_scores, int8_pv=int8_pv)
    return out.to(q.dtype)


def _ring_rank(ctx, q, k, v, scale, impl, int8_scores, int8_pv):
    """A rank's part of `ring_attention`: its shard of q, k, v by its
    `time` coordinate, the ring over its time group, the shards gathered
    back in order; the caller's rank (ctx.caller) returns the whole output."""
    n, t = ctx.cfg.time, ctx.coords["time"]
    s = q.shape[1] // n
    q, k, v = (x[:, t * s:(t + 1) * s].to(ctx.device, copy=True)
               for x in (q, k, v))
    with torch.inference_mode():
        out = ring_attention_local(q, k, v, ctx.time_group, scale=scale,
                                   impl=impl, int8_scores=int8_scores,
                                   int8_pv=int8_pv)
        out = ctx.time_group.all_gather(out, dim=1)
    mesh_lib.release_cache(ctx)
    return out if ctx.caller else None


def ring_attention(q, k, v, mesh, *, scale=None, impl="auto",
                   int8_scores=None, int8_pv=None):
    """Sharded full attention over `mesh`'s time axis (JAX
    `ring_attention`): q, k, v (B, S, H, Dh) whole on rank 0; every time
    group runs the ring on its shards. Matches dense attention over the
    whole sequence. S must split evenly over time. The flash hops' forms
    are read here (`int8_knobs`) and given to every rank: a worker's
    environment is the one it was started with."""
    n = mesh.cfg.time
    if q.shape[1] % n:
        raise ValueError(f"{q.shape[1]} positions do not split over "
                         f"time={n}")
    return mesh.run(_ring_rank, q, k, v, scale, impl,
                    *int8_knobs(int8_scores, int8_pv))[0]


def _time_part(ctx, x):
    n, t = ctx.cfg.time, ctx.coords["time"]
    s = x.shape[1] // n
    return x[:, t * s:(t + 1) * s].to(ctx.device, copy=True)


def _ring_vjp_rank(ctx, q, k, v, do, scale, impl):
    """A rank's part of `ring_attention_vjp`: its shards through the
    differentiable ring and autograd, the gradients gathered in order."""
    q, k, v, do = (_time_part(ctx, x) for x in (q, k, v, do))
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    out = ring_attention_local(q, k, v, ctx.time_group, scale=scale,
                               impl=impl)
    grads = torch.autograd.grad(out, (q, k, v), do)
    grads = [ctx.time_group.all_gather(g, dim=1) for g in grads]
    mesh_lib.release_cache(ctx)
    return tuple(grads) if ctx.caller else None


def ring_attention_vjp(q, k, v, do, mesh, *, scale=None, impl="auto"):
    """(dq, dk, dv) of sum(ring_attention(q, k, v) * do) over `mesh`'s time
    axis, through the ranks' autograd (the forward and `_RingDiff`'s
    backward); inputs (B, S, H, Dh) whole on rank 0, the gradients too."""
    return mesh.run(_ring_vjp_rank, q, k, v, do, scale, impl)[0]


def _ring_bwd_rank(ctx, q, k, v, out, lse, do, scale, impl):
    q, k, v, out, lse, do = (_time_part(ctx, x)
                             for x in (q, k, v, out, lse, do))
    with torch.no_grad():
        grads = ring_backward(q, k, v, out, lse, do, ctx.time_group,
                              scale=scale, impl=impl)
        grads = [ctx.time_group.all_gather(g, dim=1) for g in grads]
    mesh_lib.release_cache(ctx)
    return tuple(grads) if ctx.caller else None


def ring_attention_bwd(q, k, v, out, lse, do, mesh, *, scale=None,
                       impl="auto"):
    """`ring_backward` alone over `mesh`'s time axis from a given global
    output and log2 lse (B, S, H): (dq, dk, dv) whole on rank 0. The
    ring's hops see what one flash_bwd over the whole sequence sees."""
    return mesh.run(_ring_bwd_rank, q, k, v, out, lse, do, scale, impl)[0]
