"""Ring attention, the forward: sequence-parallel full attention over the
`time` ranks of a mesh (counterpart of landiff_tpu/parallel/
ring_attention.py, its inference half).

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

The custom VJP (the ring backward, `_hop_bwd_*`) is the training half,
ROADMAP item 15b: a call that needs a gradient raises.

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


def ring_attention_local(q, k, v, group, *, scale=None, impl="auto",
                         int8_scores=None, int8_pv=None):
    """Per-rank ring attention (JAX `ring_attention_local`, forward
    only): q, k, v this rank's (B, S_local, H, Dh) shard of a sequence
    sharded over `group`'s ranks in member order. Returns the local
    output shard in q's dtype."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the ring attention backward (training under a time axis) is "
            f"not ported yet: {mesh_lib.ITEM_15B}")
    out, _ = ring_forward(q, k, v, group, scale=scale, impl=impl,
                          int8_scores=int8_scores, int8_pv=int8_pv)
    return out.to(q.dtype)


def _ring_rank(ctx, q, k, v, scale, impl, int8_scores, int8_pv):
    """A rank's part of `ring_attention`: its shard of q, k, v by its
    `time` coordinate, the ring over its time group, the shards gathered
    back in order; rank 0 returns the whole output."""
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
    return out if ctx.rank == 0 else None


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
