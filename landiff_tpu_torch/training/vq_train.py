"""Tokenizer (VideoVQ) training: straight-through VQ with an EMA codebook,
k-means init, dead-code replacement and the reference loss mix
(counterpart of landiff_tpu/training/vq_train.py).

Reference behaviour: vector_quantize_pytorch.VectorQuantize(
kmeans_init=True, threshold_ema_dead_code=2, decay 0.8) configured at
tokenizer_cfg.py:89-95; losses (recon MSE + commit, plus the per-I/P-frame
monitoring losses) from video_titok_vq.py:279-375.

The codebook state is a dict {"embed_avg": (K, cdim), "cluster_size":
(K,), "initted": () bool} (`init_codebook_state`). Random draws: the
k-means permutation and the dead-code samples' row indices come from a
`torch.Generator` or are handed in as tensors, which is how a test feeds
both packages the same draws.

On a mesh (`make_train_step_mesh`, JAX's step under TITOK_RULES with the
batch over `data`) the TiTok runs on each rank's heads and MLP columns,
the gradients are summed over `data`, and the EMA codebook statistics are
those of the whole batch: every rank gathers the batch's projected
latents and codes, so the EMA update (and the first batch's k-means) is
the same computation on every rank. The optimizer state stays
replicated, as JAX's (train.py:223).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from landiff_tpu_torch.config import TokenizerConfig
from landiff_tpu_torch.models import titok as titok_lib
from landiff_tpu_torch.models import vq as vq_lib
from landiff_tpu_torch.training import ema as ema_lib
from landiff_tpu_torch.training import optim


def init_codebook_state(cfg: TokenizerConfig, device="cuda") -> dict:
    q = cfg.vq
    return {"embed_avg": torch.zeros((q.codebook_size, q.codebook_dim),
                                     device=device),
            "cluster_size": torch.zeros((q.codebook_size,), device=device),
            "initted": torch.tensor(False, device=device)}


@torch.no_grad()
def kmeans_init_codebook(zin, codebook_size: int, rng, iters: int = 10):
    """k-means over the first batch's projected latents
    (vector-quantize-pytorch kmeans_init). rng: a torch.Generator, or the
    permutation of the rows (n,) that seeds the means."""
    flat = zin.detach().reshape(-1, zin.shape[-1])
    n = flat.shape[0]
    perm = rng if isinstance(rng, torch.Tensor) else torch.randperm(
        n, generator=rng, device=rng.device)
    idx = torch.arange(codebook_size, device=flat.device) % n
    means = flat[perm.to(flat.device)[idx]]
    for _ in range(iters):
        assign = vq_lib.sq_dist(flat, means).argmin(-1)
        one_hot = F.one_hot(assign, codebook_size).to(flat.dtype)
        counts = one_hot.sum(0)
        sums = one_hot.T @ flat
        means = torch.where(counts[:, None] > 0,
                            sums / counts[:, None].clamp_min(1), means)
    return means


def quantize_ste(qp, z):
    """Straight-through VQ: (quantized output (..., dim), zin, idx,
    commit loss). Gradients reach project_in / out; the codebook is
    EMA-updated and gets none."""
    zin, cb, idx = vq_lib.nearest(qp, z)
    e = cb.detach()[idx]
    commit = ((zin - e).square().sum(-1) / zin.shape[-1]).mean()
    q_ste = zin + (e - zin).detach()
    return q_ste @ qp["out_w"].float() + qp["out_b"].float(), zin, idx, commit


@torch.no_grad()
def ema_codebook_update(qp, state: dict, zin, idx, *, rng, decay=0.8,
                        eps=1e-5, threshold_dead=2.0):
    """EMA cluster update and dead-code replacement from batch samples.
    rng: a torch.Generator, or the (K,) indices of the batch rows that
    replace dead codes. Returns (new quant params, new state)."""
    K = qp["codebook"].shape[0]
    flat = zin.detach().reshape(-1, zin.shape[-1])
    one_hot = F.one_hot(idx.reshape(-1), K).to(flat.dtype)
    counts = one_hot.sum(0)
    sums = one_hot.T @ flat
    cluster_size = state["cluster_size"] * decay + counts * (1 - decay)
    embed_avg = state["embed_avg"] * decay + sums * (1 - decay)
    n = cluster_size.sum()
    smoothed = (cluster_size + eps) / (n + K * eps) * n
    embed = embed_avg / smoothed[:, None]
    # dead-code replacement: expired codes <- random batch vectors
    dead = (cluster_size < threshold_dead)[:, None]
    rand_idx = rng if isinstance(rng, torch.Tensor) else torch.randint(
        0, flat.shape[0], (K,), generator=rng, device=rng.device)
    samples = flat[rand_idx.to(flat.device)]
    embed = torch.where(dead, samples, embed)
    embed_avg = torch.where(dead, samples * cluster_size[:, None], embed_avg)
    new_qp = dict(qp)
    new_qp["codebook"] = embed.to(qp["codebook"].dtype)
    return new_qp, {"embed_avg": embed_avg, "cluster_size": cluster_size,
                    "initted": torch.ones_like(state["initted"])}


@torch.no_grad()
def kmeans_input(params, features, cfg: TokenizerConfig, tp=None):
    """k-means' input on the first batch: tokenizer_loss's zin (the TiTok
    encoder and project_in, in f32) without the decoder half, which the
    JAX driver runs and throws away."""
    lat = titok_lib.encode(params["encoder"], features.float(), cfg.titok,
                           compute_dtype=torch.float32, tp=tp)
    return vq_lib.project_in(params["quant"], lat)


def tokenizer_loss(params, features, cfg: TokenizerConfig, *,
                   commit_weight=1.0, recon_weight=1.0,
                   compute_dtype=torch.float32, tp=None):
    """VideoVQ._inner_forward + the forward's loss mix
    (video_titok_vq.py:279-375). Returns (total loss, aux) with zin / idx
    for the EMA update and the per-I/P-frame monitoring losses."""
    feats = features.to(compute_dtype)
    lat = titok_lib.encode(params["encoder"], feats, cfg.titok,
                           compute_dtype=compute_dtype, tp=tp)
    q_out, zin, idx, commit = quantize_ste(params["quant"], lat)
    rec = titok_lib.decode(params["decoder"], q_out.to(compute_dtype),
                           cfg.titok, compute_dtype=compute_dtype, tp=tp)
    diff = rec.float() - feats.float()
    re_loss = diff.square().mean()
    iframe_loss = diff[:, 0].square().mean()
    pframe_loss = (diff[:, 1:].square().mean() if feats.shape[1] > 1
                   else torch.zeros((), device=diff.device))
    total = commit_weight * commit + recon_weight * re_loss
    aux = {"zin": zin, "idx": idx, "commit_loss": commit,
           "re_loss": re_loss, "iframe_loss": iframe_loss,
           "pframe_loss": pframe_loss}
    return total, aux


def make_train_step(optimizer, cfg: TokenizerConfig, *, decay=0.8,
                    threshold_dead=2.0, compute_dtype=torch.float32,
                    ema_decay: float | None = None):
    """The tokenizer train step: (params, opt_state, cb_state, features,
    rng) -> (params, opt_state, cb_state, metrics), rng a torch.Generator
    or the (K,) dead-code row indices (ema_codebook_update). The
    codebook's gradient is zeroed (the EMA owns it). With `ema_decay`
    (LitEma, sgm/modules/ema.py:1-88; the reference's default is 0.9999)
    the step also takes and returns an EMA state after cb_state:
    (params, opt_state, cb_state, ema_state, features, rng)."""

    def step(params, opt_state, cb_state, features, rng):
        params = optim.require_grad(params)
        loss, aux = tokenizer_loss(params, features, cfg,
                                   commit_weight=cfg.vq.commitment_weight,
                                   compute_dtype=compute_dtype)
        grads = optim.grad(loss, params)
        grads["quant"]["codebook"] = torch.zeros_like(
            grads["quant"]["codebook"])
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optim.apply_updates(params, updates)
        params["quant"], cb_state = ema_codebook_update(
            params["quant"], cb_state, aux["zin"], aux["idx"], rng=rng,
            decay=decay, threshold_dead=threshold_dead)
        metrics = {k: aux[k].detach() for k in
                   ("commit_loss", "re_loss", "iframe_loss", "pframe_loss")}
        metrics["total_loss"] = loss.detach()
        return params, opt_state, cb_state, metrics

    if ema_decay is None:
        return step

    def step_ema(params, opt_state, cb_state, ema_state, features, rng):
        params, opt_state, cb_state, metrics = step(
            params, opt_state, cb_state, features, rng)
        ema_state = ema_lib.ema_update(ema_state, params, decay=ema_decay)
        return params, opt_state, cb_state, ema_state, metrics

    return step_ema


def make_train_step_mesh(optimizer, cfg: TokenizerConfig, *, ctx,
                         model_split, decay=0.8, threshold_dead=2.0,
                         compute_dtype=torch.float32):
    """make_train_step on a rank of a mesh: (params, opt_state, cb_state,
    features, rng, first) -> (params, opt_state, cb_state, metrics), with
    this rank's parameter parts (TITOK_RULES), the whole optimizer state
    of those parts and the WHOLE batch; rng a torch.Generator (the same
    seed on every rank) or the dead-code row indices. first: initialise
    the codebook by k-means on the whole batch first, as train.py's
    first step does. The loss of this rank's rows counts for its share of
    the batch; metrics are the whole batch's."""
    from landiff_tpu_torch.data.loader import data_rows
    from landiff_tpu_torch.parallel import mesh as mesh_lib

    n, d = ctx.cfg.data, ctx.coords["data"]
    tp, data = ctx.model_group, ctx.data_group

    def whole(x):            # the whole batch's rows, in rank order
        return data.all_gather(x.detach().contiguous(), 0)

    def step(params, opt_state, cb_state, features, rng, first=False):
        feats = features[data_rows(features.shape[0], d, n)]
        if first:
            zin = whole(kmeans_input(params, feats, cfg, tp))
            params = dict(params)
            params["quant"] = dict(params["quant"])
            params["quant"]["codebook"] = kmeans_init_codebook(
                zin, cfg.vq.codebook_size, rng)
        params = optim.require_grad(params)
        loss, aux = tokenizer_loss(params, feats, cfg,
                                   commit_weight=cfg.vq.commitment_weight,
                                   compute_dtype=compute_dtype, tp=tp)
        grads = optim.grad(loss / n, params)
        grads["quant"]["codebook"] = torch.zeros_like(
            grads["quant"]["codebook"])
        grads = mesh_lib.reduce_grads(grads, [data])
        dims = mesh_lib.map_with_path(lambda path, x: None, params)
        params, opt_state = optim.sharded_update(
            optimizer, grads, opt_state, params, dims=dims,
            model_split=model_split, model_group=tp)
        params["quant"], cb_state = ema_codebook_update(
            params["quant"], cb_state, whole(aux["zin"]), whole(aux["idx"]),
            rng=rng, decay=decay, threshold_dead=threshold_dead)
        metrics = {k: aux[k].detach() for k in
                   ("commit_loss", "re_loss", "iframe_loss", "pframe_loss")}
        metrics["total_loss"] = loss.detach()
        metrics = {k: data.all_reduce(v.clone()) / n
                   for k, v in metrics.items()}
        return params, opt_state, cb_state, metrics

    return step
