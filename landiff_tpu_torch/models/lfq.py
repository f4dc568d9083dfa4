"""Lookup-Free Quantization (counterpart of landiff_tpu/models/lfq.py;
reference sgm/modules/autoencoding/regularizers/
lookup_free_quantization.py:63-327, from vector-quantize-pytorch /
MagViT2).

Codes are sign bits: quantized = sign(x) * codebook_scale per bit; the
index is the big-endian bit pattern (bit i set iff x_i > 0). Training adds
a straight-through estimator, an entropy aux loss and an MSE commit loss.
Parameters are a dict (empty when dim == num_codebooks * log2(K), else
the project_in / project_out linears, (in, out)); inputs are (B, N, dim)
sequences.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class LFQConfig:
    codebook_size: int = 65536          # a power of 2
    dim: int | None = None              # None -> num_codebooks * log2(K)
    num_codebooks: int = 1
    codebook_scale: float = 1.0
    entropy_loss_weight: float = 0.1
    commitment_loss_weight: float = 0.25
    diversity_gamma: float = 1.0
    inv_temperature: float = 100.0
    frac_per_sample_entropy: float = 1.0

    @property
    def codebook_dim(self) -> int:
        d = math.log2(self.codebook_size)
        if not d.is_integer():
            raise ValueError("codebook_size must be a power of 2")
        return int(d)

    @property
    def codebook_dims(self) -> int:
        return self.codebook_dim * self.num_codebooks

    @property
    def effective_dim(self) -> int:
        return self.dim if self.dim is not None else self.codebook_dims

    @property
    def has_projections(self) -> bool:
        return self.effective_dim != self.codebook_dims


def bit_mask(cfg: LFQConfig) -> np.ndarray:
    """Big-endian bit weights (lookup_free_quantization.py:134)."""
    return 2 ** np.arange(cfg.codebook_dim - 1, -1, -1)


def codebook(cfg: LFQConfig) -> np.ndarray:
    """(K, codebook_dim) in {-scale, +scale} (:139-143)."""
    codes = np.arange(cfg.codebook_size)
    bits = ((codes[:, None] & bit_mask(cfg)) != 0).astype(np.float32)
    return bits * cfg.codebook_scale * 2 - cfg.codebook_scale


def init(gen: torch.Generator, cfg: LFQConfig, dtype=torch.float32) -> dict:
    """The projections, uniform in +-1/sqrt(fan_in), on gen's device."""
    if not cfg.has_projections:
        return {}
    d, cd = cfg.effective_dim, cfg.codebook_dims

    def uniform(shape, bound):
        u = torch.rand(shape, generator=gen, device=gen.device)
        return ((u * 2.0 - 1.0) * bound).to(dtype)

    z = lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)
    return {"in_w": uniform((d, cd), 1 / math.sqrt(d)), "in_b": z(cd),
            "out_w": uniform((cd, d), 1 / math.sqrt(cd)), "out_b": z(d)}


def _entropy(prob, eps=1e-5):
    return (-prob * torch.log(prob.clamp_min(eps))).sum(-1)


def _affine(x, w, b):
    return x @ w.float() + b.float()


def quantize(params, cfg: LFQConfig, x, *, training: bool = False,
             generator: torch.Generator | None = None, perm=None,
             sample_mask=None):
    """LFQ.forward (:180-327) on (B, N, dim) inputs.

    Returns (out (B, N, dim), indices (B, N, C) int32, C squeezed when
    num_codebooks == 1, the aux loss, a breakdown dict). With
    frac_per_sample_entropy < 1 the per-sample entropy averages over the
    samples perm[:n_keep] of a permutation of the B*N samples: `perm`, or
    drawn from `generator`."""
    x = x.float()
    B, N, _ = x.shape
    if cfg.has_projections:
        x = _affine(x, params["in_w"], params["in_b"])
    x = x.reshape(B, N, cfg.num_codebooks, cfg.codebook_dim)
    original = x

    scale = cfg.codebook_scale
    quantized = torch.where(x > 0, scale, -scale)
    if training:
        x = x + (quantized - x).detach()          # straight-through
    else:
        x = quantized

    mask = torch.as_tensor(bit_mask(cfg), dtype=torch.int32, device=x.device)
    indices = ((x > 0).to(torch.int32) * mask).sum(-1, dtype=torch.int32)

    zero = torch.zeros((), device=x.device)
    entropy_aux = per_sample_entropy = codebook_entropy = commit = zero
    if training:
        cb = torch.as_tensor(codebook(cfg), device=x.device)
        distance = -2.0 * torch.einsum("bncd,jd->bncj", original, cb)
        prob = torch.softmax(-distance * cfg.inv_temperature, dim=-1)
        prob = prob.reshape(B * N, cfg.num_codebooks, cfg.codebook_size)
        if sample_mask is not None:
            w = torch.as_tensor(sample_mask, device=x.device).float() \
                .reshape(-1)
        else:
            w = torch.ones((B * N,), device=x.device)
        if cfg.frac_per_sample_entropy < 1.0:
            if perm is None:
                if generator is None:
                    raise ValueError("frac_per_sample_entropy < 1 needs a "
                                     "generator or a permutation")
                perm = torch.randperm(B * N, generator=generator,
                                      device=generator.device)
            n_keep = int(B * N * cfg.frac_per_sample_entropy)
            keep = torch.zeros((B * N,), device=x.device)
            keep[torch.as_tensor(perm, device=x.device)[:n_keep]] = 1.0
            w = w * keep
        denom = w.sum().clamp_min(1.0)
        per_sample_entropy = (_entropy(prob).mean(-1) * w).sum() / denom
        avg_prob = (prob * w[:, None, None]).sum(0) / denom
        codebook_entropy = _entropy(avg_prob).mean()
        entropy_aux = (per_sample_entropy
                       - cfg.diversity_gamma * codebook_entropy)
        commit = (original - quantized.detach()) ** 2
        if sample_mask is not None:
            wm = torch.as_tensor(sample_mask, device=x.device).float() \
                .reshape(B, N, 1, 1)
            commit = (commit * wm).sum() / (
                wm.sum() * cfg.num_codebooks * cfg.codebook_dim).clamp_min(
                    1.0)
        else:
            commit = commit.mean()

    out = x.reshape(B, N, cfg.codebook_dims)
    if cfg.has_projections:
        out = _affine(out, params["out_w"], params["out_b"])
    if cfg.num_codebooks == 1:
        indices = indices[..., 0]
    aux = (entropy_aux * cfg.entropy_loss_weight
           + commit * cfg.commitment_loss_weight)
    breakdown = {"per_sample_entropy": per_sample_entropy,
                 "codebook_entropy": codebook_entropy,
                 "commitment": commit}
    return out, indices, aux, breakdown


def indices_to_codes(params, cfg: LFQConfig, indices, project_out=True):
    """LFQ.indices_to_codes (:152-177). indices (..., C), or (...) when
    num_codebooks == 1."""
    indices = torch.as_tensor(indices)
    if cfg.num_codebooks == 1 and (indices.dim() == 0
                                   or indices.shape[-1] != cfg.num_codebooks):
        indices = indices[..., None]
    mask = torch.as_tensor(bit_mask(cfg), dtype=torch.int32,
                           device=indices.device)
    bits = (indices[..., None].to(torch.int32) & mask) != 0
    codes = bits.float() * cfg.codebook_scale * 2 - cfg.codebook_scale
    codes = codes.reshape(codes.shape[:-2] + (cfg.codebook_dims,))
    if project_out and cfg.has_projections:
        codes = _affine(codes, params["out_w"], params["out_b"])
    return codes
