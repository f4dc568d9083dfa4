"""Vector quantizer + VideoVQ pipeline, Theia -> TiTok -> VQ (counterpart
of landiff_tpu/models/vq.py).

The quantizer re-creates `vector_quantize_pytorch.VectorQuantize(
codebook_size=2048, dim=768, codebook_dim=16, kmeans_init,
threshold_ema_dead_code=2)` (tokenizer_cfg.py:89-95): project_in 768 -> 16,
Euclidean nearest-code lookup, project_out 16 -> 768, in f32 (the
reference's `self.quantizer(x.float())`). Inference is the codebook gather
and the projections; the EMA codebook and k-means live in
training/vq_train.py.

VideoVQ (tokenizer/models/video_titok_vq.py):
  encode_to_index (:171-202): frames -> Theia -> norm -> TiTok encode ->
                              quantize
  index_to_feature (:250-265): indices -> codebook -> TiTok decode -> denorm
The released config passes mean_std_dim but no mean_std_path, so norm /
denorm are the identity (video_titok_vq.py:224-238 test `mean_std_path is
not None`); the buffers and the flag are kept, as in the JAX package.

Params tree:
  {"quant": {"in_w": (dim, cdim), "in_b", "out_w": (cdim, dim), "out_b",
             "codebook": (K, cdim)},
   "encoder": TiTok encoder, "decoder": TiTok decoder,
   "theia": Theia (frozen; with_theia), "mean": (C,), "std": (C,)}
"""

from __future__ import annotations

import numpy as np
import torch

from landiff_tpu_torch.config import TokenizerConfig
from landiff_tpu_torch.models import theia as theia_lib
from landiff_tpu_torch.models import titok as titok_lib


# ---------------------------------------------------------------------------
# quantizer core (f32)


def project_in(qp, z):
    """The quantizer's project_in: z (..., dim) -> (..., cdim), in f32."""
    return z.float() @ qp["in_w"].float() + qp["in_b"].float()


def sq_dist(x, means):
    """||x - m||^2 = x^2 - 2 x.m + m^2 between the rows of x (n, d) and
    of means (K, d): (n, K)."""
    return (x.square().sum(-1, keepdim=True) - 2.0 * x @ means.T
            + means.square().sum(-1)[None])


def nearest(qp, z):
    """(project_in(z) (..., cdim), the codebook (K, cdim), argmin indices),
    in f32."""
    zin = project_in(qp, z)
    cb = qp["codebook"].float()
    return zin, cb, sq_dist(zin, cb).argmin(-1)


def quantize(qp, z):
    """z (..., dim) -> (quantized (..., dim) f32, indices (...))."""
    _, _, idx = nearest(qp, z)
    return codes_to_output(qp, idx), idx


def codes_to_output(qp, indices):
    """VectorQuantize.get_output_from_indices: codebook gather +
    project_out, in f32."""
    e = qp["codebook"].float()[indices]
    return e @ qp["out_w"].float() + qp["out_b"].float()


def commit_loss(qp, z):
    """Commitment loss (training): mse(project_in(z), sg(nearest code)).
    Returns (loss, indices)."""
    zin, cb, idx = nearest(qp, z)
    e = cb[idx].detach()
    return ((zin - e).square().sum(-1) / zin.shape[-1]).mean(), idx


# ---------------------------------------------------------------------------
# FSQ (finite scalar quantization), the alternative quantizer TowDVQ
# supports (video_titok_vq.py:92-96), vector_quantize_pytorch.FSQ semantics


def fsq_quantize(z, levels: tuple[int, ...]):
    """z (..., len(levels)) -> (codes in [-1, 1], flat indices). Even
    levels take the half-integer offset: bound(z) = tanh(z +
    atanh(offset / half_l)) * half_l - offset."""
    dev = z.device
    lv = torch.tensor(levels, dtype=torch.float32, device=dev)
    half_l = (lv - 1.0) / 2.0
    offset = torch.tensor([0.5 if L % 2 == 0 else 0.0 for L in levels],
                          dtype=torch.float32, device=dev)
    shift = torch.atanh(offset / half_l)
    bounded = torch.tanh(z.float() + shift) * half_l - offset
    rounded = torch.round(bounded)
    q = bounded + (rounded - bounded).detach()
    half_w = torch.tensor([L // 2 for L in levels], dtype=torch.float32,
                          device=dev)
    digits = (rounded + half_w).to(torch.int32)
    basis = torch.tensor([int(np.prod(levels[:i])) for i in
                          range(len(levels))], dtype=torch.int32, device=dev)
    return q / half_w, (digits * basis).sum(-1, dtype=torch.int32)


def fsq_indices_to_codes(indices, levels: tuple[int, ...]):
    """FSQ.indices_to_codes: flat index -> normalized code vector."""
    half_w = torch.tensor([L // 2 for L in levels], dtype=torch.float32,
                          device=indices.device)
    digits = []
    rem = indices
    for L in levels:
        digits.append(rem % L)
        rem = rem // L
    return (torch.stack(digits, dim=-1).float() - half_w) / half_w


# ---------------------------------------------------------------------------
# VideoVQ pipeline


def norm_features(params, feats, use_mean_std: bool = False):
    if not use_mean_std:
        return feats
    return (feats - params["mean"]) / (params["std"] + 1e-8)


def denorm_features(params, feats, use_mean_std: bool = False):
    if not use_mean_std:
        return feats
    return feats * (params["std"] + 1e-8) + params["mean"]


def extract_features(params, video, cfg: TokenizerConfig,
                     compute_dtype=torch.bfloat16):
    """video (B, T, H, W, 3) uint8 -> (B, T, gh, gw, C) Theia features."""
    return theia_lib.extract(params["theia"], video, cfg.theia,
                             output_shape=(cfg.titok.grid_h, cfg.titok.grid_w),
                             compute_dtype=compute_dtype)


def encode_features_to_index(params, features, cfg: TokenizerConfig,
                             compute_dtype=torch.bfloat16,
                             use_mean_std: bool = False):
    """features (B, T, gh, gw, C) -> (quantized (B, L, dim), indices
    (B, L))."""
    feats = norm_features(params, features, use_mean_std)
    lat = titok_lib.encode(params["encoder"], feats, cfg.titok,
                           compute_dtype=compute_dtype)
    return quantize(params["quant"], lat)


def encode_to_index(params, video, cfg: TokenizerConfig,
                    compute_dtype=torch.bfloat16,
                    use_mean_std: bool = False):
    """VideoVQ.encode_to_index: (B, T, H, W, 3) uint8 -> (quantized,
    indices)."""
    feats = extract_features(params, video, cfg, compute_dtype)
    return encode_features_to_index(params, feats, cfg, compute_dtype,
                                    use_mean_std)


def encode_codes(params, video, cfg: TokenizerConfig, *,
                 segment_length: int | None = None,
                 segment_stride: int | None = None,
                 compute_dtype=torch.bfloat16):
    """SemanticFrozenTokenizer.encode_codes (llm/modules/tokenizer.py:
    90-102): the video cut along time (default 13 / 13), each segment
    encoded. Returns flat (B, n_segments * latent_tokens) indices."""
    seg_len = segment_length or cfg.segment_length
    seg_stride = segment_stride or cfg.segment_stride
    outs = [encode_to_index(params, video[:, off:off + seg_len], cfg,
                            compute_dtype)[1]
            for off in range(0, video.shape[1], seg_stride)]
    return torch.cat(outs, dim=1)


def index_to_feature(params, indices, cfg: TokenizerConfig, *,
                     forward_t: int | None = None, denormalize: bool = True,
                     compute_dtype=torch.bfloat16,
                     use_mean_std: bool = False):
    """indices (B, L) -> (B, T, gh, gw, C) reconstructed Theia features."""
    lat = codes_to_output(params["quant"], indices)
    out = titok_lib.decode(params["decoder"], lat.to(compute_dtype),
                           cfg.titok, forward_t=forward_t,
                           compute_dtype=compute_dtype)
    if denormalize:
        out = denorm_features(params, out, use_mean_std)
    return out


def init(gen: torch.Generator, cfg: TokenizerConfig, dtype=torch.float32,
         with_theia: bool = True):
    """Random VideoVQ parameters on the generator's device."""
    q = cfg.vq
    nrm = lambda s, std: (torch.randn(s, generator=gen, device=gen.device)
                          * std).to(dtype)
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)
    params = {
        "quant": {
            "in_w": nrm((q.dim, q.codebook_dim), q.dim ** -0.5),
            "in_b": zeros(q.codebook_dim),
            "out_w": nrm((q.codebook_dim, q.dim), q.codebook_dim ** -0.5),
            "out_b": zeros(q.dim),
            "codebook": nrm((q.codebook_size, q.codebook_dim), 1.0),
        },
        "encoder": titok_lib.init_encoder(gen, cfg.titok, cfg.feature_dim,
                                          dtype),
        "decoder": titok_lib.init_decoder(gen, cfg.titok, cfg.feature_dim,
                                          dtype),
        "mean": zeros(cfg.feature_dim),
        "std": torch.ones((cfg.feature_dim,), dtype=dtype, device=gen.device),
    }
    if with_theia:
        params["theia"] = theia_lib.init(gen, cfg.theia, dtype)
    return params
