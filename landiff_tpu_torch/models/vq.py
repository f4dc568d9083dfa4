"""Vector quantizer decode side (counterpart of codes_to_output and
index_to_feature in landiff_tpu/models/vq.py; vector_quantize_pytorch
VectorQuantize get_output_from_indices + VideoVQ.index_to_feature,
video_titok_vq.py:250-265).

The released config passes no mean_std_path, so the JAX package's
feature denormalization is the identity and is left out. Encode,
quantize, FSQ and Theia are not ported yet.
"""

from __future__ import annotations

import torch

from landiff_tpu_torch.config import TokenizerConfig
from landiff_tpu_torch.models import titok as titok_lib


def codes_to_output(qp, indices):
    """Codebook gather + project_out, in f32."""
    e = qp["codebook"].float()[indices]
    return e @ qp["out_w"].float() + qp["out_b"].float()


def index_to_feature(params, indices, cfg: TokenizerConfig, *,
                     forward_t: int | None = None,
                     compute_dtype=torch.bfloat16):
    """indices (B, L) -> (B, T, gh, gw, C) reconstructed Theia features."""
    lat = codes_to_output(params["quant"], indices)
    return titok_lib.decode(params["decoder"], lat.to(compute_dtype),
                            cfg.titok, forward_t=forward_t,
                            compute_dtype=compute_dtype)


def init(gen: torch.Generator, cfg: TokenizerConfig, dtype=torch.float32,
         with_theia: bool = False):
    """Quantizer + TiTok decoder (the encoder and Theia are not part of
    the port yet)."""
    if with_theia:
        raise NotImplementedError("Theia is not ported yet")
    q = cfg.vq
    nrm = lambda s, std: (torch.randn(s, generator=gen, device=gen.device)
                          * std).to(dtype)
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)
    return {
        "quant": {
            "in_w": nrm((q.dim, q.codebook_dim), q.dim ** -0.5),
            "in_b": zeros(q.codebook_dim),
            "out_w": nrm((q.codebook_dim, q.dim), q.codebook_dim ** -0.5),
            "out_b": zeros(q.dim),
            "codebook": nrm((q.codebook_size, q.codebook_dim), 1.0),
        },
        "decoder": titok_lib.init_decoder(gen, cfg.titok, cfg.feature_dim,
                                          dtype),
    }
