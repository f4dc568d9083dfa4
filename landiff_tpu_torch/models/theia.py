"""Theia feature extractor (counterpart of landiff_tpu/models/theia.py;
reference landiff/tokenizer/models/feature_extractor/theia_extractor.py and
theia_model.py DeiT :357-452, handle_feature_output :23-63): a DeiT /
ViT-base backbone returning patch-token features at native resolution.

LanDiff runs it with interpolate=True / do_resize=False: 480x720 frames ->
a 30x45 patch grid, position embeddings bicubically interpolated from the
14x14 train grid on the host (a=-0.75, torch F.interpolate's kernel;
numpy tables of this module's own), preprocessing (x - 127.5) / 127.5, the
CLS token stripped from the output. Attention is the dense
`attention.mha_reference`, as in the JAX package (no flash kernel: S is
about 2,000 per frame).

Params tree (the JAX package's names; patch_w OIHW (D, 3, P, P), see
bridge.py):
  {"patch_w", "patch_b": (D,), "cls": (D,), "pos": (1+G, D),
   "blocks": [{"ln0_w","ln0_b","q_w","q_b","k_w","k_b","v_w","v_b",
               "o_w","o_b","ln1_w","ln1_b","fc0_w","fc0_b","fc1_w","fc1_b"}],
   "ln_f_w", "ln_f_b"[, "reg_token": (N, D), "reg_pos": (N, D)]}
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from landiff_tpu_torch.config import TheiaConfig
from landiff_tpu_torch.ops.attention import mha_reference
from landiff_tpu_torch.ops.norms import layer_norm


# ---------------------------------------------------------------------------
# bicubic interpolation of position embeddings (host-side, cached)


def _cubic_kernel(x, a=-0.75):
    x = np.abs(x)
    return np.where(
        x <= 1, ((a + 2) * x - (a + 3)) * x * x + 1,
        np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _resize_axis_matrix(src: int, dst: int,
                        scale: float | None = None) -> np.ndarray:
    """(dst, src) row-stochastic matrix for torch-style bicubic
    (align_corners=False, half-pixel centers). `scale` overrides the
    source-coordinate step (F.interpolate given scale_factor=sf steps by
    1/sf, not src/dst)."""
    if scale is None:
        scale = src / dst
    out = np.zeros((dst, src), np.float64)
    for i in range(dst):
        center = (i + 0.5) * scale - 0.5
        base = math.floor(center)
        for t in range(-1, 3):
            j = base + t
            w = _cubic_kernel(center - j)
            jc = min(max(j, 0), src - 1)  # replicate border
            out[i, jc] += w
    return out


@functools.lru_cache(maxsize=16)
def interpolate_pos_embed_matrixes(src_h: int, src_w: int, dst_h: int,
                                   dst_w: int, dino_scale: bool = False):
    """dino_scale: DeiTNoCLS / DeiTReg interpolate with
    F.interpolate(scale_factor=(h0 + 0.1) / sqrt(N)), DINO's +0.1
    (theia_model.py:103-120, 229-270), whose step is 1/sf; the plain CLS
    variant goes through HF ViTModel's size-based interpolation."""
    sh = src_h / (dst_h + 0.1) if dino_scale else None
    sw = src_w / (dst_w + 0.1) if dino_scale else None
    return (_resize_axis_matrix(src_h, dst_h, sh),
            _resize_axis_matrix(src_w, dst_w, sw))


def interpolate_pos_embed(pos: np.ndarray, dst_h: int, dst_w: int,
                          dino_scale: bool = False) -> np.ndarray:
    """pos: (1+G, D) with CLS first. Returns (1 + dst_h*dst_w, D)."""
    cls_pos, patch_pos = pos[:1], pos[1:]
    g = int(round(math.sqrt(patch_pos.shape[0])))
    assert g * g == patch_pos.shape[0]
    d = patch_pos.shape[-1]
    grid = patch_pos.reshape(g, g, d).astype(np.float64)
    mh, mw = interpolate_pos_embed_matrixes(g, g, dst_h, dst_w, dino_scale)
    grid = np.einsum("hH,Hwd->hwd", mh, grid)
    grid = np.einsum("wW,hWd->hwd", mw, grid)
    return np.concatenate(
        [cls_pos, grid.reshape(dst_h * dst_w, d).astype(pos.dtype)], axis=0)


def _pos_table(params, h: int, w: int, cfg: TheiaConfig,
               dtype) -> torch.Tensor:
    """The position table for an h x w grid, in `dtype` on the params'
    device: the stored one at the train grid, else interpolated on the
    host in float64 and rounded to the stored dtype first, as JAX does;
    no_cls drops the CLS row, registers append their own rows."""
    pos = params["pos"]
    n_reg = cfg.num_register_tokens
    src_g = cfg.image_size // cfg.patch_size
    if (h, w) != (src_g, src_g):
        table = interpolate_pos_embed(pos.detach().float().cpu().numpy()
                                      .astype(np.float64), h, w,
                                      dino_scale=cfg.no_cls or n_reg > 0)
        pos = torch.from_numpy(table).to(pos.dtype).to(pos.device)
    if cfg.no_cls:
        pos = pos[1:]
    pos = pos.to(dtype)
    if n_reg:
        pos = torch.cat([pos, params["reg_pos"].to(dtype)], dim=0)
    return pos


# ---------------------------------------------------------------------------
# ViT forward


def _vit_block(p, x, cfg: TheiaConfig):
    B, S, D = x.shape
    H = cfg.num_heads
    dt = x.dtype
    lin = lambda h, name: h @ p[f"{name}_w"].to(dt) + p[f"{name}_b"].to(dt)
    h = layer_norm(x, p["ln0_w"], p["ln0_b"], cfg.layer_norm_eps)
    q, k, v = (lin(h, n).reshape(B, S, H, D // H) for n in "qkv")
    x = x + lin(mha_reference(q, k, v).reshape(B, S, D), "o")
    h = layer_norm(x, p["ln1_w"], p["ln1_b"], cfg.layer_norm_eps)
    return x + lin(F.gelu(lin(h, "fc0")), "fc1")


def forward_features(params, images, cfg: TheiaConfig,
                     compute_dtype=torch.bfloat16):
    """images (B, H, W, 3) uint8 -> (B, H/P, W/P, D) patch features (CLS
    and register tokens dropped)."""
    B, H, W, _ = images.shape
    P = cfg.patch_size
    h, w = H // P, W // P
    x = ((images.float() - 127.5) / 127.5).to(compute_dtype)
    x = F.conv2d(x.permute(0, 3, 1, 2), params["patch_w"].to(compute_dtype),
                 stride=P)
    x = x + params["patch_b"].to(compute_dtype)[None, :, None, None]
    x = x.flatten(2).transpose(1, 2)                 # (B, h*w, D)
    # DeiTNoCLS (theia_model.py:79-120) has no CLS token; DeiTReg
    # (:121-327) appends N register tokens after the patch tokens
    parts = [x]
    if not cfg.no_cls:
        parts.insert(0, params["cls"].to(compute_dtype).expand(B, 1, -1))
    n_reg = cfg.num_register_tokens
    if n_reg:
        parts.append(params["reg_token"].to(compute_dtype).expand(B, -1, -1))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else x
    x = x + _pos_table(params, h, w, cfg, compute_dtype)[None]
    for p in params["blocks"]:
        x = _vit_block(p, x, cfg)
    x = layer_norm(x, params["ln_f_w"], params["ln_f_b"], cfg.layer_norm_eps)
    # handle_feature_output(num_discard_tokens=N) (theia_model.py:23-63)
    start = 0 if cfg.no_cls else 1
    return x[:, start:x.shape[1] - n_reg].reshape(B, h, w, -1)


def extract(params, frames, cfg: TheiaConfig, output_shape=None,
            compute_dtype=torch.bfloat16):
    """TheiaExtractor.forward (theia_extractor.py:46-143): frames
    (..., H, W, 3) uint8 -> (..., out_h, out_w, D), cropped or zero-padded
    to `output_shape` (default cfg.output_grid)."""
    if output_shape is None:
        output_shape = cfg.output_grid
    lead = frames.shape[:-3]
    feats = forward_features(params, frames.reshape(-1, *frames.shape[-3:]),
                             cfg, compute_dtype)
    oh, ow = output_shape
    fh, fw = feats.shape[1:3]
    if fh < oh or fw < ow:
        feats = F.pad(feats, (0, 0, 0, max(0, ow - fw), 0, max(0, oh - fh)))
    feats = feats[:, :oh, :ow]
    return feats.reshape(*lead, *feats.shape[1:])


def init(gen: torch.Generator, cfg: TheiaConfig, dtype=torch.float32):
    """Random Theia parameters on the generator's device (patch_w OIHW)."""
    D, P = cfg.hidden_size, cfg.patch_size
    M = int(D * cfg.mlp_ratio)
    G = (cfg.image_size // P) ** 2
    nrm = lambda s: (torch.randn(s, generator=gen, device=gen.device)
                     * 0.02).to(dtype)
    z = lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)
    o = lambda n: torch.ones((n,), dtype=dtype, device=gen.device)
    blocks = [{
        "ln0_w": o(D), "ln0_b": z(D),
        "q_w": nrm((D, D)), "q_b": z(D), "k_w": nrm((D, D)), "k_b": z(D),
        "v_w": nrm((D, D)), "v_b": z(D), "o_w": nrm((D, D)), "o_b": z(D),
        "ln1_w": o(D), "ln1_b": z(D),
        "fc0_w": nrm((D, M)), "fc0_b": z(M), "fc1_w": nrm((M, D)),
        "fc1_b": z(D),
    } for _ in range(cfg.num_layers)]
    out = {
        "patch_w": nrm((D, 3, P, P)), "patch_b": z(D),
        "cls": nrm((D,)), "pos": nrm((1 + G, D)),
        "blocks": blocks, "ln_f_w": o(D), "ln_f_b": z(D),
    }
    if cfg.num_register_tokens:
        # DeiTReg: reg_token + reg_pos_embed (theia_model.py:209-227)
        out["reg_token"] = nrm((cfg.num_register_tokens, D))
        out["reg_pos"] = nrm((cfg.num_register_tokens, D))
    return out
