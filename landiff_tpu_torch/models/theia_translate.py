"""Theia feature-translator heads (counterpart of landiff_tpu/models/
theia_translate.py; reference tokenizer/models/feature_extractor/
theia_model.py:686-1310), the distillation side of Theia training: the
backbone's tokens are adapted and translated into the feature spaces of
the teacher models. Unused by LanDiff inference.

  FeatureTranslator     = backbone adapter -> per-target head
  LinearAdapterHead     (theia_model.py:686-720): CLS token -> linear
  MLPAdapterHead        (:723-805): drop CLS, nearest resize to the
                          target grid, MLP (hidden 2 * C_s)
  LightConvAdapterHead  (:935-1094): drop CLS, an optional pad-to-16
                          transposed conv, then [full-tensor LayerNorm,
                          (transposed) conv, ReLU] stacks + a linear
  MLPFeatureTranslator / LightConvFeatureTranslator (:1189-1310)

Feature maps run NCHW. Parameters keep the JAX tree and the bridge's
layouts: conv kernels OIHW (co, ci, kh, kw), for F.conv2d and, with the
first two axes swapped and no flip, for F.conv_transpose2d; the
full-tensor LayerNorm's (C, H, W) affine stored (H, W, C), as in JAX;
linears (in, out). Heads carry their kind and static shapes as plain
Python values.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _linear(p, x):
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def layer_norm_chw(p, x, eps=1e-5):
    """Full-tensor LayerNorm over (C, H, W) with a (C, H, W) affine
    (nn.LayerNorm(source_size), theia_model.py:1023). x: (B, C, H, W);
    the affine is stored (H, W, C)."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2, 3), keepdim=True)
    var = xf.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
    out = ((xf - mean) / torch.sqrt(var + eps)).to(x.dtype)
    return (out * p["g"].permute(2, 0, 1).to(x.dtype)
            + p["b"].permute(2, 0, 1).to(x.dtype))


def conv2d(p, x, *, stride=1, padding=1):
    """NCHW conv, kernel OIHW."""
    return F.conv2d(x, p["w"].to(x.dtype), p["b"].to(x.dtype),
                    stride=stride, padding=padding)


def conv_transpose2d(p, x, *, stride=1, padding=0, output_padding=0):
    """torch ConvTranspose2d semantics, out = (H - 1) * stride - 2 *
    padding + k + output_padding. The kernel is the bridged OIHW (co, ci,
    kh, kw); F.conv_transpose2d takes (ci, co, kh, kw), not flipped. The
    full output is cropped by `padding` at the start and by padding -
    output_padding at the end (a negative crop adds rows no input
    reaches, as JAX's lhs-dilated conv does, also where output_padding
    is not below the stride, which nn.ConvTranspose2d refuses)."""
    w = p["w"].to(x.dtype).transpose(0, 1)
    y = F.conv_transpose2d(x, w, stride=stride)
    end = padding - output_padding
    y = F.pad(y, (-padding, -end, -padding, -end))
    return y + p["b"].to(x.dtype)[:, None, None]


# ---------------------------------------------------------------------------
# init (the JAX init's shapes in the bridge's layouts)


def _normal(gen, shape, std, dtype):
    return (torch.randn(shape, generator=gen, device=gen.device)
            * std).to(dtype)


def _linear_init(gen, cin, cout, dtype=torch.float32):
    return {"w": _normal(gen, (cin, cout), (1.0 / cin) ** 0.5, dtype),
            "b": torch.zeros((cout,), dtype=dtype, device=gen.device)}


def _ln_chw_init(gen, h, w, c, dtype=torch.float32):
    return {"g": torch.ones((h, w, c), dtype=dtype, device=gen.device),
            "b": torch.zeros((h, w, c), dtype=dtype, device=gen.device)}


def _conv_init(gen, kh, kw, ci, co, dtype=torch.float32):
    return {"w": _normal(gen, (co, ci, kh, kw), (1.0 / (kh * kw * ci)) ** 0.5,
                         dtype),
            "b": torch.zeros((co,), dtype=dtype, device=gen.device)}


def linear_head_init(gen, source_c, target_c, dtype=torch.float32):
    return {"kind": "linear",
            "lin": _linear_init(gen, source_c, target_c, dtype)}


def mlp_head_init(gen, source, target, num_layer, dtype=torch.float32):
    """source / target: (C, H, W). MLP hidden 2 * C_s (theia_model.py:
    778-791)."""
    cs, ct = source[0], target[0]
    hidden = cs * 2
    if num_layer == 1:
        layers = [_linear_init(gen, cs, ct, dtype)]
    else:
        layers = [_linear_init(gen, cs, hidden, dtype)]
        layers += [_linear_init(gen, hidden, hidden, dtype)
                   for _ in range(num_layer - 2)]
        layers.append(_linear_init(gen, hidden, ct, dtype))
    return {"kind": "mlp", "source": tuple(source), "target": tuple(target),
            "layers": layers}


def light_conv_head_init(gen, source, target, hidden_factor=1.0,
                         dtype=torch.float32):
    """source (C, H, W) with H in {12..14 (padded to 16), 16, 64}; target
    H in {7, 14, 16, 64}, the reference's cases (theia_model.py:
    991-1085)."""
    cs, hs, ws = source
    ct, ht, _ = target
    hidden = int(cs * hidden_factor)
    conv = lambda k, ci, co: _conv_init(gen, k, k, ci, co, dtype)
    ln = lambda h, c: ("ln", _ln_chw_init(gen, h, h, c, dtype))
    p = {"kind": "light_conv", "source": tuple(source),
         "target": tuple(target)}
    if hs < 16 and ht >= 16:                       # pad <= 14 -> 16
        p["pad"] = conv(3, cs, cs)
        p["pad_out"] = 14 - hs
        hs = ws = 16
    if hs == 16 and ht == 64:
        p["stack"] = [
            ln(16, cs),
            ("convt", conv(3, cs, hidden), dict(stride=2, padding=1)),  # 31
            ln(31, hidden),
            ("convt", conv(3, hidden, hidden),
             dict(stride=2, padding=0, output_padding=1)),              # 64
            ln(64, hidden)]
    elif hs == ht:                                  # same size
        p["stack"] = [
            ln(hs, cs),
            ("conv", conv(3, cs, hidden), dict(stride=1, padding=1)),
            ln(hs, hidden),
            ("conv", conv(3, hidden, hidden), dict(stride=1, padding=1)),
            ln(hs, hidden)]
    elif hs == 64 and ht == 16:
        p["stack"] = [
            ln(64, cs),
            ("conv", conv(3, cs, hidden), dict(stride=2, padding=1)),   # 32
            ln(32, hidden),
            ("conv", conv(3, hidden, hidden), dict(stride=2, padding=1)),
            ln(16, hidden)]
    elif ht == 7:                                   # 14 x 14 -> 7 x 7
        p["stack"] = [
            ln(hs, cs),
            ("conv", conv(4, cs, hidden), dict(stride=2, padding=1)),   # 7
            ln(7, hidden)]
    else:
        raise NotImplementedError((source, target))
    p["out"] = _linear_init(gen, hidden, ct, dtype)
    return p


# ---------------------------------------------------------------------------
# forward


def head_forward(p, x, *, no_cls=False):
    """x: (B, (1+)H*W, C) backbone tokens -> the target features: linear
    -> (B, C_t) from the CLS token; mlp / light_conv -> (B, H_t*W_t,
    C_t)."""
    kind = p["kind"]
    if kind == "linear":
        if no_cls:
            raise ValueError("the linear head needs the CLS token")
        return _linear(p["lin"], x[:, 0])
    if not no_cls:
        x = x[:, 1:]
    cs, hs, ws = p["source"]
    ct, ht, wt = p["target"]
    B = x.shape[0]
    if kind == "mlp":
        grid = x.reshape(B, hs, ws, cs)
        if (hs, ws) != (ht, wt):
            # F.interpolate's default 'nearest': source index floor(i *
            # src / dst), computed in f32 as the JAX package does
            hi = np.floor(np.arange(ht, dtype=np.float32)
                          * np.float32(hs / ht)).astype(np.int64)
            wi = np.floor(np.arange(wt, dtype=np.float32)
                          * np.float32(ws / wt)).astype(np.int64)
            grid = grid[:, torch.from_numpy(hi).to(x.device)][
                :, :, torch.from_numpy(wi).to(x.device)]
        out = grid.reshape(B, ht * wt, cs)
        for i, lin in enumerate(p["layers"]):
            if i:
                out = F.relu(out)
            out = _linear(lin, out)
        return out
    if kind != "light_conv":
        raise ValueError(f"unknown head kind {kind!r}")
    grid = x.reshape(B, hs, ws, cs).permute(0, 3, 1, 2)
    if "pad" in p:
        grid = conv_transpose2d(p["pad"], grid, stride=1, padding=0,
                                output_padding=p["pad_out"])
    # LN -> (conv, ReLU) -> LN -> ... -> LN -> linear: every conv is
    # followed by ReLU, none before the output linear (:1022-1085)
    for item in p["stack"]:
        if item[0] == "ln":
            grid = layer_norm_chw(item[1], grid)
        else:
            conv = conv_transpose2d if item[0] == "convt" else conv2d
            grid = F.relu(conv(item[1], grid, **item[2]))
    out = grid.permute(0, 2, 3, 1).reshape(B, -1, grid.shape[1])
    return _linear(p["out"], out)


def init_translator(gen, backbone, targets, *, kind="light_conv",
                    hidden_size=1024, n_layer=3, hidden_factor=1.0,
                    dtype=torch.float32):
    """backbone: (C, H, W); targets: name -> (C, H, W). kind "mlp": the
    MLPFeatureTranslator (LN + linear adapter to hidden_size, MLP heads,
    theia_model.py:1189-1227); "light_conv": the LightConvFeatureTranslator
    (identity adapter, light-conv heads, "_cls" targets a linear head,
    :1263-1310)."""
    p = {"kind": kind, "backbone": tuple(backbone), "heads": {}}
    c = backbone[0]
    if kind == "mlp":
        p["adapter_ln"] = {
            "g": torch.ones((c,), dtype=dtype, device=gen.device),
            "b": torch.zeros((c,), dtype=dtype, device=gen.device)}
        p["adapter_lin"] = _linear_init(gen, c, hidden_size, dtype)
        source = (hidden_size, backbone[1], backbone[2])
        for name, tgt in targets.items():
            p["heads"][name] = mlp_head_init(gen, source, tgt, n_layer, dtype)
    elif kind == "light_conv":
        for name, tgt in targets.items():
            p["heads"][name] = (
                linear_head_init(gen, c, tgt[0], dtype) if "_cls" in name
                else light_conv_head_init(gen, backbone, tgt, hidden_factor,
                                          dtype))
    else:
        raise ValueError(kind)
    return p


def translate(p, x, *, target_names=None, no_cls=False):
    """x: (B, (1+)H*W, C) backbone tokens -> {target: features}
    (FeatureTranslator.forward, theia_model.py:1154-1187)."""
    if p["kind"] == "mlp":
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        ln = ((xf - mu) / torch.sqrt(var + 1e-5)).to(x.dtype)
        ln = (ln * p["adapter_ln"]["g"].to(x.dtype)
              + p["adapter_ln"]["b"].to(x.dtype))
        x = _linear(p["adapter_lin"], ln)
    names = target_names if target_names is not None else list(p["heads"])
    return {t: head_forward(p["heads"][t], x, no_cls=no_cls) for t in names}


def distill_loss(pred, teacher_feats, *, beta=1.0):
    """Per-target cosine + smooth-L1 distillation objective (the Theia
    recipe, the JAX package's training utility). Returns (total,
    per-target dict)."""
    per = {}
    for name, yhat in pred.items():
        y = teacher_feats[name].float()
        yh = yhat.float()
        cos = 1.0 - torch.mean((yh * y).sum(-1)
                               / (torch.linalg.norm(yh, dim=-1)
                                  * torch.linalg.norm(y, dim=-1) + 1e-8))
        diff = (yh - y).abs()
        sl1 = torch.where(diff < beta, 0.5 * diff ** 2 / beta,
                          diff - 0.5 * beta).mean()
        per[name] = cos + sl1
    total = sum(per.values()) / max(len(per), 1)
    return total, per
