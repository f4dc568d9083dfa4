"""Checkpoint conversion: reference torch checkpoints -> the numpy
parameter trees of the JAX package's layouts (the port's own copy of
landiff_tpu/ckpt/convert.py; ckpt/load.py hands the trees to `bridge`).

What differs from that module: numpy has no bfloat16, so BF16 tensors
(safetensors or torch) are widened to f32 on load, exactly (a bf16 value
is the f32 with the low 16 bits zero); `save_safetensors` writes the
format as well as reading it; and the DiT layer round-trip of
`verify_ckpt_tree` reports "skipped" (the SAT-layer transcription it holds
the layer to is test code of the JAX package).

Handles the reference's four formats (SURVEY §5 checkpoint/resume):
  1. safetensors strict-load for LLM & tokenizer (llm_infer.py:70-71,
     video_titok_vq.py:161-167)
  2. SAT/DeepSpeed `mp_rank_00_model_states.pt["module"]` for the DiT
     (dif_infer.py:147, dit_video_concat.py:1176-1185)
  3. Lightning-style `["state_dict"]` for 3d-vae.pt (autoencoder.py:603-614)
  4. HF hub T5/Theia (frozen weights, omitted from released ckpts via
     freeze_model — utils.py:220-275)

All mapping functions take a FLAT dict[str, np.ndarray] (torch state_dict
converted to numpy) and return our nested pytrees; torch is only needed by
the `load_torch_file` helper (dev-time). Linear weights transpose
(out,in)->(in,out); convs to HWIO/DHWIO.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger("landiff_tpu_torch.ckpt")


_ST_TO_NP = {"F64": "float64", "F32": "float32", "F16": "float16",
             "I64": "int64", "I32": "int32", "I16": "int16", "I8": "int8",
             "U8": "uint8", "BOOL": "bool"}


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> the same values in f32, exactly."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bfloat16 bit patterns (uint16), rounded to nearest even."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


def round_to_bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bfloat16 (nearest even), held in f32."""
    return _bf16_bits_to_f32(_f32_to_bf16_bits(x))


def load_safetensors_views(path: str | Path) -> dict[str, np.ndarray]:
    """mmap a safetensors file and return ZERO-COPY numpy views into it
    (BF16 tensors excepted: widened to f32 copies).

    The multi-GB checkpoints (LLM 7.8 GB, T5-XXL 9 GB) would otherwise be
    copied twice (library load + convert); views defer every byte to its
    single actual use. Views are read-only; converters copy on transform
    (ascontiguousarray/stack), loaders copy on the tensor cast — nothing
    downstream mutates in place."""
    import json as _json

    path = Path(path)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = _json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for k, v in header.items():
        if k == "__metadata__":
            continue
        s, e = v["data_offsets"]
        if v["dtype"] == "BF16":
            out[k] = _bf16_bits_to_f32(
                data[s:e].view(np.uint16).reshape(v["shape"]))
        else:
            out[k] = data[s:e].view(np.dtype(_ST_TO_NP[v["dtype"]])
                                    ).reshape(v["shape"])
    return out


_NP_TO_ST = {np.dtype(v): k for k, v in _ST_TO_NP.items()}


def save_safetensors(path: str | Path, tensors: dict[str, np.ndarray],
                     bf16: tuple[str, ...] = ()) -> int:
    """Write numpy arrays as a safetensors file (8-byte little-endian
    header length, the JSON header, the data in header order, each tensor
    C-contiguous little-endian). Names in `bf16` are written as BF16,
    rounded to nearest even from f32. Returns the file's size in bytes."""
    import json as _json

    header, blobs, offset = {}, [], 0
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        if name in bf16:
            raw, dtype = _f32_to_bf16_bits(arr).astype("<u2"), "BF16"
        else:
            raw = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
            dtype = _NP_TO_ST[arr.dtype]
        blob = raw.tobytes()
        header[name] = {"dtype": dtype, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = _json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for blob in blobs:
            f.write(blob)
    return 8 + len(head) + offset


def _torch_to_np(v):
    """torch tensor -> numpy at NATIVE dtype, zero-copy where possible
    (fp16 ckpts stay fp16 until the loader's final cast — fp16->bf16
    directly equals fp16->f32->bf16, and halves host memory traffic);
    bf16 widened to f32."""
    import torch

    if not hasattr(v, "numpy"):
        return np.asarray(v)
    if v.dtype == torch.bfloat16:
        return v.float().numpy()
    return v.numpy()


def load_torch_file(path: str | Path) -> dict[str, np.ndarray]:
    """Load .pt/.safetensors into numpy, unwrapping DeepSpeed 'module' and
    Lightning 'state_dict' envelopes. Zero-copy (mmap-backed views) for
    both formats; values keep the checkpoint's dtype."""
    path = Path(path)
    if path.suffix == ".safetensors":
        return load_safetensors_views(path)
    import torch

    try:
        obj = torch.load(str(path), map_location="cpu", weights_only=False,
                         mmap=True)
    except (TypeError, RuntimeError):  # legacy (non-zip) serialization
        obj = torch.load(str(path), map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "module" in obj:
        obj = obj["module"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    # frozen submodules are saved with None values (reference freeze_model,
    # utils.py:256-266) — drop them so they can't shadow real weights when
    # dicts are merged (ControlDiffWarp base-then-override)
    return {k: _torch_to_np(v) for k, v in obj.items() if v is not None}


def _lin(sd, key):
    """torch Linear weight -> (in, out)."""
    return np.ascontiguousarray(sd[key].T)


def _sub(sd, prefix):
    n = len(prefix)
    sub = {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}
    if isinstance(sd, TrackedStateDict):
        child = TrackedStateDict(sub)
        child._parent, child._parent_prefix = sd, prefix
        return child
    return sub


# ---------------------------------------------------------------------------
# 1. Stage-1 LLM (Semantic1DLM safetensors; module names from
#    llm/models/lm_model.py + transformer.py + transformer_blocks.py)


def convert_llm(sd: dict[str, np.ndarray], num_layers: int) -> dict:
    blocks = []
    for i in range(num_layers):
        p = f"transformer.blocks.{i}."
        blocks.append({
            "wqkv": _lin(sd, p + "wqkv.weight"),
            "wo": _lin(sd, p + "wo.weight"),
            "norm0": sd[p + "norm0.weight"],
            "norm1": sd[p + "norm1.weight"],
            "w1": _lin(sd, p + "mlp.w1.weight"),
            "w2": _lin(sd, p + "mlp.w2.weight"),
            "w3": _lin(sd, p + "mlp.w3.weight"),
        })
    micro = {}
    for key in ("frames", "motion_score"):
        p = f"micro_condition.mlps.{key}."
        if p + "0.weight" in sd:
            micro[key] = {
                "fc0_w": _lin(sd, p + "0.weight"),
                "fc0_b": sd[p + "0.bias"],
                "fc1_w": _lin(sd, p + "2.weight"),
                "fc1_b": sd[p + "2.bias"],
            }
    return {
        "gpt": {
            "blocks": blocks,
            "ln_f": {"w": sd["transformer.layer_norm.weight"],
                     "b": sd["transformer.layer_norm.bias"]},
            "head": _lin(sd, "transformer.head.weight"),
        },
        "tok_emb": sd["visual_embedding_model.tok_emb_code.weight"],
        "text_proj": {
            "fc0_w": _lin(sd, "cond_model.embeddings.fc0.weight"),
            "fc0_b": sd["cond_model.embeddings.fc0.bias"],
            "fc1_w": _lin(sd, "cond_model.embeddings.fc1.weight"),
            "fc1_b": sd["cond_model.embeddings.fc1.bias"],
        },
        "null_text_embedding": sd["cond_model.null_text_embedding"],
        "micro": micro,
    }


# ---------------------------------------------------------------------------
# 2. Tokenizer (VideoVQ safetensors; tokenizer/modules/blocks.py names)


def _convert_titok_block(sd, prefix):
    return {
        "ln0_w": sd[prefix + "ln_1.weight"],
        "ln0_b": sd[prefix + "ln_1.bias"],
        "wq": _lin(sd, prefix + "attn.wq.weight"),
        "wk": _lin(sd, prefix + "attn.wk.weight"),
        "wv": _lin(sd, prefix + "attn.wv.weight"),
        "wo": _lin(sd, prefix + "attn.wo.weight"),
        "ln1_w": sd[prefix + "ln_2.weight"],
        "ln1_b": sd[prefix + "ln_2.bias"],
        "fc0_w": _lin(sd, prefix + "mlp.c_fc.weight"),
        "fc0_b": sd[prefix + "mlp.c_fc.bias"],
        "fc1_w": _lin(sd, prefix + "mlp.c_proj.weight"),
        "fc1_b": sd[prefix + "mlp.c_proj.bias"],
    }


def _count_layers(sd, pat):
    i = 0
    while any(k.startswith(pat.format(i)) for k in sd):
        i += 1
    return i


def convert_tokenizer(sd: dict[str, np.ndarray]) -> dict:
    n_enc = _count_layers(sd, "encoder.transformer.{}.")
    n_dec = _count_layers(sd, "decoder.transformer.{}.")
    # patch_embed conv2d 1x1 (C_out, C_in, 1, 1) -> per-token linear (in,out)
    pw = sd["encoder.patch_embed.weight"]
    enc = {
        "patch_w": np.ascontiguousarray(pw[:, :, 0, 0].T),
        "patch_b": sd["encoder.patch_embed.bias"],
        "iframe_latent": sd["encoder.IFrame_latent_tokens"],
        "pframe_latent": sd["encoder.PFrame_latent_tokens"],
        "ln_pre_w": sd["encoder.ln_pre.weight"],
        "ln_pre_b": sd["encoder.ln_pre.bias"],
        "blocks": [_convert_titok_block(sd, f"encoder.transformer.{i}.")
                   for i in range(n_enc)],
        "ln_post_w": sd["encoder.ln_post.weight"],
        "ln_post_b": sd["encoder.ln_post.bias"],
        "proj_w": _lin(sd, "encoder.proj_out.weight"),
        "proj_b": sd["encoder.proj_out.bias"],
    }
    dec = {
        "embed_w": _lin(sd, "decoder.decoder_embed.weight"),
        "embed_b": sd["decoder.decoder_embed.bias"],
        "mask_token": sd["decoder.mask_token"].reshape(-1),
        "ln_pre_w": sd["decoder.ln_pre.weight"],
        "ln_pre_b": sd["decoder.ln_pre.bias"],
        "blocks": [_convert_titok_block(sd, f"decoder.transformer.{i}.")
                   for i in range(n_dec)],
        "ln_post_w": sd["decoder.ln_post.weight"],
        "ln_post_b": sd["decoder.ln_post.bias"],
        "ffn0_w": _lin(sd, "decoder.ffn.0.weight"),
        "ffn0_b": sd["decoder.ffn.0.bias"],
        "ffn1_w": _lin(sd, "decoder.ffn.2.weight"),
        "ffn1_b": sd["decoder.ffn.2.bias"],
    }
    # vector-quantize-pytorch VectorQuantize
    codebook = sd.get("quantizer._codebook.embed",
                      sd.get("quantizer.codebook"))
    if codebook is not None and codebook.ndim == 3:
        codebook = codebook[0]
    quant = {
        "in_w": _lin(sd, "quantizer.project_in.weight"),
        "in_b": sd["quantizer.project_in.bias"],
        "out_w": _lin(sd, "quantizer.project_out.weight"),
        "out_b": sd["quantizer.project_out.bias"],
        "codebook": codebook,
    }
    out = {"encoder": enc, "decoder": dec, "quant": quant}
    if "mean" in sd:
        out["mean"] = sd["mean"]
        out["std"] = sd["std"]
    return out


# ---------------------------------------------------------------------------
# 3. DiT (SAT mp_rank_00_model_states.pt; sat module names, see
#    dit_video_concat.py mixin construction)


def convert_dit(sd: dict[str, np.ndarray], num_layers: int,
                control: bool = False) -> dict:
    layers = []
    for i in range(num_layers):
        lp = f"transformer.layers.{i}."
        ap = "mixins.adaln_layer."
        layer = {
            "adaln_w": _lin(sd, ap + f"adaLN_modulations.{i}.1.weight"),
            "adaln_b": sd[ap + f"adaLN_modulations.{i}.1.bias"],
            "ln1_w": sd[lp + "input_layernorm.weight"],
            "ln1_b": sd[lp + "input_layernorm.bias"],
            "qkv_w": _lin(sd, lp + "attention.query_key_value.weight"),
            "qkv_b": sd[lp + "attention.query_key_value.bias"],
            "attn_out_w": _lin(sd, lp + "attention.dense.weight"),
            "attn_out_b": sd[lp + "attention.dense.bias"],
            "ln2_w": sd[lp + "post_attention_layernorm.weight"],
            "ln2_b": sd[lp + "post_attention_layernorm.bias"],
            "mlp0_w": _lin(sd, lp + "mlp.dense_h_to_4h.weight"),
            "mlp0_b": sd[lp + "mlp.dense_h_to_4h.bias"],
            "mlp1_w": _lin(sd, lp + "mlp.dense_4h_to_h.weight"),
            "mlp1_b": sd[lp + "mlp.dense_4h_to_h.bias"],
        }
        if ap + f"query_layernorm_list.{i}.weight" in sd:
            layer.update({
                "q_ln_w": sd[ap + f"query_layernorm_list.{i}.weight"],
                "q_ln_b": sd[ap + f"query_layernorm_list.{i}.bias"],
                "k_ln_w": sd[ap + f"key_layernorm_list.{i}.weight"],
                "k_ln_b": sd[ap + f"key_layernorm_list.{i}.bias"],
            })
        if control:
            layer["zero_linear_w"] = _lin(
                sd, ap + f"zero_linears.{i}.weight")
        layers.append(layer)

    pw = sd["mixins.patch_embed.proj.weight"]  # (D, C, p, p)
    out = {
        "patch_w": np.ascontiguousarray(pw.transpose(2, 3, 1, 0)),
        "patch_b": sd["mixins.patch_embed.proj.bias"],
        "text_proj_w": _lin(sd, "mixins.patch_embed.text_proj.weight"),
        "text_proj_b": sd["mixins.patch_embed.text_proj.bias"],
        "time_mlp": {
            "fc0_w": _lin(sd, "time_embed.0.weight"),
            "fc0_b": sd["time_embed.0.bias"],
            "fc1_w": _lin(sd, "time_embed.2.weight"),
            "fc1_b": sd["time_embed.2.bias"],
        },
        "layers": layers,
        "final_ln_w": sd["transformer.final_layernorm.weight"],
        "final_ln_b": sd["transformer.final_layernorm.bias"],
    }
    # the control net has EmptyFinalLayerMixin — any final_layer keys in the
    # (base) state dict are ignored, as SAT's strict=False load does
    if not control and "mixins.final_layer.norm_final.weight" in sd:
        out["final"] = {
            "norm_w": sd["mixins.final_layer.norm_final.weight"],
            "norm_b": sd["mixins.final_layer.norm_final.bias"],
            "adaln_w": _lin(sd, "mixins.final_layer.adaLN_modulation.1.weight"),
            "adaln_b": sd["mixins.final_layer.adaLN_modulation.1.bias"],
            "linear_w": _lin(sd, "mixins.final_layer.linear.weight"),
            "linear_b": sd["mixins.final_layer.linear.bias"],
        }
    return out


# ---------------------------------------------------------------------------
# 4. Semantic conditioner (control_model.semantic_conditioner.*)


def _conv2d(sd, key):
    """(O, I, kh, kw) -> HWIO."""
    return np.ascontiguousarray(sd[key].transpose(2, 3, 1, 0))


def _vq_resblock(sd, prefix):
    p = {
        "norm1_w": sd[prefix + "norm1.weight"],
        "norm1_b": sd[prefix + "norm1.bias"],
        "conv1_w": _conv2d(sd, prefix + "conv1.weight"),
        "conv1_b": sd[prefix + "conv1.bias"],
        "norm2_w": sd[prefix + "norm2.weight"],
        "norm2_b": sd[prefix + "norm2.bias"],
        "conv2_w": _conv2d(sd, prefix + "conv2.weight"),
        "conv2_b": sd[prefix + "conv2.bias"],
    }
    if prefix + "nin_shortcut.weight" in sd:
        p["nin_w"] = _conv2d(sd, prefix + "nin_shortcut.weight")
        p["nin_b"] = sd[prefix + "nin_shortcut.bias"]
    return p


def convert_semantic_cond(sd: dict[str, np.ndarray],
                          num_res_blocks: int = 4) -> dict:
    """sd scoped to semantic_conditioner.* (strip the prefix first).
    The inner VideoVQ lives at semantic_model.model.*"""
    vq = convert_tokenizer(_sub(sd, "semantic_model.model."))
    up = "upsample_model."
    upsampler = {
        "conv_in_w": _conv2d(sd, up + "conv_in.weight"),
        "conv_in_b": sd[up + "conv_in.bias"],
        "mid1": _vq_resblock(sd, up + "mid.block_1."),
        "mid2": _vq_resblock(sd, up + "mid.block_2."),
        "up1": [_vq_resblock(sd, up + f"up.1.block.{i}.")
                for i in range(num_res_blocks + 1)],
        "up1_conv_w": _conv2d(sd, up + "up.1.upsample.conv.weight"),
        "up1_conv_b": sd[up + "up.1.upsample.conv.bias"],
        "up0": [_vq_resblock(sd, up + f"up.0.block.{i}.")
                for i in range(num_res_blocks + 1)],
        "norm_out_w": sd[up + "norm_out.weight"],
        "norm_out_b": sd[up + "norm_out.bias"],
        "conv_out_w": _conv2d(sd, up + "conv_out.weight"),
        "conv_out_b": sd[up + "conv_out.bias"],
    }
    return {
        "vq": vq,
        "upsampler": upsampler,
        "conv_out_w": _conv2d(sd, "conv_out.weight"),
        "conv_out_b": sd["conv_out.bias"],
    }


# ---------------------------------------------------------------------------
# 5. VAE (3d-vae.pt["state_dict"]; vae_modules/cp_enc_dec.py names)


def _conv3d(sd, key):
    """(O, I, kt, kh, kw) -> DHWIO."""
    return np.ascontiguousarray(sd[key].transpose(2, 3, 4, 1, 0))


def _causal(sd, prefix):
    return {"w": _conv3d(sd, prefix + "conv.weight"),
            "b": sd[prefix + "conv.bias"]}


def _vae_norm(sd, prefix, spatial: bool):
    if not spatial:
        return {"norm_w": sd[prefix + "weight"],
                "norm_b": sd[prefix + "bias"]}
    return {
        "norm_w": sd[prefix + "norm_layer.weight"],
        "norm_b": sd[prefix + "norm_layer.bias"],
        "conv_y": _causal(sd, prefix + "conv_y."),
        "conv_b": _causal(sd, prefix + "conv_b."),
    }


def _vae_resblock(sd, prefix, spatial: bool):
    p = {
        "norm1": _vae_norm(sd, prefix + "norm1.", spatial),
        "conv1": _causal(sd, prefix + "conv1."),
        "norm2": _vae_norm(sd, prefix + "norm2.", spatial),
        "conv2": _causal(sd, prefix + "conv2."),
    }
    if prefix + "nin_shortcut.weight" in sd:
        w = sd[prefix + "nin_shortcut.weight"]  # Conv3d 1x1x1 (O,I,1,1,1)
        p["nin_w"] = np.ascontiguousarray(w[:, :, 0, 0, 0].T)
        p["nin_b"] = sd[prefix + "nin_shortcut.bias"]
    return p


def convert_vae(sd: dict[str, np.ndarray], num_res_blocks: int = 3,
                num_levels: int = 4) -> dict:
    enc = {
        "conv_in": _causal(sd, "encoder.conv_in."),
        "down": [],
        "mid1": _vae_resblock(sd, "encoder.mid.block_1.", False),
        "mid2": _vae_resblock(sd, "encoder.mid.block_2.", False),
        "norm_out_w": sd["encoder.norm_out.weight"],
        "norm_out_b": sd["encoder.norm_out.bias"],
        "conv_out": _causal(sd, "encoder.conv_out."),
    }
    for i in range(num_levels):
        level = {"blocks": [
            _vae_resblock(sd, f"encoder.down.{i}.block.{j}.", False)
            for j in range(num_res_blocks)]}
        if f"encoder.down.{i}.downsample.conv.weight" in sd:
            level["down"] = {
                "conv_w": _conv2d(sd, f"encoder.down.{i}.downsample.conv.weight"),
                "conv_b": sd[f"encoder.down.{i}.downsample.conv.bias"],
            }
        enc["down"].append(level)
    dec = {
        "conv_in": _causal(sd, "decoder.conv_in."),
        "mid1": _vae_resblock(sd, "decoder.mid.block_1.", True),
        "mid2": _vae_resblock(sd, "decoder.mid.block_2.", True),
        "up": [],
        "norm_out": _vae_norm(sd, "decoder.norm_out.", True),
        "conv_out": _causal(sd, "decoder.conv_out."),
    }
    for i in range(num_levels):
        level = {"blocks": [
            _vae_resblock(sd, f"decoder.up.{i}.block.{j}.", True)
            for j in range(num_res_blocks + 1)]}
        if f"decoder.up.{i}.upsample.conv.weight" in sd:
            level["up"] = {
                "conv_w": _conv2d(sd, f"decoder.up.{i}.upsample.conv.weight"),
                "conv_b": sd[f"decoder.up.{i}.upsample.conv.bias"],
            }
        dec["up"].append(level)
    return {"encoder": enc, "decoder": dec}


# ---------------------------------------------------------------------------
# 6. Theia ViT (HF DeiT/ViTModel state dict, possibly under backbone.model.)


def convert_theia(sd: dict[str, np.ndarray], num_layers: int = 12) -> dict:
    for pre in ("backbone.model.", "model.backbone.model.", ""):
        if pre + "embeddings.position_embeddings" in sd:
            sd = _sub(sd, pre)
            break
    blocks = []
    for i in range(num_layers):
        p = f"encoder.layer.{i}."
        blocks.append({
            "ln0_w": sd[p + "layernorm_before.weight"],
            "ln0_b": sd[p + "layernorm_before.bias"],
            "q_w": _lin(sd, p + "attention.attention.query.weight"),
            "q_b": sd[p + "attention.attention.query.bias"],
            "k_w": _lin(sd, p + "attention.attention.key.weight"),
            "k_b": sd[p + "attention.attention.key.bias"],
            "v_w": _lin(sd, p + "attention.attention.value.weight"),
            "v_b": sd[p + "attention.attention.value.bias"],
            "o_w": _lin(sd, p + "attention.output.dense.weight"),
            "o_b": sd[p + "attention.output.dense.bias"],
            "ln1_w": sd[p + "layernorm_after.weight"],
            "ln1_b": sd[p + "layernorm_after.bias"],
            "fc0_w": _lin(sd, p + "intermediate.dense.weight"),
            "fc0_b": sd[p + "intermediate.dense.bias"],
            "fc1_w": _lin(sd, p + "output.dense.weight"),
            "fc1_b": sd[p + "output.dense.bias"],
        })
    out = {
        "patch_w": _conv2d(sd, "embeddings.patch_embeddings.projection.weight"),
        "patch_b": sd["embeddings.patch_embeddings.projection.bias"],
        "pos": sd["embeddings.position_embeddings"][0],
        "blocks": blocks,
        "ln_f_w": sd["layernorm.weight"],
        "ln_f_b": sd["layernorm.bias"],
    }
    # DeiTNoCLS has no cls_token (theia_model.py:79-92); DeiTReg adds
    # register tokens + their pos embed (theia_model.py:199-227)
    if "embeddings.cls_token" in sd:
        out["cls"] = sd["embeddings.cls_token"].reshape(-1)
    if "embeddings.reg_token" in sd:
        out["reg_token"] = sd["embeddings.reg_token"][0]
        out["reg_pos"] = sd["embeddings.reg_pos_embed"][0]
    return out


# ---------------------------------------------------------------------------
# engine-checkpoint splitter


def split_engine_state(sd: dict[str, np.ndarray]):
    """Split a SATControlVideoDiffusionEngine checkpoint into per-model flat
    dicts: main DiT, control DiT, semantic conditioner, VAE, T5."""
    return {
        "main": _sub(sd, "model.diffusion_model.main_model."),
        "control": _sub(sd, "model.diffusion_model.control_model."),
        "semantic": _sub(sd, "model.diffusion_model.control_model."
                             "semantic_conditioner."),
        "vae": _sub(sd, "first_stage_model."),
        "t5": _sub(sd, "conditioner.embedders.0.transformer."),
    }


# ---------------------------------------------------------------------------
# consumed-key tracking + verify mode


class TrackedStateDict(dict):
    """State dict that records which keys a conversion actually touched —
    the unconsumed remainder is the cheap canary for layout drift."""

    def __init__(self, sd):
        super().__init__(sd)
        self.consumed: set[str] = set()
        self._parent = None          # set by _sub for prefixed views
        self._parent_prefix = ""

    def _mark(self, k):
        self.consumed.add(k)
        if self._parent is not None:
            self._parent._mark(self._parent_prefix + k)

    def __getitem__(self, k):
        self._mark(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        if super().__contains__(k):
            self._mark(k)
        return super().get(k, default)

    @property
    def unconsumed(self) -> set[str]:
        return set(self.keys()) - self.consumed


def convert_tracked(fn, sd, *args, **kwargs):
    """Run a convert_* function on a TrackedStateDict; returns
    (tree, unconsumed_keys)."""
    tsd = TrackedStateDict(sd)
    tree = fn(tsd, *args, **kwargs)
    return tree, tsd.unconsumed


def verify_ckpt_tree(ckpt_dir, cfg=None, *, torch_block_check: bool = True):
    """`--verify` mode: for every real checkpoint file present under
    ckpt_dir, convert with key tracking and report missing/unconsumed keys
    against the manifests; validate the frozen SAT pos_embedding against
    our recomputed 3-D sincos table; optionally round-trip one DiT AdaLN
    layer through a torch transcription with the REAL weights.

    Returns a report dict; raises nothing (all findings are reported)."""
    from landiff_tpu_torch.ckpt import manifests
    from landiff_tpu_torch.config import LanDiffConfig

    cfg = cfg or LanDiffConfig()
    ckpt_dir = Path(ckpt_dir)
    report = {}

    def check(name, path, convert_fn, manifest, ignored=()):
        if not path.exists():
            report[name] = {"status": "absent"}
            return None
        sd = load_torch_file(path)
        missing_from_file = sorted(set(manifest) - set(sd))
        extra_in_file = sorted(set(sd) - set(manifest))
        shape_mismatch = sorted(
            k for k in set(manifest) & set(sd)
            if tuple(np.asarray(sd[k]).shape) != tuple(manifest[k]))
        try:
            tree, unconsumed = convert_tracked(convert_fn, sd)
            err = None
        except KeyError as e:
            tree, unconsumed, err = None, set(), f"missing key: {e}"
        bad_unconsumed = sorted(
            k for k in unconsumed
            if not any(k.startswith(i) or i in k for i in ignored))
        report[name] = {
            "status": "error" if err else "ok",
            "error": err,
            "missing_vs_manifest": missing_from_file,
            "extra_vs_manifest": extra_in_file,
            "shape_mismatch": shape_mismatch,
            "unconsumed_unexpected": bad_unconsumed,
        }
        return sd if tree is not None else None

    check("llm", ckpt_dir / "llm" / "model.safetensors",
          lambda sd: convert_llm(sd, cfg.llm.num_layers),
          manifests.llm_safetensors(cfg.llm, t5_dim=cfg.t5.d_model))
    check("tokenizer", ckpt_dir / "tokenizer" / "model.safetensors",
          convert_tokenizer, manifests.tokenizer_safetensors(cfg.tokenizer),
          ignored=manifests.TOKENIZER_IGNORED)

    base_path = (ckpt_dir / "CogVideoX-2b-sat" / "transformer" / "1000"
                 / "mp_rank_00_model_states.pt")
    base_sd = None
    if base_path.exists():
        raw = load_torch_file(base_path)
        base_sd = {k[6:]: v for k, v in raw.items()
                   if k.startswith("model.")}
        # guard like check(): --verify must REPORT layout drift (missing
        # keys raise KeyError inside the converter), not crash on it
        try:
            tree, unconsumed = convert_tracked(
                lambda sd: convert_dit(sd, cfg.dit.num_layers), base_sd)
            bad = sorted(k for k in unconsumed
                         if not any(k.startswith(i) for i in
                                    manifests.DIT_IGNORED))
            entry = {"status": "ok", "unconsumed_unexpected": bad}
        except KeyError as e:
            tree = None
            entry = {"status": "error", "missing_key": str(e)}
        if tree is not None:
            # validate our recomputed sincos table vs the frozen parameter
            if "mixins.pos_embed.pos_embedding" in base_sd:
                from landiff_tpu_torch.models import dit as dit_lib

                theirs = np.asarray(
                    base_sd["mixins.pos_embed.pos_embedding"])[0]
                ours = dit_lib.pos_embed_table(cfg.dit)
                n = min(len(theirs), len(ours))
                entry["pos_embed_max_abs_diff"] = float(
                    np.abs(theirs[:n] - ours[:n]).max())
            if torch_block_check:
                # JAX holds layer 0 to a SAT-layer transcription kept in
                # its tests; the port keeps no copy of it (its DiT layer is
                # held to JAX's by tests/test_torch_port_dit.py)
                entry["layer0_torch_parity"] = (
                    "skipped (the SAT-layer transcription is test code of "
                    "the JAX package)")
        else:
            base_sd = None
        report["dit_base"] = entry
    else:
        report["dit_base"] = {"status": "absent"}

    eng_path = ckpt_dir / "diffusion" / "1" / "mp_rank_00_model_states.pt"
    if eng_path.exists():
        sd = load_torch_file(eng_path)
        manifest = manifests.engine_ckpt(cfg)
        report["engine"] = {
            "status": "ok",
            "missing_vs_manifest": sorted(set(manifest) - set(sd)),
            "extra_vs_manifest": sorted(set(sd) - set(manifest)),
        }
    else:
        report["engine"] = {"status": "absent"}

    check("vae", ckpt_dir / "CogVideoX-2b-sat" / "vae" / "3d-vae.pt",
          lambda sd: convert_vae(sd, cfg.vae.num_res_blocks,
                                 len(cfg.vae.ch_mult)),
          manifests.vae_state_dict(cfg.vae), ignored=("loss.",))
    return report


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description="LanDiff ckpt converter")
    ap.add_argument("--verify", metavar="CKPT_DIR",
                    help="verify a real ckpt tree against the manifests")
    ap.add_argument("--no-torch-check", action="store_true")
    args = ap.parse_args(argv)
    if args.verify:
        report = verify_ckpt_tree(
            args.verify, torch_block_check=not args.no_torch_check)
        print(json.dumps(report, indent=2))
        bad = [k for k, v in report.items()
               if v.get("status") == "error"
               or v.get("unconsumed_unexpected")
               or v.get("missing_vs_manifest")
               or v.get("shape_mismatch")]
        return 1 if bad else 0
    ap.print_help()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
