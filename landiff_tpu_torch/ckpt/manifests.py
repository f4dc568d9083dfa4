"""Exact state-dict key/shape inventories for the reference checkpoints
(the port's own copy of landiff_tpu/ckpt/manifests.py, on the port's
config), transcribed from the reference module definitions (not from real files —
the weights are not available offline). These pin the converter against
layout drift: a conversion that misses a manifest key, or leaves one
unconsumed that isn't in the documented ignore set, is a bug.

Sources (reference file:line):
  llm:       llm/models/lm_model.py:18-100, transformer.py:18-42,
             transformer_blocks.py:91-126, 226-236, conditioner.py:17-228,
             tokenizer.py:10-25; llm_cfg.py:18-81 for dims. Frozen T5 /
             tokenizer erased by freeze_model (utils.py:220-275); the
             single_int_tensor_* buffers are persistent=False.
  tokenizer: tokenizer/modules/blocks.py:340-812 (TiTokEncoder/Decoder,
             ROPE_3D + temporal>1 -> no learned pos embeds, no cls),
             video_titok_vq.py:50-68 (mean/std buffers),
             vector-quantize-pytorch==1.19.2 VectorQuantize/
             EuclideanCodebook (project_in/out + _codebook buffers).
  dit:       dit_video_concat.py:670-909 (+SAT 0.4.12 BaseTransformer
             naming), mixin registration :796-875; reinit DELETES
             transformer.word_embeddings (:68) and position_embeddings
             (:234); Basic3DPositionEmbeddingMixin keeps a frozen
             pos_embedding Parameter (:219-223); configs yaml for dims.
  vae:       vae_modules/cp_enc_dec.py:683-1072 (causal convs wrap .conv,
             decoder norms are SpatialNorm3D with norm_layer/conv_y/conv_b).
  semantic:  semantic_models/condition.py:30-137, vq_warp.py:17-57 (inner
             VideoVQ frozen with disable_state_dict=False -> KEPT in the
             engine ckpt), vq_gan_blocks.py:41-66, 480-606 + configs yaml
             (z 768, ch 512, ch_mult [.25, 1], nrb 4, pixelshuffle).
"""

from __future__ import annotations

from landiff_tpu_torch.config import (DiTConfig, LanDiffConfig, LLMConfig,
                                SemanticCondConfig, TheiaConfig,
                                TokenizerConfig, VAEConfig)

MICRO_HIDDEN = 512  # MicroConditioner hidden_dim default (conditioner.py:23)


def llm_safetensors(cfg: LLMConfig, t5_dim: int = 4096) -> dict[str, tuple]:
    D, M, V = cfg.hidden_size, cfg.mlp_hidden, cfg.vocab_size
    out = {}
    for i in range(cfg.num_layers):
        p = f"transformer.blocks.{i}."
        out[p + "wqkv.weight"] = (3 * D, D)       # attn_bias=False
        out[p + "wo.weight"] = (D, D)
        out[p + "norm0.weight"] = (D,)            # RMSNorm: weight only
        out[p + "norm1.weight"] = (D,)
        out[p + "mlp.w1.weight"] = (M, D)         # LlamaMLP2 bias=False
        out[p + "mlp.w2.weight"] = (D, M)
        out[p + "mlp.w3.weight"] = (M, D)
    out["transformer.layer_norm.weight"] = (D,)
    out["transformer.layer_norm.bias"] = (D,)
    out["transformer.head.weight"] = (V, D)       # bias=False
    out["visual_embedding_model.tok_emb_code.weight"] = (V, D)
    out["cond_model.embeddings.fc0.weight"] = (D, t5_dim)
    out["cond_model.embeddings.fc0.bias"] = (D,)
    out["cond_model.embeddings.fc1.weight"] = (D, D)
    out["cond_model.embeddings.fc1.bias"] = (D,)
    out["cond_model.null_text_embedding"] = (D,)
    for key in sorted(cfg.micro_cond_keys):
        p = f"micro_condition.mlps.{key}."
        out[p + "0.weight"] = (MICRO_HIDDEN, cfg.micro_cond_embed_dim)
        out[p + "0.bias"] = (MICRO_HIDDEN,)
        out[p + "2.weight"] = (D, MICRO_HIDDEN)
        out[p + "2.bias"] = (D,)
    return out


def _titok_block(prefix: str, W: int) -> dict[str, tuple]:
    return {
        prefix + "ln_1.weight": (W,), prefix + "ln_1.bias": (W,),
        prefix + "attn.wq.weight": (W, W),       # bias=False (cfg:51,78)
        prefix + "attn.wk.weight": (W, W),
        prefix + "attn.wv.weight": (W, W),
        prefix + "attn.wo.weight": (W, W),
        prefix + "ln_2.weight": (W,), prefix + "ln_2.bias": (W,),
        prefix + "mlp.c_fc.weight": (4 * W, W),
        prefix + "mlp.c_fc.bias": (4 * W,),
        prefix + "mlp.c_proj.weight": (W, 4 * W),
        prefix + "mlp.c_proj.bias": (W,),
    }


def theia_hf_safetensors(cfg: TheiaConfig,
                         prefix: str = "backbone.model.") -> dict[str, tuple]:
    """The Theia backbone's HF DeiT / ViTModel keys (theia_model.py
    DeiT :357-452 wraps a ViTModel as backbone.model), the ones
    convert.convert_theia reads: CLS variant, no register tokens."""
    D, P = cfg.hidden_size, cfg.patch_size
    M = int(D * cfg.mlp_ratio)
    G = (cfg.image_size // P) ** 2
    e = prefix + "embeddings."
    out = {e + "patch_embeddings.projection.weight": (D, 3, P, P),
           e + "patch_embeddings.projection.bias": (D,),
           e + "position_embeddings": (1, 1 + G, D),
           e + "cls_token": (1, 1, D),
           prefix + "layernorm.weight": (D,),
           prefix + "layernorm.bias": (D,)}
    for i in range(cfg.num_layers):
        p = f"{prefix}encoder.layer.{i}."
        for name in ("layernorm_before", "layernorm_after"):
            out[p + name + ".weight"] = (D,)
            out[p + name + ".bias"] = (D,)
        for name in ("query", "key", "value"):
            out[p + f"attention.attention.{name}.weight"] = (D, D)
            out[p + f"attention.attention.{name}.bias"] = (D,)
        out[p + "attention.output.dense.weight"] = (D, D)
        out[p + "attention.output.dense.bias"] = (D,)
        out[p + "intermediate.dense.weight"] = (M, D)
        out[p + "intermediate.dense.bias"] = (M,)
        out[p + "output.dense.weight"] = (D, M)
        out[p + "output.dense.bias"] = (D,)
    return out


def tokenizer_safetensors(cfg: TokenizerConfig) -> dict[str, tuple]:
    t = cfg.titok
    W, TS, C = t.width, t.token_size, cfg.feature_dim
    K, cd = cfg.vq.codebook_size, cfg.vq.codebook_dim
    out = {
        "encoder.patch_embed.weight": (W, C, 1, 1),  # patch size 1
        "encoder.patch_embed.bias": (W,),
        "encoder.IFrame_latent_tokens": (t.iframe_latent_tokens, W),
        "encoder.ln_pre.weight": (W,), "encoder.ln_pre.bias": (W,),
        "encoder.ln_post.weight": (W,), "encoder.ln_post.bias": (W,),
        "encoder.proj_out.weight": (TS, W), "encoder.proj_out.bias": (TS,),
        "decoder.decoder_embed.weight": (W, TS),
        "decoder.decoder_embed.bias": (W,),
        "decoder.mask_token": (1, 1, W),
        "decoder.ln_pre.weight": (W,), "decoder.ln_pre.bias": (W,),
        "decoder.ln_post.weight": (W,), "decoder.ln_post.bias": (W,),
        "decoder.ffn.0.weight": (2 * W, W), "decoder.ffn.0.bias": (2 * W,),
        "decoder.ffn.2.weight": (C, 2 * W), "decoder.ffn.2.bias": (C,),
        "quantizer.project_in.weight": (cd, TS),
        "quantizer.project_in.bias": (cd,),
        "quantizer.project_out.weight": (TS, cd),
        "quantizer.project_out.bias": (TS,),
        "quantizer._codebook.embed": (1, K, cd),
        # EMA bookkeeping buffers — present in the file, not used at
        # inference (vq-pytorch EuclideanCodebook)
        "quantizer._codebook.initted": (1,),
        "quantizer._codebook.cluster_size": (1, K),
        "quantizer._codebook.embed_avg": (1, K, cd),
        "mean": (C,), "std": (C,),
    }
    if t.temporal_size > 1:
        out["encoder.PFrame_latent_tokens"] = (t.pframe_latent_tokens, W)
    for i in range(t.num_layers):
        out.update(_titok_block(f"encoder.transformer.{i}.", W))
        out.update(_titok_block(f"decoder.transformer.{i}.", W))
    return out


TOKENIZER_IGNORED = (
    # EMA buffers consumed by training-resume only, ignored by conversion
    "quantizer._codebook.initted",
    "quantizer._codebook.cluster_size",
    "quantizer._codebook.embed_avg",
)


def dit_sat(cfg: DiTConfig, *, control: bool = False,
            with_final: bool = True) -> dict[str, tuple]:
    """Keys of a (Control)DiffusionTransformer state dict AFTER the
    'model.' prefix strip (dit_video_concat.py:1178-1182). The control net
    swaps FinalLayerMixin for EmptyFinalLayerMixin (no params) and its
    adaln mixin (ControlOutAdaLNMixin) adds bias-free zero_linears."""
    D, TE = cfg.hidden_size, cfg.time_embed_dim
    n = cfg.control_layers if control else cfg.num_layers
    hp = cfg.latent_height // cfg.patch_size
    wp = cfg.latent_width // cfg.patch_size
    num_patches = cfg.latent_frames * hp * wp
    out = {
        "mixins.pos_embed.pos_embedding":
            (1, cfg.text_length + num_patches, D),
        "mixins.patch_embed.proj.weight":
            (D, cfg.in_channels, cfg.patch_size, cfg.patch_size),
        "mixins.patch_embed.proj.bias": (D,),
        "mixins.patch_embed.text_proj.weight": (D, cfg.text_dim),
        "mixins.patch_embed.text_proj.bias": (D,),
        "time_embed.0.weight": (TE, D), "time_embed.0.bias": (TE,),
        "time_embed.2.weight": (TE, TE), "time_embed.2.bias": (TE,),
        "transformer.final_layernorm.weight": (D,),
        "transformer.final_layernorm.bias": (D,),
    }
    for i in range(n):
        lp = f"transformer.layers.{i}."
        ap = "mixins.adaln_layer."
        out[ap + f"adaLN_modulations.{i}.1.weight"] = (12 * D, TE)
        out[ap + f"adaLN_modulations.{i}.1.bias"] = (12 * D,)
        if cfg.qk_ln:
            out[ap + f"query_layernorm_list.{i}.weight"] = (cfg.head_dim,)
            out[ap + f"query_layernorm_list.{i}.bias"] = (cfg.head_dim,)
            out[ap + f"key_layernorm_list.{i}.weight"] = (cfg.head_dim,)
            out[ap + f"key_layernorm_list.{i}.bias"] = (cfg.head_dim,)
        if control:
            out[ap + f"zero_linears.{i}.weight"] = (D, D)
        out[lp + "input_layernorm.weight"] = (D,)
        out[lp + "input_layernorm.bias"] = (D,)
        out[lp + "attention.query_key_value.weight"] = (3 * D, D)
        out[lp + "attention.query_key_value.bias"] = (3 * D,)
        out[lp + "attention.dense.weight"] = (D, D)
        out[lp + "attention.dense.bias"] = (D,)
        out[lp + "post_attention_layernorm.weight"] = (D,)
        out[lp + "post_attention_layernorm.bias"] = (D,)
        out[lp + "mlp.dense_h_to_4h.weight"] = (4 * D, D)
        out[lp + "mlp.dense_h_to_4h.bias"] = (4 * D,)
        out[lp + "mlp.dense_4h_to_h.weight"] = (D, 4 * D)
        out[lp + "mlp.dense_4h_to_h.bias"] = (D,)
    if with_final and not control:
        pp = cfg.patch_size ** 2 * cfg.out_channels
        out.update({
            "mixins.final_layer.norm_final.weight": (D,),
            "mixins.final_layer.norm_final.bias": (D,),
            "mixins.final_layer.linear.weight": (pp, D),
            "mixins.final_layer.linear.bias": (pp,),
            "mixins.final_layer.adaLN_modulation.1.weight": (2 * D, TE),
            "mixins.final_layer.adaLN_modulation.1.bias": (2 * D,),
        })
    return out


# The converter computes the 3-D sincos table itself; the frozen parameter
# in the file is validated (not consumed) — see convert.verify_ckpt_tree.
DIT_IGNORED = ("mixins.pos_embed.pos_embedding",)


def _vq_resblock(prefix: str, cin: int, cout: int) -> dict[str, tuple]:
    out = {
        prefix + "norm1.weight": (cin,), prefix + "norm1.bias": (cin,),
        prefix + "conv1.weight": (cout, cin, 3, 3),
        prefix + "conv1.bias": (cout,),
        prefix + "norm2.weight": (cout,), prefix + "norm2.bias": (cout,),
        prefix + "conv2.weight": (cout, cout, 3, 3),
        prefix + "conv2.bias": (cout,),
    }
    if cin != cout:
        out[prefix + "nin_shortcut.weight"] = (cout, cin, 1, 1)
        out[prefix + "nin_shortcut.bias"] = (cout,)
    return out


def semantic_conditioner(cfg: SemanticCondConfig,
                         tok: TokenizerConfig) -> dict[str, tuple]:
    """Keys under control_model.semantic_conditioner. (condition.py:30-137;
    upsampler per the yaml: Decoder z=768 ch=512 ch_mult [.25,1] nrb=4
    out_ch=64 pixelshuffle, no mid attention)."""
    z, ch = tok.feature_dim, cfg.upsample_ch
    lo = int(ch * cfg.ch_mult[0])
    nrb = cfg.num_res_blocks
    out = {f"semantic_model.model.{k}": v
           for k, v in tokenizer_safetensors(tok).items()}
    up = "upsample_model."
    out.update({
        up + "conv_in.weight": (ch, z, 3, 3), up + "conv_in.bias": (ch,),
        up + "norm_out.weight": (lo,), up + "norm_out.bias": (lo,),
        up + "conv_out.weight": (cfg.up_out_channels, lo, 3, 3),
        up + "conv_out.bias": (cfg.up_out_channels,),
        # pixelshuffle Upsample: conv in//4 -> in (vq_gan_blocks.py:55-57)
        up + "up.1.upsample.conv.weight": (ch, ch // 4, 3, 3),
        up + "up.1.upsample.conv.bias": (ch,),
    })
    out.update(_vq_resblock(up + "mid.block_1.", ch, ch))
    out.update(_vq_resblock(up + "mid.block_2.", ch, ch))
    for j in range(nrb + 1):
        out.update(_vq_resblock(up + f"up.1.block.{j}.", ch, ch))
    for j in range(nrb + 1):
        out.update(_vq_resblock(up + f"up.0.block.{j}.",
                                ch if j == 0 else lo, lo))
    out.update({
        "conv_out.weight": (cfg.out_channels, cfg.up_out_channels, 3, 3),
        "conv_out.bias": (cfg.out_channels,),
    })
    return out


def engine_ckpt(cfg: LanDiffConfig) -> dict[str, tuple]:
    """Keys of the LanDiff diffusion mp_rank ckpt ['module'] that carry
    real tensors. Frozen parts (main_model, first_stage_model, T5
    conditioner) are saved as None by freeze_model (utils.py:256-266) and
    dropped by load_torch_file."""
    import dataclasses

    ctrl = dataclasses.replace(cfg.dit, num_layers=cfg.dit.control_layers)
    pre = "model.diffusion_model.control_model."
    out = {pre + k: v
           for k, v in dit_sat(ctrl, control=True).items()}
    out.update({pre + "semantic_conditioner." + k: v
                for k, v in semantic_conditioner(cfg.semantic_cond,
                                                 cfg.tokenizer).items()})
    return out


def _causal(prefix: str, cin: int, cout: int, k: int = 3) -> dict[str, tuple]:
    return {prefix + "conv.weight": (cout, cin, k, k, k),
            prefix + "conv.bias": (cout,)}


def _vae_norm(prefix: str, c: int, zq: int | None) -> dict[str, tuple]:
    if zq is None:
        return {prefix + "weight": (c,), prefix + "bias": (c,)}
    out = {prefix + "norm_layer.weight": (c,),
           prefix + "norm_layer.bias": (c,)}
    out.update(_causal(prefix + "conv_y.", zq, c, 1))
    out.update(_causal(prefix + "conv_b.", zq, c, 1))
    return out


def _vae_resblock(prefix: str, cin: int, cout: int,
                  zq: int | None) -> dict[str, tuple]:
    out = {}
    out.update(_vae_norm(prefix + "norm1.", cin, zq))
    out.update(_causal(prefix + "conv1.", cin, cout))
    out.update(_vae_norm(prefix + "norm2.", cout, zq))
    out.update(_causal(prefix + "conv2.", cout, cout))
    if cin != cout:
        out[prefix + "nin_shortcut.weight"] = (cout, cin, 1, 1, 1)
        out[prefix + "nin_shortcut.bias"] = (cout,)
    return out


def vae_state_dict(cfg: VAEConfig) -> dict[str, tuple]:
    ch, mult, nrb = cfg.ch, cfg.ch_mult, cfg.num_res_blocks
    nres = len(mult)
    z = cfg.z_channels
    zq = z
    out = {}
    out.update(_causal("encoder.conv_in.", cfg.in_channels, ch))
    in_mult = (1,) + tuple(mult)
    block_in = ch
    for i in range(nres):
        block_in = ch * in_mult[i]
        block_out = ch * mult[i]
        for j in range(nrb):
            out.update(_vae_resblock(f"encoder.down.{i}.block.{j}.",
                                     block_in, block_out, None))
            block_in = block_out
        if i != nres - 1:
            out[f"encoder.down.{i}.downsample.conv.weight"] = \
                (block_in, block_in, 3, 3)
            out[f"encoder.down.{i}.downsample.conv.bias"] = (block_in,)
    out.update(_vae_resblock("encoder.mid.block_1.", block_in, block_in,
                             None))
    out.update(_vae_resblock("encoder.mid.block_2.", block_in, block_in,
                             None))
    out["encoder.norm_out.weight"] = (block_in,)
    out["encoder.norm_out.bias"] = (block_in,)
    out.update(_causal("encoder.conv_out.",
                       block_in, 2 * z if cfg.double_z else z))

    block_in = ch * mult[-1]
    out.update(_causal("decoder.conv_in.", z, block_in))
    out.update(_vae_resblock("decoder.mid.block_1.", block_in, block_in,
                             zq))
    out.update(_vae_resblock("decoder.mid.block_2.", block_in, block_in,
                             zq))
    for i in reversed(range(nres)):
        block_out = ch * mult[i]
        for j in range(nrb + 1):
            out.update(_vae_resblock(f"decoder.up.{i}.block.{j}.",
                                     block_in, block_out, zq))
            block_in = block_out
        if i != 0:
            out[f"decoder.up.{i}.upsample.conv.weight"] = \
                (block_in, block_in, 3, 3)
            out[f"decoder.up.{i}.upsample.conv.bias"] = (block_in,)
    out.update(_vae_norm("decoder.norm_out.", block_in, zq))
    out.update(_causal("decoder.conv_out.", block_in, cfg.out_channels))
    return out


def t5_hf_safetensors(cfg) -> dict[str, tuple]:
    """HF T5EncoderModel key inventory (the frozen text encoders: stage-1
    google/flan-t5-xxl, stage-2 CogVideoX t5-v1_1-xxl). Keys exactly as
    models/t5.params_from_hf_state_dict consumes them (encoder. prefix
    stripped); torch linear layout (out_features, in_features)."""
    D, F = cfg.d_model, cfg.d_ff
    inner = cfg.num_heads * cfg.d_kv
    out = {"shared.weight": (cfg.vocab_size, D),
           "final_layer_norm.weight": (D,)}
    for i in range(cfg.num_layers):
        p = f"block.{i}.layer."
        for c in ("q", "k", "v"):
            out[p + f"0.SelfAttention.{c}.weight"] = (inner, D)
        out[p + "0.SelfAttention.o.weight"] = (D, inner)
        out[p + "0.layer_norm.weight"] = (D,)
        out[p + "1.DenseReluDense.wi_0.weight"] = (F, D)
        out[p + "1.DenseReluDense.wi_1.weight"] = (F, D)
        out[p + "1.DenseReluDense.wo.weight"] = (D, F)
        out[p + "1.layer_norm.weight"] = (D,)
    out["block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = \
        (cfg.relative_attention_num_buckets, cfg.num_heads)
    return out
