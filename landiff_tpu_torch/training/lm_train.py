"""Stage-1 LM training: teacher-forcing forward + masked cross-entropy
(counterpart of landiff_tpu/training/lm_train.py).

Sequence assembly follows tokenize() (lm_model.py:175-276), the loss
CondTransformerBase._losses (transformer.py:134-138, masked
cross-entropy) with the next-token shift: logits at i-1 predict the label
at i; the loss-masked positions are the tokens appended with
loss_mask=True (SOI, visual codes, EOI, SOP, EOP, EOS). The forward pins
attn_impl="xla", as the JAX package does: it reaches no kernel.

Random draws: the text and micro conditioning dropouts take a
`torch.Generator` (text first, then the micro keys in sorted order) or a
`CondDraws` of keep masks, which is how a test feeds both packages the
same draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from landiff_tpu_torch.config import LLMConfig
from landiff_tpu_torch.models import gpt, lm
from landiff_tpu_torch.ops.rope import rope_1d_table
from landiff_tpu_torch.training import optim


@dataclasses.dataclass
class CondDraws:
    """Keep masks of one step: text (B,) bool, micro dict key -> (B,)."""

    text: torch.Tensor
    micro: dict | None = None


def build_training_batch(params, cfg: LLMConfig, text_feats, micro_feats,
                         codes, *, num_frames: int | None = None,
                         compute_dtype=torch.float32):
    """Assemble one teacher-forcing row.

    text_feats: (n_text, D) projected text condition features; codes:
    (num_visual,) ground-truth visual token ids. Returns (features (L, D),
    labels (L,), loss_mask (L,))."""
    if num_frames is None:
        num_frames = cfg.frames_per_segment
    prompt = lm.assemble_prompt(params, cfg, text_feats, micro_feats,
                                compute_dtype)
    sched = lm.build_schedule(cfg, prompt.shape[0], num_frames)
    assert len(codes) == sched.num_visual, (len(codes), sched.num_visual)
    dev = prompt.device

    tokens = np.asarray(sched.forced).copy()
    tokens[sched.visual] = np.asarray(codes)
    tokens = torch.from_numpy(np.maximum(tokens, 0)).to(dev)
    # features: prompt part from cond embeddings, sampled part from tok_emb
    emb = params["tok_emb"].to(compute_dtype)[tokens[sched.prefix_len:]]
    features = torch.cat([prompt, emb], dim=0)
    loss_mask = np.zeros(sched.full_len, bool)
    loss_mask[sched.prefix_len:] = True
    # SOI sits at prefix_len-1 inside the prompt with loss_mask=True
    # (lm_model.py:213-215); it is a label for the position before it
    loss_mask[sched.prefix_len - 1] = True
    vocab = lm.Vocab(cfg.codebook_size)
    labels = tokens.clone()
    labels[:sched.prefix_len - 1] = 0
    labels[sched.prefix_len - 1] = vocab.START_OF_IFRAME
    return features, labels, torch.from_numpy(loss_mask).to(dev)


def lm_loss(params, cfg: LLMConfig, features, labels, loss_mask,
            compute_dtype=torch.float32):
    """Masked next-token cross-entropy: logits[i-1] predict labels[i]."""
    L = features.shape[-2]
    dev = features.device
    cos, sin = (torch.from_numpy(t[:L]).to(dev)
                for t in rope_1d_table(cfg.rope))
    logits = gpt.forward(params["gpt"], features[None] if features.dim() == 2
                         else features, cfg, cos, sin, attn_impl="xla",
                         compute_dtype=compute_dtype).float()
    if features.dim() == 2:
        labels = labels[None]
        loss_mask = loss_mask[None]
    shift_mask = loss_mask[:, 1:].float()
    ce = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                         labels[:, 1:].reshape(-1),
                         reduction="none").reshape(shift_mask.shape)
    return (ce * shift_mask).sum() / shift_mask.sum().clamp_min(1)


def lm_cond_loss(params, cfg: LLMConfig, t5_feats, codes, micro_values, *,
                 rng=None, cfg_drop_prob: float = 0.0,
                 micro_drop_probs=None, num_frames: int | None = None,
                 compute_dtype=torch.float32):
    """Teacher-forcing loss with the conditioners INSIDE the gradient:
    text projection MLP, micro-cond MLPs, token embeddings AND the learned
    null embeddings all receive gradients, as CFG training needs (the
    null_text_embedding is trained through the per-sample conditioning
    dropout: TextCond cfg_drop_prob=0.1, conditioner.py:238-248 +
    llm_cfg.py:60-62; MicroConditioner per-key drop, conditioner.py:77-88,
    117-141).

    t5_feats: (B, n_text, t5_dim) raw frozen-T5 features; codes:
    (B, num_visual) ground-truth visual ids; micro_values: dict key ->
    scalar (or (B,) tensor); rng: a torch.Generator or CondDraws enabling
    the training dropout (None = eval, no dropout)."""
    B, n_text = t5_feats.shape[:2]
    dev = t5_feats.device
    if num_frames is None:
        num_frames = cfg.frames_per_segment
    num_micro = len(cfg.micro_cond_keys)
    prefix_len = 1 + num_micro + n_text + 1
    sched = lm.build_schedule(cfg, prefix_len, num_frames)
    assert codes.shape[1] == sched.num_visual, (codes.shape,
                                                sched.num_visual)
    vocab = lm.Vocab(cfg.codebook_size)
    visual_idx = torch.from_numpy(np.nonzero(np.asarray(sched.visual))[0])
    template = torch.from_numpy(np.maximum(np.asarray(sched.forced), 0))
    tokens = template.to(dev).expand(B, sched.full_len).clone()
    tokens[:, visual_idx.to(dev)] = codes.to(tokens.dtype)
    labels = tokens.clone()
    labels[:, :prefix_len - 1] = 0
    labels[:, prefix_len - 1] = vocab.START_OF_IFRAME
    loss_mask = torch.zeros((B, sched.full_len), dtype=torch.bool, device=dev)
    loss_mask[:, prefix_len - 1:] = True

    text_rng = micro_rng = None
    if rng is not None:
        draws = isinstance(rng, CondDraws)
        text_rng = rng.text if draws else rng
        micro_rng = rng.micro if draws else rng
    text = lm.text_cond_features(params, t5_feats, compute_dtype)
    if text_rng is not None and cfg_drop_prob > 0:
        text = lm.text_dropout(params, text, text_rng, cfg_drop_prob)
    mic = lm.micro_cond_features_batch(
        params, cfg, micro_values, B, drop_rng=micro_rng,
        drop_probs=micro_drop_probs, compute_dtype=compute_dtype)
    emb_table = params["tok_emb"].to(compute_dtype)
    D = emb_table.shape[1]
    bos = emb_table[vocab.BOS][None, None].expand(B, 1, D)
    soi = emb_table[vocab.START_OF_IFRAME][None, None].expand(B, 1, D)
    suffix = emb_table[tokens[:, prefix_len:]]
    features = torch.cat(
        [bos, mic.to(compute_dtype), text.to(compute_dtype), soi, suffix],
        dim=1)
    return lm_loss(params, cfg, features, labels, loss_mask, compute_dtype)


def _step(optimizer, loss_fn):
    def train_step(params, opt_state, *batch):
        params = optim.require_grad(params)
        loss = loss_fn(params, *batch)
        grads = optim.grad(loss, params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optim.apply_updates(params, updates), opt_state, loss.detach()

    return train_step


def make_cond_train_step(optimizer, cfg: LLMConfig, micro_values, *,
                         cfg_drop_prob: float = 0.1, micro_drop_probs=None,
                         num_frames: int | None = None,
                         compute_dtype=torch.float32):
    """Gradient-correct stage-1 step: conditioners assembled in-grad, with
    CFG conditioning dropout. Step signature:
    (params, opt_state, t5_feats, codes, rng) -> (params, opt_state, loss).
    """
    def loss_fn(params, t5_feats, codes, rng):
        return lm_cond_loss(params, cfg, t5_feats, codes, micro_values,
                            rng=rng, cfg_drop_prob=cfg_drop_prob,
                            micro_drop_probs=micro_drop_probs,
                            num_frames=num_frames,
                            compute_dtype=compute_dtype)

    return _step(optimizer, loss_fn)


def make_train_step(optimizer, cfg: LLMConfig, compute_dtype=torch.float32):
    """Step on assembled rows: (params, opt_state, features, labels,
    loss_mask) -> (params, opt_state, loss)."""
    def loss_fn(params, features, labels, loss_mask):
        return lm_loss(params, cfg, features, labels, loss_mask,
                       compute_dtype)

    return _step(optimizer, loss_fn)
