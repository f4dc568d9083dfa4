"""Semantic 1-D LM (counterpart of landiff_tpu/models/lm.py): vocab, prompt
assembly, the structural schedule and the constrained autoregressive
sampling loop: stage 1 of LanDiff.

Reference: landiff/llm/models/lm_model.py. The structural constraints are
precomputed into static per-position arrays (forced-token table and
free-position mask). The decode loop is a Python loop whose state stays
on the device: the sampled token, the forced / teacher lookups, the
embedding gather and the cache write never visit the host, so the loop
only enqueues work.

Vocab (lm_model.py:62-71): visual ids [0, codebook) then specials
EOS, BOS, START_OF_IFrame, END_OF_IFrame, START_OF_PFrame, END_OF_PFrame, PAD.

Sequence layout at inference (tokenize, lm_model.py:175-276):
  [BOS][micro frames][micro motion][text cond ...][SOI] then sampled:
  330 I tokens [EOI] ([SOP] 74 P tokens [EOP]) x (frames-1), per segment,
  [SOI]-per-extra-segment, final [EOS].

Random draws. The JAX sampler draws each token as argmax(x + Gumbel noise)
(`jax.random.categorical`) from a key split once per step. Here the noise
of all steps is one tensor, (steps, V) with steps = full_len - prefix_len,
either drawn up front from a `torch.Generator` or handed in (`gumbel=`),
which is how a test feeds both packages the same noise.

The training-time conditioning dropouts (micro_cond_features_batch,
text_dropout) take their keep masks from a `torch.Generator` or as
tensors. Not ported yet: the ground-truth first I-frame prompt
(assemble_prompt_with_gt_iframe).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from landiff_tpu_torch.config import ARSampleConfig, LLMConfig
from landiff_tpu_torch.models import gpt
from landiff_tpu_torch.ops.embeddings import timestep_embedding
from landiff_tpu_torch.ops.rope import rope_1d_table
from landiff_tpu_torch.utils import top_k_filter_logits, top_p_filter_probs


@dataclass(frozen=True)
class Vocab:
    codebook_size: int

    @property
    def EOS(self):
        return self.codebook_size

    @property
    def BOS(self):
        return self.codebook_size + 1

    @property
    def START_OF_IFRAME(self):
        return self.codebook_size + 2

    @property
    def END_OF_IFRAME(self):
        return self.codebook_size + 3

    @property
    def START_OF_PFRAME(self):
        return self.codebook_size + 4

    @property
    def END_OF_PFRAME(self):
        return self.codebook_size + 5

    @property
    def PAD(self):
        return self.codebook_size + 6

    @property
    def size(self):
        return self.codebook_size + 7


def video_frames_to_code_len(cfg: LLMConfig, num_frames: int,
                             segment_length: int | None = None,
                             segment_stride: int | None = None) -> int:
    """Total sampled positions for `num_frames` semantic frames
    (lm_model.py:278-291), incl. structural tokens, excl. the leading SOI."""
    seg_len = segment_length or cfg.frames_per_segment
    seg_stride = segment_stride or cfg.frames_per_segment
    res = 0
    for offset in range(0, num_frames, seg_stride):
        frame_len = min(offset + seg_len, num_frames) - offset
        res += cfg.iframe_len + (frame_len - 1) * cfg.pframe_len
        res += 2 * frame_len  # use_end_of_IFrame and use_end_of_PFrame
    return res


@dataclass(frozen=True)
class SampleSchedule:
    """Static structural schedule for the AR decode (lm_model.py:353-396).

    Arrays of length `full_len`; position i describes the token SAMPLED at i:
      forced[i]  >= 0: token id forced at this position; -1: free (visual)
      visual[i]  True where the sampled token is a visual code to emit
      allow_eos[i] True where EOS may terminate generation (predict_eos mode)
    """

    prefix_len: int
    full_len: int
    forced: np.ndarray
    visual: np.ndarray
    allow_eos: np.ndarray

    @property
    def num_visual(self) -> int:
        return int(self.visual.sum())


def build_schedule(cfg: LLMConfig, prefix_len: int, num_frames: int,
                   segment_length: int | None = None,
                   soi_index: int | None = None) -> SampleSchedule:
    """Replicates the index-set construction of lm_model.py:353-396.

    `prefix_len` = first SAMPLED position (index of SOI + 1 normally; deeper
    when the prompt embeds a ground-truth I-frame: pass `soi_index`
    explicitly then)."""
    vocab = Vocab(cfg.codebook_size)
    seg_len = segment_length or cfg.frames_per_segment
    p_num = seg_len - 1
    i_len, p_len = cfg.iframe_len, cfg.pframe_len
    start_of_iframe_index = (prefix_len - 1 if soi_index is None
                             else soi_index)

    full_len = start_of_iframe_index + video_frames_to_code_len(
        cfg, num_frames, seg_len, seg_len) + 1

    forced = np.full(full_len, -1, np.int64)
    visual = np.zeros(full_len, bool)
    allow_eos = np.zeros(full_len, bool)

    visual_block_len = i_len + p_num * p_len + seg_len * 2
    for index in range(start_of_iframe_index, full_len - 1, visual_block_len):
        move = index
        forced[move] = vocab.START_OF_IFRAME
        move += 1
        visual[move:move + i_len] = True
        move += i_len
        forced[move] = vocab.END_OF_IFRAME
        move += 1
        if index > start_of_iframe_index:
            allow_eos[move] = True
        p_end = min(full_len - 1, move - 1 + p_len * p_num + 2 * p_num)
        for j in range(move, p_end, p_len + 2):
            forced[j] = vocab.START_OF_PFRAME
            visual[j + 1:j + 1 + p_len] = True
            forced[j + p_len + 1] = vocab.END_OF_PFRAME
            move = j + p_len + 2
            if index > start_of_iframe_index:
                allow_eos[move] = True
    if forced[full_len - 1] < 0:  # structural sets take precedence
        forced[full_len - 1] = vocab.EOS
    visual[full_len - 1:] = False
    # the prompt's SOI is at start_of_iframe_index and not sampled
    return SampleSchedule(prefix_len=prefix_len, full_len=full_len,
                          forced=forced, visual=visual, allow_eos=allow_eos)


# ---------------------------------------------------------------------------
# Conditioners


def _affine(p, name, x, dt):
    return x @ p[f"{name}_w"].to(dt) + p[f"{name}_b"].to(dt)


def micro_cond_features(params, cfg: LLMConfig, values: dict[str, float],
                        compute_dtype=torch.bfloat16):
    """MicroConditioner (llm/modules/conditioner.py:17-170): scalar ->
    sinusoid(256) -> per-key MLP(freq->512->SiLU->2048). Keys sorted.
    Returns (num_keys, D)."""
    outs = []
    for key in sorted(cfg.micro_cond_keys):
        p = params["micro"][key]
        v = torch.tensor([values[key]], dtype=torch.float32,
                         device=p["fc0_w"].device)
        emb = timestep_embedding(v, cfg.micro_cond_embed_dim,
                                 dtype=compute_dtype)
        h = F.silu(_affine(p, "fc0", emb, compute_dtype))
        outs.append(_affine(p, "fc1", h, compute_dtype)[0])
    return torch.stack(outs)


def _keep_mask(rng, shape, prob: float, device) -> torch.Tensor:
    """Keep where uniform > prob (as the JAX dropouts draw it). rng: a
    torch.Generator on `device`, or the bool mask itself."""
    if isinstance(rng, torch.Generator):
        return torch.rand(shape, generator=rng, device=device) > prob
    return rng.to(device).reshape(shape)


def micro_cond_features_batch(params, cfg: LLMConfig, values, batch: int,
                              *, drop_rng=None, drop_probs=None,
                              compute_dtype=torch.bfloat16):
    """Batched MicroConditioner with training-time conditioning dropout
    (conditioner.py:77-88, 117-141): per key, the sinusoid embedding is
    replaced PRE-MLP by the learned null embedding
    (params["micro_null"][key], shape (freq,)) with probability
    drop_probs[key], per sample. drop_rng: None (no dropout), a
    torch.Generator, or a dict key -> (batch,) bool keep mask. Returns
    (batch, num_keys, D)."""
    drop_probs = drop_probs or {}
    outs = []
    for key in sorted(cfg.micro_cond_keys):
        p = params["micro"][key]
        dev = p["fc0_w"].device
        v = torch.as_tensor(values[key], dtype=torch.float32,
                            device=dev).expand(batch)
        emb = timestep_embedding(v, cfg.micro_cond_embed_dim,
                                 dtype=compute_dtype)          # (B, freq)
        prob = drop_probs.get(key, 0.0)
        if drop_rng is not None and prob > 0:
            null = params["micro_null"][key].to(compute_dtype)
            rng = drop_rng[key] if isinstance(drop_rng, dict) else drop_rng
            keep = _keep_mask(rng, (batch, 1), prob, dev)
            emb = torch.where(keep, emb, null[None])
        h = F.silu(_affine(p, "fc0", emb, compute_dtype))
        outs.append(_affine(p, "fc1", h, compute_dtype))
    return torch.stack(outs, dim=1)


def text_dropout(params, text_feats, rng, drop_prob: float):
    """TextCond training-time CFG dropout (conditioner.py:238-248): with
    probability drop_prob per SAMPLE, the whole projected text feature
    block is replaced by the learned null embedding (which thereby
    receives gradients). text_feats: (B, n_text, D); rng: a
    torch.Generator or a (B,) bool keep mask."""
    if drop_prob <= 0:
        return text_feats
    B = text_feats.shape[0]
    keep = _keep_mask(rng, (B, 1, 1), drop_prob, text_feats.device)
    null = params["null_text_embedding"].to(text_feats.dtype)
    return torch.where(keep, text_feats, null[None, None])


def text_cond_features(params, text_embedding, compute_dtype=torch.bfloat16):
    """TextCond MLP projection (conditioner.py:173-264): T5 features
    (S, 4096) -> MLP2(gelu-tanh) -> (S, D)."""
    p = params["text_proj"]
    x = text_embedding.to(compute_dtype)
    h = F.gelu(_affine(p, "fc0", x, compute_dtype), approximate="tanh")
    return _affine(p, "fc1", h, compute_dtype)


def null_text_features(params, length: int, compute_dtype=torch.bfloat16):
    """forward_unconditional (conditioner.py:309-323): the learned null
    embedding repeated to the tokenized length (NOT passed through the
    MLP)."""
    null = params["null_text_embedding"].to(compute_dtype)
    return null[None].expand(length, null.shape[0])


def assemble_prompt(params, cfg: LLMConfig, text_feats, micro_feats,
                    compute_dtype=torch.bfloat16):
    """Build prompt features [BOS][micro x2][text][SOI] -> (prefix_len, D)
    (lm_model.py:201-276, micro_cond_first=True)."""
    vocab = Vocab(cfg.codebook_size)
    embed = params["tok_emb"]
    bos = embed[vocab.BOS][None].to(compute_dtype)
    soi = embed[vocab.START_OF_IFRAME][None].to(compute_dtype)
    return torch.cat([bos, micro_feats.to(compute_dtype),
                      text_feats.to(compute_dtype), soi], dim=0)


# ---------------------------------------------------------------------------
# Constrained AR sampling


@dataclasses.dataclass(frozen=True)
class _SampleStatic:
    """The static part of a sampling run."""

    cfg: LLMConfig
    prefix_len: int
    full_len: int
    temperature: float
    top_k: int
    top_p: float
    guidance_scale: float

    @property
    def with_guidance(self) -> bool:
        return self.guidance_scale > 0 and self.guidance_scale != 1


def _static(cfg, schedule, sample_cfg) -> _SampleStatic:
    return _SampleStatic(
        cfg=cfg, prefix_len=schedule.prefix_len, full_len=schedule.full_len,
        temperature=sample_cfg.temperature, top_k=sample_cfg.top_k,
        top_p=sample_cfg.top_p, guidance_scale=sample_cfg.cfg_scale)


def _combined_logits(logits, st: _SampleStatic):
    """CFG combine + temperature. logits: (..., rows, V) f32, rows =
    [cond, uncond] iff guidance. Returns (..., V)."""
    if st.with_guidance:
        cond, uncond = logits[..., 0, :], logits[..., 1, :]
        logits = uncond + st.guidance_scale * (cond - uncond)
    else:
        logits = logits[..., 0, :]
    return logits / st.temperature


def _sample_token(comb, forced_t, g, st: _SampleStatic):
    """top-k / top-p + structural forcing for one step on combined logits
    (..., V); g: Gumbel noise of the same shape. The draw is
    argmax(log(max(probs, 1e-30)) + g), what jax.random.categorical
    computes (lm.py:312)."""
    x = comb
    if st.top_k > 0:
        x = top_k_filter_logits(x, st.top_k)
    probs = torch.softmax(x, dim=-1)
    if st.top_p < 1.0:
        probs = top_p_filter_probs(probs, st.top_p)
    sampled = (torch.log(probs.clamp_min(1e-30)) + g).argmax(-1)
    return torch.where(forced_t >= 0, forced_t, sampled)


def _sample_restricted(comb, forced_t, eos_id, g):
    """Structural positions where EOS may fire sample from the RESTRICTED
    set {forced, EOS} (lm_model.py:448-453), with the step's own noise
    (the JAX sampler reuses the step's key, lm.py:399-400)."""
    ids = torch.arange(comb.shape[-1], device=comb.device)
    allowed = (ids == forced_t) | (ids == eos_id)
    return (torch.where(allowed, comb, -torch.inf) + g).argmax(-1)


def _draw(comb, forced_t, allow_eos_t, eos_id, g, st, predict_eos: bool):
    """One step's token(s) from combined logits (..., V): returns (token,
    hit_eos), both of shape (...); hit_eos is None without predict_eos."""
    sampled = _sample_token(comb, forced_t, g, st)
    hit_eos = None
    if predict_eos:
        # at eos-allowed structural positions, draw from {forced, EOS}
        restricted = _sample_restricted(comb, forced_t, eos_id, g)
        hit_eos = allow_eos_t & (restricted == eos_id)
        sampled = torch.where(allow_eos_t & (forced_t >= 0), restricted,
                              sampled)
    return sampled, hit_eos


def gumbel_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), f32, on the generator's
    device."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def _noise(generator, gumbel, shape, device):
    if (generator is None) == (gumbel is None):
        raise ValueError("give exactly one of generator= and gumbel=")
    if gumbel is None:
        return gumbel_noise(generator, shape).to(device)
    gumbel = torch.as_tensor(gumbel, dtype=torch.float32, device=device)
    if tuple(gumbel.shape) != tuple(shape):
        raise ValueError(f"gumbel noise has shape {tuple(gumbel.shape)}, "
                         f"want {tuple(shape)}")
    return gumbel


def _rope_tables(cfg: LLMConfig, full_len: int, device):
    cos_t, sin_t = rope_1d_table(cfg.rope)
    return (torch.from_numpy(cos_t[:full_len]).to(device),
            torch.from_numpy(sin_t[:full_len]).to(device))


def _visual_codes(tokens, stop, schedule: SampleSchedule, cfg: LLMConfig):
    """The emitted codes of one prompt: visual positions that were sampled
    (not part of the prompt) before the stop, clamped to the visual range."""
    pos = np.arange(schedule.full_len)
    keep = schedule.visual & (pos >= schedule.prefix_len) & (pos < int(stop))
    return np.clip(tokens[keep], 0, cfg.codebook_size - 1).astype(np.int32)


@torch.inference_mode()
def sample(params, cfg: LLMConfig, schedule: SampleSchedule, prompt_features,
           sample_cfg: ARSampleConfig, *, generator=None, gumbel=None,
           teacher_tokens=None, predict_eos: bool = False,
           compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16):
    """Constrained AR decode (lm_model.py:293-516).

    Args:
      prompt_features: (rows, prefix_len, D); rows=2 for CFG ([cond,
        uncond]) else 1. The run happens on its device.
      schedule: static structural schedule from build_schedule.
      generator / gumbel: the source of the draws: a torch.Generator, or
        the (full_len - prefix_len, V) Gumbel noise itself.
      teacher_tokens: optional (full_len,) ground-truth tokens; when given,
        the fed token is the ground truth (teacher forcing,
        lm_model.py:506-507) while sampled tokens are still recorded.
      predict_eos: allow early termination when EOS is sampled at an
        allowed position (lm_model.py:455-462); codes after the stop are
        dropped.
    Returns: (num_visual,) int32 codes clamped to the visual range (shorter
    if predict_eos fired).
    """
    st = _static(cfg, schedule, sample_cfg)
    vocab = Vocab(cfg.codebook_size)
    dev = prompt_features.device
    rows = prompt_features.shape[0]
    steps = st.full_len - st.prefix_len
    noise = _noise(generator, gumbel, (steps, cfg.vocab_size), dev)
    forced = torch.as_tensor(schedule.forced, device=dev)
    allow_eos = torch.as_tensor(schedule.allow_eos, device=dev)
    teacher = (torch.full((st.full_len,), -1, dtype=torch.int64, device=dev)
               if teacher_tokens is None else
               torch.as_tensor(np.asarray(teacher_tokens), dtype=torch.int64,
                               device=dev))
    cos, sin = _rope_tables(cfg, st.full_len, dev)
    positions = torch.arange(st.full_len, device=dev)
    emb = params["tok_emb"]

    cache = gpt.KVCache.create(cfg, rows, st.full_len, cache_dtype, dev)
    logits, cache = gpt.prefill(
        params["gpt"], prompt_features, cache, cfg, cos[:st.prefix_len],
        sin[:st.prefix_len], compute_dtype=compute_dtype)

    out = torch.zeros((st.full_len,), dtype=torch.int64, device=dev)
    stop = torch.full((), st.full_len, dtype=torch.int64, device=dev)
    for j, i in enumerate(range(st.prefix_len, st.full_len)):
        # i is a Python int, but every tensor it selects is a device view:
        # nothing below copies to the host
        comb = _combined_logits(logits, st)
        sampled, hit_eos = _draw(comb, forced[i], allow_eos[i], vocab.EOS,
                                 noise[j], st, predict_eos)
        out[i] = sampled
        if predict_eos:
            stop = torch.where(hit_eos, torch.minimum(stop, positions[i]),
                               stop)
            # the one host read of the loop, only where the schedule allows
            # EOS (once per segment boundary): it waits for the device
            if schedule.allow_eos[i] and int(stop) <= i:
                break
        if i + 1 == st.full_len:
            break                    # the last token feeds no further step
        fed = torch.where(teacher[i] >= 0, teacher[i], sampled)
        feat = emb[fed][None, None].expand(rows, 1, -1)
        logits, cache = gpt.decode_step(
            params["gpt"], feat, cache, positions[i:i + 1], cfg,
            cos[i:i + 1], sin[i:i + 1], compute_dtype=compute_dtype)
    return _visual_codes(out.cpu().numpy(), stop.cpu(), schedule, cfg)


# ---------------------------------------------------------------------------
# Batched multi-prompt sampling (serving throughput)
#
# Prompts are RIGHT-ALIGNED (left zero-pad to the batch's prefix length;
# per-row `pad` offsets shift the rope positions and mask padded slots out
# of attention), so every row shares ONE structural schedule. Each prompt
# has its own noise stream, so the batched draw equals N single runs with
# the same streams.


@torch.inference_mode()
def sample_batch(params, cfg: LLMConfig, schedule: SampleSchedule,
                 prompt_features, pad, sample_cfg: ARSampleConfig, *,
                 generators=None, gumbel=None, predict_eos: bool = False,
                 compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16):
    """Constrained AR decode for N prompts at once.

    Args:
      prompt_features: (R, P, D) right-aligned prompt rows; R = 2N with CFG
        ([cond_0, uncond_0, cond_1, uncond_1, ...]) else N. P = the padded
        prompt length of the batch.
      pad: (R,) left-pad length per row (P - true_prefix_len).
      schedule: shared schedule built with prefix_len = P.
      generators / gumbel: N torch.Generators, one stream per prompt, or
        the (N, full_len - prefix_len, V) Gumbel noise itself.
    Returns: list of N (num_visual_n,) int32 code arrays (shorter per
    prompt if predict_eos fired).
    """
    st = _static(cfg, schedule, sample_cfg)
    vocab = Vocab(cfg.codebook_size)
    dev = prompt_features.device
    rows = prompt_features.shape[0]
    rows_per = 2 if st.with_guidance else 1
    n_prompts = rows // rows_per
    steps = st.full_len - st.prefix_len
    if gumbel is None and generators is not None:
        if len(generators) != n_prompts:
            raise ValueError(f"{len(generators)} generators for "
                             f"{n_prompts} prompts")
        # one stream per prompt, drawn as the single-prompt sampler draws
        gumbel = torch.stack([gumbel_noise(g, (steps, cfg.vocab_size)).to(dev)
                              for g in generators])
        generators = None
    noise = _noise(generators, gumbel, (n_prompts, steps, cfg.vocab_size),
                   dev)
    pad = torch.as_tensor(np.asarray(pad), dtype=torch.int64, device=dev)
    forced = torch.as_tensor(schedule.forced, device=dev)
    allow_eos = torch.as_tensor(schedule.allow_eos, device=dev)
    cos, sin = _rope_tables(cfg, st.full_len, dev)
    positions = torch.arange(st.full_len, device=dev)
    emb = params["tok_emb"]

    # per-row rope angles shifted by the left pad: buffer index j is the
    # row's logical position j - pad (padded slots clip to 0; masked anyway)
    ppos = (positions[None, :st.prefix_len] - pad[:, None]).clamp_min(0)
    cache = gpt.KVCache.create(cfg, rows, st.full_len, cache_dtype, dev)
    logits, cache = gpt.prefill(
        params["gpt"], prompt_features, cache, cfg, cos[ppos], sin[ppos],
        compute_dtype=compute_dtype, pad=pad)

    out = torch.zeros((n_prompts, st.full_len), dtype=torch.int64, device=dev)
    stop = torch.full((n_prompts,), st.full_len, dtype=torch.int64,
                      device=dev)
    for j, i in enumerate(range(st.prefix_len, st.full_len)):
        comb = _combined_logits(logits.reshape(n_prompts, rows_per, -1), st)
        sampled, hit_eos = _draw(comb, forced[i], allow_eos[i], vocab.EOS,
                                 noise[:, j], st, predict_eos)
        out[:, i] = sampled
        if predict_eos:
            stop = torch.where(hit_eos, torch.minimum(stop, positions[i]),
                               stop)
            # host read only where the schedule allows EOS; it waits for
            # the device
            if schedule.allow_eos[i] and int(stop.max()) <= i:
                break
        if i + 1 == st.full_len:
            break
        feat = emb[sampled][:, None].repeat_interleave(rows_per, dim=0)
        dpos = (positions[i] - pad).clamp_min(0)[:, None]       # (R, 1)
        logits, cache = gpt.decode_step(
            params["gpt"], feat, cache, positions[i:i + 1], cfg, cos[dpos],
            sin[dpos], compute_dtype=compute_dtype, pad=pad)
    tokens, stops = out.cpu().numpy(), stop.cpu().numpy()
    return [_visual_codes(tokens[n], stops[n], schedule, cfg)
            for n in range(n_prompts)]


# ---------------------------------------------------------------------------
# init


def init(gen: torch.Generator, cfg: LLMConfig, t5_dim: int = 4096,
         dtype=torch.float32, micro_drop_probs: dict | None = None):
    """Random parameters with the JAX init's tree (lm.py:573), drawn from
    `gen` on its device. The micro conditioner's output linear is
    zero-init (conditioner.py:85-89). micro_drop_probs: keys with a
    probability > 0 get a learned null embedding under "micro_null"
    (randn(freq) / sqrt(freq), conditioner.py:58-68), which the
    training-time per-key dropout uses."""
    D = cfg.hidden_size
    dev = gen.device
    z = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
    nrm = lambda shape, std: (torch.randn(shape, generator=gen, device=dev)
                              * std).to(dtype)
    tn = lambda *shape: gpt._trunc_normal(gen, shape, dtype)
    micro = {}
    for name in sorted(cfg.micro_cond_keys):
        micro[name] = {
            "fc0_w": nrm((cfg.micro_cond_embed_dim, 512), 0.02),
            "fc0_b": z(512),
            "fc1_w": z(512, D),
            "fc1_b": z(D),
        }
    out = {
        "gpt": gpt.init(gen, cfg, dtype),
        "tok_emb": nrm((cfg.vocab_size, D), 0.02),
        "text_proj": {
            "fc0_w": tn(t5_dim, D), "fc0_b": z(D),
            "fc1_w": tn(D, D), "fc1_b": z(D),
        },
        "null_text_embedding": nrm((D,), 1.0 / math.sqrt(D)),
        "micro": micro,
    }
    freq = cfg.micro_cond_embed_dim
    micro_null = {name: nrm((freq,), 1.0 / math.sqrt(freq))
                  for name in sorted(cfg.micro_cond_keys)
                  if micro_drop_probs and micro_drop_probs.get(name, 0.0) > 0}
    if micro_null:
        out["micro_null"] = micro_null
    return out
