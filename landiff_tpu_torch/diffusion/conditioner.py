"""GeneralConditioner: the reference's multi-embedder conditioning engine
(counterpart of landiff_tpu/diffusion/conditioner.py; reference sgm/
modules/encoders/modules.py:62-243).

The shipped LanDiff config uses one embedder (FrozenT5Embedder ->
"crossattn"), which pipeline/dif_infer.py runs directly; stage-2 training
with more conditionings needs the general machinery:

- embedders declared as `EmbedderSpec`s over plain parameter trees;
- outputs routed by rank, 2-D "vector", 3-D "crossattn", 4/5-D "concat"
  (OUTPUT_DIM2KEYS, modules.py:63), concatenated per key along KEY2CATDIM;
- per-embedder `ucg_rate` dropout: output rows zeroed per sample
  (modules.py:150-166), or for `legacy_ucg_val` embedders the input
  replaced before the embedder runs (modules.py:107-115);
- correlated dropout `cor_embs` / `cor_p`: one categorical draw per sample
  over 2**len(cor_embs) joint outcomes, bit-decomposed into per-embedder
  drop masks (modules.py:188-203);
- `force_zero_embeddings` zeroes outputs by input_key (modules.py:
  178-181);
- a frozen embedder contributes through `.detach()` (the reference
  freezes its parameters, modules.py:75-80);
- `get_unconditional_conditioning` runs the (c, uc) pair with every
  dropout off (modules.py:222-243).

Dropout draws come from `generator`, or are passed as `ConditionerDraws`
(the seam through which a test feeds the JAX key chain's draws).
Embedder `apply` callables receive (params_subtree, *batch_inputs) and
return one tensor or a tuple (each routed on its own, modules.py:
146-149).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

OUTPUT_DIM2KEYS = {2: "vector", 3: "crossattn", 4: "concat", 5: "concat"}
KEY2CATDIM = {"vector": 1, "crossattn": 2, "concat": 1}


@dataclasses.dataclass(frozen=True)
class EmbedderSpec:
    """One conditioning embedder (AbstractEmbModel, modules.py:30-59).

    name: key of its subtree in the conditioner's parameters (absent for
      an embedder without parameters: apply receives None).
    apply: (params_subtree, *inputs) -> tensor | tuple of tensors.
    input_key / input_keys: the batch entries that feed `apply`, exactly
      one of the two (modules.py:86-93).
    ucg_rate: per-sample unconditional-guidance dropout probability.
    legacy_ucg_val: if set, dropout replaces the input batch value with
      this scalar instead of zeroing the output (modules.py:95-98).
    is_trainable: gradients flow into params_subtree only if True.
    """
    name: str
    apply: Callable
    input_key: Optional[str] = None
    input_keys: Tuple[str, ...] = ()
    ucg_rate: float = 0.0
    legacy_ucg_val: Optional[float] = None
    is_trainable: bool = False

    def __post_init__(self):
        if (self.input_key is None) == (len(self.input_keys) == 0):
            raise ValueError(
                f"embedder {self.name}: need exactly one of input_key / "
                "input_keys (modules.py:86-93)")


@dataclasses.dataclass
class ConditionerDraws:
    """The dropout draws of one apply_conditioner call. cor_idx: (B,)
    int, the joint outcome of the correlated embedders; ucg: embedder
    index -> (B,) bool, True = drop that sample's conditioning."""
    cor_idx: Optional[torch.Tensor] = None
    ucg: dict = dataclasses.field(default_factory=dict)


def _expand_like(mask, emb):
    """(B,) -> (B, 1, 1, ...) broadcastable to emb, in emb's dtype."""
    return mask.reshape(mask.shape + (1,) * (emb.dim() - 1)).to(emb.dtype)


def _batch_size(batch):
    return next(iter(batch.values())).shape[0]


def _run_embedder(spec: EmbedderSpec, params, batch, drop, output,
                  force_zero_keys):
    """get_single_embedding (modules.py:127-184). drop: (B,) float, 1.0 =
    drop this sample's conditioning, or None (no dropout)."""
    sub = params.get(spec.name) if params else None
    if spec.input_key is not None:
        val = batch[spec.input_key]
        if spec.legacy_ucg_val is not None and drop is not None:
            val = torch.where(_expand_like(drop, val) > 0.5,
                              torch.tensor(spec.legacy_ucg_val,
                                           dtype=val.dtype,
                                           device=val.device), val)
        emb_out = spec.apply(sub, val)
    else:
        emb_out = spec.apply(sub, *[batch[k] for k in spec.input_keys])
    if not isinstance(emb_out, (list, tuple)):
        emb_out = [emb_out]
    for emb in emb_out:
        out_key = OUTPUT_DIM2KEYS[emb.dim()]
        if not spec.is_trainable:
            emb = emb.detach()
        if (spec.ucg_rate > 0.0 and spec.legacy_ucg_val is None
                and drop is not None):
            emb = emb * (1.0 - _expand_like(drop, emb))
        if spec.input_key is not None and spec.input_key in force_zero_keys:
            emb = torch.zeros_like(emb)
        if out_key in output:
            output[out_key] = torch.cat([output[out_key], emb],
                                        dim=KEY2CATDIM[out_key])
        else:
            output[out_key] = emb
    return output


def apply_conditioner(specs: Sequence[EmbedderSpec], params, batch, *,
                      generator: torch.Generator | None = None,
                      draws: ConditionerDraws | None = None,
                      train: bool = False,
                      cor_embs: Sequence[int] = (),
                      cor_p: Sequence[float] = (),
                      force_zero_embeddings: Sequence[str] = ()):
    """GeneralConditioner.forward (modules.py:186-218): a dict with any of
    "vector" / "crossattn" / "concat".

    Dropout runs only with train=True and a generator or draws (the
    inference behaviour otherwise). Correlated embedders (indices in
    cor_embs) are processed first, in cor_embs order, then the rest in
    spec order, which fixes the per-key concatenation order. With a
    generator the correlated outcome is drawn first, then each other
    embedder's mask in processing order."""
    if cor_embs and len(cor_p) != 2 ** len(cor_embs):
        raise ValueError("len(cor_p) must be 2**len(cor_embs)")
    output = {}
    dropout_on = train and (generator is not None or draws is not None)
    B = _batch_size(batch)
    device = next(iter(batch.values())).device
    cond_or_not = {}
    if cor_embs and dropout_on:
        if draws is not None:
            rand_idx = draws.cor_idx.to(device)
        else:
            rand_idx = torch.multinomial(
                torch.tensor(cor_p, dtype=torch.float32, device=device), B,
                replacement=True, generator=generator)
        for emb_idx in cor_embs:
            cond_or_not[emb_idx] = (rand_idx % 2).float()
            rand_idx = rand_idx // 2
    for i in tuple(cor_embs) + tuple(j for j in range(len(specs))
                                     if j not in cor_embs):
        spec = specs[i]
        drop = None
        if dropout_on:
            if i in cond_or_not:
                drop = cond_or_not[i]
            elif spec.ucg_rate > 0.0:
                if draws is not None:
                    drop = draws.ucg[i].to(device).float()
                else:
                    drop = (torch.rand(B, generator=generator, device=device)
                            < spec.ucg_rate).float()
        output = _run_embedder(spec, params, batch, drop, output,
                               tuple(force_zero_embeddings))
    return output


def get_unconditional_conditioning(specs, params, batch_c, batch_uc=None, *,
                                   force_uc_zero_embeddings: Sequence[str]
                                   = ()):
    """(c, uc) with every ucg / cor dropout off (modules.py:222-243): uc
    runs on batch_uc if given, else on batch_c with the
    force_uc_zero_embeddings outputs zeroed (the shipped config's ["txt"]
    gives the all-zero uc context the pipelines use)."""
    c = apply_conditioner(specs, params, batch_c)
    uc = apply_conditioner(specs, params,
                           batch_c if batch_uc is None else batch_uc,
                           force_zero_embeddings=force_uc_zero_embeddings)
    return c, uc
