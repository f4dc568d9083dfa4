"""Tensor-parallel inference over a (data, model) mesh of ranks
(counterpart of landiff_tpu/parallel/): `mesh` (axes, rules, the ranks),
`tp_infer` (the head-padded Megatron DiT), `plan` (per-rank bytes)."""
