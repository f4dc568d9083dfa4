"""Parallel inference over a (data, model, time) mesh of ranks
(counterpart of landiff_tpu/parallel/): `mesh` (axes, rules, the ranks),
`tp_infer` (the head-padded Megatron DiT and the sequence-parallel one),
`ring_attention` (the ring forward over `time`), `vae_cp` (the
context-parallel VAE), `plan` (per-rank bytes)."""
