"""Tensor ops of the port: norms, embeddings, rope, masks and attention
(whose flash forwards are the CUDA kernels in csrc/)."""
