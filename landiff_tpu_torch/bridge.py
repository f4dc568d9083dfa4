"""Parameter bridge: the JAX package's parameter trees, handed over as
numpy arrays, become the port's tensors.

Layouts are converted once here, so the port's forwards call PyTorch's
own operators without transposes:
  - 4-D conv kernels, HWIO (kh, kw, ci, co)      -> OIHW for F.conv2d
  - 5-D conv kernels, (kt, kh, kw, ci, co)       -> OIDHW for F.conv3d
Every other array (linear weights stored (in, out) for x @ W, biases,
tables, codebooks) keeps its layout. Every 4-D or 5-D leaf of the stage-2
trees is a conv kernel (DiT patchify, semantic upsampler, VAE), which is
what makes the rule by rank safe. The stage-1 tree ({"lm": {"gpt",
"tok_emb", "text_proj", "null_text_embedding", "micro"}, "t5"}) holds
only vectors and (in, out) matrices and crosses unchanged. The port's own
`init` functions build the converted layouts directly.
"""

from __future__ import annotations

import numpy as np
import torch

from landiff_tpu_torch.utils import tree_map

_PERMUTE = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _convert(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.ndim in _PERMUTE and np.issubdtype(arr.dtype, np.floating):
        arr = np.transpose(arr, _PERMUTE[arr.ndim])
    return torch.from_numpy(np.array(arr)).to(device)   # a writable copy


def to_torch(tree, device="cuda"):
    """A JAX-package parameter tree (dicts / lists of arrays, anything
    numpy can read) -> the same tree of tensors on `device`, conv kernels
    in PyTorch's layouts."""
    return tree_map(lambda a: _convert(a, device), tree)
