"""Training checkpoint save / restore (counterpart of
landiff_tpu/training/checkpoint.py, same call contract). One file per
step, `step_<N>.pt`, written by `torch.save` under a temporary name and
renamed, so a reader never sees half a file. The files are not
interchangeable with the JAX package's orbax directories.
"""

from __future__ import annotations

import logging
import os
import re
from pathlib import Path

import torch

from landiff_tpu_torch.utils import tree_map

logger = logging.getLogger("landiff_tpu_torch.training")

_NAME = re.compile(r"step_(\d+)\.pt$")


def save_checkpoint(ckpt_dir: str | Path, step: int, params, opt_state,
                    extra: dict | None = None):
    ckpt_dir = Path(ckpt_dir).absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    payload = {"params": params, "opt_state": opt_state}
    if extra:
        payload["extra"] = extra
    payload = tree_map(
        lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x,
        payload)
    path = ckpt_dir / f"step_{step}.pt"
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    logger.info("saved checkpoint step %d to %s", step, ckpt_dir)


def latest_step(ckpt_dir: str | Path) -> int | None:
    steps = [int(m.group(1)) for p in Path(ckpt_dir).glob("step_*.pt")
             if (m := _NAME.search(p.name))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str | Path, template=None,
                       step: int | None = None):
    """Restore the latest (or given) step: (step, payload). `template` is
    a tree of the expected structure (e.g. {'params': ..., 'opt_state':
    ...}); when given, restored tensors adopt its devices and dtypes."""
    ckpt_dir = Path(ckpt_dir).absolute()
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    restored = torch.load(ckpt_dir / f"step_{step}.pt", map_location="cpu",
                          weights_only=False)
    if template is not None:
        restored = tree_map(
            lambda t, r: r.to(device=t.device, dtype=t.dtype)
            if isinstance(t, torch.Tensor) else r, template, restored)
    logger.info("restored checkpoint step %d from %s", step, ckpt_dir)
    return step, restored
