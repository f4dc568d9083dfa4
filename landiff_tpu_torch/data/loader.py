"""Training input pipeline (counterpart of landiff_tpu/data/loader.py):
a directory of .npz shards, each holding equally-keyed arrays; iteration
is DP-rank-aware (disjoint shard assignment), shuffled per epoch with a
seeded numpy rng (the same batches as the JAX loader for a seed), and
double-buffered onto the device by a background thread so host IO
overlaps the steps. On a training mesh every rank gets the global batch
and takes its rows by its `data` coordinate (`data_rows`).
"""

from __future__ import annotations

import logging
import queue
import threading
from pathlib import Path

import numpy as np
import torch

from landiff_tpu_torch.utils import tree_map

logger = logging.getLogger("landiff_tpu_torch.data")


class ShardedNpzDataset:
    """Directory of .npz shards -> batches of dict[str, np.ndarray]."""

    def __init__(self, root: str | Path, batch_size: int, *,
                 dp_rank: int = 0, dp_size: int = 1, seed: int = 0,
                 drop_remainder: bool = True):
        self.shards = sorted(Path(root).glob("*.npz"))
        assert self.shards, f"no .npz shards under {root}"
        self.batch_size = batch_size
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.seed = seed
        self.drop_remainder = drop_remainder

    def _epoch_shards(self, epoch: int):
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(len(self.shards))
        # disjoint per-rank assignment (round robin over the shuffled order)
        return [self.shards[i] for i in order[self.dp_rank::self.dp_size]]

    def iter_epoch(self, epoch: int = 0):
        rng = np.random.default_rng(self.seed * 7919 + epoch + self.dp_rank)
        buf: dict[str, list] = {}
        for shard in self._epoch_shards(epoch):
            with np.load(shard) as z:
                keys = list(z.keys())
                n = len(z[keys[0]])
                perm = rng.permutation(n)
                for k in keys:
                    buf.setdefault(k, []).extend(z[k][perm])
            while len(next(iter(buf.values()))) >= self.batch_size:
                batch = {k: np.stack(v[:self.batch_size])
                         for k, v in buf.items()}
                buf = {k: v[self.batch_size:] for k, v in buf.items()}
                yield batch
        if not self.drop_remainder and buf and len(
                next(iter(buf.values()))):
            yield {k: np.stack(v) for k, v in buf.items()}


def data_rows(batch_size: int, dp_rank: int, dp_size: int) -> slice:
    """The rows of a global batch that data rank `dp_rank` of `dp_size`
    takes (JAX's P("data") placement: equal consecutive blocks in rank
    order); the batch must split evenly."""
    if batch_size % dp_size:
        raise ValueError(f"a batch of {batch_size} does not split over "
                         f"data={dp_size}")
    n = batch_size // dp_size
    return slice(dp_rank * n, (dp_rank + 1) * n)


def prefetch_to_device(iterator, size: int = 2, device="cuda"):
    """Wrap a host batch iterator with a background thread that stages
    batches onto `device` (double buffering; IO overlaps compute). The
    thread is a daemon and ends with the iterator."""
    q: queue.Queue = queue.Queue(maxsize=size)
    _END = object()
    pin = torch.device(device).type == "cuda"

    def put(batch):
        def stage(x):
            t = torch.from_numpy(np.ascontiguousarray(x))
            return (t.pin_memory() if pin else t).to(device,
                                                     non_blocking=pin)

        q.put(tree_map(stage, batch))

    def worker():
        try:
            for batch in iterator:
                put(batch)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        yield item


def write_npz_shards(samples: dict[str, np.ndarray], out_dir: str | Path,
                     shard_size: int):
    """Helper to materialize a dataset into .npz shards."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = len(next(iter(samples.values())))
    for si, start in enumerate(range(0, n, shard_size)):
        sl = {k: v[start:start + shard_size] for k, v in samples.items()}
        np.savez_compressed(out_dir / f"shard_{si:05d}.npz", **sl)
    return sorted(out_dir.glob("*.npz"))
