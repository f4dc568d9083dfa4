"""One launched process of tests/test_torch_port_multihost_launch.py: a
rank of the PyTorch port's mesh started from outside (MASTER_ADDR /
MASTER_PORT / RANK / WORLD_SIZE in the environment), on the CPU over
gloo. It imports no JAX: the JAX sides run in the test process, which
hands this one its inputs in a file.

Modes:
  train        - one stage-1 lm train step on MeshConfig(data=2) through
                 MeshTrainer from the parameters, the whole batch and the
                 dropout draws in <dir>/train.pt (JAX's, bridged), each
                 process passing its own rows of the batch to
                 make_global_batch; prints "LOSS <float>".
  train_loop   - train.train("lm", <dir>/d, mesh_spec=global_mesh(data=2))
                 for TRAIN_STEPS steps, checkpoint and metrics under
                 <dir>; saves the returned state to <dir>/state<rank>.pt
                 and prints "LOSS <float>".
  tp_denoise   - one call of the tiny-config denoise closure on
                 MeshConfig(model=2) (tp_infer.denoise_call) from the
                 trees and inputs in <dir>/tp_denoise.pt, this process
                 building only its own shard (mesh.shard_devices); prints
                 "STATS <mean> <mean |.|> <max |.|>" and "REPORT <json>".

The inputs' files are written once the test's JAX side has run; a
process waits for its file up to INPUT_WAIT_S.

Usage: python _torch_port_multihost_worker.py <mode> <dir>
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.parallel import mesh as mesh_lib
from landiff_tpu_torch.parallel import multihost
from landiff_tpu_torch.parallel import tp_infer
from landiff_tpu_torch.training import mesh_train
from landiff_tpu_torch.training import train as train_lib

OPT = {"lr": 1e-3, "steps": 1, "grad_accum": 1}
CFG_DROP = 0.5
TRAIN_INPUTS, TP_INPUTS = "train.pt", "tp_denoise.pt"
TRAIN_STEPS, TRAIN_BATCH = 2, 4
INPUT_WAIT_S = 300


def loop_kw(data_dir: Path) -> dict:
    """train.train's arguments of the train_loop mode, but the mesh."""
    return dict(steps=TRAIN_STEPS, batch_size=TRAIN_BATCH, lr=1e-3,
                log_every=1, tiny=True, device="cpu",
                ckpt_dir=str(data_dir / "ckpt"),
                metrics_path=str(data_dir / "metrics.jsonl"))


def _inputs(path: Path):
    deadline = time.monotonic() + INPUT_WAIT_S
    while not path.exists():
        assert time.monotonic() < deadline, f"no {path}"
        time.sleep(0.1)
    return torch.load(path, weights_only=False)


def train_mode(cfg, rank, n, data_dir):
    mesh = multihost.global_mesh(tcfg.MeshConfig(data=n))
    blob = _inputs(data_dir / TRAIN_INPUTS)
    whole = {"t5_feats": blob["t5_feats"], "codes": blob["codes"]}
    rows = len(whole["codes"]) // n
    batch = multihost.make_global_batch(
        {k: v[rank * rows:(rank + 1) * rows] for k, v in whole.items()},
        mesh)
    assert all(torch.equal(batch[k], whole[k]) for k in whole)
    multihost.barrier("batch_ready")
    opt = train_lib.make_optimizer(**OPT)
    params = blob["params"]
    trainer = mesh_train.MeshTrainer(
        mesh, "lm", cfg, OPT, torch.float32, (params, opt.init(params)),
        step_kw={"cfg_drop_prob": CFG_DROP})
    loss = float(trainer.step(batch, blob["draws"])["loss"])
    multihost.barrier("step_done")
    assert np.isfinite(loss)
    print(f"LOSS {loss:.9g}", flush=True)


def train_loop_mode(rank, n, data_dir):
    mesh = multihost.global_mesh(tcfg.MeshConfig(data=n))
    state, last = train_lib.train("lm", str(data_dir / "d"),
                                  mesh_spec=mesh, **loop_kw(data_dir))
    torch.save(state[0], data_dir / f"state{rank}.pt")
    multihost.barrier("train_done")
    mesh.close()
    print(f"LOSS {float(last['loss']):.9g}", flush=True)


def tp_denoise_mode(cfg, data_dir):
    mesh = multihost.global_mesh(tcfg.MeshConfig(model=2))
    blob = _inputs(data_dir / TP_INPUTS)
    params = blob["params"]
    for k in ("main", "control"):
        shards = tp_infer.dit_shards(params[k], cfg.dit, mesh.cfg,
                                     mesh.shard_devices, dtype=torch.float32)
        assert [s is None for s in shards] == \
            [r != mesh.rank for r in range(2)]
        mesh_lib.load(mesh, "mh", k, shards)
    mesh_lib.load(mesh, "mh", "semantic",
                  tp_infer.replicated(params["semantic"], mesh.shard_devices))
    # the initial noise, whole in every process
    x = multihost.make_global_batch({"x": blob["x"]}, mesh)["x"]
    mesh.run(tp_infer.rank_report, True)
    out = mesh.run(tp_infer.denoise_call, "mh", cfg, blob["ctx"],
                   torch.zeros_like(blob["ctx"]), blob["tokens"], x,
                   blob["step"], torch.float32)[0]
    report = mesh.run(tp_infer.rank_report, True)[0]
    multihost.barrier("denoise_done")
    mesh.close()
    stats = (out.mean(), out.abs().mean(), out.abs().max())
    print("STATS " + " ".join(f"{float(s):.9g}" for s in stats), flush=True)
    print("REPORT " + json.dumps(
        {k: report[k] for k in ("rank", "backend", "device", "launches",
                                "collectives")}), flush=True)


def main():
    mode, data_dir = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(2)     # tier-1 runs six pytest workers
    assert multihost.initialize(device="cpu", timeout_s=60)
    assert multihost.initialize()            # idempotent
    rank, n = multihost._WORLD["rank"], multihost._WORLD["size"]
    assert multihost.is_primary() == (rank == 0)
    cfg = tcfg.tiny_test_config()
    if mode == "train":
        train_mode(cfg, rank, n, data_dir)
    elif mode == "train_loop":
        train_loop_mode(rank, n, data_dir)
    else:
        tp_denoise_mode(cfg, data_dir)


if __name__ == "__main__":
    main()
