"""PyTorch port: the multi-process launch (landiff_tpu_torch/parallel/
multihost.py) in two real processes on localhost, started as a launcher
starts them (MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE), each running
tests/_torch_port_multihost_worker.py on the CPU over gloo: JAX's
tests/test_multihost.py's two launched runs, held against JAX, and the
training loop (train.train) on a ProcessMesh. The processes start first
and meet while the test process runs the JAX side, whose inputs they
then read from a file. The quick tests of the module are in
test_torch_port_multihost.py.

Tolerances: the two processes' losses within 1e-6 of each other and
within 5e-6 of JAX's make_cond_train_step loss on the whole batch from
the same key (JAX test_multihost.py:121), as is the port's one-device
step; the TP denoise statistics of the two processes equal at rtol 1e-6,
and equal to JAX's own multihost_worker.tp_denoise_stats on a
data=1,model=2 JAX mesh at rtol 2e-5, atol 1e-6 (JAX :169); the training
loop's parameters after two steps within 2e-5 of the one-device loop's (the
lm mesh steps' tolerance in test_torch_port_train_mesh.py)."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from _torch_port_helpers import fast_jit, lm_cond_draws
from landiff_tpu import config as jcfg
from landiff_tpu.diffusion import schedule as jsched
from landiff_tpu.models import lm as jlm
from landiff_tpu.parallel import mesh as jmesh
from landiff_tpu.parallel import multihost as jmultihost
from landiff_tpu.parallel import tp_infer as jtp
from landiff_tpu.training import lm_train as jlt
from landiff_tpu_torch import bridge
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.training import lm_train as tlt
from landiff_tpu_torch.training import train as ttrain
from landiff_tpu_torch.utils import tree_leaves

import _torch_port_multihost_worker as worker

torch.set_num_threads(2)   # tier-1 runs six xdist workers

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(worker.__file__).resolve()
TC = tcfg.tiny_test_config()
ENV_KEYS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "MASTER_ADDR",
            "MASTER_PORT", "RANK", "WORLD_SIZE", "NUM_PROCESSES",
            "PROCESS_ID", "LOCAL_RANK")
# JAX test_multihost.py:134-150: the batch, the parameters' and the
# step's keys
LM_ROWS, LM_TEXT, LM_T5_DIM = 8, 3, 24


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start_workers(mode, data_dir):
    """Two launched processes of the worker, RANK 0 / 1 of WORLD_SIZE 2
    at 127.0.0.1:<free port>."""
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", LOCAL_RANK="0",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), str(WORKER.parent),
                    os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen(
        [sys.executable, str(WORKER), mode, str(data_dir)],
        env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]


def _kill(procs):
    for p in procs:
        p.kill()
        p.communicate()


def _run_beside(procs, fn):
    """fn() while the processes run; both killed if it raises."""
    try:
        return fn()
    except BaseException:
        _kill(procs)
        raise


def _collect(procs, timeout_s=120):
    """Each process's marked output lines by their first word (the last
    of each); a process still running at its timeout is killed with its
    peer."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    except subprocess.TimeoutExpired:
        _kill(procs)
        raise
    rows = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} failed:\n{out[-4000:]}"
        rows.append({ln.split(" ", 1)[0]: ln.split(" ", 1)[1]
                     for ln in out.splitlines()
                     if ln.split(" ", 1)[0] in ("LOSS", "STATS", "REPORT")})
    return rows


def _hand_over(blob, data_dir, name):
    torch.save(blob, data_dir / (name + ".tmp"))
    os.replace(data_dir / (name + ".tmp"), data_dir / name)


def _jax_lm_step(data_dir):
    """JAX's stage-1 step of test_multihost.py on its whole batch (its
    loss), and the processes' inputs: the same parameters bridged, the
    batch, and the step's dropout masks from PRNGKey(42)."""
    cfg = jcfg.tiny_test_config().llm
    params = jlm.init(jax.random.PRNGKey(0), cfg, t5_dim=LM_T5_DIM)
    opt = optax.adam(1e-3)
    micro = {"frames": cfg.frames_per_segment, "motion_score": 0.1}
    step = jlt.make_cond_train_step(opt, cfg, micro,
                                    cfg_drop_prob=worker.CFG_DROP)
    sched = jlm.build_schedule(cfg, 1 + 2 + LM_TEXT + 1,
                               cfg.frames_per_segment)
    rng = np.random.default_rng(0)
    t5 = rng.standard_normal((LM_ROWS, LM_TEXT, LM_T5_DIM)).astype(
        np.float32)
    codes = rng.integers(0, cfg.codebook_size,
                         (LM_ROWS, sched.num_visual)).astype(np.int32)
    key = jax.random.PRNGKey(42)
    args = (params, opt.init(params), jnp.asarray(t5), jnp.asarray(codes),
            key)
    loss = float(fast_jit(step, *args)(*args)[2])
    blob = {"params": bridge.to_torch(
                jax.tree_util.tree_map(np.asarray, params), device="cpu"),
            "t5_feats": torch.from_numpy(t5),
            "codes": torch.from_numpy(codes).long(),
            "draws": lm_cond_draws(key, LM_ROWS, TC.llm.micro_cond_keys)(
                worker.CFG_DROP)}
    _hand_over(blob, data_dir, worker.TRAIN_INPUTS)
    return loss, blob


def test_two_process_rendezvous_train_step(tmp_path):
    """A stage-1 train step on MeshConfig(data=2) over two launched
    processes, each passing its rows of the batch: both report the same
    loss, JAX's make_cond_train_step loss on the whole batch from the
    same parameters, batch and key (JAX test_multihost.py:125-150), as
    is the port's one-device step."""
    procs = _start_workers("train", tmp_path)
    want, blob = _run_beside(procs, lambda: _jax_lm_step(tmp_path))
    losses = [float(r["LOSS"]) for r in _collect(procs)]
    assert np.isfinite(losses).all()
    assert abs(losses[0] - losses[1]) < 1e-6, losses
    assert abs(losses[0] - want) < 5e-6, (want, losses)

    opt = ttrain.make_optimizer(**worker.OPT)
    step = tlt.make_cond_train_step(
        opt, TC.llm, {"frames": TC.llm.frames_per_segment,
                      "motion_score": 0.1}, cfg_drop_prob=worker.CFG_DROP)
    params = blob["params"]
    one = float(step(params, opt.init(params), blob["t5_feats"],
                     blob["codes"], blob["draws"])[2])
    assert abs(one - want) < 5e-6, (one, want)


def _jax_tp_denoise(monkeypatch, data_dir):
    """JAX's own tp_denoise_stats on a data=1,model=2 mesh over two of the
    eight virtual devices; the trees and inputs it used (read off
    make_tp_denoise_fn's and make_global_batch's arguments) handed to the
    processes."""
    import multihost_worker

    seen = {}
    make_fn = jtp.make_tp_denoise_fn
    global_batch = jmultihost.make_global_batch

    def spy_fn(params, mesh, d, sampler, tok, sem, ctx, uc, tokens, **kw):
        seen.update(params=params, ctx=ctx, tokens=tokens)
        return make_fn(params, mesh, d, sampler, tok, sem, ctx, uc, tokens,
                       **kw)

    def spy_batch(batch, sharding):
        seen["x"] = np.array(batch["x"])
        return global_batch(batch, sharding)

    monkeypatch.setattr(jtp, "make_tp_denoise_fn", spy_fn)
    monkeypatch.setattr(jmultihost, "make_global_batch", spy_batch)
    mesh = jmesh.make_mesh(jcfg.MeshConfig(data=1, model=2),
                           jax.devices()[:2])
    want = multihost_worker.tp_denoise_stats(mesh)
    tab = jsched.sampler_tables(jcfg.tiny_test_config().sampler)
    step = {k: float(tab[k][0]) for k in ("alpha", "timestep",
                                          "cfg_scale")}
    _hand_over({"params": bridge.to_torch(
                    jax.tree_util.tree_map(np.asarray, seen["params"]),
                    device="cpu"),
                "ctx": torch.from_numpy(np.array(seen["ctx"])),
                "tokens": torch.from_numpy(np.array(seen["tokens"])).long(),
                "x": torch.from_numpy(seen["x"]), "step": step},
               data_dir, worker.TP_INPUTS)
    return want


def test_two_process_tp_denoise_inference(tmp_path, monkeypatch):
    """The TP denoise on MeshConfig(model=2) over two launched processes
    (JAX's tp_denoise mode at model=2), each building only its own shard:
    equal statistics in both, equal to JAX's tp_denoise_stats on the
    same trees and inputs; per process gloo on the CPU and two
    all-reduces a layer."""
    procs = _start_workers("tp_denoise", tmp_path)
    want = _run_beside(procs, lambda: _jax_tp_denoise(monkeypatch, tmp_path))
    rows = _collect(procs)
    stats = [[float(v) for v in r["STATS"].split()] for r in rows]
    assert np.isfinite(stats).all(), stats
    np.testing.assert_allclose(stats[0], stats[1], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(stats[0], want, rtol=2e-5, atol=1e-6)
    layers = TC.dit.num_layers + TC.dit.control_layers
    for r, row in enumerate(rows):
        rep = json.loads(row["REPORT"])
        assert (rep["rank"], rep["backend"], rep["device"]) == \
            (r, "gloo", "cpu")
        assert rep["collectives"]["all_reduce"] == 2 * layers, rep


def test_two_process_train_loop(tmp_path):
    """train.train with mesh_spec=global_mesh(data=2) in two launched
    processes: the same last loss and parameters in both, those of the
    one-device loop on the same data and seed; rank 0 alone writes the
    checkpoint and the metrics (one line a step)."""
    ttrain.synthesize("lm", TC, 8, tmp_path / "d", shard_size=4)
    procs = _start_workers("train_loop", tmp_path)
    kw = {k: v for k, v in worker.loop_kw(tmp_path).items()
          if k not in ("ckpt_dir", "metrics_path")}
    ref, ref_last = _run_beside(
        procs, lambda: ttrain.train("lm", str(tmp_path / "d"), **kw))
    losses = [float(r["LOSS"]) for r in _collect(procs)]
    assert losses[0] == losses[1], losses
    assert abs(losses[0] - float(ref_last["loss"])) < 5e-6, \
        (losses, float(ref_last["loss"]))
    got = [torch.load(tmp_path / f"state{r}.pt") for r in range(2)]
    saved = torch.load(tmp_path / "ckpt" / f"step_{worker.TRAIN_STEPS}.pt",
                       weights_only=False)["params"]
    for a, b, c, w in zip(*(tree_leaves(t) for t in
                            (got[0], got[1], saved, ref[0]))):
        assert torch.equal(a, b) and torch.equal(a, c)
        torch.testing.assert_close(a, w, atol=2e-5, rtol=0)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == \
        [f"step_{worker.TRAIN_STEPS}.pt"]
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(ln)["step"] for ln in lines] == [1, 2]
