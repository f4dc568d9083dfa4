"""PyTorch port: the multi-process launch (landiff_tpu_torch/parallel/
multihost.py), its quick tests, on the CPU: JAX tests/test_multihost.py's
environment tests and single-process degradation, then what the port
needs beyond JAX: devices told apart by host, the node layout, a missing
peer, no GPU, a ProcessMesh's shards and stored trees (two ranks in two
threads of this process), and the entry points that take or refuse a
ProcessMesh. The two-process runs held against JAX are in
test_torch_port_multihost_launch.py.

Tolerance: the two-rank ProcessMesh's model call within 2e-4 of the
unsharded call (test_torch_port_tp.py's model-call tolerance)."""

import socket
import threading
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.models import dit as tdit
from landiff_tpu_torch.parallel import mesh as tmesh
from landiff_tpu_torch.parallel import multihost
from landiff_tpu_torch.parallel import tp_infer as ttp
from landiff_tpu_torch.pipeline import infer_video
from landiff_tpu_torch.training import train as ttrain
from landiff_tpu_torch.utils import fill_zero_leaves, tree_leaves

torch.set_num_threads(2)   # tier-1 runs six xdist workers

TC = tcfg.tiny_test_config()
ENV_KEYS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "MASTER_ADDR",
            "MASTER_PORT", "RANK", "WORLD_SIZE", "NUM_PROCESSES",
            "PROCESS_ID", "LOCAL_RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert not multihost._WORLD
    return monkeypatch


class _NoSocket(Exception):
    pass


def _store_spy(captured):
    def fake(host, port, world_size, is_master, **kw):
        captured.update(host=host, port=port, n=world_size,
                        master=is_master)
        raise _NoSocket()
    return fake


def test_initialize_noop_without_env(clean_env):
    clean_env.setattr(multihost.dist, "TCPStore", _store_spy({}))
    assert multihost.initialize() is False
    assert not multihost._WORLD and multihost.is_primary()
    multihost.barrier("alone")        # a no-op in one process


def test_stray_master_addr_is_ignored(clean_env):
    """A leaked MASTER_ADDR without RANK / WORLD_SIZE starts no
    rendezvous (it would block a single-process run)."""
    clean_env.setenv("MASTER_ADDR", "10.0.0.99")
    clean_env.setattr(multihost.dist, "TCPStore", _store_spy({}))
    assert multihost.initialize() is False


def test_master_addr_gets_default_port(clean_env):
    """MASTER_ADDR + RANK / WORLD_SIZE without MASTER_PORT: the store is
    sought at host:29500, rank 1 a client of a world of 2."""
    captured = {}
    clean_env.setenv("MASTER_ADDR", "10.0.0.7")
    clean_env.setenv("RANK", "1")
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setattr(multihost.dist, "TCPStore", _store_spy(captured))
    with pytest.raises(_NoSocket):
        multihost.initialize(device="cpu")
    assert captured == {"host": "10.0.0.7", "port": 29500, "n": 2,
                        "master": False}
    assert not multihost._WORLD


def test_global_mesh_single_process_is_make_mesh(clean_env):
    """Without a rendezvous global_mesh is make_mesh (JAX :131-132): the
    same cfg (every device on data by default), devices, rank
    coordinates and backend."""
    made, make_mesh = [], tmesh.make_mesh

    def spy(*a):
        made.append((a, make_mesh(*a)))
        return made[-1][1]

    clean_env.setattr(tmesh, "make_mesh", spy)
    mesh = multihost.global_mesh(devices=["cpu"] * 2, timeout_s=60)
    try:
        ranks = [(r["rank"], r["coords"], r["backend"], r["device"])
                 for r in mesh.run(ttp.rank_report)]
    finally:
        mesh.close()
    cfg = tcfg.MeshConfig(data=2, model=1)
    assert made == [((cfg, ["cpu"] * 2, 60), mesh)]
    assert (mesh.cfg, mesh.devices, mesh.backend) == \
        (cfg, ["cpu", "cpu"], "gloo")
    assert ranks == [(r, tmesh.rank_coords(cfg, r), "gloo", "cpu")
                     for r in range(2)]


def test_make_global_batch_single_process():
    mesh = tmesh.make_mesh(tcfg.MeshConfig(data=1, model=1),
                           devices=["cpu"])
    try:
        x = np.arange(32, dtype=np.float32).reshape(8, 4)
        y = torch.arange(8)
        out = multihost.make_global_batch({"x": x, "y": y, "n": 3}, mesh)
    finally:
        mesh.close()
    assert out["x"].device == mesh.ctx.device == out["y"].device
    np.testing.assert_array_equal(out["x"].numpy(), x)
    assert torch.equal(out["y"], y) and out["n"] == 3


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# what the port needs beyond JAX's tests


def test_backend_for_tells_hosts_apart(monkeypatch):
    """Two hosts each on cuda:0 are two GPUs (nccl); one device twice on
    one host is shared (gloo); the in-process lists are unchanged; gloo
    binds 127.0.0.1 only when every rank is on this host."""
    two = ["cuda:0", "cuda:0"]
    assert tmesh.backend_for(two, ["gpu:a", "gpu:b"]) == "nccl"
    assert tmesh.backend_for(two, ["host:n1", "host:n2"]) == "nccl"
    assert tmesh.backend_for(two, ["gpu:a", "gpu:a"]) == "gloo"
    assert tmesh.backend_for(two) == "gloo"
    assert tmesh.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert tmesh.backend_for(["cpu"] * 2) == "gloo"
    assert tmesh.backend_for(["cpu"] * 2, ["host:a", "host:b"]) == "gloo"
    monkeypatch.delenv("GLOO_SOCKET_IFNAME", raising=False)
    assert multihost._gloo_device(["n1", "n1"], "10.0.0.7") == \
        {"hostname": "127.0.0.1"}
    assert multihost._gloo_device(["n1", "n2"], "127.0.0.1") == \
        {"hostname": "127.0.0.1"}      # the route to the coordinator
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "eth1,eth2")
    assert multihost._gloo_device(["n1", "n2"], "10.0.0.7") == \
        {"interface": "eth1"}


def test_global_mesh_refuses_a_split_group(clean_env):
    """Every host must hold whole model x time groups, its ranks
    consecutive; global_mesh refuses other layouts before any group."""
    mt = tcfg.MeshConfig(data=2, model=2)
    multihost.check_nodes(mt, ["a", "a", "b", "b"])
    multihost.check_nodes(tcfg.MeshConfig(data=4), ["a", "b", "c", "d"])
    with pytest.raises(ValueError, match="split a model x time group"):
        multihost.check_nodes(tcfg.MeshConfig(model=4), ["a", "a", "b", "b"])
    with pytest.raises(ValueError, match="split a model x time group"):
        multihost.check_nodes(tcfg.MeshConfig(data=2, time=2),
                              ["a", "b", "b", "b"])
    with pytest.raises(ValueError, match="not consecutive"):
        multihost.check_nodes(mt, ["a", "b", "a", "b"])
    clean_env.setattr(multihost, "_WORLD", {
        "size": 4, "rank": 0, "hosts": ["a", "a", "b", "b"], "meshes": 0})
    with pytest.raises(ValueError, match="split a model x time group"):
        multihost.global_mesh(tcfg.MeshConfig(data=1, model=4))
    with pytest.raises(ValueError, match="needs 2 ranks"):
        multihost.global_mesh(tcfg.MeshConfig(model=2))
    assert multihost._WORLD["meshes"] == 0


def test_initialize_fails_without_its_peer(clean_env):
    """WORLD_SIZE 2 and nobody else: rank 0 fails at its timeout, naming
    the address; nothing is left initialized."""
    addr = f"127.0.0.1:{_free_port()}"
    t0 = time.monotonic()
    with pytest.raises(multihost.RendezvousError, match=addr):
        multihost.initialize(addr, 2, 0, device="cpu", timeout_s=2)
    assert time.monotonic() - t0 < 15
    assert not multihost._WORLD


def test_initialize_refuses_to_run_without_a_gpu(clean_env):
    """A launch with no GPU raises unless device="cpu" was asked for, as
    does a process id outside the world; neither opens a socket."""
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    clean_env.setattr(multihost.dist, "TCPStore", _store_spy({}))
    clean_env.setenv("MASTER_ADDR", "127.0.0.1")
    clean_env.setenv("RANK", "0")
    clean_env.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("127.0.0.1:1", 2, 0, device="cuda:0")
    with pytest.raises(_NoSocket):
        multihost.initialize(device="cpu")
    with pytest.raises(ValueError, match="outside a world of 2"):
        multihost.initialize("127.0.0.1:1", 2, 2, device="cpu")
    assert not multihost._WORLD


def test_store_places_the_callers_tree_on_its_rank():
    """mesh.load's store: the caller's tree kept as given where it lies on
    the rank's device, else moved there (a ProcessMesh rank given a tree
    built on another device); a worker's tree copied into its own
    memory."""
    tree = {"w": torch.ones(3), "n": 2}
    here = types.SimpleNamespace(caller=True, device=torch.device("cpu"),
                                 state={})
    tmesh._store(here, tree, "k", "p")
    assert here.state["k"]["p"]["w"] is tree["w"]
    away = types.SimpleNamespace(caller=True, device=torch.device("meta"),
                                 state={})
    tmesh._store(away, tree, "k", "p")
    assert away.state["k"]["p"]["w"].device.type == "meta"
    assert away.state["k"]["p"]["n"] == 2
    worker = types.SimpleNamespace(caller=False, device=torch.device("cpu"),
                                   state={})
    tmesh._store(worker, tree, "k", "p")
    got = worker.state["k"]["p"]["w"]
    assert torch.equal(got, tree["w"])
    assert got.data_ptr() != tree["w"].data_ptr()


def _dit_trees(seed=5):
    gen = torch.Generator().manual_seed(seed)
    return fill_zero_leaves({"main": tdit.init(gen, TC.dit),
                             "control": tdit.init(gen, TC.dit, control=True)},
                            gen)


@pytest.mark.parametrize("layout", ["model2", "time2"])
def test_shard_lists_skip_other_processes_ranks(layout):
    """The shard builders given mesh.shard_devices of a ProcessMesh (None
    for another process's rank) build this rank's part alone, equal to
    its part of the whole list; None elsewhere."""
    cfg = tcfg.MeshConfig(model=2) if layout == "model2" \
        else tcfg.MeshConfig(data=1, time=2)
    trees = _dit_trees()
    whole = ttp.dit_shards(trees["main"], TC.dit, cfg, ["cpu", "cpu"],
                           dtype=torch.float32)
    mine = ttp.dit_shards(trees["main"], TC.dit, cfg, [None, "cpu"],
                          dtype=torch.float32)
    assert mine[0] is None
    for a, b in zip(tree_leaves(mine[1]), tree_leaves(whole[1])):
        assert torch.equal(a, b)
    assert ttp.replicated({"w": torch.ones(2)}, ["cpu", None])[1] is None
    gen = torch.Generator().manual_seed(0)
    from landiff_tpu_torch.pipeline import llm_infer
    stage1 = llm_infer.init_params(gen, TC.llm, TC.t5)
    mt = tcfg.MeshConfig(model=2)
    for fn, params, c in ((ttp.t5_shards, stage1["t5"], TC.t5),
                          (ttp.lm_shards, stage1["lm"], TC.llm)):
        full = fn(params, c, mt, ["cpu", "cpu"])
        own = fn(params, c, mt, ["cpu", None])
        assert own[1] is None
        for a, b in zip(tree_leaves(own[0]), tree_leaves(full[0])):
            assert torch.equal(a, b)


def _cfg_batch(dc):
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(1, dc.latent_frames, dc.in_channels, dc.latent_height,
                    dc.latent_width, generator=gen)
    ctx = torch.randn(1, dc.text_length, dc.text_dim, generator=gen)
    sem = torch.randn(x.shape, generator=gen)
    return (torch.cat([x, x]), torch.tensor([421.0, 421.0]),
            torch.cat([torch.zeros_like(ctx), ctx]), torch.cat([sem, sem]))


def test_process_mesh_ranks_build_and_run_their_own_shards():
    """Two ranks of a model=2 ProcessMesh, one a thread of this process,
    meeting through one store: each builds only its shard
    (shard_devices), stores it, and runs the model call, whose output
    every rank returns, equal across ranks and within 2e-4 of the
    unsharded call; a command that raises closes the mesh."""
    cfg = tcfg.MeshConfig(model=2)
    store = dist.HashStore()
    trees = _dit_trees()
    x2, ts, c2, s2 = _cfg_batch(TC.dit)
    outs, errors = [None, None], []

    def rank(r):
        try:
            mesh = tmesh.ProcessMesh(cfg, ["cpu", "cpu"], r, store, 60)
            assert mesh.shard_devices == ["cpu" if i == r else None
                                          for i in range(2)]
            for k in ("main", "control"):
                shards = ttp.dit_shards(trees[k], TC.dit, cfg,
                                        mesh.shard_devices,
                                        dtype=torch.float32)
                tmesh.load(mesh, "mh", k, shards)
            outs[r] = mesh.run(ttp.model_call, "mh", x2, ts, c2, s2, TC.dit,
                               torch.float32)[0]
            with pytest.raises(tmesh.MeshError, match="ZeroDivisionError"):
                mesh.run(lambda ctx: 1 / 0)
            with pytest.raises(tmesh.MeshError, match="closed"):
                mesh.run(ttp.rank_report)
        except BaseException as e:          # noqa: BLE001 (re-raised)
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    assert torch.equal(outs[0], outs[1])
    with torch.inference_mode():
        want = tdit.control_warp_forward(trees["main"], trees["control"], x2,
                                         ts, c2, TC.dit, s2,
                                         compute_dtype=torch.float32)
    assert float(want.abs().max()) > 1e-2
    np.testing.assert_allclose(outs[0].numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_entry_points_take_or_refuse_a_process_mesh(tmp_path):
    """train takes a ProcessMesh as given (the caller keeps it); the
    pipeline wrappers, driven from one process, refuse it by name."""
    mesh = tmesh.ProcessMesh(tcfg.MeshConfig(data=1), ["cpu"], 0,
                             dist.HashStore())
    assert mesh.shard_devices == ["cpu"] and mesh.backend == "gloo"
    assert ttrain._train_mesh(mesh, torch.device("cpu")) == (mesh, False)
    with pytest.raises(TypeError, match="ProcessMesh"):
        tmesh.as_mesh(mesh, "cpu")
    with pytest.raises(TypeError, match="ProcessMesh"):
        infer_video.build_pipeline(TC, None, mesh=mesh, device="cpu")
    mesh.close()
