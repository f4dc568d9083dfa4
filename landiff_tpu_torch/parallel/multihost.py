"""Multi-process launch (counterpart of landiff_tpu/parallel/multihost.py).

`mesh.make_mesh` starts a mesh from one process, which spawns the other
ranks and sends them commands. This module serves the other launch: one
process per rank, each started from outside by a launcher (torchrun, a
cluster's job script, a shell loop) through MASTER_ADDR / MASTER_PORT /
RANK / WORLD_SIZE / LOCAL_RANK, every process running the same program,
as JAX runs one SPMD program in every process:

    from landiff_tpu_torch.config import MeshConfig
    from landiff_tpu_torch.parallel import multihost
    from landiff_tpu_torch.training.mesh_train import MeshTrainer

    multihost.initialize()              # the rendezvous, from the env
    mesh = multihost.global_mesh(MeshConfig(data=2, model=4))
    trainer = MeshTrainer(mesh, "dit", cfg, opt_kw, dtype, state, frozen)
    metrics = trainer.step(multihost.make_global_batch(rows, mesh), seed)

`initialize` joins a TCPStore at the coordinator (process 0 serves it)
and publishes this process's host and device there; `global_mesh` then
returns a `mesh.ProcessMesh`, this process's rank of the mesh, behind
Mesh's `run` / `close`: every rank function of the port (mesh_train's,
tp_infer's, ...) runs there unchanged, and `mesh.load` stores this
process's own shard. JAX runs one process per host, driving all of its
devices; here a process drives one device, so a host runs as many
processes as it has GPUs.

Ranks are numbered node-major, so that a node holds whole `model x time`
groups and only the `data` collectives (the gradients' all-reduce, the
batch's gather) cross nodes: JAX carves the DCN dimension out of `data`
(:133-144). Ranks that share one GPU (NCCL refuses them) run gloo, which
takes CUDA tensors but for a shift's send and receive, staged through
host memory; ranks with a GPU each run NCCL. `train(mesh_spec=)`,
`MeshTrainer` and the tp_infer rank functions take the mesh; the
pipeline wrappers, which drive their ranks from one process, refuse it.

In one process (no coordinator in the arguments or the environment)
everything degrades: `initialize` returns False and opens no socket,
`global_mesh` is `mesh.make_mesh`, `make_global_batch` places the batch
on the rank's device.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from landiff_tpu_torch.config import MeshConfig
from landiff_tpu_torch.parallel import mesh as mesh_lib

logger = logging.getLogger("landiff_tpu_torch.multihost")

# env hints of a coordinated multi-process launch, first found wins; a
# MASTER_ADDR counts only beside RANK and WORLD_SIZE (JAX :30-33)
_ENV_COORD = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
              "MASTER_ADDR")
DEFAULT_PORT = 29500

# the world after a rendezvous: store, rank, size, and per rank its
# devices / places / hosts; empty in a single-process run
_WORLD: dict = {}


class RendezvousError(RuntimeError):
    """The processes did not all meet at the coordinator in time."""


def _from_env(address, n, rank):
    """(coordinator "host:port", number of processes, process id), each
    from the arguments where given, else from the environment."""
    if address is None:
        for k in _ENV_COORD:
            if not os.environ.get(k):
                continue
            if k == "MASTER_ADDR" and not (os.environ.get("RANK")
                                           and os.environ.get("WORLD_SIZE")):
                # a stray MASTER_ADDR (leaked from a launcher's shell)
                # is not a launch: honouring it would block this run
                continue
            address = os.environ[k]
            if ":" not in address:
                port = os.environ.get("MASTER_PORT", str(DEFAULT_PORT))
                address = f"{address}:{port}"
            break
    if n is None:
        for k in ("NUM_PROCESSES", "WORLD_SIZE"):
            if os.environ.get(k):
                n = int(os.environ[k])
                break
    if rank is None:
        for k in ("PROCESS_ID", "RANK"):
            if os.environ.get(k):
                rank = int(os.environ[k])
                break
    return address, n, rank


def _local_device(device, local_device_ids) -> str:
    """This process's device: cpu only when asked for; else cuda:i with
    i from `device`, local_device_ids[0] or LOCAL_RANK (default 0)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"multihost: device {device!r} is neither cuda "
                         "nor cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("multihost.initialize: no CUDA device in this "
                           "process; pass device='cpu' to run its rank on "
                           "the CPU")
    if dev.index is not None:
        idx = dev.index
    elif local_device_ids:
        idx = int(list(local_device_ids)[0])
    else:
        idx = int(os.environ.get("LOCAL_RANK", "0"))
    if idx >= torch.cuda.device_count():
        raise ValueError(f"multihost: cuda:{idx} asked for, "
                         f"{torch.cuda.device_count()} visible")
    return f"cuda:{idx}"


def _place(device: str, host: str) -> str:
    """Where a device is, across processes: a GPU's UUID, else the host."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"gpu:{torch.cuda.get_device_properties(dev.index).uuid}"
    return f"host:{host}"


def _route_address(host: str) -> str:
    """This machine's address on its route to `host` (a UDP socket's
    connect picks the route and sends nothing)."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.connect((host, 9))
        return s.getsockname()[0]


def _gloo_device(hosts, coordinator_host: str) -> dict:
    """Where gloo binds: 127.0.0.1 when every rank is on this host; else
    GLOO_SOCKET_IFNAME's interface where it is set, else the address the
    rendezvous runs on."""
    if len(set(hosts)) == 1:
        return dict(mesh_lib.LOCAL_GLOO)
    if os.environ.get("GLOO_SOCKET_IFNAME"):
        return {"interface": os.environ["GLOO_SOCKET_IFNAME"].split(",")[0]}
    return {"hostname": _route_address(coordinator_host)}


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, local_device_ids=None,
               device="cuda", timeout_s: float = 300.0) -> bool:
    """Rendezvous if this is (or is declared as) a multi-process launch;
    idempotent. Returns True iff running multi-process afterwards.

    Explicit arguments win; otherwise JAX_COORDINATOR_ADDRESS /
    COORDINATOR_ADDRESS / MASTER_ADDR (+ MASTER_PORT, default 29500) and
    NUM_PROCESSES / WORLD_SIZE, PROCESS_ID / RANK. Without a coordinator
    it returns False and opens no socket. Otherwise every process joins
    a TCPStore at the coordinator (process 0 serves it) and publishes its
    host and device: cuda:LOCAL_RANK (or local_device_ids[0]) by default,
    the CPU only for device="cpu"; without a GPU it raises. A process
    that does not arrive within timeout_s fails the others with a
    RendezvousError naming the address."""
    if _WORLD:
        return _WORLD["size"] > 1
    address, n, rank = _from_env(coordinator_address, num_processes,
                                 process_id)
    if address is None:
        return False
    missing = [what for what, v in (
        ("number of processes (NUM_PROCESSES / WORLD_SIZE)", n),
        ("process id (PROCESS_ID / RANK)", rank)) if v is None]
    if missing:
        raise ValueError(f"multihost.initialize: coordinator {address} "
                         f"but no {' and no '.join(missing)}")
    if not 0 <= rank < n:
        raise ValueError(f"multihost.initialize: process id {rank} outside "
                         f"a world of {n}")
    dev = _local_device(device, local_device_ids)
    host, port = address.rsplit(":", 1)
    me = socket.gethostname()
    record = {"host": me, "device": dev, "place": _place(dev, me)}
    keys = [f"landiff/rank/{r}" for r in range(n)]
    try:
        store = dist.TCPStore(host, int(port), n, rank == 0,
                              timeout=datetime.timedelta(seconds=timeout_s),
                              wait_for_workers=False)
        store.set(keys[rank], json.dumps(record))
        store.wait(keys)
        peers = [json.loads(store.get(k)) for k in keys]
    except RuntimeError as e:
        raise RendezvousError(
            f"multihost: process {rank} of {n} did not meet every process "
            f"at {address} within {timeout_s:g} s: {e}") from e
    _WORLD.update(
        store=store, rank=rank, size=n, address=address,
        devices=[p["device"] for p in peers],
        places=[p["place"] for p in peers],
        hosts=[p["host"] for p in peers], meshes=0, barriers={})
    logger.info("multihost: process %d/%d on %s %s, coordinator %s", rank,
                n, me, dev, address)
    return n > 1


def is_primary() -> bool:
    return _WORLD.get("rank", 0) == 0


def barrier(name: str = "landiff_barrier"):
    """Block until every process reaches this point (a counter in the
    store per name and pass; fails at the store's timeout)."""
    if _WORLD.get("size", 1) == 1:
        return
    store = _WORLD["store"]
    n = _WORLD["barriers"][name] = _WORLD["barriers"].get(name, 0) + 1
    key = f"landiff/barrier/{name}/{n}"
    if store.add(key, 1) == _WORLD["size"]:
        store.set(key + "/open", "1")
    store.wait([key + "/open"])


def check_nodes(cfg: MeshConfig, hosts) -> None:
    """Raise unless every host's ranks are consecutive and hold whole
    `model x time` groups (JAX's assert that data divides over slices):
    then only `data` collectives cross hosts."""
    runs = []
    for h in hosts:
        if runs and runs[-1][0] == h:
            runs[-1][1] += 1
        else:
            runs.append([h, 1])
    group = cfg.model * cfg.time
    if len({h for h, _ in runs}) != len(runs):
        raise ValueError(f"mesh {cfg}: a host's ranks are not consecutive "
                         f"({[tuple(r) for r in runs]}); number the ranks "
                         "node-major")
    split = [tuple(r) for r in runs if r[1] % group]
    if split:
        raise ValueError(
            f"mesh {cfg}: hosts {split} split a model x time group of "
            f"{group} ranks; every host must hold whole groups, so that "
            "only the data axis crosses hosts")


def global_mesh(cfg: MeshConfig | None = None, devices=None,
                timeout_s: float = 300.0):
    """The mesh over every process's device. In one process it is
    make_mesh(cfg, devices) (default: every visible GPU on `data`, as
    JAX). After a multi-process initialize, this process's rank of `cfg`
    (default: every process on `data`) as a mesh.ProcessMesh; cfg must
    hold one rank per process, laid out as check_nodes asks."""
    if _WORLD.get("size", 1) == 1:
        if devices is None:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if cfg is None:
            cfg = MeshConfig(data=len(devices), model=1)
        return mesh_lib.make_mesh(cfg, devices, timeout_s)
    if devices is not None:
        raise ValueError("multihost.global_mesh: each process's device is "
                         "the one initialize published")
    n = _WORLD["size"]
    cfg = cfg or MeshConfig(data=n, model=1)
    if cfg.num_devices != n:
        raise ValueError(f"mesh {cfg} needs {cfg.num_devices} ranks, "
                         f"{n} processes joined")
    check_nodes(cfg, _WORLD["hosts"])
    # every process builds its meshes in the same order: the count names
    # this mesh's groups in the store
    _WORLD["meshes"] += 1
    store = dist.PrefixStore(f"landiff/mesh{_WORLD['meshes']}/",
                             _WORLD["store"])
    return mesh_lib.ProcessMesh(
        cfg, _WORLD["devices"], _WORLD["rank"], store, timeout_s,
        places=_WORLD["places"],
        gloo_device=_gloo_device(_WORLD["hosts"],
                                 _WORLD["address"].rsplit(":", 1)[0]))


def make_global_batch(batch, mesh):
    """The global batch from each process's rows (JAX :146-155): a tree
    of tensors (or arrays), this process's rows of the `data` axis. In a
    ProcessMesh the rows of every data index are gathered in rank order,
    on this rank's device; in one process the tree is placed on rank 0's
    device, values unchanged."""
    ctx = mesh.ctx

    def leaf(path, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if not isinstance(x, torch.Tensor):
            return x
        x = x.to(ctx.device)
        if isinstance(mesh, mesh_lib.ProcessMesh):
            return ctx.data_group.all_gather(x, dim=0)
        return x

    return mesh_lib.map_with_path(leaf, batch)
