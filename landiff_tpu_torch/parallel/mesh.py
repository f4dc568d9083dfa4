"""Device mesh, sharding rules and the ranks that carry them (counterpart
of landiff_tpu/parallel/mesh.py).

JAX drives every device of a mesh from one process and lets GSPMD insert
the collectives. PyTorch needs a process per rank: `make_mesh` returns a
`Mesh` whose rank 0 is the calling process and whose other ranks are
worker processes it spawns (torch.multiprocessing, spawn). Rank 0 sends
one command per stage call (`Mesh.run`): every rank runs the same
function on its own shards, so every host decision is taken on values
that are the same on every rank, and the collectives inside go through
`Group`, which counts them per kind (`COLLECTIVES`, the counterpart of
tp_infer.count_hlo_collectives). A rank's weights reach it once, as its
shard (`load`).

Ranks are laid out data-major, then model, then time: rank = (d * model
+ m) * time + t, as JAX reshapes the device list to (data, model, time)
(`rank_coords`). The `model` groups (one per data and time index) carry
the Megatron all-reduces, the `data` groups (one per model and time
index) the gather of the CFG rows, the `time` groups (one per data and
model index) the ring shifts of sequence parallelism and the halos and
statistics of the context-parallel VAE (`Group.shift`, JAX's ppermute
to (i + 1) % n).

The backend follows from the layout alone: NCCL when every rank has a
CUDA device of its own; gloo when the ranks are on the CPU or share a
CUDA device (NCCL refuses two ranks on one device). A device is named by
where it is as well (`backend_for`'s places: a GPU's UUID, a host name),
so two hosts each on cuda:0 are two devices. On a shared CUDA
device the data of a collective stays on the device, in exchange
buffers every rank maps, ordered by interprocess CUDA events, and gloo
carries only a barrier on the host (`Group`): that is this layout's
collective. Its times are those of one
device time-sliced between processes and of host barriers, not of any
interconnect. Ranks launched one per process from outside
(parallel/multihost.py, `ProcessMesh`) have no spawner to hand them
those buffers: where they share a device, gloo carries the data too
(CUDA tensors as they are; a shift's send and receive, which gloo takes
only from host memory, staged through it).

Training: the differentiable collectives `copy_to` (Megatron's f),
`reduce_from` (g), `gather_from` and `ring_shift` carry a gradient
through a rank's own autograd graph; each rank differentiates the same
loss, so the backward of a gather is this rank's slice of the cotangent,
not a sum. DIT_RULES and TITOK_RULES are the trainer's sharding rules.

Failures: a worker that raises sends its traceback and exits, which
fails the collectives its peers wait in; a rank that stops answering
fails them at the process groups' timeout. Either way rank 0 stops every
worker and raises `MeshError`.
"""

from __future__ import annotations

import atexit
import datetime
import os
import queue
import re
import threading
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from landiff_tpu_torch.config import MeshConfig

def parse_mesh(spec: str | None) -> MeshConfig:
    """'data=2,model=4' or 'data=1,time=2' -> MeshConfig; None -> every
    visible GPU (one on a machine without) on `data`, as JAX puts every
    device there."""
    if not spec:
        return MeshConfig(data=max(torch.cuda.device_count(), 1), model=1)
    kv = dict(part.split("=") for part in spec.split(","))
    return MeshConfig(**{k: int(v) for k, v in kv.items()})


def make_mesh(cfg: MeshConfig | None = None, devices=None,
              timeout_s: float = 300.0) -> "Mesh":
    """The ranks of `cfg` (default: every device on `model`, as JAX),
    one per device of `devices`: by default one per visible GPU, and more
    ranks than GPUs are refused (JAX mesh.py:40). An explicit list may
    name one device several times (["cuda:0"] * 2, ["cpu"] * 4), the
    counterpart of JAX's virtual CPU devices."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if cfg is None:
        cfg = MeshConfig(data=1, model=len(devices), time=1)
    if cfg.num_devices > len(devices):
        raise ValueError(f"mesh {cfg} needs {cfg.num_devices} devices, "
                         f"{len(devices)} given")
    return Mesh(cfg, list(devices[:cfg.num_devices]), timeout_s)


def as_mesh(mesh, device="cuda") -> "Mesh | None":
    """A Mesh from a Mesh, a MeshConfig or a spec string, its ranks on
    `device`'s type: one per GPU for cuda, all on the CPU for cpu. A
    ProcessMesh is refused: the pipeline wrappers drive their ranks from
    one process."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    if isinstance(mesh, ProcessMesh):
        raise TypeError(
            "a ProcessMesh (multihost.global_mesh) runs training "
            "(train(mesh_spec=), MeshTrainer) and the tp_infer rank "
            "functions; the pipeline wrappers take a Mesh, a MeshConfig or "
            "a spec such as 'data=1,model=2'")
    cfg = mesh if isinstance(mesh, MeshConfig) else parse_mesh(mesh)
    if torch.device(device).type == "cpu":
        return make_mesh(cfg, devices=["cpu"] * cfg.num_devices)
    return make_mesh(cfg)


# ---------------------------------------------------------------------------
# parameter sharding rules: (path regex, spec) lists, first match wins,
# default replicated; a spec names the mesh axis of each dimension. Paths
# are '/'-joined keys. Megatron: column-parallel on the out-features of
# the first matrix of a pair, row-parallel on the in-features of the
# second -> one all-reduce per pair.

DIT_RULES = [
    (r".*\bqkv_w$", (None, "model")),
    (r".*\bqkv_b$", ("model",)),
    (r".*attn_out_w$", ("model", None)),
    (r".*mlp0_w$", (None, "model")),
    (r".*mlp0_b$", ("model",)),
    (r".*mlp1_w$", ("model", None)),
    (r".*zero_linear_w$", (None, "model")),
]

GPT_RULES = [
    (r".*\bwqkv$", (None, "model")),
    (r".*\bwo$", ("model", None)),
    (r".*\bw1$", (None, "model")),
    (r".*\bw3$", (None, "model")),
    (r".*\bw2$", ("model", None)),
    (r".*\bhead$", (None, "model")),
]

T5_RULES = [
    (r".*attn/q$", (None, "model")),
    (r".*attn/k$", (None, "model")),
    (r".*attn/v$", (None, "model")),
    (r".*attn/o$", ("model", None)),
    (r".*ff/wi_0$", (None, "model")),
    (r".*ff/wi_1$", (None, "model")),
    (r".*ff/wo$", ("model", None)),
]


TITOK_RULES = [
    (r".*\bwq$", (None, "model")),
    (r".*\bwk$", (None, "model")),
    (r".*\bwv$", (None, "model")),
    (r".*\bwo$", ("model", None)),
    (r".*fc0_w$", (None, "model")),
    (r".*fc1_w$", ("model", None)),
]


def map_with_path(fn, tree, *rest, path=()):
    """fn(path, leaf, *leaves of `rest` at the same place) over trees of
    dicts and lists; path is the tuple of keys (list indices as str)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, *(r[i] for r in rest),
                              path=path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def spec_for(path: str, rules) -> tuple:
    for pat, spec in rules:
        if re.match(pat, path):
            return spec
    return ()


def axis_sizes(cfg: MeshConfig) -> dict:
    return {"data": cfg.data, "model": cfg.model, "time": cfg.time}


def fit_spec(spec: tuple, shape, cfg: MeshConfig | None) -> tuple:
    """Drop the axes that do not divide their dimension (vocab 2,055 over
    model=2): that dimension stays replicated (JAX mesh.py:110)."""
    if cfg is None or not any(spec):
        return spec
    sizes = axis_sizes(cfg)
    return tuple(ax if ax is not None and d < len(shape)
                 and shape[d] % sizes[ax] == 0 else None
                 for d, ax in enumerate(spec))


def param_specs(params, rules, cfg: MeshConfig | None = None):
    """The spec tree of `params` (JAX mesh.py:126). int8 {q, s} leaves
    inherit their base weight's rule: q as the weight, s as the weight
    without its first (contracted) dim; a rule matching the whole path
    (T5's attn/q) wins."""
    def spec(path, x):
        s = spec_for("/".join(path), rules)
        if not any(s) and path and path[-1] in ("q", "s"):
            base = spec_for("/".join(path[:-1]), rules)
            s = base if path[-1] == "q" else tuple(base[1:])
        return fit_spec(s, tuple(getattr(x, "shape", ())), cfg)

    return map_with_path(spec, params)


AXES = ("data", "model", "time")


def rank_coords(cfg: MeshConfig, rank: int) -> dict:
    return {"data": rank // (cfg.model * cfg.time),
            "model": rank // cfg.time % cfg.model, "time": rank % cfg.time}


def coords_rank(cfg: MeshConfig, coords: dict) -> int:
    return (coords["data"] * cfg.model + coords["model"]) * cfg.time \
        + coords["time"]


def group_members(cfg: MeshConfig, rank: int, axis: str) -> list:
    """The global ranks of `rank`'s group along `axis` (the ranks that
    share its other coordinates), in the order of their coordinate on
    `axis`: the group's member order."""
    c = rank_coords(cfg, rank)
    return [coords_rank(cfg, {**c, axis: j})
            for j in range(axis_sizes(cfg)[axis])]


def shard_for_rank(tree, specs, cfg: MeshConfig, rank: int):
    """Each leaf's part for `rank` (views): along every dimension with an
    axis, the rank's equal part by its coordinate on that axis."""
    coords, sizes = rank_coords(cfg, rank), axis_sizes(cfg)

    def cut(path, x, spec):
        for d, ax in enumerate(spec):
            if ax is not None:
                n = x.shape[d] // sizes[ax]
                x = x.narrow(d, coords[ax] * n, n)
        return x

    return map_with_path(cut, tree, specs)


def tree_nbytes(tree) -> int:
    """Bytes of the tensor leaves of a tree."""
    out = []
    map_with_path(lambda p, x: out.append(x.numel() * x.element_size())
                  if isinstance(x, torch.Tensor) else None, tree)
    return sum(out)


def backend_for(devices, places=None) -> str:
    """nccl iff every rank has a CUDA device of its own, else gloo.
    places[r]: where rank r's device is (a GPU's UUID, a host name), for
    ranks of several processes or hosts; by default every device is in
    this process's host."""
    devs = [torch.device(d) for d in devices]
    places = [None] * len(devs) if places is None else list(places)
    own = len({(p, d.type, d.index) for p, d in zip(places, devs)}) \
        == len(devs)
    cuda = all(d.type == "cuda" and d.index is not None for d in devs)
    return "nccl" if own and cuda else "gloo"


# ---------------------------------------------------------------------------
# collectives

COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "ring_shift": 0}

# elements of one rank's f32 exchange buffer on a shared CUDA device (64
# MB); a longer tensor goes over in parts
SHARED_CAPACITY = 1 << 24


def reset_collective_counts():
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


class Group:
    """The ranks of one mesh axis at one coordinate of the others. Each
    collective adds one to COLLECTIVES[kind] where it runs; in a group of
    one rank it is the identity and counts nothing. (No broadcast: a
    command hands every rank its inputs.)

    On a shared CUDA device (`bufs`: two sets of one f32 buffer per
    member, every member mapping all of them) a collective runs on the
    device and the host never waits for it: each member writes its values
    into its own buffer of the current set and records an interprocess
    event; the members meet at a gloo barrier on the host, which orders
    every record before every wait; each member's stream waits for the
    others' events and reads the buffers it needs (a sum in rank order:
    the same bits on every rank; for 16-bit tensors an f32 sum, rounded
    once), then records that it has read the set. The sets alternate:
    before a member writes a set again, two parts later, its stream waits
    for every member's read of it, recorded before the barrier of the part
    between. A tensor longer than SHARED_CAPACITY goes over in parts."""

    def __init__(self, pg, size: int, rank: int, stage: bool = False):
        self.pg, self.size, self.rank = pg, size, rank
        # gloo between ranks on one CUDA device without exchange buffers:
        # gloo's all-reduce and all-gather take CUDA tensors, its send and
        # receive do not ("Bad address"), so a shift goes through host
        # memory
        self.stage = stage
        self.bufs = None
        self._turn = 0
        self._flag = torch.zeros(1)

    def make_events(self) -> dict:
        """This member's interprocess events, (set, "written" | "read")
        -> IPC handle, for open_events on every member."""
        self._mine = {(t, k): torch.cuda.Event(interprocess=True)
                      for t in (0, 1) for k in ("written", "read")}
        return {key: ev.ipc_handle() for key, ev in self._mine.items()}

    def open_events(self, handles: list):
        """handles: every member's make_events(), in member order."""
        dev = torch.cuda.current_device()
        self.events = {key: [
            self._mine[key] if j == self.rank
            else torch.cuda.Event.from_ipc_handle(dev, h[key])
            for j, h in enumerate(handles)] for key in self._mine}

    def _exchange(self, flat: torch.Tensor, combine):
        """combine(every member's f32 copy of `flat`, at most
        SHARED_CAPACITY elements, in rank order), enqueued once every
        member's copy is in its buffer; what combine returns must not be
        a view of the buffers."""
        turn = self._turn
        self._turn ^= 1
        stream = torch.cuda.current_stream()

        def wait(kind):
            for j, ev in enumerate(self.events[(turn, kind)]):
                if j != self.rank:
                    stream.wait_event(ev)

        bufs = self.bufs[turn]
        n = flat.numel()
        wait("read")
        bufs[self.rank][:n].copy_(flat)
        self.events[(turn, "written")][self.rank].record(stream)
        self.pg.allreduce([self._flag]).wait()
        wait("written")
        out = combine([b[:n] for b in bufs])
        self.events[(turn, "read")][self.rank].record(stream)
        return out

    def _parts(self, flat: torch.Tensor):
        for i in range(0, flat.numel(), SHARED_CAPACITY):
            yield i, flat[i:i + SHARED_CAPACITY]

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the group, in t's dtype, equal on every rank;
        returns it (t itself when t is contiguous)."""
        if self.size == 1:
            return t
        COLLECTIVES["all_reduce"] += 1
        t = t.contiguous()
        if self.bufs is None:
            self.pg.allreduce([t]).wait()
            return t

        def add(parts):
            total = parts[0].clone()
            for p in parts[1:]:
                total += p
            return total

        for _, part in self._parts(t.view(-1)):
            part.copy_(self._exchange(part, add))
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's t, concatenated along `dim` in rank order."""
        if self.size == 1:
            return t
        COLLECTIVES["all_gather"] += 1
        t = t.contiguous()
        if self.bufs is None:
            parts = [torch.empty_like(t) for _ in range(self.size)]
            self.pg.allgather([parts], [t]).wait()
            return torch.cat(parts, dim)
        flat = t.view(-1)
        rows = torch.empty((self.size, flat.numel()), dtype=t.dtype,
                           device=t.device)

        def gather(i):
            def copy(parts):
                for j, p in enumerate(parts):
                    rows[j, i:i + p.numel()].copy_(p)
            return copy

        for i, part in self._parts(flat):
            self._exchange(part, gather(i))
        return torch.cat([r.view(t.shape) for r in rows], dim)

    def shift(self, t: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        """The ring shift (JAX's ppermute to (i + 1) % n): each member
        sends t to the next member and returns the previous member's t;
        reverse: to the previous one, returning the next one's.
        Through gloo or NCCL as a send and a receive, even members sending
        first and odd ones receiving first (the mesh's process groups are
        not registered with torch.distributed, so dist.batch_isend_irecv
        cannot coalesce them, and NCCL would otherwise deadlock on a pair
        of ranks whose sends wait for each other's receives); on a shared
        device through the exchange buffers, each member reading its
        predecessor's."""
        if self.size == 1:
            return t
        COLLECTIVES["ring_shift"] += 1
        t = t.contiguous()
        out = torch.empty_like(t)
        step = -1 if reverse else 1
        src = (self.rank - step) % self.size
        dst = (self.rank + step) % self.size
        if self.bufs is None:
            staged = self.stage and t.is_cuda
            sent, got = (t.cpu(), torch.empty_like(out, device="cpu")) \
                if staged else (t, out)
            send = lambda: self.pg.send([sent], dst, 0).wait()
            recv = lambda: self.pg.recv([got], src, 0).wait()
            for op in ((send, recv) if self.rank % 2 == 0
                       else (recv, send)):
                op()
            return out.copy_(got) if staged else out
        flat = out.view(-1)
        for i, part in self._parts(t.view(-1)):
            self._exchange(part, lambda parts, i=i: flat[
                i:i + parts[src].numel()].copy_(parts[src]))
        return out


class _CopyTo(torch.autograd.Function):
    """Megatron's f: the identity forward, an all-reduce backward."""

    @staticmethod
    def forward(fctx, x, group):
        fctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return fctx.group.all_reduce(g.clone()), None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: an all-reduce forward, the identity backward."""

    @staticmethod
    def forward(fctx, x, group):
        return group.all_reduce(x.clone())

    @staticmethod
    def backward(fctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """An all-gather along `dim` forward; the backward is this rank's
    slice of the cotangent: every rank differentiates the same loss, so
    each already holds the whole cotangent."""

    @staticmethod
    def forward(fctx, x, group, dim):
        fctx.group, fctx.dim, fctx.n = group, dim, x.shape[dim]
        return group.all_gather(x, dim)

    @staticmethod
    def backward(fctx, g):
        return g.narrow(fctx.dim, fctx.group.rank * fctx.n, fctx.n), None, \
            None


class _RingShift(torch.autograd.Function):
    """The ring shift forward, the reverse shift backward."""

    @staticmethod
    def forward(fctx, x, group):
        fctx.group = group
        return group.shift(x)

    @staticmethod
    def backward(fctx, g):
        return fctx.group.shift(g, reverse=True), None


def _needs_grad(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to(group: "Group | None", x: torch.Tensor) -> torch.Tensor:
    """Enter a tensor-parallel region (Megatron's f): x, whose gradient is
    summed over `group` in the backward. The input of a column-parallel
    product, and a replicated parameter used on this rank's heads alone."""
    if group is None or group.size == 1 or not _needs_grad(x):
        return x
    return _CopyTo.apply(x, group)


def reduce_from(group: "Group | None", x: torch.Tensor) -> torch.Tensor:
    """Leave a tensor-parallel region (Megatron's g): the sum over `group`
    (one all-reduce, as Group.all_reduce), its gradient passed through."""
    if group is None or group.size == 1:
        return x
    if not _needs_grad(x):
        return group.all_reduce(x)
    return _ReduceFrom.apply(x, group)


def gather_from(group: "Group | None", x: torch.Tensor,
                dim: int) -> torch.Tensor:
    """Every member's x concatenated along `dim` (Group.all_gather); the
    gradient of this rank's part is its slice of the cotangent."""
    if group is None or group.size == 1:
        return x
    if not _needs_grad(x):
        return group.all_gather(x, dim)
    return _GatherFrom.apply(x, group, dim)


def ring_shift(group: "Group | None", x: torch.Tensor) -> torch.Tensor:
    """Group.shift with a gradient: the cotangent goes the reverse way."""
    if group is None or group.size == 1:
        return x
    if not _needs_grad(x):
        return group.shift(x)
    return _RingShift.apply(x, group)


def collective_vjp(ctx, inputs, kind: str, axis: str):
    """One differentiable collective on this rank's group along `axis`
    (a command: Mesh.run(collective_vjp, kind, axis, per_rank=[(x, cot)
    of each rank])): (its output, the gradient of sum(output * cot) with
    respect to x), rank 0's pair (CPU tensors) or None. kind: copy_to,
    reduce_from, gather_from (along the last dim) or ring_shift."""
    x, cot = inputs
    group = ctx.groups[axis]
    x = to_rank(ctx, x, copy=True).requires_grad_(True)
    fn = {"copy_to": copy_to, "reduce_from": reduce_from,
          "ring_shift": ring_shift,
          "gather_from": lambda g, t: gather_from(g, t, -1)}[kind]
    y = fn(group, x)
    (g,) = torch.autograd.grad(y, x, to_rank(ctx, cot))
    return (y.detach().cpu(), g.cpu()) if ctx.caller else None


def reduce_grads(grads, groups):
    """A gradient tree summed over each Group of `groups` (the ranks that
    split the batch or the tokens), leaf by leaf."""
    for group in groups:
        if group is not None and group.size > 1:
            grads = map_with_path(lambda path, g: group.all_reduce(g), grads)
    return grads


# where gloo binds when every rank is on this host
LOCAL_GLOO = {"hostname": "127.0.0.1"}


def _process_group(store, prefix: str, rank: int, size: int, backend: str,
                   timeout_s: float, gloo_device: dict = LOCAL_GLOO):
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.PrefixStore(prefix, store)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = timeout
    opts._devices = [dist.ProcessGroupGloo.create_device(**gloo_device)]
    return dist.ProcessGroupGloo(store, rank, size, opts)


class RankContext:
    """One rank's view of the mesh: its coordinates, device, groups (one
    per axis, `groups[axis]`), and `state`, the trees its commands stored
    (weights, by key).

    store: the world's store (a spawned worker's, or multihost's
    rendezvous); devices: every rank's device, as that rank names it;
    places: where each is (backend_for); gloo_device: create_device's
    arguments (an address or an interface to bind); caller: whether the
    commands are called in this rank's process, which then gets their
    results (rank 0 of a spawned mesh, every rank of a ProcessMesh)."""

    def __init__(self, cfg: MeshConfig, devices, rank: int, store,
                 timeout_s: float, *, places=None,
                 gloo_device: dict = LOCAL_GLOO, caller: bool = False):
        self.cfg, self.rank = cfg, rank
        self.caller = caller
        self.coords = rank_coords(cfg, rank)
        self.device = torch.device(devices[rank])
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.backend = backend_for(devices, places)
        stage = self.backend == "gloo" and self.device.type == "cuda"
        # the global ranks of each group, in member order
        self.members = {axis: group_members(cfg, rank, axis)
                        for axis in AXES}
        self.groups = {}
        for axis in AXES:
            ranks = self.members[axis]
            # a group is named by the coordinates its members share
            name = ",".join(f"{a}{self.coords[a]}" for a in AXES
                            if a != axis)
            pg = None if len(ranks) == 1 else _process_group(
                store, f"{axis}/{name}/", ranks.index(rank), len(ranks),
                self.backend, timeout_s, gloo_device)
            self.groups[axis] = Group(pg, len(ranks), ranks.index(rank),
                                      stage)
        self.model_group = self.groups["model"]
        self.data_group = self.groups["data"]
        self.time_group = self.groups["time"]
        self.state: dict = {}

    def attach_buffers(self, axes, bufs: torch.Tensor) -> dict:
        """bufs (len(axes), 2, ranks, SHARED_CAPACITY) f32 on the shared
        device: the groups of axes[i] exchange through bufs[i], in two
        alternating sets, each member through the row of its global rank.
        Returns this rank's event handles per group."""
        for axis, b in zip(axes, bufs):
            self.groups[axis].bufs = [[s[r] for r in self.members[axis]]
                                      for s in b]
        return {axis: self.groups[axis].make_events() for axis in axes}

    def open_events(self, handles: list):
        """handles: every rank's attach_buffers() result, in rank order."""
        for axis in handles[self.rank]:
            self.groups[axis].open_events(
                [handles[r][axis] for r in self.members[axis]])


class MeshError(RuntimeError):
    """A rank of the mesh failed or stopped answering; the mesh is closed."""


class Mesh:
    """data x model x time ranks: rank 0 in this process, the others in
    worker processes stopped by close() and at exit. `run` executes one
    command on every rank, one command at a time."""

    def __init__(self, cfg: MeshConfig, devices, timeout_s: float = 300.0):
        self.cfg = cfg
        self.size = cfg.num_devices
        self.devices = [str(torch.device(d)) for d in devices]
        # the devices of the ranks whose shards this process builds
        # (tp_infer's shard lists): every rank's
        self.shard_devices = self.devices
        self.backend = backend_for(self.devices)
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._closed = False
        store = dist.TCPStore("127.0.0.1", 0, self.size, True,
                              timeout=datetime.timedelta(seconds=timeout_s),
                              wait_for_workers=False)
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._cmds, self._procs = [], []
        for r in range(1, self.size):
            q = ctx.Queue()
            p = ctx.Process(target=_worker_main, name=f"landiff-rank{r}",
                            args=(r, cfg, self.devices, store.port,
                                  timeout_s, q, self._results, os.getpid()),
                            daemon=True)
            p.start()
            self._cmds.append(q)
            self._procs.append(p)
        atexit.register(self.close)
        self._store = store
        try:
            self.ctx = RankContext(cfg, self.devices, 0, store, timeout_s,
                                   caller=True)
        except BaseException as e:
            _, errs = self._collect(5.0)
            self._stop()
            raise MeshError(f"mesh {cfg} did not start: {errs}") from e
        if self.backend == "gloo" and self.ctx.device.type == "cuda":
            # ranks sharing a CUDA device exchange through buffers there,
            # made here and mapped by every worker (CUDA IPC), a set for
            # each axis of more than one rank
            axes = [a for a in AXES if axis_sizes(cfg)[a] > 1]
            if axes:
                handles = self.run(_attach, axes, torch.empty(
                    (len(axes), 2, self.size, SHARED_CAPACITY),
                    dtype=torch.float32, device=self.ctx.device))
                self.run(_open_events, handles)

    def run(self, fn, *args, per_rank=None) -> list:
        """fn(ctx, *args) on every rank, or fn(ctx, per_rank[r], *args);
        returns the ranks' results in rank order. fn must be importable
        (a module-level function of the port). Raises MeshError, and
        closes the mesh, if any rank fails or a worker does not answer
        within the timeout after rank 0's part."""
        with self._lock:
            if self._closed:
                raise MeshError("the mesh is closed")

            def argv(r):
                return args if per_rank is None else (per_rank[r],) + args

            for r in range(1, self.size):
                self._cmds[r - 1].put((fn, argv(r)))
            err0 = out0 = None
            try:
                out0 = fn(self.ctx, *argv(0))
            except BaseException as e:     # reported with the workers'
                err0 = e
            outs, errs = self._collect(5.0 if err0 else self.timeout_s)
            if err0 is None and not errs:
                return [out0] + outs
            self._stop()
            what = [f"rank 0: {type(err0).__name__}: {err0}"] if err0 else []
            what += [errs[r] for r in sorted(errs)]
            raise MeshError(f"{getattr(fn, '__name__', fn)} failed on the "
                            f"mesh:\n" + "\n".join(what)) from err0

    def _collect(self, wait_s: float):
        """The workers' answers to the last command: (results in rank
        order, {rank: error text})."""
        got, errs = {}, {}
        deadline = time.monotonic() + wait_s
        dead_at = None
        while len(got) + len(errs) < self.size - 1:
            try:
                r, status, payload = self._results.get(timeout=0.2)
                (got if status == "ok" else errs)[r] = payload
                continue
            except queue.Empty:
                pass
            missing = [r for r in range(1, self.size)
                       if r not in got and r not in errs]
            dead = [r for r in missing if not self._procs[r - 1].is_alive()]
            if dead:
                dead_at = dead_at or time.monotonic()
                if time.monotonic() - dead_at > 2.0:   # its last words read
                    for r in dead:
                        errs[r] = (f"rank {r}: exited with code "
                                   f"{self._procs[r - 1].exitcode}")
            if time.monotonic() > deadline:
                for r in missing:
                    errs.setdefault(r, f"rank {r}: no answer within "
                                       f"{wait_s:.0f} s")
        return [got.get(r) for r in range(1, self.size)], errs

    def _stop(self):
        self._closed = True
        for q in self._cmds:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)

    def close(self):
        """Stop the workers (idempotent)."""
        if self._closed:
            return
        with self._lock:
            self._stop()
        atexit.unregister(self.close)


class ProcessMesh:
    """This process's rank of a mesh whose every rank is a process
    started from outside (parallel/multihost.global_mesh), with Mesh's
    contract: `run` executes a command on this rank alone, every process
    running the same commands in the same order, as JAX runs one SPMD
    program in every process; its result list is [this rank's result].
    A command that raises closes the mesh and raises MeshError here; the
    peers' collectives then fail at the process groups' timeout."""

    def __init__(self, cfg: MeshConfig, devices, rank: int, store,
                 timeout_s: float = 300.0, *, places=None,
                 gloo_device: dict = LOCAL_GLOO):
        self.cfg, self.rank = cfg, rank
        self.size = cfg.num_devices
        self.devices = [str(torch.device(d)) for d in devices]
        # this rank's shard alone is built here (None: another process's)
        self.shard_devices = [d if r == rank else None
                              for r, d in enumerate(self.devices)]
        self.timeout_s = timeout_s
        self._closed = False
        self.ctx = RankContext(cfg, self.devices, rank, store, timeout_s,
                               places=places, gloo_device=gloo_device,
                               caller=True)
        self.backend = self.ctx.backend

    def run(self, fn, *args, per_rank=None) -> list:
        """[fn(ctx, *args)], or [fn(ctx, per_rank[rank], *args)]."""
        if self._closed:
            raise MeshError("the mesh is closed")
        if per_rank is not None:
            args = (per_rank[self.rank],) + args
        try:
            return [fn(self.ctx, *args)]
        except Exception as e:
            self._closed = True
            raise MeshError(f"{getattr(fn, '__name__', fn)} failed on rank "
                            f"{self.rank}: {type(e).__name__}: {e}") from e

    def close(self):
        """Drop this rank's stored trees (idempotent)."""
        self._closed = True
        self.ctx.state.clear()


def _worker_main(rank, cfg, devices, port, timeout_s, cmds, results,
                 parent_pid):
    """A worker rank: join the groups, then run commands until told to
    stop, the parent is gone, or a command fails (its exit fails the
    peers' pending collectives)."""
    try:
        if torch.device(devices[rank]).type == "cpu":
            torch.set_num_threads(
                max(1, (os.cpu_count() or 1) // cfg.num_devices))
        store = dist.TCPStore("127.0.0.1", port, cfg.num_devices, False,
                              timeout=datetime.timedelta(seconds=timeout_s))
        ctx = RankContext(cfg, devices, rank, store, timeout_s)
    except BaseException:
        results.put((rank, "err", f"rank {rank}: {traceback.format_exc()}"))
        return
    while True:
        try:
            item = cmds.get(timeout=5.0)
        except queue.Empty:
            if os.getppid() != parent_pid:
                return
            continue
        if item is None:
            return
        fn, args = item
        try:
            out = fn(ctx, *args)
        except BaseException:
            results.put((rank, "err",
                         f"rank {rank}: {traceback.format_exc()}"))
            return
        results.put((rank, "ok", out))


# ---------------------------------------------------------------------------
# weights and arguments on the ranks


def to_rank(ctx: RankContext, tree, copy: bool = False):
    """The tensors of a command's argument on this rank's device; copy:
    into memory this rank owns (a tensor from another process arrives as
    a view of the sender's memory)."""
    def move(path, x):
        if isinstance(x, torch.Tensor):
            return x.to(ctx.device, copy=copy)
        return x

    return map_with_path(move, tree)


def release_cache(ctx: RankContext):
    """Where the ranks share a CUDA device, return this rank's cached
    blocks to it at the end of a stage command: the next stage runs in
    other processes' allocators (rank 0's VAE decode after a denoise)."""
    if ctx.backend == "gloo" and ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def _attach(ctx: RankContext, axes, bufs):
    return ctx.attach_buffers(axes, bufs)


def _open_events(ctx: RankContext, handles):
    ctx.open_events(handles)


def _store(ctx: RankContext, tree, key: str, part: str):
    # the caller's tree as given where it already lies on this rank's
    # device; a worker's in memory of its own
    ctx.state.setdefault(key, {})[part] = to_rank(ctx, tree,
                                                  copy=not ctx.caller)


def load(mesh: "Mesh | ProcessMesh", key: str, part: str, shards: list):
    """Store shards[r] (rank r's tree, tensors on any device) as
    ctx.state[key][part] on every rank: each worker copies its own once;
    rank 0, and each rank of a ProcessMesh, keeps its tree as given where
    it lies on the rank's device, else moves it there (a ProcessMesh's
    shards are built for `mesh.shard_devices`: its own alone, the others
    None). On CUDA, rank 0 then lets go of the
    other ranks' copies and returns the memory they held to the device,
    where the next part's worker copies need it when the ranks share it;
    a caller loads a model part by part to keep that transient small."""
    mesh.run(_store, key, part, per_rank=shards)
    if any(torch.device(d).type == "cuda" for d in mesh.devices):
        del shards[1:]
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
