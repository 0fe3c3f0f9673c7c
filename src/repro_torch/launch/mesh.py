"""Serving meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

The JAX package is single-controller: one program over a device mesh, its
collectives inserted by the partitioner.  The port is multi-controller:
one process a rank (``torchrun``, or ``torch.multiprocessing`` in the
tests), every rank running the same engine loop, and the collectives are
this module's, each over one named axis of a ("data", "model") mesh.

Rank r of a (D, M) mesh sits at data index r // M and model index r % M.
Its "model" group is its row (the M ranks of its data index), its "data"
group its column (the D ranks of its model index); every rank creates
every group, in the same order, as ``torch.distributed.new_group``
requires.  A (1, 1) mesh creates no group and launches no collective.

The backend is the caller's: ``nccl`` by default on CUDA, ``gloo`` when
asked for (the CPU tests; two ranks sharing one card).  Gloo's
collectives run on host tensors, so a CUDA tensor goes through the host
and back.  A backend that fails to initialise raises; nothing switches to
another.  The mesh counts its collectives, their bytes (each rank's
contribution: the shard it sends to a gather, the tensor it reduces; in
all and per collective) and their seconds on the host clock (``stats``;
a CUDA tensor's collective waits for the device there).

Collectives on one group must run in the same order on every rank, so
two threads of a rank must not share a group.  Each axis therefore has
one group per *lane*: "main" for the serving loop's thread, "admission"
for the overlapped engine's admission worker (its wave prefill gathers
the params beside the window's gathers).  A thread picks its lane with
``with mesh.lane("admission"):``; the counters are shared and locked.

``without(axis)`` views the same ranks with ``axis`` read as size 1 (no
collective over it): the engine's steps on slots that do not split over
"data", and a layer whose ring or pool the rules keep whole over
"model" (``layer``).
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import os
import threading
import time

import torch
import torch.distributed as dist


class Mesh:
    """A ("data", "model") mesh of ``torch.distributed`` ranks: this
    rank's coordinates, its two axis groups and the collectives over them.
    ``shape`` maps axis -> size, as the sharding rules read it."""

    LANES = ("main", "admission")

    def __init__(self, data: int = 1, model: int = 1, *, backend: str | None = None,
                 groups: dict | None = None, rank: int = 0):
        if data < 1 or model < 1:
            raise ValueError(f"mesh axes must be >= 1, got ({data}, {model})")
        self.shape = {"data": int(data), "model": int(model)}
        self.size = data * model
        self.rank = int(rank)
        self.backend = backend
        self._groups = groups or {}      # lane -> axis -> process group
        self.index = {"data": self.rank // model, "model": self.rank % model}
        self._stats = {"all_reduce": 0, "all_gather": 0, "bytes": 0,
                       "all_reduce_bytes": 0, "all_gather_bytes": 0,
                       "all_reduce_s": 0.0, "all_gather_s": 0.0}
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._whole_layers: frozenset = frozenset()

    @property
    def stats(self) -> dict:
        """The collectives' counters, one dict that every view shares."""
        return self._stats

    @stats.setter
    def stats(self, value: dict):
        # in place: the views made of this mesh keep counting into it
        with self._lock:
            self._stats.clear()
            self._stats.update(value)

    def __str__(self) -> str:
        return f"{self.shape['data']}x{self.shape['model']}"

    __repr__ = __str__

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.index[axis]

    def without(self, axis: str) -> "Mesh":
        """A view of this mesh with ``axis`` read as size 1 (index 0): the
        same ranks, groups, lanes and counters; no collective over
        ``axis``."""
        v = copy.copy(self)
        v.shape = dict(self.shape, **{axis: 1})
        v.index = dict(self.index, **{axis: 0})
        v.size = v.shape["data"] * v.shape["model"]
        v._whole_layers = frozenset()
        return v

    def with_whole_layers(self, layers) -> "Mesh":
        """A view whose :meth:`layer` reads the self caches of ``layers``
        (indices) as whole over "model"."""
        v = copy.copy(self)
        v._whole_layers = frozenset(layers)
        v._model_less = v.without("model")
        return v

    def layer(self, i: int) -> "Mesh":
        """The mesh layer ``i``'s self cache (ring or pool) is sharded by:
        this mesh, or, where the rules keep it whole on every "model"
        rank (a ring length or page size "model" does not divide), this
        mesh without "model"."""
        return self._model_less if i in self._whole_layers else self

    @contextlib.contextmanager
    def lane(self, name: str):
        """Run this thread's collectives on lane ``name``'s groups."""
        if name not in self.LANES:
            raise ValueError(f"lane {name!r}: expected one of {self.LANES}")
        prev = getattr(self._tls, "lane", "main")
        self._tls.lane = name
        try:
            yield
        finally:
            self._tls.lane = prev

    def _group(self, axis: str):
        return self._groups[getattr(self._tls, "lane", "main")][axis]

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend's collectives take it: the host for
        gloo, the card for nccl."""
        if self.backend == "gloo":
            return t.cpu()
        if self.backend == "nccl" and not t.is_cuda:
            return t.cuda()
        return t

    def _count(self, op: str, t: torch.Tensor, t0: float):
        n = t.numel() * t.element_size()
        with self._lock:
            self.stats[op] += 1
            self.stats["bytes"] += n
            self.stats[op + "_bytes"] += n
            self.stats[op + "_s"] += time.perf_counter() - t0

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """Sum or max of ``t`` over ``axis``, on every rank of it (a new
        tensor on ``t``'s device; ``t`` itself on an axis of size 1)."""
        if self.shape[axis] == 1:
            return t
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        t0 = time.perf_counter()
        buf = self._host(t).clone()
        dist.all_reduce(buf, op=red, group=self._group(axis))
        out = buf.to(t.device)
        self._count("all_reduce", buf, t0)
        return out

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` over ``axis`` concatenated along ``dim`` in axis
        order, on every rank of it (``t`` itself on an axis of size 1).
        Bool travels as uint8."""
        n = self.shape[axis]
        if n == 1:
            return t
        t0 = time.perf_counter()
        src = self._host(t).contiguous()
        if src.dtype == torch.bool:
            src = src.to(torch.uint8)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self._group(axis))
        out = torch.cat(parts, dim=dim).to(device=t.device, dtype=t.dtype)
        self._count("all_gather", src, t0)
        return out


    def all_gather_grad(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """:meth:`all_gather` under autograd: the backward sums the
        upstream gradient over ``axis`` (every rank's use of the gathered
        rows) and keeps this rank's part along ``dim``.  The training
        forward's MoE reads activation rows of every data rank this way."""
        if self.shape[axis] == 1:
            return t
        return _AllGatherRows.apply(t, self, axis, dim)


class _AllGatherRows(torch.autograd.Function):
    """The gather of :meth:`Mesh.all_gather_grad`."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, t.shape[dim]
        return mesh.all_gather(t, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        total = ctx.mesh.all_reduce(g.float(), ctx.axis)      # summed in float32
        i = ctx.mesh.axis_index(ctx.axis)
        return total.narrow(ctx.dim, i * ctx.n, ctx.n).to(g.dtype), None, None, None


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return None if v is None else int(v)


def init_distributed(backend: str, *, store=None, rank: int | None = None,
                     world_size: int | None = None, init_method: str | None = None,
                     timeout_s: float = 600.0):
    """Initialise the default process group once (a no-op if it exists):
    from ``store`` / ``init_method`` with an explicit rank and world size,
    or from ``torchrun``'s environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT).  Raises if that fails; no other backend is tried."""
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()!r}, "
                               f"the mesh asks for {backend!r}")
        return
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if rank is None or world_size is None:
        raise RuntimeError("a mesh of more than one rank needs a process group: "
                           "run under torchrun, or pass rank and world_size")
    kw = dict(backend=backend, rank=rank, world_size=world_size,
              timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        kw["store"] = store
    elif init_method is not None:
        kw["init_method"] = init_method
    else:
        kw["init_method"] = "env://"
    if backend == "nccl":
        torch.cuda.set_device(_env_int("LOCAL_RANK") or 0)
    dist.init_process_group(**kw)


def make_mesh(data: int = 1, model: int = 1, *, backend: str | None = None,
              **init) -> Mesh:
    """A (data, model) mesh over the default process group, initialised
    first if needed (``init`` as for :func:`init_distributed`).  The
    group's world size must be data * model.  ``backend`` defaults to
    ``nccl`` when CUDA is available, else ``gloo``.  Each lane
    (:attr:`Mesh.LANES`) gets its own group per axis.  (1, 1) touches no
    process group."""
    if data * model == 1:
        return Mesh(1, 1)
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    init_distributed(backend, **init)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != data * model:
        raise ValueError(f"mesh ({data}, {model}) needs {data * model} ranks, "
                         f"the process group has {world}")
    groups = {}
    for lane in Mesh.LANES:   # every rank creates every group, in this order
        mine = groups[lane] = {}
        for d in range(data):
            g = dist.new_group(list(range(d * model, (d + 1) * model)), backend=backend)
            if rank // model == d:
                mine["model"] = g
        for m in range(model):
            g = dist.new_group(list(range(m, data * model, model)), backend=backend)
            if rank % model == m:
                mine["data"] = g
    return Mesh(data, model, backend=backend, groups=groups, rank=rank)


def single_device_mesh() -> Mesh:
    """The (1, 1) mesh: one rank, no process group, no collective."""
    return Mesh(1, 1)


def make_test_mesh(data: int = 2, model: int = 2, **kw) -> Mesh:
    """A (data, model) mesh for tests: gloo unless ``backend`` says
    otherwise (see :func:`make_mesh`)."""
    kw.setdefault("backend", "gloo")
    return make_mesh(data, model, **kw)


def parse_mesh_spec(spec: str | None) -> tuple[int, int]:
    """"DATA,MODEL" or "DATAxMODEL" (e.g. "2,4", "2x4") -> (data, model);
    None -> (1, 1)."""
    if spec is None:
        return 1, 1
    try:
        data, model = (int(p) for p in spec.replace("x", ",").split(","))
    except ValueError:
        raise ValueError(f"--mesh expects DATA,MODEL (e.g. 2,4), got {spec!r}") from None
    return data, model


def mesh_from_spec(spec: str | None, **kw) -> Mesh:
    """A ``--mesh`` spec as a mesh (:func:`parse_mesh_spec`, then
    :func:`make_mesh`); None is the single-device mesh."""
    return make_mesh(*parse_mesh_spec(spec), **kw)
