"""Meshes of processes (counterpart of ``repro/launch/mesh.py``).

A :class:`Mesh` lays the processes of one ``torch.distributed`` world out
on named axes, as the JAX package lays devices: ``(data, model)``, or
``(pod, data, model)`` where a pod axis is pure data parallelism. It is
built on ``torch.distributed.device_mesh.init_device_mesh`` (row-major: rank
r sits at the coordinates of r in the mesh's shape) and holds a process
group for every set of its axes, so a collective runs over exactly the ranks
that differ on those axes: the batch axes' group for the weighted grads'
all-reduce, a leaf's sharded axes' group for its gather.

Rank r computes on ``cuda:(local_rank % device_count)``, or on the CPU where
the caller asks for it. The backend is NCCL on the card and gloo on the
CPU, and gloo where a host's ranks outnumber its cards: NCCL cannot put two
ranks on one card (:func:`pick_backend`). Nothing here touches
``torch.distributed`` at import.
"""
from __future__ import annotations

import itertools
import math
import os
import socket
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.core.blocks import batch_axes  # noqa: F401 (re-exported)

# how long a collective waits for a rank before the group fails (a rank
# that compiles the kernels first may keep the others waiting minutes)
TIMEOUT = timedelta(seconds=600)


def free_port() -> int:
    """A free TCP port on localhost (the rendezvous of a world the caller
    starts itself)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def pick_backend(device, local_world: int, cards: int) -> str:
    """NCCL for CUDA ranks that each have a card of their own; gloo on the
    CPU, or where ``local_world`` ranks of one host share its ``cards``."""
    if torch.device(device).type == "cuda" and local_world <= cards:
        return "nccl"
    return "gloo"


def init_distributed(rank=None, world=None, init_method=None,
                     device="cuda") -> tuple:
    """Join (or start) the process group -> (rank, world, local rank).

    Already initialized: its rank and size. Else rank and world come from
    the arguments, or from the ``torchrun`` environment (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), or are a world
    of one on a free localhost port. Ranks the caller starts itself share
    one host. The backend is :func:`pick_backend`'s."""
    env = os.environ
    local = int(env.get("LOCAL_RANK", rank if rank is not None else 0))
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), local
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world = int(env.get("WORLD_SIZE", 1)) if world is None else int(world)
    if init_method is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            init_method = "env://"
        elif world == 1:
            init_method = f"tcp://localhost:{free_port()}"
        else:
            raise ValueError(
                f"rank {rank} of a world of {world}: pass init_method "
                "(tcp://localhost:<port>) or run under torchrun")
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    dist.init_process_group(pick_backend(device, local_world, cards),
                            init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    return rank, world, local


def rank_device(device="cuda", local_rank: int = 0) -> torch.device:
    """The device a rank computes on: ``cuda:(local_rank % count)`` (made
    current), or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


class Mesh:
    """The processes of the world on named axes. ``shape`` maps each axis
    name to its size, in ``axis_names`` order (what ``launch.sharding``
    reads, as the JAX package reads ``jax.sharding.Mesh.shape``);
    ``coords`` the calling rank's index on each axis."""

    def __init__(self, shape, axis_names, device="cuda"):
        shape = tuple(int(n) for n in shape)
        if len(shape) != len(axis_names) or min(shape, default=1) < 1:
            raise ValueError(f"mesh {shape} over axes {tuple(axis_names)}")
        world = dist.get_world_size() if dist.is_initialized() else 1
        if math.prod(shape) != world:
            raise ValueError(
                f"mesh {dict(zip(axis_names, shape))} needs "
                f"{math.prod(shape)} processes; the world has {world}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.size = world
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.device = torch.device(device)
        self.coords = self.coords_of(self.rank)
        self.device_mesh = None
        self._groups = {}
        self.control = self.io = None
        if not dist.is_initialized():
            return
        from torch.distributed.device_mesh import init_device_mesh
        self.device_mesh = init_device_mesh(
            "cuda" if self.device.type == "cuda" else "cpu", shape,
            mesh_dim_names=self.axis_names)
        # a group for every set of two axes or more (one axis: the device
        # mesh's own); every rank creates every group, in one order
        for k in range(2, len(shape) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                if self.axis_size(axes) > 1:
                    self._groups[axes], _ = dist.new_subgroups_by_enumeration(
                        self._partition(axes))
        # host-side coordination on gloo (CPU tensors, objects), one group
        # for the train loop's thread and one for the checkpoint writer's
        self.control = dist.new_group(backend="gloo")
        self.io = dist.new_group(backend="gloo")

    def coords_of(self, rank: int) -> dict:
        out, rest = {}, int(rank)
        for a in reversed(self.axis_names):
            rest, out[a] = divmod(rest, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: dict) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def _order(self, axes) -> tuple:
        names = {axes} if isinstance(axes, str) else set(axes)
        return tuple(a for a in self.axis_names if a in names)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._order(axes))

    def members(self, axes, rank=None) -> list:
        """The ranks of ``rank``'s group over ``axes`` (the ranks that
        differ from it on those axes only), in row-major order over them:
        member i holds block i of a dim sharded over ``axes``."""
        order = self._order(axes)
        base = self.coords_of(self.rank if rank is None else rank)
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in order)):
            out.append(self.rank_of({**base, **dict(zip(order, idx))}))
        return out

    def _partition(self, axes) -> list:
        seen, groups = set(), []
        for r in range(self.size):
            if r not in seen:
                g = self.members(axes, r)
                seen.update(g)
                groups.append(g)
        return groups

    def group(self, axes):
        """The process group over ``axes`` holding this rank; None where
        it has one member (no collective is launched)."""
        order = self._order(axes)
        if self.axis_size(order) <= 1:
            return None
        if len(order) == 1:
            return self.device_mesh.get_group(order[0])
        return self._groups[order]

    def all_reduce(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Sum ``t`` in place over the group of ``axes``."""
        g = self.group(axes)
        if g is not None:
            dist.all_reduce(t, group=g)
        return t

    def all_gather(self, t: torch.Tensor, axes) -> list:
        """Every member's ``t`` (one shape), in :meth:`members` order."""
        g = self.group(axes)
        if g is None:
            return [t]
        out = [torch.empty_like(t) for _ in range(self.axis_size(axes))]
        dist.all_gather(out, t.contiguous(), group=g)
        return out

    def any(self, flag: bool) -> bool:
        """Whether any rank of the mesh passes a true flag (the train
        loop's stop: every rank must stop at the same step)."""
        if self.control is None:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control)
        return bool(t.item())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


def _axes(shape) -> tuple:
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def make_mesh(shape, axis_names=None, device="cuda") -> Mesh:
    """A mesh of the whole world: ``shape`` (data, model) or (pod, data,
    model) unless ``axis_names`` says otherwise."""
    return Mesh(shape, axis_names or _axes(shape), device)


class PlanMesh(Mesh):
    """A mesh with no process world, on the meta device: the planner's
    (``launch.steps.plan_cell``) stand-in for one rank of a mesh of any
    shape, as the JAX package plans on fake host devices. Its
    collectives launch nothing: each returns meta tensors of the shapes a
    real world gives and adds its bytes a rank (the result's, as the
    reference counts an HLO collective's) to :attr:`traffic`, by kind and
    by axes."""

    def __init__(self, shape, axis_names, rank: int = 0):
        shape = tuple(int(n) for n in shape)
        if len(shape) != len(axis_names) or min(shape, default=1) < 1:
            raise ValueError(f"mesh {shape} over axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.size = math.prod(shape)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} of a mesh of {self.size}")
        self.rank = int(rank)
        self.device = torch.device("meta")
        self.coords = self.coords_of(self.rank)
        self.device_mesh = self.control = self.io = None
        self._groups = {}
        self.traffic = {}

    def _add(self, kind: str, axes, nbytes: int) -> None:
        for key in (kind, f"{kind}@{','.join(self._order(axes))}"):
            self.traffic[key] = self.traffic.get(key, 0) + int(nbytes)

    def group(self, axes):
        raise RuntimeError("a planning mesh has no process groups")

    def all_reduce(self, t: torch.Tensor, axes) -> torch.Tensor:
        if self.axis_size(axes) > 1:
            self._add("all_reduce", axes, t.numel() * t.element_size())
        return t

    def all_gather(self, t: torch.Tensor, axes) -> list:
        n = self.axis_size(axes)
        if n <= 1:
            return [t]
        self._add("all_gather", axes, n * t.numel() * t.element_size())
        return [torch.empty_like(t) for _ in range(n)]

    def any(self, flag: bool) -> bool:
        return bool(flag)

    def __repr__(self) -> str:
        return f"PlanMesh({self.shape}, rank {self.rank} at {self.coords})"


def make_plan_mesh(shape, axis_names=None, rank: int = 0) -> PlanMesh:
    """A :class:`PlanMesh` of ``shape`` ((data, model) or (pod, data,
    model) unless ``axis_names`` says otherwise), seen from ``rank``."""
    return PlanMesh(shape, axis_names or _axes(shape), rank)


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         plan: bool = False) -> Mesh:
    """The reference's production mesh: (16, 16), or (2, 16, 16) with
    ``multi_pod``; over the world of processes, or with ``plan`` a
    :class:`PlanMesh` seen from rank 0 (the dry-run's)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    if plan:
        return make_plan_mesh(shape)
    return make_mesh(shape, device=device)


def make_test_mesh(shape=(1, 1), axes=("data", "model"),
                   device="cpu") -> Mesh:
    return make_mesh(shape, axes, device)


def make_train_mesh(data: int = 0, model: int = 1, device="cuda") -> Mesh:
    """(data, model) over the world: ``data=0`` means every process left
    once ``model`` has its share; a model axis that does not divide the
    world, or a mesh of another size than the world, raises."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if model <= 0:
        model = 1
    if data <= 0:
        if n % model:
            raise ValueError(f"model axis {model} does not divide {n} "
                             "processes")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh ({data}, {model}) needs {data * model} "
                         f"processes; the world has {n}")
    return make_mesh((data, model), device=device)
