"""Device meshes over the launched world (counterpart of
``repro/launch/mesh.py``).

The reference builds a ``jax`` mesh over the devices of one controller;
the port runs one process per card (``python -m torch.distributed.run``
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address)
and lays a ``torch.distributed`` :class:`DeviceMesh` over those processes,
row-major: rank = (pod coordinate · data size + data coordinate) ·
model size + model coordinate.  The collectives run on NCCL on the card
and on gloo on the CPU, and never one in place of the other: a mesh asked
for on a device whose backend the process group lacks raises.

:class:`Mesh` carries what ``sharding/`` reads of a jax mesh (``shape``
by axis name and ``axis_names``) plus this rank's coordinates and the
process group of each axis, and of the client axes (``pod`` × ``data``)
together.

:func:`dry_mesh` is the counterpart of the reference's
``--xla_force_host_platform_device_count=512``: a world of 256 or 512 ranks
in this one process on the ``fake`` backend, rank 0 its only member, over
the meta device (``launch/dryrun.py``).
"""
from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import resolve_device

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}
CLIENT_AXES = ("pod", "data")


class Mesh:
    """Named axes over the launched world: ``shape`` ({axis: size}),
    ``axis_names``, ``device`` (this rank's), :meth:`coord`, :meth:`group`.
    """

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = {a: int(n) for a, n in
                      zip(self.axis_names, device_mesh.mesh.shape)}
        self._groups = {(a,): device_mesh.get_group(a)
                        for a in self.axis_names}
        caxes = tuple(a for a in self.axis_names if a in CLIENT_AXES)
        if len(caxes) > 1:
            # pod × data as one group per model coordinate, in row-major
            # (pod, data) order; every rank creates every group
            grid = device_mesh.mesh
            others = [i for i, a in enumerate(self.axis_names)
                      if a not in caxes]
            keep = [i for i, a in enumerate(self.axis_names) if a in caxes]
            grid = grid.permute(*others, *keep).reshape(
                -1, math.prod(self.shape[a] for a in caxes))
            mine, _ = dist.new_subgroups_by_enumeration(
                [row.tolist() for row in grid])
            self._groups[caxes] = mine

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def group(self, axes) -> dist.ProcessGroup:
        """The process group of this rank's line along ``axes`` (one axis
        name, or the client axes together)."""
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        return self._groups[key]

    def size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else axes
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (the position of its
        shard along a dim split over all of them)."""
        axes = (axes,) if isinstance(axes, str) else axes
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coord(a)
        return i

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def join_world(device="cuda") -> int:
    """The launched world's size, joining it (from the environment
    ``torch.distributed.run`` sets) if this process has not: NCCL for the
    card, gloo for the CPU.  Raises without a GPU unless ``device="cpu"``,
    and when the process group's backend is not the one of the device."""
    dev = resolve_device(device)
    want = _BACKEND[dev.type]
    if not dist.is_initialized():
        dist.init_process_group(want)
    have = dist.get_backend()
    if have != want:
        raise RuntimeError(f"a {dev.type} mesh needs the {want!r} backend; "
                           f"the process group runs {have!r}")
    return dist.get_world_size()


def _make_mesh(shape: tuple, names: tuple, device) -> Mesh:
    dev = resolve_device(device)
    world = join_world(dev)
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{math.prod(shape)} processes; the world has "
                         f"{world}")
    if dev.type == "cuda":
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    return Mesh(init_device_mesh(dev.type, shape, mesh_dim_names=names), dev)


@contextlib.contextmanager
def dry_mesh(shape: tuple, names: tuple):
    """A mesh of ``shape`` over a fake world in this process: rank 0 of
    ``prod(shape)`` ranks on the ``fake`` backend, whose collectives
    accept meta tensors and move nothing, with the meta device as the
    mesh's.  Rank 0 stands for every rank: its program is the per-device
    program.  Refuses to start beside an existing process group (an NCCL
    or gloo world), and destroys its own when the block ends."""
    if dist.is_initialized():
        raise RuntimeError(
            f"a dry mesh needs a process of its own: this one already "
            f"runs a {dist.get_backend()!r} world of "
            f"{dist.get_world_size()}")
    # importing fake_pg registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield Mesh(init_device_mesh("cpu", tuple(shape),
                                    mesh_dim_names=tuple(names)),
                   torch.device("meta"))
    finally:
        dist.destroy_process_group()


def production_mesh_shape(multi_pod: bool = False) -> tuple:
    """(shape, axis names) of the reference's production meshes."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """(data, model) = (16, 16) single pod; (pod, data, model) =
    (2, 16, 16): the reference's shapes, over a world of 256 or 512."""
    return _make_mesh(*production_mesh_shape(multi_pod), device)


def make_host_mesh(data: int = 1, model: int = 1, *, pod: int = 0,
                   device="cuda") -> Mesh:
    """A (data, model) mesh over the launched world, or (pod, data,
    model) when ``pod`` is given; ``data × model`` (× ``pod``) must equal
    the world size.  Raises without a GPU unless ``device="cpu"``."""
    if pod:
        return _make_mesh((pod, data, model), ("pod", "data", "model"),
                          device)
    return _make_mesh((data, model), ("data", "model"), device)
