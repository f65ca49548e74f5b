"""Meshes: the production meshes as plain descriptions, and device meshes.

Port of ``src/repro/launch/mesh.py``. The sharding rules read only a mesh's
axis names and sizes, so a mesh is described by ``MeshShape`` (the port's
counterpart of JAX's ``AbstractMesh``): the 256-device (16, 16) ``(data,
model)`` and 512-device (2, 16, 16) ``(pod, data, model)`` production meshes
are reckoned in one process, with no process group. ``make_mesh`` and
``make_host_mesh`` build a ``torch.distributed`` ``DeviceMesh`` of the
process group's ranks, one rank a device. Where no group is running and the
mesh has one device, they start a one-rank group whose rendezvous is an
in-process ``HashStore``: no ``TCPStore``, no ``MASTER_PORT``. A mesh of
more devices needs its ranks started first, each calling
``torch.distributed.init_process_group`` (a ``FileStore`` will do).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple, Union

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, major to minor, and nothing else."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def tag(self) -> str:
        return "x".join(map(str, self.axis_sizes))


Mesh = Union[MeshShape, DeviceMesh]


def describe(mesh: Mesh) -> MeshShape:
    """The names and sizes of ``mesh``, a ``MeshShape`` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape))


def start_single_rank(device=None) -> None:
    """Start a process group of one rank, rendezvous through an in-process
    ``HashStore``: NCCL for the card (its communicator is made only at the
    first collective), gloo for the CPU. Does nothing if a group runs."""
    if dist.is_initialized():
        return
    from ..models.layers import resolve_device     # the models import the distribution layer
    dev = resolve_device(device)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device=None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the process group's
    ranks, on the card unless ``device`` names another. With no group
    running, a one-device mesh starts a one-rank group (``start_single_rank``)."""
    from ..models.layers import resolve_device
    dev = resolve_device(device)
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} devices needs a process group of {n} ranks: start "
                "one process a device, each calling torch.distributed."
                "init_process_group (a FileStore rendezvous will do)")
        start_single_rank(dev)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {shape} needs {n} ranks; the process group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """(16, 16) ``(data, model)``, or (2, 16, 16) ``(pod, data, model)``:
    ``pod`` is the slow axis carrying the outer data-parallel dimension."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(device=None) -> DeviceMesh:
    """(1, n) ``(data, model)`` over the process group's n ranks, one a local
    card (or CPU process with ``device="cpu"``); a one-rank group is started
    where none runs, so on one card this is the (1, 1) mesh."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((1, n), ("data", "model"), device=device)
