"""Device meshes on PyTorch: the port of ``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dimensions
carry the reference's axis names (``mesh_dim_names``).  PyTorch runs one
process a device, so a mesh spans the ranks of the running process group
(a ``gloo`` group on the CPU, ``nccl`` on the card) and is built on every
rank alike.  A mesh larger than the job exists only under a fake process
group (``torch.testing._internal.distributed.fake_pg``), where one process
plays rank 0 of many and no collective moves a byte: the dry run traces
the production meshes that way (:func:`fake_world`).  Meshes are made
by functions when called, never at module level, so importing this
module starts no process group.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..kernels.transfer import checked_device


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _backend_for(device: str) -> str:
    """The process group's backend for ``device``: ``nccl`` for a CUDA
    device (raising when there is none), ``gloo`` otherwise."""
    return "nccl" if torch.device(checked_device(device)).type == "cuda" \
        else "gloo"


def _ensure_group(size: int, device: str) -> None:
    """A process group of ``size`` ranks: the running one, or, when none
    is up and ``size`` is 1, a one-rank group on an in-process store
    (:func:`_backend_for` ``device``).  Raises when the running group has
    another size, when none is up for more ranks, and when ``device``
    names a CUDA device and there is none (before any group is made)."""
    if not dist.is_initialized():
        if size != 1:
            raise RuntimeError(f"a {size}-device mesh needs a process group "
                               f"of {size} ranks; none is up")
        dist.init_process_group(_backend_for(device), store=dist.HashStore(),
                                rank=0, world_size=1)
    if dist.get_world_size() != size:
        raise RuntimeError(f"a {size}-device mesh on a process group of "
                           f"{dist.get_world_size()} ranks")


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: str = "cuda") -> DeviceMesh:
    """``jax.make_mesh``: the ranks 0..N-1 of the process group in
    row-major order over ``shape``, dimensions named ``axes``; on a
    one-rank job with no group up, a one-rank group is made first
    (:func:`_ensure_group`) on the card, or on the CPU for
    ``device="cpu"``, as ``jax.make_mesh`` takes the default backend's
    devices.  A running group decides the device type."""
    _ensure_group(math.prod(shape), device)
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The 16x16 (or 2x16x16) mesh over a process group of 256 (512)
    ranks: a real job's or :func:`fake_world`'s."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def dp_axes(mesh) -> tuple:
    """The batch / FSDP axes of a mesh ('pod' composes with 'data')."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def make_smoke_mesh(*, device: str = "cuda") -> DeviceMesh:
    """1-device mesh for smoke tests (``device="cpu"`` on the CPU)."""
    return make_mesh((1, 1), ("data", "model"), device=device)


def axis_size(mesh, axis) -> int:
    """The devices along one axis name, or along a tuple of them."""
    names = axis if isinstance(axis, tuple) else (axis,)
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in names)


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A fake process group of ``world_size`` ranks, this process its
    ``rank``, for the span of the block: meshes of that many devices
    build and trace, collectives return at once and move nothing.  Needs
    no group to be up before, and leaves none up after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
