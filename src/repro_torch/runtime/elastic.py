"""Elastic scaling: re-mesh on a changed device count; the port of
``repro.runtime.elastic``.

A failed node shrinks the healthy pool; ``choose_mesh`` picks the largest
(data, model) grid the survivors support (model axis must divide head/expert
counts), and ``reshard_plan`` pairs a checkpoint restore with the new mesh's
shardings -- the checkpoint manager's placement on restore does the actual
movement.  Growth works identically.  On PyTorch a device is a rank of the
process group, so the new mesh spans the group's first ``data * model``
ranks; with no group up, a one-device mesh makes its one-rank group as
``launch.mesh.make_mesh`` does.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..launch.mesh import _device_type, _ensure_group


def choose_mesh(n_devices: int, *, model_divisors: List[int],
                max_model: int = 64) -> Tuple[int, int]:
    """Largest usable (data, model) for ``n_devices``.

    model must divide every entry of ``model_divisors`` (head counts, expert
    counts, ffn tiling); prefer the largest model axis that keeps data >= 1
    and uses every device (drops stragglers to a power-of-two pool if the
    count is awkward)."""
    usable = n_devices
    while usable > 0:
        for model in sorted({d for d in range(1, max_model + 1)
                             if usable % d == 0 and
                             all(m % d == 0 for m in model_divisors)},
                            reverse=True):
            data = usable // model
            if data >= 1:
                return data, model
        usable -= 1
    raise ValueError("no usable mesh")


def mesh_for(n_devices: int, model_divisors: List[int], *,
             device: str = "cuda") -> DeviceMesh:
    """The (data, model) mesh of :func:`choose_mesh` over the process
    group's first ``data * model`` ranks (built on every rank).  With no
    group up, a one-rank group is made first on ``device`` (the card by
    default), as ``launch.mesh.make_mesh`` does; more ranks with none up
    raise."""
    data, model = choose_mesh(n_devices, model_divisors=model_divisors)
    if not dist.is_initialized():
        _ensure_group(data * model, device)
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=("data", "model"))


def reshard_plan(ckpt, template, new_mesh, sharding_fn):
    """Restore the latest checkpoint onto ``new_mesh``.

    sharding_fn(new_mesh, template) -> tree of NamedSharding for the new
    mesh."""
    shardings = sharding_fn(new_mesh, template)
    return ckpt.restore(template, shardings=shardings)
