"""Sharding rules: parameter FSDP x TP, batch DP, cache layouts; the port
of ``repro.launch.sharding``.

Conventions (DESIGN.md §5):
  * ``model`` axis: tensor parallel -- attention heads / ffn hidden /
    experts / vocab.
  * ``data`` axis: batch + ZeRO-style full sharding of params & optimizer.
  * ``pod`` axis: extra data parallelism (params replicated across pods,
    gradients all-reduced over pod+data).

The rule table (:func:`_spec_for`) is the reference's, keyed on substrings
of the reference's parameter paths (``jax.tree_util.keystr``, as
``"['groups'][0]['attn']['wq']"``): each of the port's tensors is looked
up under the path its values have in the reference's tree
(:func:`repro_torch.models.convert._reference_path`), so every tensor gets
the spec its reference leaf gets.  A leaf of a group is stacked on a
leading replicated axis there; the port keeps a group's layers apart, so
a layer's tensor takes the spec without that axis.

A spec (:class:`P`) names the mesh axes each tensor dimension is split
over, as ``jax.sharding.PartitionSpec`` does, and becomes DTensor
placements on the mesh (:meth:`NamedSharding.placements`): ``Shard(d)``
on every mesh dimension named for tensor dimension ``d``, ``Replicate``
on the others.  A dimension split over two axes (``("data", "model")``)
is split over the first one, then each part over the second: the block
that mesh coordinate (i, j) holds is block ``i * |model| + j``, as on the
reference's device (i, j).  Every rule divides evenly (it drops an axis
that does not), so the blocks are the reference's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, List, Mapping

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..models import convert
from .mesh import _backend_for, axis_size, dp_axes, make_mesh

FSDP = "data"       # params are fully sharded over the in-pod data axis


class P(tuple):
    """``jax.sharding.PartitionSpec``: per tensor dimension, None, a mesh
    axis name or a tuple of them (a tuple of one is that name, as jax
    keeps it)."""

    def __new__(cls, *dims):
        return super().__new__(cls, (
            d[0] if isinstance(d, tuple) and len(d) == 1 else d
            for d in dims))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: DeviceMesh
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one a mesh dimension.
    A mesh dimension of one device splits nothing, so it stays
    ``Replicate`` (the same blocks; no collective to undo it)."""
    names = mesh.mesh_dim_names
    out: List[Any] = [Replicate()] * len(names)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            # DTensor splits a dimension over mesh dimensions left to
            # right; another order would hand out other blocks
            raise NotImplementedError(f"axes {axes} out of the mesh's "
                                      f"order {names}")
        for i in where:
            if mesh.size(i) > 1:
                out[i] = Shard(dim)
    return tuple(out)


def keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and list indices."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def _divisible(dim: int, mesh, axis) -> bool:
    if axis is None:
        return True
    return dim % axis_size(mesh, axis) == 0


def _spec_for(path: str, shape, mesh, serve: bool = False,
              embed_d: bool = True) -> P:
    """TP/FSDP rule table, keyed on parameter path substrings.

    ``serve``: inference shardings -- TP only, weights replicated over the
    data axis (no per-token FSDP all-gathers; perf iteration A1).
    ``embed_d``: shard the embedding on d_model over (data, model) instead
    of vocab-sharding -- token gathers become device-local (iteration C3,
    fixes XLA "involuntary full rematerialization" on the vocab gather).
    """
    fsdp = None if serve else FSDP

    def pick(*axes):
        # drop axes that don't divide; keep rank aligned with shape
        out = []
        for dim, ax in zip(shape, axes):
            out.append(ax if _divisible(dim, mesh, ax) else None)
        return P(*out)

    if "embed" in path:
        if embed_d:
            return pick(None, (FSDP, "model") if not serve else "model")
        return pick("model", fsdp)
    if "lm_head" in path or "frontend" in path:
        return pick(fsdp, "model")
    if any(k in path for k in ("wq", "wk", "wv", "wg", "w_x", "w_gate",
                               "wq_a", "wq_b", "wkv_a", "wkv_b", "w1", "w3",
                               "ck", "cr", "wA", "w_in_gate", "w_rec_gate",
                               "router")):
        if len(shape) == 3:                       # MoE expert stacks [E,d,f]
            return pick("model", fsdp, None)
        if len(shape) == 2:
            return pick(fsdp, "model")
        return pick("model")                      # bias vectors
    if any(k in path for k in ("wo", "w2", "w_out", "cv", "wB")):
        if len(shape) == 3:
            return pick("model", None, fsdp)
        if len(shape) == 2:
            return pick("model", fsdp)
        return pick(fsdp)
    if "conv" in path:
        return pick(None, "model")
    # norms, scalars, gates, mu, lam, u, w0 ...
    return P(*([None] * len(shape)))


def _tree_specs(tree: nn.Module, mesh, prefix: tuple, **rule
                ) -> Dict[str, NamedSharding]:
    """{port parameter name: sharding} of an ``LM``-shaped tree, each by
    its reference path under ``prefix``; a group's layer takes its
    stacked leaf's spec less the leading axis."""
    out = {}
    for name, t in tree.named_parameters():
        path, _ = convert._reference_path(tree.cfg, name)
        spec = _spec_for(keystr(prefix + path), tuple(t.shape), mesh, **rule)
        out[name] = NamedSharding(mesh, spec)
    return out


def param_shardings(mesh, params_shape: nn.Module, *, serve: bool = False,
                    embed_d: bool = True) -> Dict[str, NamedSharding]:
    """{parameter name: NamedSharding} of an ``LM`` (on any device,
    ``meta`` included)."""
    return _tree_specs(params_shape, mesh, (), serve=serve, embed_d=embed_d)


def opt_shardings(mesh, opt_shape: Mapping[str, Any], pshard
                  ) -> Dict[str, Any]:
    """Optimizer state: m/v follow params (by the reference's rule, under
    its defaults: ``serve`` off, ``embed_d`` on); step replicated."""
    out = {}
    for key in sorted(opt_shape):
        leaf = opt_shape[key]
        if isinstance(leaf, nn.Module):
            out[key] = _tree_specs(leaf, mesh, (key,))
        else:
            out[key] = NamedSharding(mesh, P())
    return out


def batch_shardings(mesh, batch_shape: Mapping[str, torch.Tensor], *,
                    accum: bool = False) -> Dict[str, NamedSharding]:
    """Batch sharding over the DP axes.  With ``accum`` the leading dim is
    the (unsharded) gradient-accumulation axis and the batch dim is dim 1."""
    dp = dp_axes(mesh)
    dp_size = axis_size(mesh, dp)

    def visit(leaf):
        if leaf.ndim == 0:
            return NamedSharding(mesh, P())
        bdim = 1 if (accum and leaf.ndim >= 2) else 0
        dims = [None] * leaf.ndim
        if leaf.shape[bdim] % dp_size == 0:
            dims[bdim] = dp
        return NamedSharding(mesh, P(*dims))

    return {k: visit(v) for k, v in batch_shape.items()}


def cache_shardings(mesh, cache_shape: List[Mapping[str, torch.Tensor]], *,
                    batch: int, seq_shard: bool = False
                    ) -> List[Dict[str, NamedSharding]]:
    """KV/state caches (the port's list, one dict a layer): batch over DP
    when divisible, plus one dim over 'model'.

    ``seq_shard`` (perf iteration A2): prefer the *sequence* dim (dim 1)
    for the model axis -- flash-decoding-style distributed attention where
    score partials are exchanged (MBs) instead of the cache being
    all-gathered (GBs).  Default/baseline: last divisible dim (head_dim /
    lora).  The reference decides on its stacked leaf's path; a group's
    layer here takes that spec less the leading axis."""
    dp = dp_axes(mesh)
    dp_size = axis_size(mesh, dp)
    msize = axis_size(mesh, "model")

    def visit(core):
        dims = [None] * len(core)
        if core and core[0] % dp_size == 0 and batch % dp_size == 0:
            dims[0] = dp
        cands = ([1] + list(reversed(range(2, len(core))))) if seq_shard \
            else list(reversed(range(1, len(core))))
        for cand in cands:
            if cand < len(core) and core[cand] % msize == 0:
                dims[cand] = "model"
                break
        return NamedSharding(mesh, P(*dims))

    return [{k: visit(tuple(v.shape)) for k, v in layer.items()}
            for layer in cache_shape]


# --------------------------------------------------------------------------
# placing tensors
# --------------------------------------------------------------------------

def distribute(t: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``t`` (the whole tensor, the same on every rank) as a DTensor of
    ``sharding``: each rank keeps its own block; nothing is sent."""
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def place_tree(tree, shardings, place=distribute):
    """A tree of the port's state (an ``LM`` or a tree of its shape, a
    mapping, a list, a tensor) with every tensor made a DTensor of its
    sharding in ``shardings`` (the tree :func:`param_shardings`,
    :func:`opt_shardings`, :func:`batch_shardings` or
    :func:`cache_shardings` gave for it) by ``place(tensor, sharding)``
    (:func:`distribute` by default)."""
    if isinstance(tree, nn.Module):
        return convert.assemble(tree.cfg, {
            n: place(p.detach(), shardings[n])
            for n, p in tree.named_parameters()})
    if isinstance(tree, Mapping):
        return {k: place_tree(v, shardings[k], place)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(v, s, place)
                          for v, s in zip(tree, shardings))
    return place(tree, shardings)


# --------------------------------------------------------------------------
# activations
# --------------------------------------------------------------------------

def install_activation_sharder(mesh):
    """Hook the model's sharding points to this mesh: a DTensor at a point
    is redistributed to the tag's placements (``with_sharding_constraint``
    in the reference); a plain tensor passes unchanged, as the
    reference's constraint leaves a one-device array."""
    from ..models import layers as L
    from ..models import model as M
    dp = dp_axes(mesh)
    dp_size = axis_size(mesh, dp)
    msize = axis_size(mesh, "model")
    L.set_moe_groups(dp_size)

    def to(x, dims):
        return x.redistribute(mesh, placements(mesh, P(*dims)))

    def sharder(tag, x):
        if not isinstance(x, DTensor):
            return x
        if tag == "moe_eo":
            dims = [None] * x.ndim
            if x.shape[0] % dp_size == 0:
                dims[0] = dp
            return to(x, dims)
        if tag == "moe_w":
            # experts stay EP-sharded on 'model'; FSDP axis gathered
            return to(x, ["model", None, None])
        if tag == "moe_buf":
            dims = [None] * x.ndim
            if x.shape[0] % dp_size == 0:
                dims[0] = dp
            if x.shape[1] % msize == 0:
                dims[1] = "model"
            return to(x, dims)
        if tag == "act" and x.shape[0] % dp_size == 0:
            return to(x, [dp] + [None] * (x.ndim - 1))
        if tag == "logits" and x.shape[-1] % msize == 0:
            dims = [None] * x.ndim
            if x.shape[0] % dp_size == 0:
                dims[0] = dp
            dims[-1] = "model"
            return to(x, dims)
        return x

    M.set_activation_sharder(sharder)


@contextlib.contextmanager
def activation_sharder(mesh):
    """:func:`install_activation_sharder` for the span of the block; the
    sharder and the MoE groups installed before come back after."""
    from ..models import layers as L
    before = L._SHARDER, L._MOE_GROUPS
    install_activation_sharder(mesh)
    try:
        yield
    finally:
        L.set_activation_sharder(before[0])
        L.set_moe_groups(before[1])


@contextlib.contextmanager
def launch_mesh(device: str = "cuda"):
    """The mesh the train and serve entry points run on, as the
    reference's launchers build it: ``(n_dev, 1)`` over ``("data",
    "model")``, with the activation sharder installed for the span.
    PyTorch runs a process a device, so ``n_dev`` is the process group's
    size: the running group's, a group made from torchrun's environment
    (``WORLD_SIZE`` above 1; ``nccl`` for a CUDA ``device``, ``gloo``
    otherwise), or a one-rank group made for the span: on the card, or
    on the CPU for ``device="cpu"``.  A group made here is destroyed at
    the end."""
    made = not dist.is_initialized()
    if made and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        backend = _backend_for(device)
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend)
    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    try:
        mesh = make_mesh((n_dev, 1), ("data", "model"), device=device)
        with activation_sharder(mesh):
            yield mesh
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
