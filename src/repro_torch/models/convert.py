"""The reference's parameters as the port's :class:`~.model.LM`, and back.

``repro.models.model.init_model`` returns a pytree: ``embed``, ``norm_f``,
``lm_head``, ``frontend``, a ``prefix`` list of layer dicts and a
``groups`` list (one
dict a kind of ``cfg.group``) whose leaves carry a leading ``n_groups``
axis, put there by ``jax.vmap``.  :func:`from_reference` takes that tree
as numpy arrays (``jax.tree.map(np.asarray, params)``), unstacks the
groups into the port's flat layer list and copies every leaf bit for bit
into exactly one tensor of the port.  :func:`to_reference` is its
inverse, for the parameters and for any tree of their shape (AdamW's
moments); :func:`reference_leaves` gives the port's tensors in the
reference's leaf order (``jax.tree.leaves``: dict keys sorted, the groups
stacked), the order its optimizer sums the gradient norm in and its
checkpoints are written in.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..kernels.ops import _checked_device
from .config import ModelConfig
from .model import LM


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def to_tensor(a: np.ndarray, bits_of=None) -> torch.Tensor:
    """A float32 or bfloat16 numpy array (or scalar) as a CPU tensor of the
    same bits and shape, a 0-d one included (``torch.from_numpy`` refuses
    ``ml_dtypes.bfloat16``: its bits go through ``uint16``).  With
    ``bits_of=torch.bfloat16``, a ``uint16`` array holds bfloat16 bits, as
    :func:`to_reference` writes them."""
    a = np.array(a, order="C")          # a copy; 0-d stays 0-d
    if a.dtype.name == "bfloat16" or \
            (a.dtype == np.uint16 and bits_of == torch.bfloat16):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype == np.float32:
        return torch.from_numpy(a)
    raise TypeError(f"no port dtype for a {a.dtype} parameter")


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor's values on the host, bfloat16 as its ``uint16``
    bits (numpy has no bfloat16 without ``ml_dtypes``)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def port_names(cfg: ModelConfig, path: tuple) -> Iterator[Tuple[str, tuple]]:
    """The port's parameter name for the reference leaf at ``path``, with
    the index into the leaf that gives its tensor (``(g,)`` for a stacked
    group leaf, ``()`` otherwise)."""
    head, rest = path[0], path[1:]
    if head in ("prefix", "groups"):
        j, rest = rest[0], rest[1:]
        leaf = ".".join(map(str, rest))
        if head == "prefix":
            yield f"layers.{j}.{leaf}", ()
            return
        base, width = len(cfg.prefix), len(cfg.group)
        for g in range(cfg.n_groups):
            yield f"layers.{base + g * width + j}.{leaf}", (g,)
        return
    yield ".".join(map(str, path)), ()


def assemble(cfg: ModelConfig, tensors: Mapping[str, torch.Tensor]) -> LM:
    """An :class:`LM` whose parameters are ``tensors`` (by the port's
    parameter names), frozen and not copied.  Raises when a name is not
    the port's or one is missing; shapes are the caller's to check."""
    lm = LM(cfg, device="meta")
    want = dict(lm.named_parameters())
    unknown = sorted(set(tensors) - set(want))
    missing = sorted(set(want) - set(tensors))
    if unknown or missing:
        raise ValueError(f"not the port's tensors: {unknown}; port "
                         f"tensors with no value: {missing}")
    for name, t in tensors.items():
        mod_name, _, leaf = name.rpartition(".")
        lm.get_submodule(mod_name).register_parameter(
            leaf, nn.Parameter(t, requires_grad=False))
    return lm


def from_reference(cfg: ModelConfig, tree, *, device="cuda") -> LM:
    """The port's model holding ``tree``'s values on ``device`` (the card
    unless the caller asks for the CPU).  Raises when a leaf has no place
    in the port, a port tensor gets no leaf or two, or a shape or dtype
    differs.  A ``uint16`` leaf where the port holds bfloat16 is taken as
    its bits (:func:`to_reference`'s output)."""
    device = _checked_device(device)
    want = dict(LM(cfg, device="meta").named_parameters())
    got: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(tree):
        for name, idx in port_names(cfg, path):
            if name not in want:
                raise ValueError(f"reference leaf {path} has no port "
                                 f"tensor ({name})")
            if name in got:
                raise ValueError(f"port tensor {name} given twice")
            meta = want[name]
            t = to_tensor(np.asarray(arr)[idx], bits_of=meta.dtype)
            if t.shape != meta.shape or t.dtype != meta.dtype:
                raise ValueError(f"{name}: reference {tuple(t.shape)} "
                                 f"{t.dtype}, port {tuple(meta.shape)} "
                                 f"{meta.dtype}")
            got[name] = t.to(device)
    missing = sorted(set(want) - set(got))
    if missing:
        raise ValueError(f"port tensors with no reference leaf: {missing}")
    return assemble(cfg, got)


def _reference_path(cfg: ModelConfig, name: str
                    ) -> Tuple[tuple, Optional[int]]:
    """The reference's path of the port's parameter ``name`` and, for a
    leaf of a group, its index along the stacked ``n_groups`` axis (None
    for any other leaf): the inverse of :func:`port_names`."""
    head, _, rest = name.partition(".")
    if head != "layers":
        return tuple(name.split(".")), None
    i, _, leaf = rest.partition(".")
    keys = tuple(leaf.split("."))
    base, width = len(cfg.prefix), len(cfg.group)
    if int(i) < base:
        return ("prefix", int(i)) + keys, None
    g, j = divmod(int(i) - base, width)
    return ("groups", j) + keys, g


Tree = Union[nn.Module, Mapping[str, torch.Tensor]]


def reference_leaves(cfg: ModelConfig, tree: Tree
                     ) -> List[Tuple[tuple, List[torch.Tensor]]]:
    """``tree``'s tensors (an :class:`LM`, a tree of its shape, or a
    mapping of the port's parameter names to tensors) as the reference's
    leaves, in ``jax.tree.leaves`` order: each its path and its tensors,
    one, or a stacked group leaf's ``n_groups`` in group order.  A path
    tuple orders like the reference's depth-first walk: a dict's keys are
    strings, sorted, and a list's indices ints."""
    named = tree.named_parameters() if isinstance(tree, nn.Module) \
        else tree.items()
    parts: Dict[tuple, list] = {}
    for name, t in named:
        path, g = _reference_path(cfg, name)
        parts.setdefault(path, []).append((g or 0, t))
    return [(path, [t for _, t in sorted(ts, key=lambda gt: gt[0])])
            for path, ts in sorted(parts.items())]


def stacked(path: tuple) -> bool:
    """Whether the reference leaf at ``path`` is a group's, stacked on a
    leading ``n_groups`` axis."""
    return path[0] == "groups"


def leaf_array(path: tuple, tensors: List[torch.Tensor]) -> np.ndarray:
    """One reference leaf on the host (:func:`to_numpy`), its group's
    tensors stacked."""
    if stacked(path):
        return np.stack([to_numpy(t) for t in tensors])
    (t,) = tensors
    return to_numpy(t)


def to_reference(cfg: ModelConfig, tree: Tree) -> dict:
    """The inverse of :func:`from_reference`: ``tree`` (the parameters or
    a tree of their shape) as the reference's pytree of numpy arrays, the
    groups' leaves stacked on a leading ``n_groups`` axis, bfloat16 as its
    ``uint16`` bits (``.view(ml_dtypes.bfloat16)`` gives the reference's
    dtype back)."""
    out: dict = {"prefix": [{} for _ in cfg.prefix],
                 "groups": [{} for _ in cfg.group]}
    for path, tensors in reference_leaves(cfg, tree):
        node = out
        for key in path[:-1]:
            node = node[key] if isinstance(node, list) \
                else node.setdefault(key, {})
        node[path[-1]] = leaf_array(path, tensors)
    return out
