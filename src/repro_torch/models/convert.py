"""The reference's parameters as the port's :class:`~.model.LM`.

``repro.models.model.init_model`` returns a pytree: ``embed``, ``norm_f``,
``lm_head``, ``frontend``, a ``prefix`` list of layer dicts and a
``groups`` list (one
dict a kind of ``cfg.group``) whose leaves carry a leading ``n_groups``
axis, put there by ``jax.vmap``.  :func:`from_reference` takes that tree
as numpy arrays (``jax.tree.map(np.asarray, params)``), unstacks the
groups into the port's flat layer list and copies every leaf bit for bit
into exactly one tensor of the port.
"""

from __future__ import annotations

from typing import Iterator, Tuple

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


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """A float32 or bfloat16 numpy array (or scalar) as a CPU tensor of the
    same bits and shape, a 0-d one included (``torch.from_numpy`` refuses
    ``ml_dtypes.bfloat16``: its bits go through ``uint16``)."""
    a = np.array(a, order="C")          # a copy; 0-d stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    if a.dtype == np.float32:
        return torch.from_numpy(a)
    raise TypeError(f"no port dtype for a {a.dtype} parameter")


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


def from_reference(cfg: ModelConfig, tree, *, device="cuda") -> LM:
    """The port's model holding ``tree``'s values on ``device`` (the card
    unless the caller asks for the CPU).  Raises when a leaf has no place
    in the port, a port tensor gets no leaf or two, or a shape or dtype
    differs."""
    device = _checked_device(device)
    lm = LM(cfg, device="meta")
    want = dict(lm.named_parameters())
    done = set()
    for path, arr in _leaves(tree):
        for name, idx in port_names(cfg, path):
            if name not in want:
                raise ValueError(f"reference leaf {path} has no port "
                                 f"tensor ({name})")
            if name in done:
                raise ValueError(f"port tensor {name} given twice")
            t = to_tensor(np.asarray(arr)[idx])
            meta = want[name]
            if t.shape != meta.shape or t.dtype != meta.dtype:
                raise ValueError(f"{name}: reference {tuple(t.shape)} "
                                 f"{t.dtype}, port {tuple(meta.shape)} "
                                 f"{meta.dtype}")
            mod_name, _, leaf = name.rpartition(".")
            lm.get_submodule(mod_name).register_parameter(
                leaf, nn.Parameter(t.to(device), requires_grad=False))
            done.add(name)
    missing = sorted(set(want) - done)
    if missing:
        raise ValueError(f"port tensors with no reference leaf: {missing}")
    return lm
