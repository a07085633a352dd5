"""Checkpoint manager: atomic, async, in the reference's layout.

The port of ``repro.checkpoint.manager``.  Layout::

    <dir>/step_00000123/
        manifest.json      leaf count, tree description, shapes, dtypes,
                           data hash
        arr_0000.npy ...   one file per leaf (on the host)
    <dir>/LATEST           atomic pointer file

Writes go to ``step_x.tmp`` and are renamed only after fsync -- a preempted
save can never corrupt LATEST.  ``save_async`` copies every tensor to the
host before it returns (the next step may update the parameters in place)
and writes in a daemon thread; the next save joins the previous.
Retention keeps the newest ``keep`` checkpoints.

A tree is flattened as ``jax.tree.flatten`` flattens the reference's: a
mapping's keys sorted, a list or tuple in order, an
:class:`~repro_torch.models.model.LM` (or a tree of its shape: AdamW's
moments) as the reference's parameter leaves, a group's layers stacked
(:func:`~repro_torch.models.convert.reference_leaves`), any other value
one leaf.  So the reference and the port write the same ``arr_*.npy``
bytes and manifest leaves for the same state, and each restores the
other's.  A bfloat16 leaf is saved as its ``uint16`` bits with ``"dtype":
"bfloat16"`` in the manifest, as the reference saves it.  The manifest's
``treedef`` is the port's own description (the leaves' paths), not
jax's string; :meth:`CheckpointManager.restore` checks only the leaf
count, as the reference's does.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models import convert

def _leaves(tree, path=()) -> Iterator[Tuple[tuple, tuple, List[Any]]]:
    """(path, its reference path or (), the leaf's values) in the
    reference's flatten order; a stacked group leaf's values are its
    layers' tensors."""
    if isinstance(tree, nn.Module):
        for rpath, tensors in convert.reference_leaves(tree.cfg, tree):
            yield path + rpath, rpath, tensors
    elif isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, (), [tree]


def _host(rpath: tuple, values: List[Any]) -> Tuple[np.ndarray, str]:
    """One leaf as the array ``np.save`` writes (a copy on the host,
    bfloat16 as its ``uint16`` bits) and its dtype's name."""
    v = values[0]
    if not isinstance(v, torch.Tensor):
        arr = np.array(v)
        return arr, str(arr.dtype)
    arr = convert.leaf_array(rpath, values) if rpath else \
        convert.to_numpy(v)
    return arr, str(v.dtype).removeprefix("torch.")


def _host_leaves(tree) -> Tuple[List[Tuple[np.ndarray, str]], str]:
    leaves, paths = [], []
    for path, rpath, values in _leaves(tree):
        leaves.append(_host(rpath, values))
        paths.append("/".join(map(str, path)))
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return leaves, json.dumps(paths)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any) -> str:
        return self._write(step, *_host_leaves(tree))

    def save_async(self, step: int, tree: Any) -> None:
        """Copies ``tree`` to the host, then writes it in a daemon thread;
        ``tree`` may change as soon as this returns."""
        self.wait()
        leaves, treedef = _host_leaves(tree)
        self._thread = threading.Thread(
            target=self._write, args=(step, leaves, treedef), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, leaves, treedef: str) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "n_leaves": len(leaves),
                    "treedef": treedef, "leaves": []}
        h = hashlib.sha256()
        for i, (arr, dtype_name) in enumerate(leaves):
            path = os.path.join(tmp, f"arr_{i:04d}.npy")
            np.save(path, arr)
            flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
            h.update(flat[:4096].tobytes())
            manifest["leaves"].append(
                {"shape": list(arr.shape), "dtype": dtype_name})
        manifest["digest"] = h.hexdigest()
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._update_latest(step)
        self._retain()
        return final

    def _update_latest(self, step: int) -> None:
        tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.dir, "LATEST"))

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return int(f.read().strip())

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """A new tree of ``template``'s structure holding checkpoint
        ``step`` (the latest by default), each tensor on its template
        tensor's device and in its dtype (the port's ``shardings=``: a
        restarted job places the state where its template lies); an
        ``LM`` comes back as a new ``LM``, frozen.  ``template`` is not
        changed."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        n = sum(1 for _ in _leaves(template))
        if manifest["n_leaves"] != n:
            raise ValueError(f"tree mismatch: checkpoint {step} has "
                             f"{manifest['n_leaves']} leaves, the template "
                             f"{n}")

        def load(i: int) -> torch.Tensor:
            arr = np.load(os.path.join(d, f"arr_{i:04d}.npy"))
            if manifest["leaves"][i]["dtype"] == "bfloat16":
                return torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16)
            return torch.from_numpy(arr)

        return _rebuild(template, iter(range(n)), load)


def _place(arr: torch.Tensor, like) -> torch.Tensor:
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {tuple(arr.shape)}, template "
                         f"{tuple(like.shape)}")
    return arr.to(device=like.device, dtype=like.dtype)


def _rebuild(template, index: Iterator[int], load):
    if isinstance(template, nn.Module):
        cfg = template.cfg
        names = {id(p): n for n, p in template.named_parameters()}
        out = {}
        for rpath, tensors in convert.reference_leaves(cfg, template):
            arr = load(next(index))
            parts = list(arr) if convert.stacked(rpath) else [arr]
            if len(parts) != len(tensors):
                raise ValueError(f"checkpoint leaf {rpath}: {len(parts)} "
                                 f"groups, template {len(tensors)}")
            for t, part in zip(tensors, parts):
                out[names[id(t)]] = _place(part, t)
        return convert.assemble(cfg, out)
    if isinstance(template, Mapping):
        got = {k: _rebuild(template[k], index, load)
               for k in sorted(template)}
        return {k: got[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, index, load) for v in template)
    arr = load(next(index))
    if isinstance(template, torch.Tensor):
        return _place(arr, template)
    return arr
