"""Plain PyTorch versions of the dense and gate-serial executors.

The counterpart of ``repro.kernels.ref``: what the CUDA level-gather
kernel (B3) and gate-serial kernel (B4) in ``kernels.pim_exec`` are held
against, and what the ``ref`` backend runs on any device.

* :func:`pim_exec_ref` -- gate-serial: one row update per lowered gate
  (INIT0=0, INIT1=1, NOT=2 stored as NOR with b == a, NOR=3), in place.
* :func:`check_words` -- verified execution's check fold: the XOR of an
  output block over one axis (the CUDA kernel ``csrc/check_words.cu`` is
  held against it).
* :func:`pim_exec_ref_level` and its io/fused wrappers -- the dense
  schedule (``alloc="scan"``): per level one gather of ``la[l]``/``lb[l]``,
  one NOR and one scatter to ``lo[l]``.  Pad lanes write distinct sink
  cells, so each level's scatter indices are unique.

Every executor here is elementwise along the trailing word axis; state is
``[n_cells, n_words]`` or planes-leading ``[planes, n_cells, n_words]``
(rows64), with the cell axis at -2.  Words are int32 bit patterns (see
``kernels.slots``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .slots import _pad_rows, pack_values, plane_shape, unpack_values

#: Calls of the plain executors and of the plain check fold;
#: ``chip_smoke.py`` reads these to show the main path did not fall back
#: to them.
CALLS = {"level_fused": 0, "level_io": 0, "gate_serial": 0,
         "check_words": 0}


def pim_exec_ref(state, ops, a, b, o, *, words_per_cta: Optional[int] = None):
    """Gate-serial executor: runs the lowered stream ``ops/a/b/o``
    (int32[n_gates] each) over ``state`` (int32[n_cells, n_words]) in
    place and returns it.  ``words_per_cta`` is the kernel's launch shape
    and has no meaning here."""
    CALLS["gate_serial"] += 1
    for op, ia, ib, io in zip(ops.tolist(), a.tolist(), b.tolist(),
                              o.tolist()):
        if op >= 2:
            state[io] = ~(state[ia] | state[ib])
        else:
            state[io] = -op              # INIT1 -> all ones, INIT0 -> 0
    return state


def _level_loop(st, la, lb, lo):
    """Per level: gather both operand sides, NOR, scatter to ``lo[l]``.
    The gathers copy, so every operand is read before the level writes."""
    if la.shape[0] == 0:        # gate-free (passthrough) program
        return st
    la, lb, lo = la.long(), lb.long(), lo.long()
    for l in range(la.shape[0]):
        st[..., lo[l], :] = ~(st.index_select(-2, la[l])
                              | st.index_select(-2, lb[l]))
    return st


def pim_exec_ref_level(state, la, lb, lo, out_idx=None):
    """Dense levelized executor over a whole state (int32[n_cells,
    n_words], or planes-leading under rows64); returns the final state, or
    only the rows in ``out_idx`` when given."""
    final = _level_loop(state, la, lb, lo)
    return final if out_idx is None else final.index_select(-2,
                                                            out_idx.long())


def assemble_state(in_rows, in_idx, n_words, *, n_cells, one_cell):
    """Zero state, the input port rows written at ``in_idx`` and the folded
    INIT1 cell.  The layout is read from ``in_rows``'s rank."""
    planes = 1 if in_rows.dim() == 2 else in_rows.shape[0]
    st = torch.zeros(plane_shape(planes, n_cells, n_words),
                     dtype=torch.int32, device=in_rows.device)
    if in_rows.shape[-2]:
        st[..., in_idx.long(), :] = in_rows
    if one_cell is not None:
        st[..., one_cell, :] = -1
    return st


def pim_exec_ref_level_io(in_rows, in_idx, la, lb, lo, out_idx, *,
                          n_cells, one_cell=None,
                          words_per_cta: Optional[int] = None):
    """Dense executor over pre-packed port rows: int32[k_in, n_words] in
    (planes-leading under rows64), the output port rows out."""
    CALLS["level_io"] += 1
    st = assemble_state(in_rows, in_idx, in_rows.shape[-1],
                        n_cells=n_cells, one_cell=one_cell)
    return pim_exec_ref_level(st, la, lb, lo, out_idx).contiguous()


def pim_exec_ref_level_fused(in_vals, in_idx, la, lb, lo, out_idx, *,
                             n_cells, one_cell, in_widths, out_widths,
                             planes: int = 1,
                             words_per_cta: Optional[int] = None):
    """Fused dense executor (ports of <= 32 cells): per-row values
    int32[n_in_ports, n_rows] in, int32[n_out_ports, n_rows] out, for any
    ``n_rows`` (the ragged last word is padded here and trimmed)."""
    CALLS["level_fused"] += 1
    n_rows = in_vals.shape[1]
    in_vals = _pad_rows(in_vals, 32 * planes)
    st = assemble_state(pack_values(in_vals, in_widths, planes), in_idx,
                        in_vals.shape[1] // (32 * planes),
                        n_cells=n_cells, one_cell=one_cell)
    sub = pim_exec_ref_level(st, la, lb, lo, out_idx)
    return unpack_values(sub, out_widths, planes)[:, :n_rows].contiguous()


def check_words(block, axis: int):
    """Per-word XOR fold of an output block over ``axis``: fused per-port
    row values ``(n_ports, rows)`` over axis 0, packed word blocks
    ``(..., k, n_words)`` over the cell axis ``ndim - 2``.  Words are int32
    bit patterns; an empty axis folds to zeros."""
    CALLS["check_words"] += 1
    parts = block.unbind(axis)
    if not parts:
        shape = block.shape[:axis % block.dim()] + \
            block.shape[axis % block.dim() + 1:]
        return torch.zeros(shape, dtype=block.dtype, device=block.device)
    out = parts[0].clone()
    for p in parts[1:]:
        out.bitwise_xor_(p)
    return out
