"""Plain PyTorch versions of the slot-schedule executor.

The counterpart of ``repro.kernels.slots``' scan executors: the reference
the CUDA slot-scan kernel (``kernels.pim_exec``) is held against, and what
the ``ref`` backend runs on any device.  Same signatures as the kernel
wrappers.

A slot schedule (:class:`~repro_torch.core.gates.LevelSchedule`,
``alloc="slots"``) writes one contiguous band per level
(``out[l] == out[l, 0] + lane``), so each level is one gather of its 2W
operand rows, one NOR, and one band write at ``lo[l, 0]``.

Words are held as int32 bit patterns: torch on the CPU has no ``~``,
``<<`` or ``>>`` for uint32, and ``>>`` on int32 is arithmetic, so the
logical right shift is emulated with a mask.  Callers view the numpy
uint32 arrays as int32 at the boundary.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

#: Calls of the plain executors; ``chip_smoke.py`` reads these to show the
#: main path did not fall back to them.
CALLS = {"slots_fused": 0, "slots_io": 0}


def _srl(x: torch.Tensor, j: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns."""
    return (x >> j) & ((1 << (32 - j)) - 1)


# --------------------------------------------------------------------------
# butterfly bit-transpose bridges (ports of <= 32 cells)
# --------------------------------------------------------------------------

def transpose32(x: torch.Tensor) -> torch.Tensor:
    """Bit-transpose 32x32 blocks: ``y[..., i]`` bit ``j`` == ``x[..., j]``
    bit ``i``.  Five butterfly steps of masked shift/xor (Hacker's Delight
    7-3, vectorized over leading axes; the double flip converts HD's
    bit-reversed convention to the straight transpose)."""
    x = x.flip(-1)
    j = 16
    m = 0x0000FFFF
    s = tuple(x.shape[:-1])
    while j:
        xr = x.reshape(s + (32 // (2 * j), 2, j))
        lo, hi = xr[..., 0, :], xr[..., 1, :]
        t = (lo ^ _srl(hi, j)) & m
        x = torch.stack([lo ^ t, hi ^ (t << j)], dim=-2).reshape(s + (32,))
        j >>= 1
        if j:
            m ^= (m << j) & 0xFFFFFFFF
    return x.flip(-1)


def pack_values(in_vals: torch.Tensor, widths: Sequence[int]) -> torch.Tensor:
    """Row-major -> column-major bit transpose: per-row port values
    (int32[n_ports, n_words*32]) to stacked port cell rows
    (int32[sum(widths), n_words]; bit w of word i is row 32*i+w)."""
    n32 = in_vals.shape[1] // 32
    rows = [transpose32(in_vals[p].reshape(n32, 32)).T[:wp]
            for p, wp in enumerate(widths)]
    if rows:
        return torch.cat(rows, dim=0)
    return torch.zeros((0, n32), dtype=torch.int32, device=in_vals.device)


def unpack_values(sub: torch.Tensor, widths: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`pack_values`: stacked port cell rows
    (int32[sum(widths), n_words]) to per-row values
    (int32[n_ports, n_words*32])."""
    n_words = sub.shape[-1]
    outs = []
    off = 0
    for wp in widths:
        blk = sub[off:off + wp]
        off += wp
        if wp < 32:
            blk = torch.cat([blk, blk.new_zeros((32 - wp, n_words))])
        outs.append(transpose32(blk.T).reshape(-1))
    if outs:
        return torch.stack(outs)
    return sub.new_zeros((0, n_words * 32))


# --------------------------------------------------------------------------
# the level loop
# --------------------------------------------------------------------------

def _assemble_slots(packed, in_idx, n_words, *, n_cells, one_cell, in_base):
    """Zero state + input rows (band write when the input cells form a
    run at ``in_base``, else an indexed write) + the folded INIT1 row."""
    st = torch.zeros((n_cells, n_words), dtype=torch.int32,
                     device=packed.device)
    if packed.shape[0]:
        if in_base is not None:
            st[in_base:in_base + packed.shape[0]] = packed
        else:
            st[in_idx.long()] = packed
    if one_cell is not None:
        st[one_cell] = -1
    return st


def _slot_levels(st, la, lb, lo):
    """Level loop over a slot schedule: per level one gather of both
    operand sides (stacked into a single (2*W,) index row) and one
    contiguous band write at ``lo[l, 0]``.  The gather copies, so a band
    that overlaps its own operands reads them before it is written."""
    if la.shape[0] == 0:
        return st
    W = la.shape[1]
    lab = torch.cat([la, lb], dim=1).long()
    for l, o in enumerate(lo[:, 0].tolist()):
        g = st.index_select(0, lab[l])
        st[o:o + W] = ~(g[:W] | g[W:])
    return st


def _extract(st, out_idx, k_out, out_base):
    if out_base is not None:
        return st[out_base:out_base + k_out]
    return st.index_select(0, out_idx.long())


def slots_fused(in_vals, in_idx, la, lb, lo, out_idx, *, n_cells, one_cell,
                in_widths, out_widths, in_base: Optional[int] = None,
                out_base: Optional[int] = None,
                words_per_cta: Optional[int] = None):
    """Fused slot executor (ports of <= 32 cells): per-row input values
    int32[n_in_ports, n_rows] in, per-row output values
    int32[n_out_ports, n_rows] out; the bit transposes, state assembly and
    level loop run in between.  Any ``n_rows``: the ragged last word is
    zero-padded here and trimmed from the result.  ``words_per_cta`` is
    the kernel's launch shape and has no meaning here."""
    CALLS["slots_fused"] += 1
    n_rows = in_vals.shape[1]
    n_words = (n_rows + 31) // 32
    pad = n_words * 32 - n_rows
    if pad:
        in_vals = torch.cat([in_vals, in_vals.new_zeros(
            (in_vals.shape[0], pad))], dim=1)
    st = _assemble_slots(pack_values(in_vals, in_widths), in_idx, n_words,
                         n_cells=n_cells, one_cell=one_cell, in_base=in_base)
    st = _slot_levels(st, la, lb, lo)
    out = unpack_values(_extract(st, out_idx, sum(out_widths), out_base),
                        out_widths)
    return out[:, :n_rows].contiguous()


def slots_io(in_rows, in_idx, la, lb, lo, out_idx, *, n_cells, one_cell,
             k_out, in_base: Optional[int] = None,
             out_base: Optional[int] = None,
             words_per_cta: Optional[int] = None):
    """Slot executor over pre-packed port rows (any port width): ships in
    int32[k_in, n_words], returns the output port rows
    int32[k_out, n_words]."""
    CALLS["slots_io"] += 1
    st = _assemble_slots(in_rows, in_idx, in_rows.shape[-1],
                         n_cells=n_cells, one_cell=one_cell, in_base=in_base)
    st = _slot_levels(st, la, lb, lo)
    return _extract(st, out_idx, k_out, out_base).contiguous()
