"""Plain PyTorch versions of the slot-schedule executors.

The counterpart of ``repro.kernels.slots``: the scan executor (what the
CUDA slot-scan kernel, B1, is held against) and the straight-line static
emission (what the generated static-slice kernel, B2, is held against).
``ref`` runs them on any device.  Same signatures as the kernel wrappers in
``kernels.pim_exec``.

A slot schedule (:class:`~repro_torch.core.gates.LevelSchedule`,
``alloc="slots"``) writes one contiguous band per level
(``out[l] == out[l, 0] + lane``), so each level is one gather of its 2W
operand rows, one NOR, and one band write at ``lo[l, 0]``.

State is ``[n_cells, n_words]`` under rows32 and planes-leading
``[planes, n_cells, n_words]`` under rows64 (``kernels.plan.WordLayout``):
the cell axis is always -2 and any plane axis rides along as a batch dim.

Words are held as int32 bit patterns: torch on the CPU has no ``~``,
``<<`` or ``>>`` for uint32, and ``>>`` on int32 is arithmetic, so the
logical right shift is emulated with a mask.  Callers view the numpy
uint32 arrays as int32 at the boundary.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .plan import SLOT_SEG_LEVELS

#: Calls of the plain executors; ``chip_smoke.py`` reads these to show the
#: main path did not fall back to them.
CALLS = {"slots_fused": 0, "slots_io": 0, "static_chain": 0}


def _srl(x: torch.Tensor, j: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns."""
    return (x >> j) & ((1 << (32 - j)) - 1)


def plane_shape(planes: int, k: int, n_words: int) -> tuple:
    """Packed-block shape for ``k`` cell rows under a ``planes``-plane
    layout: 2-D under rows32, planes-leading 3-D otherwise."""
    return (k, n_words) if planes == 1 else (planes, k, n_words)


def _pad_rows(vals: torch.Tensor, rows_per_word: int) -> torch.Tensor:
    """Zero-pad per-row values (int32[n_ports, n_rows]) to whole words."""
    pad = -vals.shape[1] % rows_per_word
    if not pad:
        return vals
    return torch.cat([vals, vals.new_zeros((vals.shape[0], pad))], dim=1)


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


def pack_values(in_vals: torch.Tensor, widths: Sequence[int],
                planes: int = 1) -> torch.Tensor:
    """Row-major -> column-major bit transpose: per-row port values
    (int32[n_ports, n_words*32*planes]) to stacked port cell rows --
    int32[sum(widths), n_words] under rows32 (bit w of word i is row
    32*i+w), or int32[planes, sum(widths), n_words] under the paired
    layout (plane h of word i covers rows ``32*planes*i + 32*h + w``)."""
    n32 = in_vals.shape[1] // 32
    n_words = n32 // planes
    rows = []
    for p, wp in enumerate(widths):
        t = transpose32(in_vals[p].reshape(n32, 32)).T          # (32, n32)
        if planes == 1:
            rows.append(t[:wp])
        else:
            # t[c, planes*i + h] is plane h of word i
            t = t.reshape(32, n_words, planes).movedim(-1, 0)
            rows.append(t[:, :wp])
    if rows:
        return torch.cat(rows, dim=0 if planes == 1 else 1)
    return torch.zeros(plane_shape(planes, 0, n_words), dtype=torch.int32,
                       device=in_vals.device)


def unpack_values(sub: torch.Tensor, widths: Sequence[int],
                  planes: int = 1) -> torch.Tensor:
    """Inverse of :func:`pack_values`: stacked port cell rows (2-D rows32
    or planes-leading 3-D) to per-row values
    (int32[n_ports, n_words*32*planes])."""
    n_words = sub.shape[-1]
    outs = []
    off = 0
    for wp in widths:
        blk = sub[..., off:off + wp, :]
        off += wp
        if wp < 32:
            blk = torch.cat([blk, blk.new_zeros(
                sub.shape[:-2] + (32 - wp, n_words))], dim=-2)
        if planes > 1:                # (planes, 32, n_words) -> (32, n32)
            blk = blk.movedim(0, -1).reshape(32, n_words * planes)
        outs.append(transpose32(blk.T).reshape(-1))
    if outs:
        return torch.stack(outs)
    return sub.new_zeros((0, n_words * 32 * planes))


# --------------------------------------------------------------------------
# the scan executor (B1's plain version)
# --------------------------------------------------------------------------

def _assemble_slots(packed, in_idx, n_words, *, n_cells, one_cell, in_base,
                    planes=1):
    """Zero state + input rows (band write when the input cells form a
    run at ``in_base``, else an indexed write) + the folded INIT1 row."""
    st = torch.zeros(plane_shape(planes, n_cells, n_words),
                     dtype=torch.int32, device=packed.device)
    k_in = packed.shape[-2]
    if k_in:
        if in_base is not None:
            st[..., in_base:in_base + k_in, :] = packed
        else:
            st[..., in_idx.long(), :] = packed
    if one_cell is not None:
        st[..., one_cell, :] = -1
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
        g = st.index_select(-2, lab[l])
        st[..., o:o + W, :] = ~(g[..., :W, :] | g[..., W:, :])
    return st


def _extract(st, out_idx, k_out, out_base):
    if out_base is not None:
        return st[..., out_base:out_base + k_out, :]
    return st.index_select(-2, out_idx.long())


def slots_fused(in_vals, in_idx, la, lb, lo, out_idx, *, n_cells, one_cell,
                in_widths, out_widths, in_base: Optional[int] = None,
                out_base: Optional[int] = None, planes: int = 1,
                words_per_cta: Optional[int] = None):
    """Fused slot executor (ports of <= 32 cells): per-row input values
    int32[n_in_ports, n_rows] in, per-row output values
    int32[n_out_ports, n_rows] out; the bit transposes, state assembly and
    level loop run in between.  Any ``n_rows``: the ragged last word is
    zero-padded here and trimmed from the result.  ``planes`` is the word
    layout; ``words_per_cta`` is the kernel's launch shape and has no
    meaning here."""
    CALLS["slots_fused"] += 1
    n_rows = in_vals.shape[1]
    in_vals = _pad_rows(in_vals, 32 * planes)
    n_words = in_vals.shape[1] // (32 * planes)
    st = _assemble_slots(pack_values(in_vals, in_widths, planes), in_idx,
                         n_words, n_cells=n_cells, one_cell=one_cell,
                         in_base=in_base, planes=planes)
    st = _slot_levels(st, la, lb, lo)
    out = unpack_values(_extract(st, out_idx, sum(out_widths), out_base),
                        out_widths, planes)
    return out[:, :n_rows].contiguous()


def slots_io(in_rows, in_idx, la, lb, lo, out_idx, *, n_cells, one_cell,
             k_out, in_base: Optional[int] = None,
             out_base: Optional[int] = None,
             words_per_cta: Optional[int] = None):
    """Slot executor over pre-packed port rows (any port width): ships in
    int32[k_in, n_words] (planes-leading [planes, k_in, n_words] under
    rows64; the layout is read from the rank), returns the output port
    rows in the same layout."""
    CALLS["slots_io"] += 1
    planes = 1 if in_rows.dim() == 2 else in_rows.shape[0]
    st = _assemble_slots(in_rows, in_idx, in_rows.shape[-1],
                         n_cells=n_cells, one_cell=one_cell, in_base=in_base,
                         planes=planes)
    st = _slot_levels(st, la, lb, lo)
    return _extract(st, out_idx, k_out, out_base).contiguous()


# --------------------------------------------------------------------------
# static emission (B2's plain version)
# --------------------------------------------------------------------------

Source = Tuple[object, int]          # ("i", init cell) or (row, lane)


def static_plan(sched):
    """Resolve every read of a slot schedule to its defining band at
    compile time: returns ``(reads, out_srcs, n_init)`` where ``reads[l]``
    is the pair of per-lane source lists of level ``l``, ``out_srcs`` maps
    each port to its per-cell sources, and ``n_init`` is the size of the
    initial (non-slot) region.  A source is ``("i", cell)`` for the initial
    region or ``(row, lane)`` for the band written by level ``row``: slot
    reuse is dissolved here."""
    if sched.alloc != "slots":
        raise ValueError("static emission requires a slot schedule "
                         f"(got alloc={sched.alloc!r})")
    D = sched.n_levels
    n_init = int(sched.out[:, 0].min()) if D else sched.n_cells
    owner: Dict[int, Source] = {}

    def src(c) -> Source:
        c = int(c)
        return owner.get(c, ("i", c))

    reads: List[Tuple[List[Source], List[Source]]] = []
    for l in range(D):
        w = int(sched.level_width[l])
        reads.append(([src(c) for c in sched.a[l, :w]],
                      [src(c) for c in sched.b[l, :w]]))
        off = int(sched.out[l, 0])
        for k in range(w):
            owner[off + k] = (l, k)
    out_srcs = {name: [src(c) for c in cells]
                for name, cells in sched.ports.items()}
    return reads, out_srcs, n_init


def read_concat(init_block, bands, srcs: List[Source]):
    """Gather the source rows as a concatenation of slices along the cell
    axis, merging consecutive lanes of the same source into one slice.  A
    leading plane axis (rows64) passes through untouched."""
    parts = []
    i = 0
    while i < len(srcs):
        kind, pos = srcs[i]
        j = i + 1
        while (j < len(srcs) and srcs[j][0] == kind
               and srcs[j][1] == srcs[j - 1][1] + 1):
            j += 1
        arr = init_block if kind == "i" else bands[kind]
        parts.append(arr[..., pos:srcs[j - 1][1] + 1, :])
        i = j
    if not parts:
        return init_block.new_zeros(init_block.shape[:-2] +
                                    (0, init_block.shape[-1]))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def emit_levels(reads, lo_row: int, hi_row: int, init_block,
                bands: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
    """Run levels ``[lo_row, hi_row)`` as dataflow over band values: each
    level's band is ``~(A | B)`` with A/B read by :func:`read_concat`."""
    bands = dict(bands)
    for l in range(lo_row, hi_row):
        ra, rb = reads[l]
        bands[l] = ~(read_concat(init_block, bands, ra)
                     | read_concat(init_block, bands, rb))
    return bands


def _band_liveness(reads, out_srcs, D: int) -> Dict[int, int]:
    """last[r] = last row (or D for outputs) whose reads touch band r."""
    last: Dict[int, int] = {}
    for l in range(D):
        for side in reads[l]:
            for kind, _ in side:
                if kind != "i":
                    last[kind] = l
    for srcs in out_srcs.values():
        for kind, _ in srcs:
            if kind != "i":
                last[kind] = D
    return last


def _init_tail(n_init: int, k_in: int, one_cell: Optional[int], n_words,
               planes: int = 1, device=None):
    """Constant rows of the initial region past the packed inputs: zeros,
    with the folded INIT1 row at ``one_cell``."""
    n_tail = n_init - k_in
    if n_tail <= 0:
        return None
    tail = torch.zeros(plane_shape(planes, n_tail, n_words),
                       dtype=torch.int32, device=device)
    if one_cell is not None and k_in <= one_cell < n_init:
        tail[..., one_cell - k_in, :] = -1
    return tail


def build_init_block(packed, n_init: int, one_cell: Optional[int]):
    """Initial region from the packed input rows: inputs occupy the leading
    run (slot layout), constants and uninitialized cells follow."""
    planes = 1 if packed.dim() == 2 else packed.shape[0]
    k_in = packed.shape[-2]
    tail = _init_tail(n_init, k_in, one_cell, packed.shape[-1], planes,
                      packed.device)
    if tail is None:
        return packed[..., :n_init, :]
    return torch.cat([packed, tail], dim=-2) if k_in else tail


def build_static_chain(sched, in_widths, out_widths, out_names,
                       in_cells: Sequence[int],
                       seg_levels: int = SLOT_SEG_LEVELS,
                       fused: bool = True, planes: int = 1):
    """The straight-line form of a slot schedule, run eagerly: returns
    ``run(in_arr) -> out`` where ``in_arr`` is the fused row-major value
    block (int32[n_ports, n_rows], any ``n_rows``) when ``fused`` else
    pre-packed port rows (int32[k_in, n_words], planes-leading under
    rows64); ``out`` mirrors the matching slot executor.  ``in_cells`` is
    the stacked cell list of the ports the caller provides (a subset of
    the schedule's inputs is fine; missing ports stay zero).  No state
    array exists: each level's band is its own tensor, and at every
    ``seg_levels`` boundary the bands no later level or output reads are
    dropped."""
    reads, out_srcs, n_init = static_plan(sched)
    D = sched.n_levels
    last = _band_liveness(reads, out_srcs, D)
    one_cell = None if sched.one_cell is None else int(sched.one_cell)
    stacked_out = [s for name in out_names for s in out_srcs[name]]
    in_cells = [int(c) for c in in_cells]
    leading_run = in_cells == list(range(len(in_cells)))
    bounds = list(range(0, D, max(int(seg_levels), 1))) + [D]
    segs = [(lo, hi) for lo, hi in zip(bounds, bounds[1:]) if hi > lo]
    keeps = [sorted(r for r in range(hi) if r in last and last[r] >= hi)
             for _, hi in segs]

    def assemble(packed):
        if leading_run:
            return build_init_block(packed, n_init, one_cell)
        init = torch.zeros(plane_shape(planes, n_init, packed.shape[-1]),
                           dtype=torch.int32, device=packed.device)
        if packed.shape[-2]:
            idx = torch.tensor(in_cells, dtype=torch.long,
                               device=packed.device)
            init[..., idx, :] = packed
        if one_cell is not None:
            init[..., one_cell, :] = -1
        return init

    def run(in_arr):
        CALLS["static_chain"] += 1
        if fused:
            n_rows = in_arr.shape[1]
            in_arr = _pad_rows(in_arr, 32 * planes)
            packed = pack_values(in_arr, in_widths, planes)
        else:
            packed = in_arr
        init_block = assemble(packed)
        bands: Dict[int, torch.Tensor] = {}
        for (lo, hi), keep in zip(segs, keeps):
            bands = emit_levels(reads, lo, hi, init_block, bands)
            bands = {r: bands[r] for r in keep}
        sub = read_concat(init_block, bands, stacked_out)
        if not fused:
            return sub.contiguous()
        return unpack_values(sub, out_widths, planes)[:, :n_rows].contiguous()

    return run
