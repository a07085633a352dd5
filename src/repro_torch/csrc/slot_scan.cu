// Slot-scan executor for levelized PIM gate programs, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_slot_scan_kernel` (src/repro/kernels/pim_exec.py,
// entries `pim_exec_slots_fused` / `pim_exec_slots_io`) together with the
// butterfly bit-transpose bridges `transpose32` / `pack_values` /
// `unpack_values` (src/repro/kernels/slots.py) that the fused entry wrapped
// around it.  Both word layouts: rows32 (planes = 1) and rows64 (planes = 2).
//
// What it computes.  A slot schedule has `n_levels` levels of W lanes (any
// slot width from 1 to 8; both packages levelize at 6 by default).  The
// kernel zeroes the state, writes the input cells, sets the folded INIT1
// cell `one_cell` to all ones, then for every level l reads the 2W cells
// `la[l]`, `lb[l]` and writes `~(a | b)` as one contiguous band of W cells
// starting at `lo[l, 0]`; the band may overwrite cells the level reads, so
// every operand is read first.  Finally it emits the output cells
// `out_idx`.
//
// Shape on Hopper: the level kernel of ring.cuh, which the level gather
// (B3) runs too.  The schedule comes packed once per program
// (kernels/pim_exec.py `pack_slots`): one window a level, lane k writing
// cell lo[l, 0] + k, the windows of 2, 4, 6 or 8 records streamed into shared
// memory by TMA bulk copies and read one level ahead of their use, so no
// index load sits on a level's load-NOR-store chain.  One thread owns one
// word column of the state in shared memory; a CTA holds as many columns
// as fit beside the ring, spread over four warps (`ring_words_per_cta`,
// `ring_lanes`), and the fused bridges of pim_state.cuh transpose 32 rows
// a warp step.
//
// What bounds it.  Per lane each column does two shared loads and one
// shared store (12 B under rows32, 24 B under rows64) and reads one 8-byte
// record from the ring, against 4 B per row of each port in device memory
// once.  The latency of each level's load-NOR-store chain, with one warp a
// scheduler, and the instructions a warp issues for it bound it; a level's
// lanes are independent, so their loads overlap.

#include "ring.cuh"

// Both entries return cudaGetLastError() of the launch (0 on success).
// `tiles` is the packed stream, n_tiles tiles of PIM_TILE_RECORDS records
// holding n_windows windows of `width` records; the CTA's `wpc` columns,
// `stride` words apart from one cell to the next, are spread over warps
// of `lanes` live lanes.
extern "C" int slot_scan_fused(
    const void* in_vals, const void* in_widths, int n_in_ports,
    const void* in_idx, int k_in, const void* tiles, int n_tiles,
    int n_windows, int width, const void* out_idx, const void* out_widths,
    int n_out_ports, int k_out, void* out_vals, long long n_rows, int planes,
    int n_cells, int one_cell, int wpc, int stride, int lanes, void* stream) {
  const pim::Params p = pim::fused_params(
      in_vals, in_widths, n_in_ports, in_idx, k_in, out_idx, out_widths,
      n_out_ports, k_out, out_vals, n_rows, planes, n_cells, one_cell, wpc,
      stride, lanes);
  const ring::Stream s{static_cast<const uint2*>(tiles), n_tiles,
                       n_windows};
  return ring::launch_levels<true>(p, planes, s, width, stream);
}

extern "C" int slot_scan_io(
    const void* in_rows, const void* in_idx, int k_in, const void* tiles,
    int n_tiles, int n_windows, int width, const void* out_idx, int k_out,
    void* out_rows, long long n_words, int planes, int n_cells, int one_cell,
    int wpc, int stride, int lanes, void* stream) {
  const pim::Params p = pim::io_params(in_rows, in_idx, k_in, out_idx, k_out,
                                       out_rows, n_words, n_cells, one_cell,
                                       wpc, stride, lanes);
  const ring::Stream s{static_cast<const uint2*>(tiles), n_tiles,
                       n_windows};
  return ring::launch_levels<false>(p, planes, s, width, stream);
}
