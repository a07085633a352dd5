// Dense-schedule executor for levelized PIM gate programs, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_pim_level_gather_kernel`
// (src/repro/kernels/pim_exec.py, reached through `pim_exec_level_padded`
// and wrapped by `pim_exec_level_fused` / `pim_exec_level_padded_io`), with
// the bit-transpose bridges of the fused wrapper done in the kernel.  Both
// word layouts: rows32 (planes = 1) and rows64 (planes = 2).
//
// What it computes.  A dense schedule (levelize's "scan" allocation) has
// levels of up to its width cap of lanes (8 by default); per level every
// lane k reads cells a[k] and b[k] and writes ~(a | b) to o[k], all reads
// before any write.  The packed stream (kernels/pim_exec.py `pack_levels`)
// holds one window a level, its lanes in uint16 cells, or a level wider
// than 8 lanes as consecutive windows of at most 8 (exact since no level
// reads a cell it writes); the schedule's pad lanes only read the sink and
// write sink cells that no port and no real lane reads.
//
// Shape on Hopper: the level kernel of ring.cuh, which the slot scan (B1)
// runs too; only the stream differs.  One thread owns one word column; the
// CTA's state sits in dynamic shared memory with the bridges of
// pim_state.cuh, and the stream comes through the ring behind it: a TMA
// bulk copy a tile, read as warp-uniform broadcasts one level ahead of its
// use.  A CTA holds as many columns as its shared memory takes beside the
// ring, spread over every scheduler of the SM (`ring_words_per_cta`,
// `ring_lanes`).
//
// What bounds it.  Per lane each column does two shared loads and one
// shared store (12 B under rows32) and reads one 8-byte record from the
// ring, against 4 B per row of each port in device memory once.  The
// latency of each level's load-NOR-store chain and the instructions a
// warp issues for it bound it; the level's lanes are independent, so their
// loads overlap.

#include "ring.cuh"

// Both entries return cudaGetLastError() of the launch (0 on success).
// Arguments as for slot_scan.cu's entries.
extern "C" int level_gather_fused(
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

extern "C" int level_gather_io(
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
