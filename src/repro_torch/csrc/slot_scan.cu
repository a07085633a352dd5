// Slot-scan executor for levelized PIM gate programs, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_slot_scan_kernel` (src/repro/kernels/pim_exec.py,
// entries `pim_exec_slots_fused` / `pim_exec_slots_io`) together with the
// butterfly bit-transpose bridges `transpose32` / `pack_values` /
// `unpack_values` (src/repro/kernels/slots.py) that the fused entry wrapped
// around it.  Both word layouts: rows32 (planes = 1) and rows64 (planes = 2).
//
// What it computes.  A slot schedule has `n_levels` levels of `W` lanes
// (W = 6, the slot width both packages levelize at).  The kernel zeroes the
// state, writes the input cells, sets the folded INIT1 cell `one_cell` to all
// ones, then for every level l reads the 2W cells `la[l]`, `lb[l]` and writes
// `~(a | b)` as one contiguous band of W cells starting at `lo[l, 0]`.
// Finally it emits the output cells `out_idx`.
//
// Shape on Hopper (pim_state.cuh).  Every word column is independent, so one
// thread owns one column and runs the whole schedule on it from shared
// memory; the schedule indices are warp-uniform (broadcast) loads, and the
// level loop needs no barrier.  All 2W operands of a level are read into
// registers before its band is written: slot reuse can make a band overlap
// its own operands.  Under rows64 a thread owns a 64-row word, so each
// level's index loads serve 64 rows instead of 32.
//
// What bounds it.  Per level each column does 2W shared loads and W shared
// stores (72 B at W = 6 under rows32, 144 B under rows64), against 4 B per
// row of each port in device memory once.  Shared-memory traffic (about
// 33 TB/s over the card) is the floor, far above device-memory traffic, and
// the state size n_cells * 4 B * planes per column caps how many columns
// (warps) an SM holds to hide the latency of the level's dependent loads.
// The design keeps the state entirely on chip; the wrapper sizes wpc from
// n_cells and the layout so a CTA's state fits.

#include "pim_state.cuh"

namespace {

constexpr int W = 6;  // slot width (lanes per level)

template <int P>
__device__ __forceinline__ void run_levels(const pim::Params& p, int col) {
  using T = typename pim::WordOf<P>::T;
  T* st = pim::state<P>();
  const int wpc = p.wpc;
  for (int l = 0; l < p.n_levels; ++l) {
    const int* a = p.la + static_cast<size_t>(l) * W;
    const int* b = p.lb + static_cast<size_t>(l) * W;
    T v[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      v[k] = ~(st[__ldg(a + k) * wpc + col] | st[__ldg(b + k) * wpc + col]);
    }
    T* band = st + __ldg(p.lo + static_cast<size_t>(l) * W) * wpc + col;
#pragma unroll
    for (int k = 0; k < W; ++k) band[k * wpc] = v[k];
  }
}

template <int P, bool kFused>
__global__ void __launch_bounds__(1024) slot_scan_kernel(const pim::Params p) {
  pim::run<P, kFused>(p, [&](int col) { run_levels<P>(p, col); });
}

template <bool kFused>
int launch_planes(int planes, const pim::Params& p, void* stream) {
  // A gate-free program (n_levels == 0) never runs the level loop, so its
  // schedule may have any width.
  if (p.n_levels > 0 && p.width != W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (planes == 1) {
    return pim::launch<1>(slot_scan_kernel<1, kFused>, p, stream);
  }
  if (planes == 2) {
    return pim::launch<2>(slot_scan_kernel<2, kFused>, p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Both entries return cudaGetLastError() of the launch (0 on success).
extern "C" int slot_scan_fused(
    const void* in_vals, const void* in_widths, int n_in_ports,
    const void* in_idx, int k_in, const void* la, const void* lb,
    const void* lo, int n_levels, int width, const void* out_idx,
    const void* out_widths, int n_out_ports, int k_out, void* out_vals,
    long long n_rows, int planes, int n_cells, int one_cell, int wpc,
    void* stream) {
  pim::Params p = pim::fused_params(
      in_vals, in_widths, n_in_ports, in_idx, k_in, out_idx, out_widths,
      n_out_ports, k_out, out_vals, n_rows, planes, n_cells, one_cell, wpc);
  p.la = static_cast<const int*>(la);
  p.lb = static_cast<const int*>(lb);
  p.lo = static_cast<const int*>(lo);
  p.n_levels = n_levels;
  p.width = width;
  return launch_planes<true>(planes, p, stream);
}

extern "C" int slot_scan_io(
    const void* in_rows, const void* in_idx, int k_in, const void* la,
    const void* lb, const void* lo, int n_levels, int width,
    const void* out_idx, int k_out, void* out_rows, long long n_words,
    int planes, int n_cells, int one_cell, int wpc, void* stream) {
  pim::Params p = pim::io_params(in_rows, in_idx, k_in, out_idx, k_out,
                                 out_rows, n_words, n_cells, one_cell, wpc);
  p.la = static_cast<const int*>(la);
  p.lb = static_cast<const int*>(lb);
  p.lo = static_cast<const int*>(lo);
  p.n_levels = n_levels;
  p.width = width;
  return launch_planes<false>(planes, p, stream);
}
