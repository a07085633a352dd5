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
// `n_levels` levels of `width` <= 8 lanes.  Per level l every lane k reads
// cells `la[l, k]` and `lb[l, k]` and writes `~(a | b)` to `lo[l, k]`.  The
// output cells of a level are unique: pad lanes read the sink cell and write
// distinct sink cells, which lie inside `n_cells`.  The input and output
// cells are not contiguous, so both are read through `in_idx` / `out_idx`.
//
// Shape on Hopper: the slot-scan shape (pim_state.cuh).  One thread owns one
// word column and runs every level on it from shared memory; the index
// loads are warp-uniform broadcasts; no barrier inside the level loop.  All
// operands of a level are read into registers before any lane writes, as the
// TPU kernel's gather-then-scatter does.  The lane loops are unrolled to 8
// with a warp-uniform guard on `width`.
//
// What bounds it.  Per level each column does 2*width shared loads and width
// shared stores (96 B at width 8 under rows32), plus 3*width index loads
// from L1, against 4 B per row of each port in device memory once.  Shared
// memory and the latency of the dependent loads bound it, as in the slot
// scan; a dense schedule has fewer levels than a slot schedule but scatters
// its writes and loads three index rows per level instead of two and a half.

#include "pim_state.cuh"

namespace {

// The dense schedule's width cap, LEVEL_MAX_WIDTH of kernels/plan.py, which
// the build passes in.
constexpr int kMaxWidth = PIM_LEVEL_MAX_WIDTH;

template <int P>
__device__ __forceinline__ void run_levels(const pim::Params& p, int col) {
  using T = typename pim::WordOf<P>::T;
  T* st = pim::state<P>();
  const int wpc = p.wpc;
  const int width = p.width;
  for (int l = 0; l < p.n_levels; ++l) {
    const size_t row = static_cast<size_t>(l) * width;
    T v[kMaxWidth];
#pragma unroll
    for (int k = 0; k < kMaxWidth; ++k) {
      if (k < width) {
        v[k] = ~(st[__ldg(p.la + row + k) * wpc + col] |
                 st[__ldg(p.lb + row + k) * wpc + col]);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxWidth; ++k) {
      if (k < width) st[__ldg(p.lo + row + k) * wpc + col] = v[k];
    }
  }
}

template <int P, bool kFused>
__global__ void __launch_bounds__(1024) level_gather_kernel(
    const pim::Params p) {
  pim::run<P, kFused>(p, [&](int col) { run_levels<P>(p, col); });
}

template <bool kFused>
int launch_planes(int planes, const pim::Params& p, void* stream) {
  if (p.n_levels > 0 && (p.width < 1 || p.width > kMaxWidth)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (planes == 1) {
    return pim::launch<1>(level_gather_kernel<1, kFused>, p, stream);
  }
  if (planes == 2) {
    return pim::launch<2>(level_gather_kernel<2, kFused>, p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Both entries return cudaGetLastError() of the launch (0 on success).
extern "C" int level_gather_fused(
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

extern "C" int level_gather_io(
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
