// Slot-scan executor for levelized PIM gate programs, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_slot_scan_kernel` (src/repro/kernels/pim_exec.py,
// entries `pim_exec_slots_fused` / `pim_exec_slots_io`) together with the
// butterfly bit-transpose bridges `transpose32` / `pack_values` /
// `unpack_values` (src/repro/kernels/slots.py) that the fused entry wrapped
// around it.
//
// What it computes.  A slot schedule has `n_levels` levels of `W` lanes
// (W = 6, the slot width both packages levelize at; other widths arrive
// with the dense schedule, ROADMAP A6).
// The state is `n_cells` 32-row bit columns per word.  The kernel zeroes the
// state, writes the input cells, sets the folded INIT1 cell `one_cell` to all
// ones, then for every level l reads the 2W cells `la[l]`, `lb[l]` and writes
// `~(a | b)` as one contiguous band of W cells starting at `lo[l, 0]`.
// Finally it emits the output cells `out_idx`.
//
// Shape on Hopper.  Every word column (32 rows) is independent, so one
// thread owns one column and runs the whole schedule on it.  The state lives
// in shared memory as [n_cells][wpc] (wpc = words per CTA): all threads of a
// CTA read the same schedule index at once, so every shared access of the
// level loop is a conflict-free row of consecutive banks, and the schedule
// indices are warp-uniform (broadcast) loads.  No thread touches another's
// column inside the level loop, so the loop needs no barrier.  All 2W
// operands of a level are read into registers before its band is written:
// slot reuse can make a band overlap its own operands.
//
// What bounds it.  Per level each column does 2W shared loads and W shared
// stores (72 B at W = 6), against 4 B per row of each port in device memory
// once.  Shared-memory traffic (about 33 TB/s over the card) is the floor,
// far above device-memory traffic, and the state size n_cells * 4 B per
// column caps how many columns (warps) an SM holds to hide the latency of
// the level's dependent loads.  The design keeps the state entirely
// on chip and spends shared-memory bandwidth only on the level loop; the
// wrapper sizes wpc from n_cells so a CTA's state fits.
//
// Fused entry: per-row values in, per-row values out.  A warp builds each
// input word with one __ballot_sync per bit (lane i holds row 32w + i), and
// takes the outputs apart by a broadcast shared read per bit, each lane
// keeping its own row's bit.  The io entry moves pre-packed rows.
// The ragged last word is masked here: rows past n_rows read as zero and
// are never written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 6;  // slot width (lanes per level)

struct Params {
  const uint32_t* in;       // fused: [n_in_ports][n_rows]; io: [k_in][n_words]
  const int* in_widths;     // fused: cells per input port
  int n_in_ports;
  const int* in_idx;        // [k_in] state cell of each stacked input cell
  int k_in;
  const int* la;            // [n_levels][W]
  const int* lb;            // [n_levels][W]
  const int* lo;            // [n_levels][W]; lo[l][0] is the band start
  int n_levels;
  const int* out_idx;       // [k_out] state cell of each stacked output cell
  const int* out_widths;    // fused: cells per output port
  int n_out_ports;
  int k_out;
  uint32_t* out;            // fused: [n_out_ports][n_rows]; io: [k_out][n_words]
  long long n_rows;         // fused only
  long long n_words;
  int n_cells;
  int one_cell;             // < 0: none
  int wpc;                  // words (columns, live threads) per CTA
};

__device__ __forceinline__ void run_levels(uint32_t* st, const Params& p,
                                           int col) {
  const int wpc = p.wpc;
  for (int l = 0; l < p.n_levels; ++l) {
    const int* a = p.la + static_cast<size_t>(l) * W;
    const int* b = p.lb + static_cast<size_t>(l) * W;
    uint32_t v[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      v[k] = ~(st[__ldg(a + k) * wpc + col] | st[__ldg(b + k) * wpc + col]);
    }
    uint32_t* band = st + __ldg(p.lo + static_cast<size_t>(l) * W) * wpc + col;
#pragma unroll
    for (int k = 0; k < W; ++k) band[k * wpc] = v[k];
  }
}

// Fused input: warp `warp` builds the words [32*warp, 32*warp + 32) of this
// CTA.  For word j, lane i loads the value of row 32*(word) + i and one
// ballot per bit gathers that bit of all 32 rows into one word.
__device__ __forceinline__ void pack_fused(uint32_t* st, const Params& p) {
  const int lane = threadIdx.x & 31;
  const int j0 = (threadIdx.x >> 5) * 32;
  const int j1 = min(p.wpc, j0 + 32);
  for (int j = j0; j < j1; ++j) {
    const long long row =
        (static_cast<long long>(blockIdx.x) * p.wpc + j) * 32 + lane;
    const bool live = row < p.n_rows;
    int s = 0;
    for (int q = 0; q < p.n_in_ports; ++q) {
      const uint32_t v = live ? __ldg(p.in + q * p.n_rows + row) : 0u;
      const int wq = __ldg(p.in_widths + q);
      for (int bit = 0; bit < wq; ++bit, ++s) {
        const uint32_t m = __ballot_sync(0xffffffffu, (v >> bit) & 1u);
        if (lane == 0) st[__ldg(p.in_idx + s) * p.wpc + j] = m;
      }
    }
  }
}

// Fused output: for word j every lane reads the same state word per output
// cell (a broadcast) and keeps bit `lane`, its own row's bit.
__device__ __forceinline__ void unpack_fused(const uint32_t* st,
                                             const Params& p) {
  const int lane = threadIdx.x & 31;
  const int j0 = (threadIdx.x >> 5) * 32;
  const int j1 = min(p.wpc, j0 + 32);
  for (int j = j0; j < j1; ++j) {
    const long long row =
        (static_cast<long long>(blockIdx.x) * p.wpc + j) * 32 + lane;
    const bool live = row < p.n_rows;
    int s = 0;
    for (int q = 0; q < p.n_out_ports; ++q) {
      const int wq = __ldg(p.out_widths + q);
      uint32_t v = 0u;
      for (int c = 0; c < wq; ++c, ++s) {
        const uint32_t m = st[__ldg(p.out_idx + s) * p.wpc + j];
        v |= ((m >> lane) & 1u) << c;
      }
      if (live) p.out[q * p.n_rows + row] = v;
    }
  }
}

template <bool kFused>
__global__ void __launch_bounds__(1024) slot_scan_kernel(const Params p) {
  extern __shared__ uint32_t st[];
  const int col = threadIdx.x;
  const long long word = static_cast<long long>(blockIdx.x) * p.wpc + col;
  const bool own = col < p.wpc && word < p.n_words;

  const int n_state = p.n_cells * p.wpc;
  for (int i = threadIdx.x; i < n_state; i += blockDim.x) st[i] = 0u;
  __syncthreads();
  if (kFused) {
    pack_fused(st, p);
  } else if (own) {
    for (int k = 0; k < p.k_in; ++k) {
      st[__ldg(p.in_idx + k) * p.wpc + col] = __ldg(p.in + k * p.n_words + word);
    }
  }
  __syncthreads();
  if (col < p.wpc) {
    if (p.one_cell >= 0) st[p.one_cell * p.wpc + col] = 0xffffffffu;
    run_levels(st, p, col);
  }
  __syncthreads();
  if (kFused) {
    unpack_fused(st, p);
  } else if (own) {
    for (int k = 0; k < p.k_out; ++k) {
      p.out[k * p.n_words + word] = st[__ldg(p.out_idx + k) * p.wpc + col];
    }
  }
}

template <bool kFused>
int launch(int width, const Params& p, void* stream) {
  // A gate-free program (n_levels == 0) never runs the level loop, so its
  // schedule may have any width.
  if (p.wpc < 1 || p.wpc > 1024 || p.n_words < 1 ||
      (p.n_levels > 0 && width != W)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(p.n_cells) * p.wpc * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      slot_scan_kernel<kFused>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (p.n_words + p.wpc - 1) / p.wpc;
  const int threads = (p.wpc + 31) / 32 * 32;
  slot_scan_kernel<kFused><<<static_cast<unsigned>(blocks), threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries return cudaGetLastError() of the launch (0 on success).
extern "C" int slot_scan_fused(
    const void* in_vals, const void* in_widths, int n_in_ports,
    const void* in_idx, int k_in, const void* la, const void* lb,
    const void* lo, int n_levels, int width, const void* out_idx,
    const void* out_widths, int n_out_ports, int k_out, void* out_vals,
    long long n_rows, int n_cells, int one_cell, int wpc, void* stream) {
  Params p{};
  p.in = static_cast<const uint32_t*>(in_vals);
  p.in_widths = static_cast<const int*>(in_widths);
  p.n_in_ports = n_in_ports;
  p.in_idx = static_cast<const int*>(in_idx);
  p.k_in = k_in;
  p.la = static_cast<const int*>(la);
  p.lb = static_cast<const int*>(lb);
  p.lo = static_cast<const int*>(lo);
  p.n_levels = n_levels;
  p.out_idx = static_cast<const int*>(out_idx);
  p.out_widths = static_cast<const int*>(out_widths);
  p.n_out_ports = n_out_ports;
  p.k_out = k_out;
  p.out = static_cast<uint32_t*>(out_vals);
  p.n_rows = n_rows;
  p.n_words = (n_rows + 31) / 32;
  p.n_cells = n_cells;
  p.one_cell = one_cell;
  p.wpc = wpc;
  return launch<true>(width, p, stream);
}

extern "C" int slot_scan_io(
    const void* in_rows, const void* in_idx, int k_in, const void* la,
    const void* lb, const void* lo, int n_levels, int width,
    const void* out_idx, int k_out, void* out_rows, long long n_words,
    int n_cells, int one_cell, int wpc, void* stream) {
  Params p{};
  p.in = static_cast<const uint32_t*>(in_rows);
  p.in_idx = static_cast<const int*>(in_idx);
  p.k_in = k_in;
  p.la = static_cast<const int*>(la);
  p.lb = static_cast<const int*>(lb);
  p.lo = static_cast<const int*>(lo);
  p.n_levels = n_levels;
  p.out_idx = static_cast<const int*>(out_idx);
  p.k_out = k_out;
  p.out = static_cast<uint32_t*>(out_rows);
  p.n_words = n_words;
  p.n_cells = n_cells;
  p.one_cell = one_cell;
  p.wpc = wpc;
  return launch<false>(width, p, stream);
}
