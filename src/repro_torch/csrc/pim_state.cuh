// Shared parts of the PIM executor kernels for Hopper (sm_90a): the launch
// parameters, the per-CTA state in shared memory, the input and output
// bridges, and the kernel skeleton that runs a level body between them.
//
// Included by slot_scan.cu (B1), level_gather.cu (B3) and every generated
// static-slice kernel (B2, written by kernels/pim_exec.py).
//
// Layout.  One thread owns one word column.  Under rows32 (P = 1) a word is
// 32 rows in a uint32_t; under rows64 (P = 2) it is 64 rows in a 64-bit
// word whose low half is plane 0 and high half plane 1, so bit b of word i
// is row 64*i + b.  The state of a CTA is [n_cells][wpc] words in dynamic
// shared memory (wpc = words per CTA): all threads of a warp read the same
// cell at once, so each access is a conflict-free row of consecutive banks.
//
// Fused bridges: per-row port values in and out (int32[n_ports][n_rows],
// ports of <= 32 cells).  A warp builds each input word with one
// __ballot_sync per bit and plane (lane i holds row 32*(P*word + plane) + i)
// and takes outputs apart with a broadcast shared read per bit, each lane
// keeping its own row's bit.  Rows past n_rows read as zero and are never
// written.  The io bridges move pre-packed port rows: int32[k][n_words],
// planes-leading [P][k][n_words] under rows64.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// The one dynamic shared-memory array of every kernel built on this header.
// Device functions index it directly, so every access compiles to a shared
// load or store.
extern __shared__ __align__(16) unsigned char pim_smem[];

namespace pim {

template <int P> struct WordOf;
template <> struct WordOf<1> { using T = uint32_t; };
template <> struct WordOf<2> { using T = unsigned long long; };

struct Params {
  const uint32_t* in;       // fused: [n_in_ports][n_rows]; io: [P][k_in][n_words]
  const int* in_widths;     // fused: cells per input port
  int n_in_ports;
  const int* in_idx;        // [k_in] state cell of each stacked input cell
  int k_in;
  const int* la;            // [n_levels][width]
  const int* lb;            // [n_levels][width]
  const int* lo;            // [n_levels][width]
  int n_levels;
  int width;                // lanes per level
  const int* out_idx;       // [k_out] state cell of each stacked output cell
  const int* out_widths;    // fused: cells per output port
  int n_out_ports;
  int k_out;
  uint32_t* out;            // fused: [n_out_ports][n_rows]; io: [P][k_out][n_words]
  long long n_rows;         // fused only
  long long n_words;
  int n_cells;
  int one_cell;             // < 0: none
  int wpc;                  // words (columns, live threads) per CTA
};

template <int P>
__device__ __forceinline__ typename WordOf<P>::T* state() {
  return reinterpret_cast<typename WordOf<P>::T*>(pim_smem);
}

// Fused input: warp `warp` builds the words [32*warp, 32*warp + 32) of this
// CTA.  For word j and plane h, lane i loads the value of row
// 32*(P*word + h) + i, and one ballot per bit gathers that bit of all 32
// rows into plane h of the word.
template <int P>
__device__ __forceinline__ void pack_fused(const Params& p) {
  using T = typename WordOf<P>::T;
  T* st = state<P>();
  const int lane = threadIdx.x & 31;
  const int j0 = (threadIdx.x >> 5) * 32;
  const int j1 = min(p.wpc, j0 + 32);
  for (int j = j0; j < j1; ++j) {
    const long long base =
        (static_cast<long long>(blockIdx.x) * p.wpc + j) * (32 * P) + lane;
    int s = 0;
    for (int q = 0; q < p.n_in_ports; ++q) {
      uint32_t v[P];
#pragma unroll
      for (int h = 0; h < P; ++h) {
        const long long row = base + 32 * h;
        v[h] = row < p.n_rows ? __ldg(p.in + q * p.n_rows + row) : 0u;
      }
      const int wq = __ldg(p.in_widths + q);
      for (int bit = 0; bit < wq; ++bit, ++s) {
        T m = 0;
#pragma unroll
        for (int h = 0; h < P; ++h) {
          m |= static_cast<T>(__ballot_sync(0xffffffffu, (v[h] >> bit) & 1u))
               << (32 * h);
        }
        if (lane == 0) st[__ldg(p.in_idx + s) * p.wpc + j] = m;
      }
    }
  }
}

// Fused output: for word j every lane reads the same state word per output
// cell (a broadcast) and keeps bit 32*h + lane of plane h, its own rows.
template <int P>
__device__ __forceinline__ void unpack_fused(const Params& p) {
  using T = typename WordOf<P>::T;
  const T* st = state<P>();
  const int lane = threadIdx.x & 31;
  const int j0 = (threadIdx.x >> 5) * 32;
  const int j1 = min(p.wpc, j0 + 32);
  for (int j = j0; j < j1; ++j) {
    const long long base =
        (static_cast<long long>(blockIdx.x) * p.wpc + j) * (32 * P) + lane;
    int s = 0;
    for (int q = 0; q < p.n_out_ports; ++q) {
      const int wq = __ldg(p.out_widths + q);
      uint32_t v[P];
#pragma unroll
      for (int h = 0; h < P; ++h) v[h] = 0u;
      for (int c = 0; c < wq; ++c, ++s) {
        const T m = st[__ldg(p.out_idx + s) * p.wpc + j];
#pragma unroll
        for (int h = 0; h < P; ++h) {
          v[h] |= (static_cast<uint32_t>(m >> (32 * h + lane)) & 1u) << c;
        }
      }
#pragma unroll
      for (int h = 0; h < P; ++h) {
        const long long row = base + 32 * h;
        if (row < p.n_rows) p.out[q * p.n_rows + row] = v[h];
      }
    }
  }
}

// io input: this thread's word of every stacked input cell.
template <int P>
__device__ __forceinline__ void load_rows(const Params& p, int col,
                                          long long word) {
  using T = typename WordOf<P>::T;
  T* st = state<P>();
  for (int k = 0; k < p.k_in; ++k) {
    T m = 0;
#pragma unroll
    for (int h = 0; h < P; ++h) {
      m |= static_cast<T>(
               __ldg(p.in + (static_cast<long long>(h) * p.k_in + k) *
                                p.n_words + word))
           << (32 * h);
    }
    st[__ldg(p.in_idx + k) * p.wpc + col] = m;
  }
}

// io output: this thread's word of every stacked output cell.
template <int P>
__device__ __forceinline__ void store_rows(const Params& p, int col,
                                           long long word) {
  using T = typename WordOf<P>::T;
  const T* st = state<P>();
  for (int k = 0; k < p.k_out; ++k) {
    const T m = st[__ldg(p.out_idx + k) * p.wpc + col];
#pragma unroll
    for (int h = 0; h < P; ++h) {
      p.out[(static_cast<long long>(h) * p.k_out + k) * p.n_words + word] =
          static_cast<uint32_t>(m >> (32 * h));
    }
  }
}

// The kernel skeleton: zero the state, bring the inputs in, set the folded
// INIT1 cell, run `levels(col)` on this thread's column, send the outputs
// out.  Columns never interact inside `levels`, so it needs no barrier.
template <int P, bool kFused, class Levels>
__device__ __forceinline__ void run(const Params& p, Levels levels) {
  using T = typename WordOf<P>::T;
  T* st = state<P>();
  const int col = threadIdx.x;
  const long long word = static_cast<long long>(blockIdx.x) * p.wpc + col;
  const bool own = col < p.wpc && word < p.n_words;

  const int n_state = p.n_cells * p.wpc;
  for (int i = threadIdx.x; i < n_state; i += blockDim.x) st[i] = 0;
  __syncthreads();
  if (kFused) {
    pack_fused<P>(p);
  } else if (own) {
    load_rows<P>(p, col, word);
  }
  __syncthreads();
  if (col < p.wpc) {
    if (p.one_cell >= 0) st[p.one_cell * p.wpc + col] = ~static_cast<T>(0);
    levels(col);
  }
  __syncthreads();
  if (kFused) {
    unpack_fused<P>(p);
  } else if (own) {
    store_rows<P>(p, col, word);
  }
}

// Launch shape: one thread per word column, whole warps, the state in
// dynamic shared memory.  Returns cudaGetLastError() of the launch.
template <int P, class Kernel>
int launch(Kernel kernel, const Params& p, void* stream) {
  if (p.wpc < 1 || p.wpc > 1024 || p.n_words < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(p.n_cells) * p.wpc *
                      sizeof(typename WordOf<P>::T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (p.n_words + p.wpc - 1) / p.wpc;
  const int threads = (p.wpc + 31) / 32 * 32;
  kernel<<<static_cast<unsigned>(blocks), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Parameters of a fused call (n_words follows from n_rows and the layout).
inline Params fused_params(const void* in_vals, const void* in_widths,
                           int n_in_ports, const void* in_idx, int k_in,
                           const void* out_idx, const void* out_widths,
                           int n_out_ports, int k_out, void* out_vals,
                           long long n_rows, int planes, int n_cells,
                           int one_cell, int wpc) {
  Params p{};
  p.in = static_cast<const uint32_t*>(in_vals);
  p.in_widths = static_cast<const int*>(in_widths);
  p.n_in_ports = n_in_ports;
  p.in_idx = static_cast<const int*>(in_idx);
  p.k_in = k_in;
  p.out_idx = static_cast<const int*>(out_idx);
  p.out_widths = static_cast<const int*>(out_widths);
  p.n_out_ports = n_out_ports;
  p.k_out = k_out;
  p.out = static_cast<uint32_t*>(out_vals);
  p.n_rows = n_rows;
  p.n_words = (n_rows + 32 * planes - 1) / (32 * planes);
  p.n_cells = n_cells;
  p.one_cell = one_cell;
  p.wpc = wpc;
  return p;
}

// Parameters of an io call.
inline Params io_params(const void* in_rows, const void* in_idx, int k_in,
                        const void* out_idx, int k_out, void* out_rows,
                        long long n_words, int n_cells, int one_cell,
                        int wpc) {
  Params p{};
  p.in = static_cast<const uint32_t*>(in_rows);
  p.in_idx = static_cast<const int*>(in_idx);
  p.k_in = k_in;
  p.out_idx = static_cast<const int*>(out_idx);
  p.k_out = k_out;
  p.out = static_cast<uint32_t*>(out_rows);
  p.n_words = n_words;
  p.n_cells = n_cells;
  p.one_cell = one_cell;
  p.wpc = wpc;
  return p;
}

}  // namespace pim
