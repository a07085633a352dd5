// Shared parts of the PIM executor kernels for Hopper (sm_90a): the launch
// parameters, the per-CTA state in shared memory, the input and output
// bridges, and the kernel skeleton that runs a level body between them.
//
// Included by ring.cuh (the slot scan B1, the level gather B3 and the
// gate-serial kernel B4) and by every generated static-slice kernel (B2,
// written by kernels/pim_exec.py).
//
// Layout.  One thread owns one word column.  Under rows32 (P = 1) a word is
// 32 rows in a uint32_t; under rows64 (P = 2) it is 64 rows in a 64-bit
// word whose low half is plane 0 and high half plane 1, so bit b of word i
// is row 64*i + b.  The state of a CTA is [n_cells][stride] words in
// dynamic shared memory, of which the first wpc (words per CTA) columns are
// used: the threads of a warp read the same cell at once, so each access
// is a conflict-free row of consecutive banks.  The CTA's wpc columns are
// spread over its warps, `lanes` live lanes a warp (the wrapper's rule,
// kernels/pim_exec.py `ring_lanes`), so that a state too large for full
// warps still gives every scheduler of the SM columns to run.  The stride
// is odd where the shared memory allows (kernels/pim_exec.py
// `state_stride`): the bridges below touch one word of 32 cells at once.
//
// Fused bridges: per-row port values in and out (int32[n_ports][n_rows],
// ports of <= 32 cells).  A warp takes the 32 rows of one word (32 values)
// and transposes them as a 32x32 bit matrix in five __shfl_xor_sync steps:
// lane b then holds the word of the port's cell b, and every lane stores
// its own, one store instruction a port and word.  The output bridge runs
// the same transpose the other way.  Each warp keeps the loads of a batch
// of words in flight before it transposes any.  Rows past n_rows read as zero
// and are never written.  The io bridges move pre-packed port rows, one
// column a thread: int32[k][n_words], planes-leading [P][k][n_words] under
// rows64.

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

// Words of one warp whose device-memory accesses the fused bridges keep in
// flight together, by default all of a warp's words under the ring
// kernels' CTA rule (32 32-bit values a lane), so a port costs the warp one
// wait on device memory.  B2 passes its own lanes a warp, known when it is
// compiled.
template <int P> constexpr int kBatch = 32 / P;

struct Params {
  const uint32_t* in;       // fused: [n_in_ports][n_rows]; io: [P][k_in][n_words]
  const int* in_widths;     // fused: cells per input port
  int n_in_ports;
  const int* in_idx;        // [k_in] state cell of each stacked input cell
  int k_in;
  const int* out_idx;       // [k_out] state cell of each stacked output cell
  const int* out_widths;    // fused: cells per output port
  int n_out_ports;
  int k_out;
  uint32_t* out;            // fused: [n_out_ports][n_rows]; io: [P][k_out][n_words]
  long long n_rows;         // fused only
  long long n_words;
  int n_cells;
  int one_cell;             // < 0: none
  int wpc;                  // word columns per CTA
  int stride;               // words from one cell's row to the next (>= wpc)
  int lanes;                // live lanes a warp
};

// Bytes of a state of n_cells rows of `stride` words of `word` bytes,
// rounded up to 16 B: the state is zeroed in 16-byte stores, and what
// follows it (the ring) is 16-B aligned.
__host__ __device__ constexpr size_t state_bytes(int n_cells, int stride,
                                                 size_t word) {
  return (static_cast<size_t>(n_cells) * stride * word + 15) / 16 * 16;
}

template <int P>
__device__ __forceinline__ typename WordOf<P>::T* state() {
  return reinterpret_cast<typename WordOf<P>::T*>(pim_smem);
}

// This thread's column of the CTA (lane `lanes` and up of a warp own none).
struct Column {
  int col;
  bool live;
};

__device__ __forceinline__ Column column(int wpc, int lanes) {
  const int lane = threadIdx.x & 31;
  const int col = (threadIdx.x >> 5) * lanes + lane;
  return {col, lane < lanes && col < wpc};
}

// One step of the warp transpose: lanes i and i ^ S swap the off-diagonal
// S x S blocks of their 2S x 2S diagonal block (M: the low S bits of each
// 2S).
template <int S, uint32_t M>
__device__ __forceinline__ uint32_t swap_blocks(uint32_t x, int lane) {
  const uint32_t y = __shfl_xor_sync(0xffffffffu, x, S);
  return (lane & S) ? (((y >> S) & M) | (x & ~M))
                    : ((x & M) | ((y & M) << S));
}

// 32x32 bit transpose across a warp: on return lane j holds the word whose
// bit i is bit j of lane i's `x` (slots.transpose32 in the plain version).
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  x = swap_blocks<16, 0x0000ffffu>(x, lane);
  x = swap_blocks<8, 0x00ff00ffu>(x, lane);
  x = swap_blocks<4, 0x0f0f0f0fu>(x, lane);
  x = swap_blocks<2, 0x33333333u>(x, lane);
  return swap_blocks<1, 0x55555555u>(x, lane);
}

// Fused input: warp w builds the words [w * lanes, w * lanes + lanes) of
// this CTA.  For word j and plane h, lane i loads the value of row
// 32*(P*word + h) + i; after the transpose lane b holds plane h of the
// port's cell b and stores it.
template <int P, int B>
__device__ __forceinline__ void pack_fused(const Params& p) {
  using T = typename WordOf<P>::T;
  const int lane = threadIdx.x & 31;
  const int j0 = (threadIdx.x >> 5) * p.lanes;
  const int j1 = min(p.wpc, j0 + p.lanes);
  const long long first = static_cast<long long>(blockIdx.x) * p.wpc;
  int s = 0;
  for (int q = 0; q < p.n_in_ports; ++q) {
    const int wq = __ldg(p.in_widths + q);
    const bool mine = lane < wq;
    T* dst = state<P>() + (mine ? __ldg(p.in_idx + s + lane) : 0) * p.stride;
    const uint32_t* src = p.in + q * p.n_rows;
    for (int jb = j0; jb < j1; jb += B) {
      uint32_t v[B][P];
#pragma unroll
      for (int i = 0; i < B; ++i) {
#pragma unroll
        for (int h = 0; h < P; ++h) {
          const long long row = (first + jb + i) * (32 * P) + 32 * h + lane;
          v[i][h] = jb + i < j1 && row < p.n_rows ? __ldg(src + row) : 0u;
        }
      }
#pragma unroll
      for (int i = 0; i < B; ++i) {
        if (jb + i >= j1) break;  // warp-uniform
        T m = 0;
#pragma unroll
        for (int h = 0; h < P; ++h) {
          m |= static_cast<T>(transpose32(v[i][h], lane)) << (32 * h);
        }
        if (mine) dst[jb + i] = m;
      }
    }
    s += wq;
  }
}

// Fused output: lane b reads the port's cell b of each word, and the
// transpose hands lane i the value of row 32*(P*word + h) + i.
template <int P, int B>
__device__ __forceinline__ void unpack_fused(const Params& p) {
  using T = typename WordOf<P>::T;
  const int lane = threadIdx.x & 31;
  const int j0 = (threadIdx.x >> 5) * p.lanes;
  const int j1 = min(p.wpc, j0 + p.lanes);
  const long long first = static_cast<long long>(blockIdx.x) * p.wpc;
  int s = 0;
  for (int q = 0; q < p.n_out_ports; ++q) {
    const int wq = __ldg(p.out_widths + q);
    const bool mine = lane < wq;
    const T* src =
        state<P>() + (mine ? __ldg(p.out_idx + s + lane) : 0) * p.stride;
    uint32_t* dst = p.out + q * p.n_rows;
    for (int jb = j0; jb < j1; jb += B) {
      T m[B];
#pragma unroll
      for (int i = 0; i < B; ++i) m[i] = mine && jb + i < j1 ? src[jb + i] : T(0);
#pragma unroll
      for (int i = 0; i < B; ++i) {
        if (jb + i >= j1) break;  // warp-uniform
#pragma unroll
        for (int h = 0; h < P; ++h) {
          const uint32_t v =
              transpose32(static_cast<uint32_t>(m[i] >> (32 * h)), lane);
          const long long row = (first + jb + i) * (32 * P) + 32 * h + lane;
          if (row < p.n_rows) dst[row] = v;
        }
      }
    }
    s += wq;
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
    st[__ldg(p.in_idx + k) * p.stride + col] = m;
  }
}

// io output: this thread's word of every stacked output cell.
template <int P>
__device__ __forceinline__ void store_rows(const Params& p, int col,
                                           long long word) {
  using T = typename WordOf<P>::T;
  const T* st = state<P>();
  for (int k = 0; k < p.k_out; ++k) {
    const T m = st[__ldg(p.out_idx + k) * p.stride + col];
#pragma unroll
    for (int h = 0; h < P; ++h) {
      p.out[(static_cast<long long>(h) * p.k_out + k) * p.n_words + word] =
          static_cast<uint32_t>(m >> (32 * h));
    }
  }
}

// The kernel skeleton: zero the state, bring the inputs in, set the folded
// INIT1 cell, run `levels(me)` on every thread (a live thread on its
// column, the others only keeping step with barriers inside it), send the
// outputs out.  Columns never interact inside `levels`.  B is the fused
// bridges' batch of words.
template <int P, bool kFused, int B = kBatch<P>, class Levels>
__device__ __forceinline__ void run(const Params& p, Levels levels) {
  using T = typename WordOf<P>::T;
  T* st = state<P>();
  const Column me = column(p.wpc, p.lanes);
  const long long word = static_cast<long long>(blockIdx.x) * p.wpc + me.col;
  const bool own = me.live && word < p.n_words;

  uint4* words16 = reinterpret_cast<uint4*>(pim_smem);
  const int n16 = static_cast<int>(state_bytes(p.n_cells, p.stride,
                                               sizeof(T)) / 16);
  for (int i = threadIdx.x; i < n16; i += blockDim.x) {
    words16[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  if (kFused) {
    pack_fused<P, B>(p);
  } else if (own) {
    load_rows<P>(p, me.col, word);
  }
  __syncthreads();
  if (me.live && p.one_cell >= 0) st[p.one_cell * p.stride + me.col] = ~T(0);
  levels(me);
  __syncthreads();
  if (kFused) {
    unpack_fused<P, B>(p);
  } else if (own) {
    store_rows<P>(p, me.col, word);
  }
}

// Checks the CTA shape of `p` against `max_threads`; returns its threads,
// or 0 for a shape no kernel takes.
inline int threads_of(const Params& p, int max_threads) {
  if (p.wpc < 1 || p.lanes < 1 || p.lanes > 32 || p.stride < p.wpc ||
      p.n_words < 1) {
    return 0;
  }
  const int threads = (p.wpc + p.lanes - 1) / p.lanes * 32;
  return threads <= max_threads ? threads : 0;
}

// Launch `kernel(args...)` over the words of `p`, wpc columns a CTA spread
// over warps of `lanes`, with `smem` bytes of dynamic shared memory.
// Returns cudaGetLastError() of the launch.
template <class Kernel, class... Args>
int launch(Kernel kernel, const Params& p, size_t smem, int max_threads,
           void* stream, Args... args) {
  const int threads = threads_of(p, max_threads);
  if (threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (p.n_words + p.wpc - 1) / p.wpc;
  kernel<<<static_cast<unsigned>(blocks), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Parameters of a fused call (n_words follows from n_rows and the layout).
inline Params fused_params(const void* in_vals, const void* in_widths,
                           int n_in_ports, const void* in_idx, int k_in,
                           const void* out_idx, const void* out_widths,
                           int n_out_ports, int k_out, void* out_vals,
                           long long n_rows, int planes, int n_cells,
                           int one_cell, int wpc, int stride, int lanes) {
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
  p.stride = stride;
  p.lanes = lanes;
  return p;
}

// Parameters of an io call.
inline Params io_params(const void* in_rows, const void* in_idx, int k_in,
                        const void* out_idx, int k_out, void* out_rows,
                        long long n_words, int n_cells, int one_cell,
                        int wpc, int stride, int lanes) {
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
  p.stride = stride;
  p.lanes = lanes;
  return p;
}

}  // namespace pim
