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
// levels of up to 8 lanes; per level every lane k reads cells a[k] and b[k]
// and writes ~(a | b) to o[k], all reads before any write.  The packed
// stream (kernels/pim_exec.py `pack_levels`) holds one window per level,
// its lanes in uint16 cells; the schedule's pad lanes only read the sink
// and write sink cells that no port and no real lane reads.
//
// Shape on Hopper.  One thread owns one word column; the CTA's state
// [n_cells][wpc] sits in dynamic shared memory with the io bridges of
// pim_state.cuh and fused bridges of its own that keep eight words' device
// memory accesses in flight a warp, and the stream comes through the ring
// of ring.cuh behind it: a TMA bulk copy a tile, read as warp-uniform
// broadcasts one level ahead of its use.  A CTA holds as many columns as
// its shared memory takes beside the ring, spread over every scheduler of
// the SM (`ring_words_per_cta`, `ring_lanes`).
//
// What bounds it.  Per lane each column does two shared loads and one
// shared store (12 B under rows32) and reads one 8-byte record from the
// ring, against 4 B per row of each port in device memory once.  The
// latency of each level's load-NOR-store chain and the instructions a
// warp issues for it bound it; the level's lanes are independent, so their
// loads overlap.

#include "pim_state.cuh"
#include "ring.cuh"

namespace {

// Words of a warp whose input loads or output stores are in flight at once
// in the fused bridges below.
constexpr int kBatch = 8;

// Fused input: pim::pack_fused for a warp that owns the `lanes` words from
// lanes * warp, with the loads of kBatch words issued before their
// ballots, so a warp that owns 32 words waits on device memory four
// times, not 32.  Lane i also holds in_idx[i] of the port's cells, handed
// out by shuffles.
template <int P>
__device__ __forceinline__ void pack_inputs(const pim::Params& p,
                                            int lanes) {
  using T = typename pim::WordOf<P>::T;
  T* st = pim::state<P>();
  const int lane = threadIdx.x & 31;
  const int j0 = (threadIdx.x >> 5) * lanes;
  const int j1 = min(p.wpc, j0 + lanes);
  for (int jb = j0; jb < j1; jb += kBatch) {
    int s = 0;
    for (int q = 0; q < p.n_in_ports; ++q) {
      uint32_t v[kBatch][P];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const long long base =
            (static_cast<long long>(blockIdx.x) * p.wpc + jb + i) * (32 * P) +
            lane;
#pragma unroll
        for (int h = 0; h < P; ++h) {
          const long long row = base + 32 * h;
          v[i][h] = jb + i < j1 && row < p.n_rows
                        ? __ldg(p.in + q * p.n_rows + row) : 0u;
        }
      }
      const int wq = __ldg(p.in_widths + q);
      const int idx = lane < wq ? __ldg(p.in_idx + s + lane) : 0;
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (jb + i >= j1) break;
        for (int bit = 0; bit < wq; ++bit) {
          T m = 0;
#pragma unroll
          for (int h = 0; h < P; ++h) {
            m |= static_cast<T>(
                     __ballot_sync(0xffffffffu, (v[i][h] >> bit) & 1u))
                 << (32 * h);
          }
          const int cell = __shfl_sync(0xffffffffu, idx, bit);
          if (lane == 0) st[cell * p.wpc + jb + i] = m;
        }
      }
      s += wq;
    }
  }
}

// Fused output: pim::unpack_fused with kBatch words gathered per output
// cell before their stores.
template <int P>
__device__ __forceinline__ void unpack_outputs(const pim::Params& p,
                                               int lanes) {
  using T = typename pim::WordOf<P>::T;
  const T* st = pim::state<P>();
  const int lane = threadIdx.x & 31;
  const int j0 = (threadIdx.x >> 5) * lanes;
  const int j1 = min(p.wpc, j0 + lanes);
  for (int jb = j0; jb < j1; jb += kBatch) {
    int s = 0;
    for (int q = 0; q < p.n_out_ports; ++q) {
      const int wq = __ldg(p.out_widths + q);
      const int idx = lane < wq ? __ldg(p.out_idx + s + lane) : 0;
      uint32_t v[kBatch][P];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
#pragma unroll
        for (int h = 0; h < P; ++h) v[i][h] = 0u;
      }
      for (int c = 0; c < wq; ++c) {
        const T* row = st + __shfl_sync(0xffffffffu, idx, c) * p.wpc + jb;
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const T m = jb + i < j1 ? row[i] : T(0);
#pragma unroll
          for (int h = 0; h < P; ++h) {
            v[i][h] |= (static_cast<uint32_t>(m >> (32 * h + lane)) & 1u)
                       << c;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const long long base =
            (static_cast<long long>(blockIdx.x) * p.wpc + jb + i) * (32 * P) +
            lane;
#pragma unroll
        for (int h = 0; h < P; ++h) {
          const long long row = base + 32 * h;
          if (jb + i < j1 && row < p.n_rows) {
            p.out[q * p.n_rows + row] = v[i][h];
          }
        }
      }
      s += wq;
    }
  }
}

// pim::run with the ring: zero the state, start the ring, bring the inputs
// in, set the folded INIT1 cell, run the stream on this thread's column,
// send the outputs out.
template <int K, int P, bool kFused>
__global__ void __launch_bounds__(ring::kMaxThreads) level_gather_kernel(
    int lanes, const pim::Params p, const ring::Stream s) {
  using T = typename pim::WordOf<P>::T;
  T* st = pim::state<P>();
  uint2* slots = reinterpret_cast<uint2*>(
      pim_smem + ring::state_bytes(sizeof(T) * p.n_cells * p.wpc));
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + ring::kSlots *
                                               ring::kRecords);
  const ring::Column me = ring::column(p.wpc, lanes);
  const int col = me.col;
  const bool live = me.live;
  const long long word = static_cast<long long>(blockIdx.x) * p.wpc + col;
  const bool own = live && word < p.n_words;

  ring::start(slots, bars, s);
  const int n_state = p.n_cells * p.wpc;
  for (int i = threadIdx.x; i < n_state; i += blockDim.x) st[i] = 0;
  __syncthreads();
  if (kFused) {
    pack_inputs<P>(p, lanes);
  } else if (own) {
    pim::load_rows<P>(p, col, word);
  }
  __syncthreads();
  if (live && p.one_cell >= 0) st[p.one_cell * p.wpc + col] = ~T(0);
  ring::run<K, T>(st, p.wpc, col, live, slots, bars, s);
  __syncthreads();
  if (kFused) {
    unpack_outputs<P>(p, lanes);
  } else if (own) {
    pim::store_rows<P>(p, col, word);
  }
}

template <int K, bool kFused>
int launch_planes(int planes, int lanes, const pim::Params& p,
                  const ring::Stream& s, void* stream) {
  if (planes == 1) {
    return ring::launch(level_gather_kernel<K, 1, kFused>,
                        sizeof(uint32_t) * p.n_cells * p.wpc, p.wpc, lanes,
                        p.n_words, stream, p, s);
  }
  if (planes == 2) {
    return ring::launch(level_gather_kernel<K, 2, kFused>,
                        sizeof(uint64_t) * p.n_cells * p.wpc, p.wpc, lanes,
                        p.n_words, stream, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kFused>
int launch_width(int width, int planes, int lanes, const pim::Params& p,
                 const ring::Stream& s, void* stream) {
  return ring::with_width(width, [&](auto k) {
    return launch_planes<decltype(k)::value, kFused>(planes, lanes, p, s,
                                                     stream);
  });
}

}  // namespace

// Both entries return cudaGetLastError() of the launch (0 on success).
// `tiles` is the packed stream, n_tiles tiles of PIM_TILE_RECORDS records
// holding n_windows windows of `width` records; the CTA's `wpc` columns
// are spread over warps of `lanes` live lanes.
extern "C" int level_gather_fused(
    const void* in_vals, const void* in_widths, int n_in_ports,
    const void* in_idx, int k_in, const void* tiles, int n_tiles,
    int n_windows, int width, const void* out_idx, const void* out_widths,
    int n_out_ports, int k_out, void* out_vals, long long n_rows, int planes,
    int n_cells, int one_cell, int wpc, int lanes, void* stream) {
  const pim::Params p = pim::fused_params(
      in_vals, in_widths, n_in_ports, in_idx, k_in, out_idx, out_widths,
      n_out_ports, k_out, out_vals, n_rows, planes, n_cells, one_cell, wpc);
  const ring::Stream s{static_cast<const uint2*>(tiles), n_tiles,
                       n_windows};
  return launch_width<true>(width, planes, lanes, p, s, stream);
}

extern "C" int level_gather_io(
    const void* in_rows, const void* in_idx, int k_in, const void* tiles,
    int n_tiles, int n_windows, int width, const void* out_idx, int k_out,
    void* out_rows, long long n_words, int planes, int n_cells, int one_cell,
    int wpc, int lanes, void* stream) {
  const pim::Params p = pim::io_params(in_rows, in_idx, k_in, out_idx, k_out,
                                       out_rows, n_words, n_cells, one_cell,
                                       wpc);
  const ring::Stream s{static_cast<const uint2*>(tiles), n_tiles,
                       n_windows};
  return launch_width<false>(width, planes, lanes, p, s, stream);
}
