// The schedule ring of the ring kernels for Hopper (sm_90a): a packed NOR
// stream streamed tile by tile into shared memory, the loop that runs it
// on one word column of the state, and the level kernel that the slot scan
// (B1, slot_scan.cu) and the level gather (B3, level_gather.cu) both are.
//
// Stream format (written by kernels/pim_exec.py `pack_slots`,
// `pack_levels` and `pack_gates`).  A record is 8 bytes, four uint16:
// (a, b, o, n), read as a uint2 {a | b << 16, o | n << 16}: the NOR gate
// o <- ~(a | b).  NOT is a NOR with b == a; the gate-serial stream's INIT1
// and INIT0 are NORs of two constant cells its kernel keeps after the state
// (all zeros, all ones).  Records come in windows of K (2, 4, 6 or 8)
// consecutive gates, and the loop reads every operand of a window before
// it stores any result, so a window is one step of the schedule: a slot
// level, whose band may overwrite cells its own lanes read; a dense level;
// or a run of the gate-serial stream with no gate reading or writing a
// cell another gate of it writes.  The gates of a window write distinct
// cells, but a window of fewer gates repeats its last gate, which stores
// the same value to the same cell again; n, the window's own gates, is on
// its first record for the reader's sake.  A tile holds kPerTile windows
// from its first record on, and its last kWin records are zero.
//
// Ring.  Two tile slots and one mbarrier each, after the state in dynamic
// shared memory.  Thread 0 fetches each tile with one TMA bulk copy
// (cp.async.bulk, completion counted in bytes on the slot's mbarrier): one
// instruction from one thread, no registers for the copy, and every thread
// can wait on the barrier.  Tiles t and t + 1 are in flight while tile t
// runs; when every thread is past tile t (__syncthreads, once a tile),
// thread 0 refills its slot with tile t + 2.
//
// Loop.  Each thread holds the current window's records in registers and
// loads the next window's (a warp-uniform broadcast from the ring, at a
// fixed stride) before it touches the state, so no index load sits on the
// dependent chain.  It reads every operand of the window, then computes
// and stores them in order, all K lanes with no branch: a guard per gate
// would make the compiler branch around each load and wait on it.
// Threads past the CTA's columns (`live` false) keep step with the others,
// since the barriers need every thread, but store nothing.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "pim_state.cuh"

namespace ring {

constexpr int kWin = PIM_LEVEL_MAX_WIDTH;   // records a window holds at most
constexpr int kRecords = PIM_TILE_RECORDS;  // records a tile holds
constexpr int kTileBytes = 8 * kRecords;
constexpr int kSlots = 2;
// Most threads a CTA has, which leaves each thread the registers of two
// windows' records and a window's operands.
constexpr int kMaxThreads = 256;

// Shared memory the ring takes after the state (the state is padded to
// 16 B first, see pim::state_bytes): the tile slots, then one mbarrier
// each.
constexpr int kRingBytes = kSlots * kTileBytes + kSlots * 8;

static_assert(kTileBytes % 16 == 0, "a bulk copy moves multiples of 16 B");

struct Stream {
  const uint2* tiles;  // [n_tiles][kRecords], 16-B aligned
  int n_tiles;
  int n_windows;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0 fetches tile `t` into its slot; the slot's barrier completes
// when all kTileBytes have landed.
__device__ __forceinline__ void fetch(uint2* slots, uint64_t* bars,
                                      const Stream& s, int t) {
  uint2* dst = slots + (t & 1) * kRecords;
  const uint32_t bar = smem_addr(bars + (t & 1));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(kTileBytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(s.tiles + static_cast<size_t>(t) * kRecords),
         "r"(kTileBytes), "r"(bar)
      : "memory");
}

// Wait until tile `t` has landed in its slot: the (t / 2)-th completion of
// that slot's barrier.
__device__ __forceinline__ void wait_tile(uint64_t* bars, int t) {
  const uint32_t bar = smem_addr(bars + (t & 1));
  const uint32_t parity = (t >> 1) & 1;
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Thread 0 sets up the barriers and starts the first two tiles.  Call it
// from every thread before the first __syncthreads of the kernel; the
// barrier makes the set-up visible before anyone waits.
__device__ __forceinline__ void start(uint2* slots, uint64_t* bars,
                                      const Stream& s) {
  if (threadIdx.x != 0 || s.n_tiles == 0) return;
  for (int i = 0; i < kSlots; ++i) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(bars + i)) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int t = 0; t < kSlots && t < s.n_tiles; ++t) fetch(slots, bars, s, t);
}

template <int K>
__device__ __forceinline__ void load_window(uint2 (&r)[K], const uint2* rec) {
#pragma unroll
  for (int k = 0; k < K; ++k) r[k] = rec[k];
}

// Store `v` at shared address `addr` if `ok`: one predicated store, never
// a branch.
__device__ __forceinline__ void store_if(bool ok, uint32_t addr, uint32_t v) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q st.shared.b32 [%0], %1;\n}\n"
      :: "r"(addr), "r"(v), "r"(static_cast<uint32_t>(ok)) : "memory");
}

__device__ __forceinline__ void store_if(bool ok, uint32_t addr,
                                         unsigned long long v) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q st.shared.b64 [%0], %1;\n}\n"
      :: "r"(addr), "l"(v), "r"(static_cast<uint32_t>(ok)) : "memory");
}

// One window of K gates on the column at `c` (cell i at c + i * stride
// bytes): every operand first, then the results in order, stored only by a
// thread that owns a column.  No branch, so all 2K loads are in flight
// together.
template <int K, class T>
__device__ __forceinline__ void window(bool live, const char* c,
                                       uint32_t c_addr, int stride,
                                       const uint2 (&r)[K]) {
  T v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = ~(*reinterpret_cast<const T*>(c + (r[k].x & 0xffffu) * stride) |
             *reinterpret_cast<const T*>(c + (r[k].x >> 16) * stride));
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    store_if(live, c_addr + (r[k].y & 0xffffu) * stride, v[k]);
  }
}

// Run the whole stream, windows of K records, on column `col` of the state
// `st` ([n_cells][stride] words of type T).  Windows sit at a fixed
// stride, kPerTile to a tile, so the next window's records load while this
// one runs and no record load waits on another.  A thread past the CTA's
// columns (`live` false) loads from inside the CTA's shared memory and
// stores nothing.
template <int K, class T>
__device__ __forceinline__ void run(T* st, int words, int col, bool live,
                                    uint2* slots, uint64_t* bars,
                                    const Stream& s) {
  static_assert(K <= kWin, "the slack after a tile's windows holds one");
  constexpr int kPerTile = (kRecords - kWin) / K;
  const char* c = reinterpret_cast<const char*>(st + col);
  const uint32_t c_addr = smem_addr(c);
  const int stride = static_cast<int>(sizeof(T)) * words;
  for (int t = 0; t < s.n_tiles; ++t) {
    wait_tile(bars, t);
    const uint2* rec = slots + (t & 1) * kRecords;
    const int count = min(kPerTile, s.n_windows - t * kPerTile);
    uint2 cur[K];
    load_window(cur, rec);
#pragma unroll 2
    for (int w = 0; w < count; ++w) {
      uint2 nxt[K];
      load_window(nxt, rec + (w + 1) * K);  // one window ahead
      window<K, T>(live, c, c_addr, stride, cur);
#pragma unroll
      for (int k = 0; k < K; ++k) cur[k] = nxt[k];
    }
    __syncthreads();  // every thread is done with this tile's slot
    if (threadIdx.x == 0 && t + 2 < s.n_tiles) fetch(slots, bars, s, t + 2);
  }
}

// Calls f(std::integral_constant<int, K>) for the smallest K in
// {2, 4, 6, 8} that holds `width` gates; returns cudaErrorInvalidValue for
// a width the kernels are not built for.  (6 is the slot scan's default
// slot width: a window of 8 would run two repeated lanes a level.)
template <class F>
int with_width(int width, F f) {
  static_assert(kWin == 8, "window bodies of 2, 4, 6 and 8 gates");
  if (width <= 2) return f(std::integral_constant<int, 2>{});
  if (width <= 4) return f(std::integral_constant<int, 4>{});
  if (width <= 6) return f(std::integral_constant<int, 6>{});
  if (width <= 8) return f(std::integral_constant<int, 8>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// The level kernel of B1 and B3: zero the state, start the ring, bring
// the inputs in (pim_state.cuh's bridges), set the folded INIT1 cell, run
// the stream on this thread's column, send the outputs out.
template <int K, int P, bool kFused>
__global__ void __launch_bounds__(kMaxThreads) level_kernel(
    const pim::Params p, const Stream s) {
  using T = typename pim::WordOf<P>::T;
  uint2* slots = reinterpret_cast<uint2*>(
      pim_smem + pim::state_bytes(p.n_cells, p.stride, sizeof(T)));
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + kSlots * kRecords);
  start(slots, bars, s);
  pim::run<P, kFused>(p, [&](pim::Column me) {
    run<K, T>(pim::state<P>(), p.stride, me.col, me.live, slots, bars, s);
  });
}

template <int K, int P, bool kFused>
int launch_planes(const pim::Params& p, const Stream& s, void* stream) {
  using T = typename pim::WordOf<P>::T;
  return pim::launch(level_kernel<K, P, kFused>, p,
                     pim::state_bytes(p.n_cells, p.stride, sizeof(T)) +
                         kRingBytes,
                     kMaxThreads, stream, p, s);
}

// Launch the level kernel on the stream `s` of `width`-record windows
// under `planes`.  Returns cudaGetLastError() of the launch.
template <bool kFused>
int launch_levels(const pim::Params& p, int planes, const Stream& s,
                  int width, void* stream) {
  return with_width(width, [&](auto k) {
    constexpr int K = decltype(k)::value;
    if (planes == 1) return launch_planes<K, 1, kFused>(p, s, stream);
    if (planes == 2) return launch_planes<K, 2, kFused>(p, s, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

}  // namespace ring
