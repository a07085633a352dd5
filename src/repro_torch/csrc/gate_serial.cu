// Gate-serial executor for PIM gate programs, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pim_kernel` (src/repro/kernels/pim_exec.py,
// reached through `pim_exec_padded`): the lowered NOR stream run one gate
// at a time over the whole packed state, in place.  rows32 only, as there.
//
// What it computes.  The lowered stream (op, a, b, o) with op in
// {INIT0 = 0, INIT1 = 1, NOT = 2 stored as NOR with b == a, NOR = 3}: gate i
// sets cell o to ~(s[a] | s[b]) for op >= 2, all ones for INIT1 and zero
// for INIT0.  The kernel reads the whole state uint32[n_cells][n_words] from
// device memory, runs every gate, and writes the whole state back.
//
// Shape on Hopper.  One thread owns one 32-row word column, with the
// program's n_cells cells in shared memory as [n_cells + 2][wpc]: the two
// last cells are constants, all zeros and all ones.  The stream comes
// packed (kernels/pim_exec.py `pack_gates`): every gate a NOR (INIT1 reads
// the zeros twice, INIT0 the ones), in order, cut into windows of two
// consecutive gates with no read-after-write, write-after-read or
// write-after-write among them (a lone gate is repeated), so reading every
// operand of a window before storing any result gives the serial state by
// construction.  It reaches shared memory through the ring of ring.cuh (a
// TMA bulk copy a tile) and is read one window ahead of its use, so no
// index load sits on the dependent chain.  A CTA holds as many columns as
// its shared memory takes beside the ring, spread over every scheduler of
// the SM (`ring_words_per_cta`, `ring_lanes`): the kernel waits on each
// column's chain, so the count of columns an SM holds sets its time.
//
// What bounds it.  Device memory: the whole state in and out, 8 B per cell
// per 32 rows (605 cells for fp32 add, 151 B a row).  Shared memory: 3
// accesses of 4 B per gate per column.  The chain of windows, one shared
// load-to-store round trip each (2469 windows of up to two gates for the
// 3721 gates of fp32 add), is what a column waits on.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(ring::kMaxThreads) gate_serial_kernel(
    int lanes, const uint32_t* state_in, uint32_t* state_out,
    const ring::Stream s, long long n_words, int n_cells, int wpc) {
  uint32_t* st = pim::state<1>();
  uint2* slots = reinterpret_cast<uint2*>(
      pim_smem + pim::state_bytes(n_cells + 2, wpc, sizeof(uint32_t)));
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + ring::kSlots *
                                               ring::kRecords);
  const pim::Column me = pim::column(wpc, lanes);
  const int col = me.col;
  const bool live = me.live;
  const long long word = static_cast<long long>(blockIdx.x) * wpc + col;
  const bool own = live && word < n_words;

  ring::start(slots, bars, s);
  if (own) {  // 32 loads in flight a thread
#pragma unroll 32
    for (int c = 0; c < n_cells; ++c) {
      st[c * wpc + col] = __ldg(state_in + c * n_words + word);
    }
  }
  if (live) {  // the constant cells INIT1 and INIT0 read
    st[n_cells * wpc + col] = 0u;
    st[(n_cells + 1) * wpc + col] = ~0u;
  }
  __syncthreads();  // the ring's barriers are set up
  ring::run<K, uint32_t>(st, wpc, col, live, slots, bars, s);
  if (own) {
#pragma unroll 32
    for (int c = 0; c < n_cells; ++c) {
      state_out[c * n_words + word] = st[c * wpc + col];
    }
  }
}

}  // namespace

// Returns cudaGetLastError() of the launch (0 on success).  `tiles` is the
// packed stream, n_tiles tiles of PIM_TILE_RECORDS records holding
// n_windows windows of `width` records; the CTA's `wpc` columns are spread
// over warps of `lanes` live lanes.
extern "C" int gate_serial(const void* state_in, void* state_out,
                           const void* tiles, int n_tiles, int n_windows,
                           int width, long long n_words, int n_cells,
                           int wpc, int lanes, void* stream) {
  if (n_cells < 1) return static_cast<int>(cudaErrorInvalidValue);
  const ring::Stream s{static_cast<const uint2*>(tiles), n_tiles,
                       n_windows};
  pim::Params shape{};  // the CTA shape alone
  shape.n_words = n_words;
  shape.wpc = shape.stride = wpc;
  shape.lanes = lanes;
  return ring::with_width(width, [&](auto k) {
    return pim::launch(
        gate_serial_kernel<decltype(k)::value>, shape,
        pim::state_bytes(n_cells + 2, wpc, sizeof(uint32_t)) +
            ring::kRingBytes,
        ring::kMaxThreads, stream, lanes,
        static_cast<const uint32_t*>(state_in),
        static_cast<uint32_t*>(state_out), s, n_words, n_cells, wpc);
  });
}
