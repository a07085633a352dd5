// Check-word fold of verified execution, for Hopper (sm_90a).
//
// Replaces `check_words` (src/repro/kernels/pim_exec.py), which the TPU
// package computes with `lax.reduce(block, 0, bitwise_xor, (axis,))` right
// behind the executor: the XOR of an output block over its port or cell
// axis, folded on the device before the block is read back, so that the
// host can refold what it received and compare.  torch has no XOR
// reduction, hence this kernel.
//
// What it computes.  The block is viewed as uint32[outer][k][inner] and
// folded over k: out[o][i] = block[o][0][i] ^ ... ^ block[o][k-1][i] (0 for
// k = 0).  Fused per-port row values (n_ports, rows) fold over axis 0
// (outer 1, inner rows); packed word blocks (k, n_words) over the cell axis
// (outer 1), and rows64 blocks (2, k, n_words) over axis 1 (outer 2).
//
// Shape on Hopper.  One thread per (outer, inner) word, 256 threads a CTA
// along inner, the grid's y over outer; each thread loops over k, and at
// each step the threads of a warp read 32 neighbouring words of one cell
// row: every load is one coalesced 128-byte line.  The loop is unrolled so
// that a thread keeps several of its k independent loads in flight.
//
// What bounds it.  Device memory: 4 B a word read once (outer * k * inner)
// and 4 B a word written (outer * inner), and one XOR a word read: at the
// H100 SXM's data-sheet 3.35 TB/s, 1 Mi fused rows of one port take at
// least 2.5 us.  It is launched on the dispatch's compute stream right
// behind the executor, whose output it reads again once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads) check_words_kernel(
    const uint32_t* __restrict__ block, uint32_t* __restrict__ out,
    long long outer, int k, long long inner) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= inner) return;
  for (long long o = blockIdx.y; o < outer; o += gridDim.y) {
    const uint32_t* p = block + o * k * inner + i;
    uint32_t acc = 0;
#pragma unroll 8
    for (int c = 0; c < k; ++c) acc ^= __ldg(p + c * inner);
    out[o * inner + i] = acc;
  }
}

}  // namespace

// Folds uint32[outer][k][inner] at `block` over k into uint32[outer][inner]
// at `out` on `stream`; returns cudaGetLastError() of the launch (0 on
// success, and 0 with nothing launched when the output is empty).
extern "C" int check_words(const void* block, void* out, long long outer,
                           int k, long long inner, void* stream) {
  if (outer < 0 || k < 0 || inner < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (outer == 0 || inner == 0) return 0;
  const long long blocks_x = (inner + kThreads - 1) / kThreads;
  if (blocks_x > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks_x),
                  static_cast<unsigned>(outer < kMaxGridY ? outer
                                                          : kMaxGridY));
  check_words_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(block), static_cast<uint32_t*>(out),
      outer, k, inner);
  return static_cast<int>(cudaGetLastError());
}
