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
// k = 0, when the block may be null).  Fused per-port row values
// (n_ports, rows) fold over axis 0 (outer 1, inner rows); packed word
// blocks (k, n_words) over the cell axis (outer 1), and rows64 blocks
// (2, k, n_words) over axis 1 (outer 2).
//
// What bounds it.  Bytes: each word of the block read once and each word
// of the fold written once, one XOR a word read; at the data sheet's 3.35
// TB/s, 1 Mi fused rows of one port (a 4 MiB copy) take at least 2.5 us.
// On its real path the block is the executor's output, just written and
// so resident in the 50 MB L2 (the device-to-host copy of the same block
// follows the fold), and a narrow block costs the card's launch floor
// (about 2.5 us a launch back to back on the H100) whatever it does.
// This design:
//
// * k <= 1 is a copy (or zeros): `copy_kernel`, kCopyUnits units a
//   thread, all loads issued before any store.  The fused 1 Mi-row chunk
//   runs as 256 CTAs that each move 16 KiB, not 4096 that each move 1 KiB
//   of 4-byte words: 0.0032 ms in L2 on the H100, not 0.0051.
// * k >= 2: `fold_kernel`, one thread a unit, kThreads threads a CTA
//   along the width and the grid's y over outer; each thread loops over
//   k, the loop unrolled so that its loads are in flight together, and at
//   each step a warp reads neighbouring units of one row.
// * 16-byte units where the fold gives every SM at least kWideCtasPerSm
//   CTAs of them, the width is a multiple of 4 and the block and the fold
//   both start on 16-byte boundaries (the launcher tests all three at run
//   time), and for the copy wherever aligned; 4-byte units otherwise.  On
//   the H100, 16-byte units fold the faulty gemv's 16 cells over 2^19
//   words about 0.8 us faster than 4-byte ones, and narrower blocks
//   slower: fewer threads then leave SMs idle.  A vector load 4 bytes past
//   a boundary would fault.
// * Default cache policy.  The block is read with plain `__ldg` (no
//   evict-first or streaming hint): the D2H copy of the same block reads
//   it again right after the fold.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Copy CTAs an SM the grid holds at most.
constexpr int kCopyCtasPerSm = 4;
// Units a thread of the copy kernel takes.
constexpr int kCopyUnits = 4;
// Fold CTAs an SM that 16-byte units must give at least.
constexpr int kWideCtasPerSm = 2;
constexpr long long kMaxGridY = 65535;

__device__ __forceinline__ void fold_into(uint32_t& acc, uint32_t v) {
  acc ^= v;
}

__device__ __forceinline__ void fold_into(uint4& acc, const uint4& v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

// k <= 1: the fold of T[outer][k][units] is a copy of its n = outer *
// units units (or zeros).  A CTA takes kThreads * U contiguous units a
// step, thread t units t + j * kThreads, all U loads issued before any
// store.
template <typename T, int U>
__global__ void __launch_bounds__(kThreads) copy_kernel(
    const T* __restrict__ block, T* __restrict__ out, int k, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * U;
  for (long long u0 = static_cast<long long>(blockIdx.x) * kThreads * U +
                      threadIdx.x;
       u0 < n; u0 += stride) {
    T v[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long u = u0 + j * kThreads;
      v[j] = k && u < n ? __ldg(block + u) : T{};
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (u0 + j * kThreads < n) out[u0 + j * kThreads] = v[j];
    }
  }
}

// k >= 2: the block as T[outer][k][units]; one thread a unit.
template <typename T>
__global__ void __launch_bounds__(kThreads) fold_kernel(
    const T* __restrict__ block, T* __restrict__ out, long long outer, int k,
    long long units) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= units) return;
  for (long long o = blockIdx.y; o < outer; o += gridDim.y) {
    const T* p = block + o * k * units + i;
    T acc = T{};
#pragma unroll 8
    for (int c = 0; c < k; ++c) fold_into(acc, __ldg(p + c * units));
    out[o * units + i] = acc;
  }
}

template <typename T>
int launch(const void* block, void* out, long long outer, int k,
           long long units, int sms, cudaStream_t stream) {
  const T* b = static_cast<const T*>(block);
  T* o = static_cast<T*>(out);
  if (k <= 1) {
    const long long cap = static_cast<long long>(sms) * kCopyCtasPerSm;
    const long long n = outer * units;
    const long long span = static_cast<long long>(kThreads) * kCopyUnits;
    const long long ctas = (n + span - 1) / span;
    copy_kernel<T, kCopyUnits>
        <<<static_cast<unsigned>(ctas < cap ? ctas : cap), kThreads, 0,
           stream>>>(b, o, k, n);
    return static_cast<int>(cudaGetLastError());
  }
  const long long blocks_x = (units + kThreads - 1) / kThreads;
  if (blocks_x > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks_x),
                  static_cast<unsigned>(outer < kMaxGridY ? outer
                                                          : kMaxGridY));
  fold_kernel<T><<<grid, kThreads, 0, stream>>>(b, o, outer, k, units);
  return static_cast<int>(cudaGetLastError());
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
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide =
      inner % 4 == 0 && reinterpret_cast<uintptr_t>(block) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
      (k <= 1 || outer * inner / 4 >= static_cast<long long>(sms) *
                                          kWideCtasPerSm * kThreads);
  return wide ? launch<uint4>(block, out, outer, k, inner / 4, sms, s)
              : launch<uint32_t>(block, out, outer, k, inner, sms, s);
}
