// Gate-serial executor for PIM gate programs, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pim_kernel` (src/repro/kernels/pim_exec.py,
// reached through `pim_exec_padded`): the lowered NOR stream run one gate
// at a time over the whole packed state, in place.  rows32 only, as there.
//
// What it computes.  `gates` is int4[n_gates] of (op, a, b, o) with op in
// {INIT0 = 0, INIT1 = 1, NOT = 2 stored as NOR with b == a, NOR = 3}.  Gate
// i sets cell o to ~(s[a] | s[b]) for op >= 2, all ones for INIT1 and zero
// for INIT0.  The kernel reads the whole state uint32[n_cells][n_words] from
// device memory, runs every gate, and writes the whole state back.
//
// Shape on Hopper.  One thread owns one 32-row word column with the
// program's n_cells cells in shared memory as [n_cells][wpc]; each gate is
// one warp-uniform 16-byte load (the int4), read into registers before its
// cell is written.  The op test is warp-uniform, so no lane diverges, and
// no gate needs a barrier.
//
// What bounds it.  Device memory: the whole state in and out, 8 B per cell
// per 32 rows (605 cells for fp32 add, 151 B a row).  Shared memory: 3
// accesses of 4 B per gate per column, 3721 gates for fp32 add.  The
// dependent chain of gates, one shared load-to-store round trip each, is
// what the column waits on; the design keeps more columns per SM in flight
// by sizing wpc from n_cells.

#include <cstdint>
#include <cuda_runtime.h>

extern __shared__ uint32_t gate_serial_smem[];

namespace {

__global__ void __launch_bounds__(1024) gate_serial_kernel(
    const uint32_t* state_in, uint32_t* state_out, const int4* gates,
    int n_gates, long long n_words, int n_cells, int wpc) {
  const int col = threadIdx.x;
  const long long word = static_cast<long long>(blockIdx.x) * wpc + col;
  const bool own = col < wpc && word < n_words;
  if (!own) return;  // columns never interact: no barrier below
  uint32_t* st = gate_serial_smem;
  for (int c = 0; c < n_cells; ++c) {
    st[c * wpc + col] = __ldg(state_in + c * n_words + word);
  }
  for (int i = 0; i < n_gates; ++i) {
    const int4 g = __ldg(gates + i);
    uint32_t res;
    if (g.x >= 2) {
      res = ~(st[g.y * wpc + col] | st[g.z * wpc + col]);
    } else {
      res = g.x == 1 ? 0xffffffffu : 0u;
    }
    st[g.w * wpc + col] = res;
  }
  for (int c = 0; c < n_cells; ++c) {
    state_out[c * n_words + word] = st[c * wpc + col];
  }
}

}  // namespace

// Returns cudaGetLastError() of the launch (0 on success).
extern "C" int gate_serial(const void* state_in, void* state_out,
                           const void* gates, int n_gates, long long n_words,
                           int n_cells, int wpc, void* stream) {
  if (wpc < 1 || wpc > 1024 || n_words < 1 || n_cells < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(n_cells) * wpc * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      gate_serial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_words + wpc - 1) / wpc;
  const int threads = (wpc + 31) / 32 * 32;
  gate_serial_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(state_in),
      static_cast<uint32_t*>(state_out), static_cast<const int4*>(gates),
      n_gates, n_words, n_cells, wpc);
  return static_cast<int>(cudaGetLastError());
}
