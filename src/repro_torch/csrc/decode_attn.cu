// Grouped-query attention of one decode step, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package computes decode attention with
// two jnp einsums and a softmax (`_group_attn`, src/repro/models/layers.py),
// which XLA fuses on the TPU.  The port's plain version of the same
// expression (`_group_attn`, src/repro_torch/models/layers.py) runs on the
// card as PyTorch's separate operators: it widens the whole cache to
// float32, copies it into the batched product's layout, multiplies, and
// only then masks the slots past the position -- some 3 GB of traffic a
// layer at batch 256 over a 576-slot cache, where the step needs the slots
// up to the position once.  This kernel computes the same function for one
// query position in one pass over those slots.
//
// What it computes.  q [B, 1, H, hd], the layer's caches k and v [B, S, K,
// hd] (any strides with the last axis contiguous), the position p = pos[0]
// (int64, read on the device: the host never waits for it).  Query head h
// reads KV head h / G, G = H / K:
//   s[t] = (q[h] . k[t]) * scale for the slots t < n = min(p + 1, S),
//   o[h] = sum_t softmax(s)[t] v[t],
// written as [B, 1, H, hd] in the caches' type.  The plain version gives
// the slots past p the score -1e30, whose weight exp(-1e30 - max) is 0 in
// float32: the same sum.  Here those slots are never loaded.
//
// What bounds it.  Bytes: the keys and values of slots 0..p, once, 4 * K *
// hd * (p + 1) bytes a row in bf16 (1,048,576 * (p + 1) B a layer at B 256,
// K 8, hd 128: 0.18 ms at 3.35 TB/s at p = 575).  Its arithmetic is 4 * G
// operations a cached value; done on the CUDA cores from shared memory it
// costs more instructions than the bytes take to arrive, so the bfloat16
// path runs both products on the tensor cores.
//
// Two paths, chosen from the dtypes and the head dim alone:
//
// * bfloat16 query and caches, head dims up to 128 (every published GQA
//   config): `decode_mma_kernel`, described where it is defined.
// * anything else the wrapper takes (a float32 query or float32 caches,
//   head dims 144 to 256): `decode_kernel`, on the CUDA cores in float32.
//
// Both:
//
// * One CTA for each (row, KV head): its G query heads share each key and
//   value it loads, so the cache is read once (no head replication).
//   B * K = 2048 CTAs at the benchmark's cell; one launch a layer.
// * The slots stream through shared memory in tiles (the wrapper picks the
//   tile), keys and values by 16-byte cp.async copies that bypass L1, the
//   next tiles loading while one is used.  A slot past p is not copied.
//   Rows are padded by 16 bytes, so that neither the CUDA cores' loads nor
//   ldmatrix meet bank conflicts.
// * Online softmax in float32: each tile rescales the running output by
//   exp(m_old - m_new).
// * No split of the slots: where B * K CTAs leave SMs idle (batch 4 or
//   32), chunks of the slots merged by a second launch were measured
//   slower than one pass on the tensor-core path at every position (0.49x
//   to 0.73x), since the host never reads the position and chunks past it
//   still cost their launch and merge.
//
// `decode_kernel`, the CUDA cores' path: kThreads threads a CTA, two
// stages.  Scores: each thread takes one slot of the tile and some of the
// G heads, float32 dot products of the widened keys with the query, held
// in shared memory, times scale; each warp keeps the running max and sum
// of its heads.  P.V: each thread owns 8 outputs (one head, 8 dims) and,
// where the outputs are fewer than the threads, a share of the tile's
// slots, the shares summed at the end.  The weights stay float32.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Query heads one KV head serves at most (G), and the head dims taken.
constexpr int kMaxGroup = 16;
constexpr int kMaxHeadDim = 256;
// Heads whose running max and sum one warp keeps.
constexpr int kHeadsPerWarp = kMaxGroup / kWarps;
// 8-output units one thread owns at most: kMaxGroup * kMaxHeadDim / 8
// units over kThreads threads.
constexpr int kMaxUnits = kMaxGroup * kMaxHeadDim / 8 / kThreads;
// Bytes of padding after each row of a tile in shared memory.
constexpr int kPad = 16;
// Dynamic shared memory one CTA may opt into on sm_90 (227 KB).
constexpr int kMaxSmem = 232448;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const long long* pos;
  void* out;
  int B, S, H, K, G, hd, tile;
  long long qsb, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one group (the tile just issued) is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float widen(float x) { return x; }

// Eight consecutive values at p (shared memory, 16-byte aligned), widened.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// Eight values to p (global memory, 16-byte aligned), rounded to nearest.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&x)[8]) {
  uint4 w;
  unsigned* u = reinterpret_cast<unsigned*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    u[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = w;
}

__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename TKV>
__host__ __device__ constexpr int row_pitch(int hd) {  // elements a row
  return hd + kPad / static_cast<int>(sizeof(TKV));
}

template <typename TKV>
size_t smem_bytes(int G, int hd, int tile) {
  return static_cast<size_t>(4) * tile * row_pitch<TKV>(hd) * sizeof(TKV) +
         sizeof(float) * (static_cast<size_t>(G) * hd +
                          static_cast<size_t>(G) * (tile + 1) +
                          2 * kMaxGroup);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / a.K, kvh = blockIdx.x - b * a.K;
  const int G = a.G, hd = a.hd, T = a.tile;
  const int oct = hd / 8;  // 8-value groups a row
  const int pitch = row_pitch<TKV>(hd);
  const int tile_elems = T * pitch;
  // [stage][keys, values][T][pitch], then the query, the weights
  // [G][T + 1] and each head's alpha and sum
  TKV* stages = reinterpret_cast<TKV*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + sizeof(TKV) * 4 * tile_elems);
  float* p_s = q_s + G * hd;
  float* alpha_s = p_s + G * (T + 1);
  float* l_s = alpha_s + kMaxGroup;

  const long long p = *a.pos;
  const int n_valid = static_cast<int>(
      p + 1 < static_cast<long long>(a.S) ? (p < 0 ? 0 : p + 1) : a.S);
  const int n_tiles = (n_valid + T - 1) / T;

  const TQ* qb = static_cast<const TQ*>(a.q) + b * a.qsb +
                 static_cast<long long>(kvh) * G * a.qsh;
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd;
    q_s[i] = widen(qb[g * a.qsh + (i - g * hd)]);
  }

  const TKV* kb = static_cast<const TKV*>(a.k) + b * a.ksb + kvh * a.ksh;
  const TKV* vb = static_cast<const TKV*>(a.v) + b * a.vsb + kvh * a.vsh;
  constexpr int kPiece = 16 / sizeof(TKV);  // elements a 16-byte copy
  const int per_row = hd / kPiece;
  auto issue = [&](int it, int st) {
    const int s0 = it * T;
    const int rows = min(T, n_valid - s0);
    TKV* ks = stages + 2 * st * tile_elems;
    TKV* vs = ks + tile_elems;
    for (int i = tid; i < rows * per_row; i += kThreads) {
      const int r = i / per_row, c = (i - r * per_row) * kPiece;
      const long long slot = s0 + r;
      cp_async16(ks + r * pitch + c, kb + slot * a.kss + c);
      cp_async16(vs + r * pitch + c, vb + slot * a.vss + c);
    }
  };

  // the score phase: slot t_s of the tile, heads gq, gq + nq, ...
  const int nq = kThreads / T;
  const int t_s = tid % T, gq = tid / T;
  // the P.V phase: units u0 + i * kThreads (head u / oct, dims 8 * (u %
  // oct)), slots part, part + n_part, ... of each tile
  const int U = G * oct;
  const int n_part = U >= kThreads ? 1 : kThreads / U;
  const int part = U >= kThreads ? 0 : tid / U;
  const int u0 = U >= kThreads ? tid : tid % U;
  const bool pv = part < n_part;
  int ug[kMaxUnits], uo[kMaxUnits];
#pragma unroll
  for (int i = 0; i < kMaxUnits; ++i) {
    const int u = u0 + i * kThreads;
    ug[i] = u < U ? u / oct : -1;
    uo[i] = u < U ? (u - (u / oct) * oct) * 8 : 0;
  }
  float acc[kMaxUnits][8];
#pragma unroll
  for (int i = 0; i < kMaxUnits; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  float m_run[kHeadsPerWarp], l_run[kHeadsPerWarp];
#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    m_run[j] = -INFINITY;
    l_run[j] = 0.f;
  }

  if (n_tiles > 0) issue(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) issue(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const TKV* ks = stages + 2 * st * tile_elems;
    const TKV* vs = ks + tile_elems;
    const int nt = min(T, n_valid - it * T);  // slots of the tile

    if (t_s < nt) {
      float s[kMaxGroup];
#pragma unroll
      for (int j = 0; j < kMaxGroup; ++j) s[j] = 0.f;
      const TKV* kr = ks + t_s * pitch;
#pragma unroll 2
      for (int o = 0; o < hd; o += 8) {
        float x[8];
        load8(kr + o, x);
#pragma unroll
        for (int j = 0; j < kMaxGroup; ++j) {
          const int g = gq + j * nq;
          if (g < G) {
            const float4 qa = *reinterpret_cast<const float4*>(q_s + g * hd + o);
            const float4 qc =
                *reinterpret_cast<const float4*>(q_s + g * hd + o + 4);
            float d = s[j];
            d = fmaf(qa.x, x[0], d);
            d = fmaf(qa.y, x[1], d);
            d = fmaf(qa.z, x[2], d);
            d = fmaf(qa.w, x[3], d);
            d = fmaf(qc.x, x[4], d);
            d = fmaf(qc.y, x[5], d);
            d = fmaf(qc.z, x[6], d);
            d = fmaf(qc.w, x[7], d);
            s[j] = d;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxGroup; ++j) {
        const int g = gq + j * nq;
        if (g < G) p_s[g * (T + 1) + t_s] = s[j] * a.scale;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) {
      const int g = warp + j * kWarps;
      if (g < G) {
        float* row = p_s + g * (T + 1);
        float mx = -INFINITY;
        for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, row[t]);
        const float m_new = fmaxf(m_run[j], warp_max(mx));
        const float alpha = expf(m_run[j] - m_new);
        float sum = 0.f;
        for (int t = lane; t < nt; t += 32) {
          const float e = expf(row[t] - m_new);
          row[t] = e;
          sum += e;
        }
        l_run[j] = l_run[j] * alpha + warp_sum(sum);
        m_run[j] = m_new;
        if (lane == 0) alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    if (pv) {
#pragma unroll
      for (int i = 0; i < kMaxUnits; ++i) {
        if (ug[i] >= 0) {
          const float al = alpha_s[ug[i]];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][e] *= al;
        }
      }
      for (int t = part; t < nt; t += n_part) {
        const TKV* vr = vs + t * pitch;
#pragma unroll
        for (int i = 0; i < kMaxUnits; ++i) {
          if (ug[i] >= 0) {
            const float w = p_s[ug[i] * (T + 1) + t];
            float x[8];
            load8(vr + uo[i], x);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(w, x[e], acc[i][e]);
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the tile after next
  }

#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    const int g = warp + j * kWarps;
    if (g < G && lane == 0) l_s[g] = l_run[j];
  }
  // the slot shares' sums, through the stages (free: the loop ended on a
  // barrier or never ran); fewer units than threads, so one unit a thread
  float* red = reinterpret_cast<float*>(smem);
  if (n_part > 1 && pv && part > 0) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red[((part - 1) * U + u0) * 8 + e] = acc[0][e];
  }
  __syncthreads();
  if (!pv || part > 0) return;
  if (n_part > 1) {
    for (int r = 1; r < n_part; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[0][e] += red[((r - 1) * U + u0) * 8 + e];
  }
#pragma unroll
  for (int i = 0; i < kMaxUnits; ++i) {
    if (ug[i] < 0) continue;
    const long long bh = static_cast<long long>(b) * a.H + kvh * G + ug[i];
    const float l = l_s[ug[i]];
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = acc[i][e] / l;
    store8(static_cast<TKV*>(a.out) + bh * hd + uo[i], y);
  }
}

template <typename TQ, typename TKV>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<TKV>(a.G, a.hd, a.tile);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(a.B) * a.K;
  decode_kernel<TQ, TKV>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The tensor-core path: bfloat16 query and caches, head dims up to 128.
//
// One CTA of kMmaWarps warps for each (row, KV head), as above, and tiles
// of kMmaTile slots in kMmaStages shared-memory stages, so that
// kMmaStages - 1 tiles are in flight while one is used.  Slots past the
// position in its last tile are filled with zeros by the copy and never
// read from global memory.  Each warp takes its own 16 slots of every tile
// and keeps its own running max, sum and output, merged once at the end:
// one barrier a tile.  Its G query heads are the 16 rows of an
// mma.m16n8k16 (rows past G zero):
//   scores  S [16 heads x 8 slots] += Q [16 x 16 dims] K^T [16 dims x 8]
//   outputs O [16 heads x 8 dims]  += P [16 x 16 slots] V [16 slots x 8]
// Products of two bfloat16 values are exact in the float32 accumulators;
// the scores, their max, exp and sums stay float32, and P enters the
// second product as the sum of two bfloat16 parts (hi + lo, 16 bits of
// mantissa), so the weights are not rounded to bfloat16 as the plain
// version rounds them.

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaTile = 16 * kMmaWarps;
constexpr int kMmaStages = 3;
constexpr int kMmaMaxHeadDim = 128;

// A 16-byte copy that reads `src` only where `full`, else writes zeros.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bfloat16 matrices; lanes 8i to 8i + 7 give matrix i's rows.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a b: a 16 x 16 (row-major fragments), b 16 x 8, d 16 x 8 float32.
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack2(__nv_bfloat162 h) {
  return *reinterpret_cast<const unsigned*>(&h);
}

// x0, x1 (the lower column first) as bfloat16 hi and lo parts.
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = pack2(h);
  lo = pack2(__floats2bfloat162_rn(x0 - __bfloat162float(h.x),
                                   x1 - __bfloat162float(h.y)));
}

template <int HD>
size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (HD + 8) *
         (static_cast<size_t>(2) * kMmaStages * kMmaTile + 16);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads) decode_mma_kernel(const Args a) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPitch = HD + 8;  // 16 bytes of padding a row
  constexpr int kTileElems = kMmaTile * kPitch;
  constexpr int kOct = HD / 8;
  constexpr int kSteps = HD / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / a.K, kvh = blockIdx.x - b * a.K;
  const int G = a.G;
  bf16* stages = reinterpret_cast<bf16*>(smem);  // [stage][k, v][T][pitch]
  bf16* q_s = stages + 2 * kMmaStages * kTileElems;  // [16][pitch]

  const long long p = *a.pos;
  const int n_valid = static_cast<int>(
      p + 1 < static_cast<long long>(a.S) ? (p < 0 ? 0 : p + 1) : a.S);
  const int n_tiles = (n_valid + kMmaTile - 1) / kMmaTile;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qsb +
                   static_cast<long long>(kvh) * G * a.qsh;
  for (int i = tid; i < 16 * HD; i += kMmaThreads) {
    const int r = i / HD, c = i - (i / HD) * HD;
    q_s[r * kPitch + c] = r < G ? qb[r * a.qsh + c] : __float2bfloat16_rn(0.f);
  }

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ksb + kvh * a.ksh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vsb + kvh * a.vsh;
  auto issue = [&](int it, int st) {
    const int s0 = it * kMmaTile;
    const int rows = min(kMmaTile, n_valid - s0);
    bf16* ks = stages + 2 * st * kTileElems;
    bf16* vs = ks + kTileElems;
    for (int i = tid; i < kMmaTile * kOct; i += kMmaThreads) {
      const int r = i / kOct, c = (i - (i / kOct) * kOct) * 8;
      const bool in = r < rows;
      const long long slot = in ? s0 + r : s0;
      cp_async16_zfill(ks + r * kPitch + c, kb + slot * a.kss + c, in);
      cp_async16_zfill(vs + r * kPitch + c, vb + slot * a.vss + c, in);
    }
  };

#pragma unroll
  for (int st = 0; st < kMmaStages - 1; ++st) {
    if (st < n_tiles) issue(st, st);
    cp_async_commit();
  }
  __syncthreads();  // the query
  unsigned qf[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    ldsm_x4(qf[kk], q_s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kPitch +
                        kk * 16 + 8 * (lane >> 4));

  float o[kOct][4];
#pragma unroll
  for (int n = 0; n < kOct; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // rows gr and gr + 8: running max and this lane's share of the sum
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const int w0 = 16 * warp;  // this warp's slots of each tile

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();  // tile it landed; the stage of tile it - 1 is free
    const int nx = it + kMmaStages - 1;
    if (nx < n_tiles) issue(nx, nx % kMmaStages);
    cp_async_commit();
    const int nt = min(kMmaTile, n_valid - it * kMmaTile);
    if (w0 >= nt) continue;  // warp-uniform: none of its slots is valid
    const bf16* ks = stages + 2 * (it % kMmaStages) * kTileElems;
    const bf16* vs = ks + kTileElems;

    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      unsigned kf[4];
      ldsm_x4(kf, ks + (w0 + 8 * (lane >> 4) + (lane & 7)) * kPitch +
                      kk * 16 + 8 * ((lane >> 3) & 1));
      mma16816(s[0], qf[kk], kf[0], kf[1]);
      mma16816(s[1], qf[kk], kf[2], kf[3]);
    }
    // s[j][e]: head gr + 8 (e >> 1), slot w0 + 8 j + 2 t4 + (e & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = w0 + 8 * j + 2 * t4 + (e & 1);
        s[j][e] = slot < nt ? s[j][e] * a.scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);  // finite: slot w0 is valid
      alpha[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_r[e >> 1]);
        l_r[e >> 1] += s[j][e];
      }
    unsigned ph[4], pl[4];  // P's A fragments, hi and lo parts
    split2(s[0][0], s[0][1], ph[0], pl[0]);
    split2(s[0][2], s[0][3], ph[1], pl[1]);
    split2(s[1][0], s[1][1], ph[2], pl[2]);
    split2(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int n = 0; n < kOct; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n2 = 0; n2 < kOct / 2; ++n2) {
      unsigned vf[4];
      ldsm_x4_t(vf, vs + (w0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kPitch +
                        n2 * 16 + 8 * (lane >> 4));
      mma16816(o[2 * n2], ph, vf[0], vf[1]);
      mma16816(o[2 * n2], pl, vf[0], vf[1]);
      mma16816(o[2 * n2 + 1], ph, vf[2], vf[3]);
      mma16816(o[2 * n2 + 1], pl, vf[2], vf[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages

  // each warp's max, sum and output through the stages: [warp][16] max,
  // [warp][16] sum, [warp][16][HD] output
  float* red_m = reinterpret_cast<float*>(smem);
  float* red_l = red_m + kMmaWarps * 16;
  float* red_o = red_l + kMmaWarps * 16;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    if (t4 == 0) {
      red_m[warp * 16 + gr + 8 * r] = m_r[r];
      red_l[warp * 16 + gr + 8 * r] = l_r[r];
    }
  }
#pragma unroll
  for (int n = 0; n < kOct; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red_o[(warp * 16 + gr + 8 * (e >> 1)) * HD + 8 * n + 2 * t4 + (e & 1)] =
          o[n][e];
  __syncthreads();

  for (int i = tid; i < G * HD; i += kMmaThreads) {
    const int h = i / HD, d = i - (i / HD) * HD;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) m = fmaxf(m, red_m[w * 16 + h]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float mw = red_m[w * 16 + h];
      const float c = mw == -INFINITY ? 0.f : expf(mw - m);
      num = fmaf(c, red_o[(w * 16 + h) * HD + d], num);
      den = fmaf(c, red_l[w * 16 + h], den);
    }
    const long long bh = static_cast<long long>(b) * a.H + kvh * G + h;
    static_cast<bf16*>(a.out)[bh * HD + d] = __float2bfloat16_rn(num / den);
  }
}

template <int HD>
int launch_mma(const Args& a, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(a.B) * a.K;
  decode_mma_kernel<HD><<<static_cast<unsigned>(blocks), kMmaThreads, smem,
                          stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma_hd(const Args& a, cudaStream_t stream) {
  switch (a.hd) {
    case 16: return launch_mma<16>(a, stream);
    case 32: return launch_mma<32>(a, stream);
    case 48: return launch_mma<48>(a, stream);
    case 64: return launch_mma<64>(a, stream);
    case 80: return launch_mma<80>(a, stream);
    case 96: return launch_mma<96>(a, stream);
    case 112: return launch_mma<112>(a, stream);
    case 128: return launch_mma<128>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Decode attention of q [B, 1, H, hd] over the caches k, v [B, S, K, hd]
// up to the slot pos[0], into out [B, 1, H, hd] (contiguous, the caches'
// type), on `stream`.  Strides are in elements (q's of its rows and heads,
// each cache's of its rows, slots and heads); every pointer and every
// cache stride is 16-byte aligned.  `q_f32` and `kv_f32` choose float32
// over bfloat16.  `tile` slots a tile: 64 where both are bfloat16 and hd
// is at most 128 (the tensor-core path), else a power of two from 16 to
// 128.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const void* pos, void* out, int B, int S, int H,
                           int K, int hd, long long qsb, long long qsh,
                           long long ksb, long long kss, long long ksh,
                           long long vsb, long long vss, long long vsh,
                           int q_f32, int kv_f32, int tile, float scale,
                           void* stream) {
  if (B <= 0 || K <= 0 || H % K || H / K > kMaxGroup || hd % 16 ||
      hd < 16 || hd > kMaxHeadDim || tile < 16 || tile > kThreads ||
      kThreads % tile)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.pos = static_cast<const long long*>(pos);
  a.out = out;
  a.B = B;
  a.S = S;
  a.H = H;
  a.K = K;
  a.G = H / K;
  a.hd = hd;
  a.tile = tile;
  a.qsb = qsb;
  a.qsh = qsh;
  a.ksb = ksb;
  a.kss = kss;
  a.ksh = ksh;
  a.vsb = vsb;
  a.vss = vss;
  a.vsh = vsh;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!q_f32 && !kv_f32 && hd <= kMmaMaxHeadDim)
    return tile == kMmaTile ? launch_mma_hd(a, s)
                            : static_cast<int>(cudaErrorInvalidValue);
  if (kv_f32)
    return q_f32 ? launch<float, float>(a, s)
                 : launch<__nv_bfloat16, float>(a, s);
  return q_f32 ? launch<float, __nv_bfloat16>(a, s)
               : launch<__nv_bfloat16, __nv_bfloat16>(a, s);
}
