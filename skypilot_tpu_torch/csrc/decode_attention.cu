// Length-aware decode attention for Hopper (sm_90a) over a monolithic
// KV cache: every layer of every decode step of the batch engine.
//
// Replaces the TPU kernels of skypilot_tpu/ops/pallas/decode_attention.py:
//   * _decode_kernel        (bf16 / fp32 cache) -> TKV = __nv_bfloat16, float
//   * _decode_kernel_quant  (int8 cache)        -> TKV = int8_t, fp32 row
//                                                  scales [B, T, KVH]
// both launched there through _pallas_decode (pl.pallas_call).
//
// What it computes, per (sequence b, kv head h): the Q*G query rows of
// the head's GQA group (row r is window position r / G) attend the cache
// rows k/v[b, :, h, :] with an fp32 running max and sum, the window mask
// pos < n_valid[b] - (Q - 1 - r / G) and the finite NEG_INF of the
// reference. q is scaled by D^-0.5 in fp32 before Q.K^T; an int8 K row is
// dequantized (times its scale) before the dot. For a bf16 cache P is
// rounded to bf16 before P.V (the reference's p.astype(v.dtype)); for an
// int8 cache V is dequantized to fp32 and P stays fp32; the accumulator
// is fp32. The result is acc / max(l, 1e-30) in the query dtype, so a
// sequence with n_valid = 0 gives 0. Only rows below min(n_valid[b], T)
// are read, which is what the TPU kernel's kv_index clamp does for its
// DMAs; T need not be a multiple of the tile (the tail is masked).
//
// What bounds it on an H100: bytes. A call must read
//   sum_b min(n_valid_b, T) * KVH * D * 2 * itemsize(cache)
// bytes of K and V (int8 reads half of bf16, plus 8 bytes of scales per
// row and head), against ~4 flops per K/V element: far below the ~295
// flop/byte at which the tensor cores would bind.
//
// What the design does about it: the TPU grid (B, KVH, T/block_k) carries
// its running softmax in VMEM across the sequential kv axis; Hopper
// blocks run in no order, so here one CTA owns (b, h, split) and each of
// its warps walks its own 32-row tiles of the split's rows: it stages a
// tile of K and V in its own shared-memory slab with 16-byte cp.async
// copies, all in flight together (each needed byte read from device
// memory once), lane j scores cache row j against every query row, and
// the warp keeps its own running max, sum and accumulator, so the tile
// loop needs no block-wide barrier. At the
// end the CTA merges its warps' partials, and a second kernel merges the
// splits with a log-sum-exp combine. The wrapper picks the splits from T
// (up to 16 per (b, h): B = 4 x KVH = 8 is only 32 pairs for 132 SMs).
// Scores and P.V run on CUDA cores in fp32: simple and exact first; TMA,
// double buffering and tensor cores for long Q-windows are later work.
//
// C interface (loaded with ctypes by skypilot_tpu_torch/_build.py):
// skyt_decode_attention(...) returns cudaGetLastError() after the
// launches (0 = cudaSuccess); it launches on the given stream, never
// synchronises and allocates nothing.

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 32;  // cache rows per warp step: one per lane
constexpr int kRows = 8;   // query rows scored per pass (registers)
constexpr int kCombineThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// dtype codes shared with ops/decode_attention.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kI8 = 2;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// 16-byte asynchronous copy global -> shared (cp.async, bypassing L1);
// with `valid` false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem_src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of a CTA's dynamic shared memory: the scaled query rows,
// then one slab per warp (K tile with rows padded by 16 bytes so that
// lane j's reads of row j fall in distinct banks, V tile, the tile's
// row scales, and the warp's accumulator, running max and sum).
struct Smem {
  size_t slabs;     // offset of warp 0's slab
  size_t k, v, ks, vs, acc, m, l;  // offsets inside a slab
  size_t per_warp;  // bytes of one slab
  size_t total;
};

__host__ __device__ inline Smem smem_layout(int qg, int d, int kv_bytes,
                                            int nw) {
  Smem s;
  s.slabs = align16(sizeof(float) * qg * d);
  s.k = 0;
  s.v = s.k + align16(static_cast<size_t>(kTile) * (d * kv_bytes + 16));
  s.ks = s.v + align16(static_cast<size_t>(kTile) * d * kv_bytes);
  s.vs = s.ks + kTile * sizeof(float);
  s.acc = s.vs + kTile * sizeof(float);
  s.m = s.acc + align16(sizeof(float) * qg * d);
  s.l = s.m + align16(sizeof(float) * qg);
  s.per_warp = s.l + align16(sizeof(float) * qg);
  s.total = s.slabs + nw * s.per_warp;
  return s;
}

template <typename TQ, typename TKV, int D, int NW>
__global__ void __launch_bounds__(NW * 32)
    decode_attention_kernel(const TQ* __restrict__ q,          // [B,KVH,QG,D]
                            const TKV* __restrict__ k_cache,   // [B,T,KVH,D]
                            const TKV* __restrict__ v_cache,
                            const float* __restrict__ k_scale,  // [B,T,KVH]
                            const float* __restrict__ v_scale,
                            const int* __restrict__ n_valid,    // [B]
                            float* __restrict__ part_acc,  // [B*KVH,S,QG,D]
                            float* __restrict__ part_ml,   // [B*KVH,S,2,QG]
                            int t, int kvh, int qg, int q_len, float scale) {
  constexpr int kVec = 16 / sizeof(TKV);  // elements per 16-byte vector
  constexpr int kVecPerRow = D / kVec;
  constexpr int kKStride = D + kVec;      // padded K row, in elements
  constexpr int kSlice = D / 32;          // head dims per lane in P.V
  constexpr bool kRoundP = std::is_same<TKV, __nv_bfloat16>::value;
  constexpr int kThreads = NW * 32;

  const int bh = blockIdx.x;  // b * kvh + h
  const int b = bh / kvh;
  const int h = bh % kvh;
  const int split = blockIdx.y;
  const int num_splits = gridDim.y;
  const int group = qg / q_len;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay = smem_layout(qg, D, sizeof(TKV), NW);
  float* s_q = reinterpret_cast<float*>(smem);
  unsigned char* slab = smem + lay.slabs + warp * lay.per_warp;
  TKV* s_k = reinterpret_cast<TKV*>(slab + lay.k);
  TKV* s_v = reinterpret_cast<TKV*>(slab + lay.v);
  float* s_ks = reinterpret_cast<float*>(slab + lay.ks);
  float* s_vs = reinterpret_cast<float*>(slab + lay.vs);
  float* s_acc = reinterpret_cast<float*>(slab + lay.acc);
  float* s_m = reinterpret_cast<float*>(slab + lay.m);
  float* s_l = reinterpret_cast<float*>(slab + lay.l);

  const int nv = n_valid[b];
  // Masking by `rows`, not nv, keeps an n_valid > T (which the combine
  // kernel asserts against) from counting rows past the cache.
  const int rows = min(max(nv, 0), t);  // cache rows this sequence reads
  const int ntiles = (rows + kTile - 1) / kTile;
  const int per = (ntiles + num_splits - 1) / num_splits;
  const int tile_begin = split * per;
  const int tile_end = min(ntiles, tile_begin + per);

  const TQ* q_bh = q + static_cast<size_t>(bh) * qg * D;
  for (int i = threadIdx.x; i < qg * D; i += kThreads)
    s_q[i] = to_float(q_bh[i]) * scale;
  for (int i = lane; i < qg * D; i += 32) s_acc[i] = 0.f;
  for (int r = lane; r < qg; r += 32) {
    s_m[r] = kNegInf;
    s_l[r] = 0.f;
  }
  __syncthreads();

  const bool quant = k_scale != nullptr;
  for (int tile = tile_begin + warp; tile < tile_end; tile += NW) {
    const int base = tile * kTile;
    // Stage the tile with every 16-byte copy in flight at once (a
    // plain load-then-store loop keeps one or two per lane in flight and
    // runs at memory latency); rows at or past `rows` are zero-filled
    // and masked.
    for (int vi = lane; vi < kTile * kVecPerRow; vi += 32) {
      const int row = vi / kVecPerRow;
      const int col = (vi % kVecPerRow) * kVec;
      const int pos = base + row;
      const bool in = pos < rows;
      const size_t off =
          in ? ((static_cast<size_t>(b) * t + pos) * kvh + h) * D + col : 0;
      cp_async16(s_k + row * kKStride + col, k_cache + off, in);
      cp_async16(s_v + row * D + col, v_cache + off, in);
    }
    const int pos = base + lane;  // this lane's cache row
    {
      float ks = 1.f;
      float vs = 1.f;
      if (quant && pos < rows) {
        const size_t srow = (static_cast<size_t>(b) * t + pos) * kvh + h;
        ks = k_scale[srow];
        vs = v_scale[srow];
      }
      s_ks[lane] = ks;
      s_vs[lane] = vs;
    }
    cp_async_wait_all();
    __syncwarp();

    const float my_ks = s_ks[lane];
    const TKV* k_row = s_k + lane * kKStride;
    for (int r0 = 0; r0 < qg; r0 += kRows) {
      // Scores of cache row `pos` against query rows r0 .. r0 + kRows - 1.
      float dot[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) dot[rr] = 0.f;
#pragma unroll 2
      for (int cv = 0; cv < kVecPerRow; ++cv) {
        const uint4 raw = *reinterpret_cast<const uint4*>(k_row + cv * kVec);
        const TKV* e = reinterpret_cast<const TKV*>(&raw);
        float kf[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) kf[i] = to_float(e[i]) * my_ks;
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          if (r0 + rr < qg) {
            const float* qr = s_q + (r0 + rr) * D + cv * kVec;
#pragma unroll
            for (int i = 0; i < kVec; ++i) dot[rr] += qr[i] * kf[i];
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const int r = r0 + rr;
        if (r < qg) {  // uniform across the warp
          const bool valid = pos < rows - (q_len - 1 - r / group);
          const float s = valid ? dot[rr] : kNegInf;
          float m_tile = s;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            m_tile = fmaxf(m_tile, __shfl_xor_sync(kFull, m_tile, off));
          const float m_prev = s_m[r];
          const float m_new = fmaxf(m_prev, m_tile);
          float p = expf(s - m_new);
          float sum = p;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_xor_sync(kFull, sum, off);
          const float corr = expf(m_prev - m_new);
          if (kRoundP) p = __bfloat162float(__float2bfloat16(p));
          // P.V for row r: lane owns head dims [lane*kSlice, +kSlice).
          float* acc_r = s_acc + r * D + lane * kSlice;
          float a[kSlice];
#pragma unroll
          for (int i = 0; i < kSlice; ++i) a[i] = acc_r[i] * corr;
#pragma unroll 8
          for (int j = 0; j < kTile; ++j) {
            const float pj = __shfl_sync(kFull, p, j);
            const float vsj = s_vs[j];
            const TKV* vr = s_v + j * D + lane * kSlice;
#pragma unroll
            for (int i = 0; i < kSlice; ++i)
              a[i] += pj * (to_float(vr[i]) * vsj);
          }
#pragma unroll
          for (int i = 0; i < kSlice; ++i) acc_r[i] = a[i];
          __syncwarp();  // every lane has read s_m[r] / s_l[r]
          if (lane == 0) {
            s_m[r] = m_new;
            s_l[r] = s_l[r] * corr + sum;
          }
          __syncwarp();
        }
      }
    }
    __syncwarp();  // the next tile overwrites this slab's K and V
  }
  __syncthreads();

  // Merge the warps' partials into this split's (max, sum, acc). A warp
  // that read nothing holds (NEG_INF, 0, 0) and adds nothing.
  const size_t part = static_cast<size_t>(bh) * num_splits + split;
  float* pa = part_acc + part * qg * D;
  float* pml = part_ml + part * 2 * qg;
  auto warp_f = [&](int w, size_t offset) {
    return reinterpret_cast<const float*>(smem + lay.slabs +
                                          w * lay.per_warp + offset);
  };
  for (int i = threadIdx.x; i < qg * D; i += kThreads) {
    const int r = i / D;
    float m = kNegInf;
    for (int w = 0; w < NW; ++w) m = fmaxf(m, warp_f(w, lay.m)[r]);
    float a = 0.f;
    for (int w = 0; w < NW; ++w)
      a += warp_f(w, lay.acc)[i] * expf(warp_f(w, lay.m)[r] - m);
    pa[i] = a;
  }
  for (int r = threadIdx.x; r < qg; r += kThreads) {
    float m = kNegInf;
    for (int w = 0; w < NW; ++w) m = fmaxf(m, warp_f(w, lay.m)[r]);
    float l = 0.f;
    for (int w = 0; w < NW; ++w)
      l += warp_f(w, lay.l)[r] * expf(warp_f(w, lay.m)[r] - m);
    pml[r] = m;
    pml[qg + r] = l;
  }
}

// Log-sum-exp merge of the per-split partial (max, sum, acc) triples.
// It also checks n_valid <= T on the card, so the host never waits for
// the lengths: a failed assert fails the stream's next synchronisation.
// The check lives here because in the attention kernel the assert's call
// costs registers and spills.
template <typename TQ>
__global__ void __launch_bounds__(kCombineThreads)
    combine_kernel(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml, TQ* __restrict__ out,
                   const int* __restrict__ n_valid, int t, int kvh, int qg,
                   int d, int num_splits) {
  const int bh = blockIdx.x;
  if (threadIdx.x == 0) assert(n_valid[bh / kvh] <= t);
  const float* ml = part_ml + static_cast<size_t>(bh) * num_splits * 2 * qg;
  const float* pa = part_acc + static_cast<size_t>(bh) * num_splits * qg * d;
  for (int i = threadIdx.x; i < qg * d; i += kCombineThreads) {
    const int r = i / d;
    float m = kNegInf;
    for (int s = 0; s < num_splits; ++s) m = fmaxf(m, ml[s * 2 * qg + r]);
    float l = 0.f;
    float a = 0.f;
    for (int s = 0; s < num_splits; ++s) {
      const float w = expf(ml[s * 2 * qg + r] - m);
      l += ml[s * 2 * qg + qg + r] * w;
      a += pa[static_cast<size_t>(s) * qg * d + i] * w;
    }
    out[static_cast<size_t>(bh) * qg * d + i] =
        from_float<TQ>(a / fmaxf(l, 1e-30f));
  }
}

template <typename TQ, typename TKV, int D, int NW>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const int* n_valid, void* out, float* part_acc,
                   float* part_ml, int b, int t, int kvh, int qg, int q_len,
                   int num_splits, float scale, cudaStream_t stream) {
  const size_t smem = smem_layout(qg, D, sizeof(TKV), NW).total;
  auto kernel = decode_attention_kernel<TQ, TKV, D, NW>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(b * kvh, num_splits);
  kernel<<<grid, NW * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), k_scale, v_scale, n_valid, part_acc,
      part_ml, t, kvh, qg, q_len, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<TQ><<<b * kvh, kCombineThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<TQ*>(out), n_valid, t, kvh, qg, D,
      num_splits);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_d(int d, int nw, const void* q, const void* k,
                     const void* v, const float* k_scale,
                     const float* v_scale, const int* n_valid, void* out,
                     float* part_acc, float* part_ml, int b, int t, int kvh,
                     int qg, int q_len, int num_splits, float scale,
                     cudaStream_t stream) {
#define SKYT_LAUNCH(DIM, WARPS)                                              \
  return launch<TQ, TKV, DIM, WARPS>(q, k, v, k_scale, v_scale, n_valid,     \
                                     out, part_acc, part_ml, b, t, kvh, qg,  \
                                     q_len, num_splits, scale, stream)
#define SKYT_LAUNCH_NW(DIM) \
  if (nw == 4) {            \
    SKYT_LAUNCH(DIM, 4);    \
  }                         \
  if (nw == 1) {            \
    SKYT_LAUNCH(DIM, 1);    \
  }                         \
  return cudaErrorInvalidValue
  switch (d) {
    case 64:
      SKYT_LAUNCH_NW(64);
    case 128:
      SKYT_LAUNCH_NW(128);
    case 256:
      SKYT_LAUNCH_NW(256);
    default:
      return cudaErrorInvalidValue;
  }
#undef SKYT_LAUNCH_NW
#undef SKYT_LAUNCH
}

int kv_bytes_of(int kv_dtype) {
  return kv_dtype == kF32 ? 4 : kv_dtype == kBF16 ? 2 : 1;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA of `nw` warps needs.
size_t skyt_decode_attention_smem(int qg, int d, int kv_dtype, int nw) {
  return smem_layout(qg, d, kv_bytes_of(kv_dtype), nw).total;
}

int skyt_decode_attention(const void* q, const void* k_cache,
                          const void* v_cache, const float* k_scale,
                          const float* v_scale, const int* n_valid,
                          void* out, float* part_acc, float* part_ml, int b,
                          int t, int kvh, int qg, int q_len, int d,
                          int num_splits, int nw, float scale, int q_dtype,
                          int kv_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == kBF16 && kv_dtype == kBF16) {
    err = launch_d<__nv_bfloat16, __nv_bfloat16>(
        d, nw, q, k_cache, v_cache, k_scale, v_scale, n_valid, out, part_acc,
        part_ml, b, t, kvh, qg, q_len, num_splits, scale, s);
  } else if (q_dtype == kF32 && kv_dtype == kF32) {
    err = launch_d<float, float>(
        d, nw, q, k_cache, v_cache, k_scale, v_scale, n_valid, out, part_acc,
        part_ml, b, t, kvh, qg, q_len, num_splits, scale, s);
  } else if (q_dtype == kBF16 && kv_dtype == kI8) {
    err = launch_d<__nv_bfloat16, int8_t>(
        d, nw, q, k_cache, v_cache, k_scale, v_scale, n_valid, out, part_acc,
        part_ml, b, t, kvh, qg, q_len, num_splits, scale, s);
  } else if (q_dtype == kF32 && kv_dtype == kI8) {
    err = launch_d<float, int8_t>(
        d, nw, q, k_cache, v_cache, k_scale, v_scale, n_valid, out, part_acc,
        part_ml, b, t, kvh, qg, q_len, num_splits, scale, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
