// Paged attention for Hopper (sm_90a): decode / verify attention read
// straight from the paged KV pool through per-slot block tables.
//
// Replaces the TPU kernels of skypilot_tpu/ops/pallas/paged_attention.py:
//   * _paged_kernel        (fp pool)    -> TKV = float or __nv_bfloat16
//   * _paged_kernel_quant  (int8 pool)  -> TKV = int8_t, fp32 row scales
// both launched there through _pallas_paged (pl.pallas_call).
//
// What it computes, per (sequence b, kv head h): the Q*G query rows of
// the kv head's GQA group (row r is window position r / G) attend the
// slot's pool rows through block_tables[b, :], with an fp32 running max
// and sum, the window mask  pos < n_valid[b] - (Q - 1 - r / G)  and the
// finite NEG_INF of the reference (a fully masked row gives uniform
// weights over the blocks read, never NaN). Only the first
// ceil(n_valid[b] / BS) pool blocks are read. The result is
// acc / max(l, 1e-30), in the query dtype.
//
// What bounds it on an H100: bytes. A launch must read
//   sum_b ceil(n_valid_b / BS) * BS * KVH * D * 2 * itemsize(pool)
// bytes of K and V (an int8 pool reads half of a bf16 one, plus 8 bytes
// of scales per row and head), against ~4 flops per K/V element: far
// below the ~295 flop/byte at which the tensor cores would bind.
//
// What the design does about it: the TPU kernel walks the kv blocks as
// a sequential third grid axis carrying the running softmax in VMEM
// scratch; Hopper blocks run in no order, so here one CTA owns a
// (b, h, split) and loops over its share of the slot's blocks itself,
// reading each needed K/V byte exactly once with 16-byte vector loads
// and skipping blocks past the slot's length. A CTA walks its blocks
// one after another and waits on each, so the time follows the longest
// chain: the wrapper splits each slot's blocks evenly over `num_splits`
// CTAs (min(16, BPS); 16 was the best split count or within 1.17x of
// it from B = 4 to 128 on an H100, see PERF.md), each writes its
// partial (max, sum, acc), and a second kernel merges them with a
// log-sum-exp combine and writes the output. Scores and the P.V
// product run on CUDA cores in fp32: simple and exact first; wgmma /
// TMA / cp.async pipelining is later work.
//
// C interface (loaded with ctypes by skypilot_tpu_torch/_build.py):
// skyt_paged_attention(...) returns cudaGetLastError() after the
// launches (0 = cudaSuccess); it launches on the given stream, never
// synchronises and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// dtype codes shared with ops/paged_attention.py
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

// One 16-byte vector of a pool row -> fp32 shared memory, times `scale`
// (1 for an fp pool, the row's dequant scale for int8).
template <typename T>
__device__ __forceinline__ void load_vec16(const T* __restrict__ src,
                                           float* dst, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) dst[i] = to_float(e[i]) * scale;
}

size_t smem_bytes(int qg, int d, int bs) {
  return sizeof(float) *
         (size_t)(2 * qg * d + 2 * bs * d + qg * bs + 3 * qg);
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const TQ* __restrict__ q,         // [B,KVH,QG,D]
                           const TKV* __restrict__ k_pool,   // [NB,BS,KVH,D]
                           const TKV* __restrict__ v_pool,
                           const float* __restrict__ k_scale,  // [NB,BS,KVH]
                           const float* __restrict__ v_scale,
                           const int* __restrict__ block_tables,  // [B,BPS]
                           const int* __restrict__ n_valid,       // [B]
                           float* __restrict__ part_acc,  // [B*KVH,S,QG,D]
                           float* __restrict__ part_ml,   // [B*KVH,S,2,QG]
                           int kvh, int qg, int q_len, int bs, int bps,
                           float scale) {
  const int bh = blockIdx.x;  // b * kvh + h
  const int b = bh / kvh;
  const int h = bh % kvh;
  const int split = blockIdx.y;
  const int num_splits = gridDim.y;
  const int group = qg / q_len;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ float smem[];
  float* s_q = smem;              // [QG, D] query rows * D^-0.5
  float* s_acc = s_q + qg * D;    // [QG, D] running P.V
  float* s_k = s_acc + qg * D;    // [BS, D] staged K block
  float* s_v = s_k + bs * D;      // [BS, D] staged V block
  float* s_p = s_v + bs * D;      // [QG, BS] scores, then probabilities
  float* s_m = s_p + qg * bs;     // [QG] running max
  float* s_l = s_m + qg;          // [QG] running sum
  float* s_corr = s_l + qg;       // [QG] rescale of this block

  const int nv = n_valid[b];
  int nblk = nv > 0 ? (nv + bs - 1) / bs : 0;
  if (nblk > bps) nblk = bps;
  const int per = (nblk + num_splits - 1) / num_splits;
  const int blk_begin = split * per;
  const int blk_end = min(nblk, blk_begin + per);

  const TQ* q_bh = q + (size_t)bh * qg * D;
  for (int i = tid; i < qg * D; i += kThreads) {
    s_q[i] = to_float(q_bh[i]) * scale;
    s_acc[i] = 0.f;
  }
  for (int r = tid; r < qg; r += kThreads) {
    s_m[r] = kNegInf;
    s_l[r] = 0.f;
  }
  __syncthreads();

  constexpr int kVec = 16 / sizeof(TKV);
  constexpr int kVecPerRow = D / kVec;
  const int* bt = block_tables + (size_t)b * bps;

  for (int blk = blk_begin; blk < blk_end; ++blk) {
    const size_t pool_blk = (size_t)bt[blk];
    for (int vi = tid; vi < bs * kVecPerRow; vi += kThreads) {
      const int row = vi / kVecPerRow;
      const int col = (vi % kVecPerRow) * kVec;
      const size_t pool_row = (pool_blk * bs + row) * kvh + h;
      float ks = 1.f;
      float vs = 1.f;
      if (k_scale != nullptr) {
        ks = k_scale[pool_row];
        vs = v_scale[pool_row];
      }
      load_vec16(k_pool + pool_row * D + col, s_k + row * D + col, ks);
      load_vec16(v_pool + pool_row * D + col, s_v + row * D + col, vs);
    }
    __syncthreads();

    // Scores: one warp per (query row, key row) pair, lanes split D.
    const int base_pos = blk * bs;
    for (int pair = warp; pair < qg * bs; pair += kWarps) {
      const int r = pair / bs;
      const int j = pair % bs;
      float dot = 0.f;
#pragma unroll
      for (int d = lane; d < D; d += 32) dot += s_q[r * D + d] * s_k[j * D + d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) {
        const int qj = r / group;
        const bool valid = base_pos + j < nv - (q_len - 1 - qj);
        s_p[r * bs + j] = valid ? dot : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax, one thread per query row.
    for (int r = tid; r < qg; r += kThreads) {
      float* p = s_p + r * bs;
      const float m_prev = s_m[r];
      float m_new = m_prev;
      for (int j = 0; j < bs; ++j) m_new = fmaxf(m_new, p[j]);
      float sum = 0.f;
      for (int j = 0; j < bs; ++j) {
        const float e = expf(p[j] - m_new);
        p[j] = e;
        sum += e;
      }
      const float corr = expf(m_prev - m_new);
      s_m[r] = m_new;
      s_l[r] = s_l[r] * corr + sum;
      s_corr[r] = corr;
    }
    __syncthreads();

    for (int i = tid; i < qg * D; i += kThreads) {
      const int r = i / D;
      const int d = i % D;
      const float* p = s_p + r * bs;
      float a = 0.f;
      for (int j = 0; j < bs; ++j) a += p[j] * s_v[j * D + d];
      s_acc[i] = s_acc[i] * s_corr[r] + a;
    }
    __syncthreads();
  }

  const size_t part = (size_t)bh * num_splits + split;
  float* pa = part_acc + part * qg * D;
  for (int i = tid; i < qg * D; i += kThreads) pa[i] = s_acc[i];
  float* pml = part_ml + part * 2 * qg;
  for (int r = tid; r < qg; r += kThreads) {
    pml[r] = s_m[r];
    pml[qg + r] = s_l[r];
  }
}

// Log-sum-exp merge of the per-split partial (max, sum, acc) triples.
// An empty split holds (NEG_INF, 0, 0) and contributes nothing.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml, TQ* __restrict__ out,
                   int qg, int d, int num_splits) {
  const int bh = blockIdx.x;
  const float* ml = part_ml + (size_t)bh * num_splits * 2 * qg;
  const float* pa = part_acc + (size_t)bh * num_splits * qg * d;
  for (int i = threadIdx.x; i < qg * d; i += kThreads) {
    const int r = i / d;
    float m = kNegInf;
    for (int s = 0; s < num_splits; ++s) m = fmaxf(m, ml[s * 2 * qg + r]);
    float l = 0.f;
    float a = 0.f;
    for (int s = 0; s < num_splits; ++s) {
      const float w = expf(ml[s * 2 * qg + r] - m);
      l += ml[s * 2 * qg + qg + r] * w;
      a += pa[(size_t)s * qg * d + i] * w;
    }
    out[(size_t)bh * qg * d + i] = from_float<TQ>(a / fmaxf(l, 1e-30f));
  }
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* block_tables, const int* n_valid, void* out,
                   float* part_acc, float* part_ml, int b, int kvh, int qg,
                   int q_len, int bs, int bps, int num_splits, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(qg, D, bs);
  auto kernel = paged_attention_kernel<TQ, TKV, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(b * kvh, num_splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), k_scale, v_scale, block_tables,
      n_valid, part_acc, part_ml, kvh, qg, q_len, bs, bps, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<TQ><<<b * kvh, kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<TQ*>(out), qg, D, num_splits);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_d(int d, const void* q, const void* k_pool,
                     const void* v_pool, const float* k_scale,
                     const float* v_scale, const int* block_tables,
                     const int* n_valid, void* out, float* part_acc,
                     float* part_ml, int b, int kvh, int qg, int q_len,
                     int bs, int bps, int num_splits, float scale,
                     cudaStream_t stream) {
#define SKYT_LAUNCH(DIM)                                                    \
  return launch<TQ, TKV, DIM>(q, k_pool, v_pool, k_scale, v_scale,          \
                              block_tables, n_valid, out, part_acc, part_ml, \
                              b, kvh, qg, q_len, bs, bps, num_splits, scale, \
                              stream)
  switch (d) {
    case 64:
      SKYT_LAUNCH(64);
    case 128:
      SKYT_LAUNCH(128);
    case 256:
      SKYT_LAUNCH(256);
    default:
      return cudaErrorInvalidValue;
  }
#undef SKYT_LAUNCH
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs (the wrapper checks it
// against the card's opt-in limit before launching).
size_t skyt_paged_attention_smem(int qg, int d, int bs) {
  return smem_bytes(qg, d, bs);
}

int skyt_paged_attention(const void* q, const void* k_pool,
                         const void* v_pool, const float* k_scale,
                         const float* v_scale, const int* block_tables,
                         const int* n_valid, void* out, float* part_acc,
                         float* part_ml, int b, int kvh, int qg, int q_len,
                         int d, int bs, int bps, int num_splits, float scale,
                         int q_dtype, int kv_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == kBF16 && kv_dtype == kBF16) {
    err = launch_d<__nv_bfloat16, __nv_bfloat16>(
        d, q, k_pool, v_pool, k_scale, v_scale, block_tables, n_valid, out,
        part_acc, part_ml, b, kvh, qg, q_len, bs, bps, num_splits, scale, s);
  } else if (q_dtype == kF32 && kv_dtype == kF32) {
    err = launch_d<float, float>(
        d, q, k_pool, v_pool, k_scale, v_scale, block_tables, n_valid, out,
        part_acc, part_ml, b, kvh, qg, q_len, bs, bps, num_splits, scale, s);
  } else if (q_dtype == kBF16 && kv_dtype == kI8) {
    err = launch_d<__nv_bfloat16, int8_t>(
        d, q, k_pool, v_pool, k_scale, v_scale, block_tables, n_valid, out,
        part_acc, part_ml, b, kvh, qg, q_len, bs, bps, num_splits, scale, s);
  } else if (q_dtype == kF32 && kv_dtype == kI8) {
    err = launch_d<float, int8_t>(
        d, q, k_pool, v_pool, k_scale, v_scale, block_tables, n_valid, out,
        part_acc, part_ml, b, kvh, qg, q_len, bs, bps, num_splits, scale, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
