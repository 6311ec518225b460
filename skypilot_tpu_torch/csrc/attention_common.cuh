// Device helpers of the attention kernels for Hopper (sm_90a), included
// by csrc/paged_attention.cu and csrc/decode_attention.cu: 16- and
// 4-byte cp.async copies, warp and quad reductions, mma.sync.m16n8k16
// with ldmatrix fragments, the exact int8 -> bf16 widening, the ring
// depths and the epilogue that merges a CTA's warps and the split CTAs
// of one (sequence, kv head) through distributed shared memory. Each
// .cu file is its own library, so the helpers keep internal linkage.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the reference's finite NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 32;       // K/V rows per warp step (CUDA cores)
constexpr int kMmaTile = 16;    // K/V rows per warp step (tensor cores)
constexpr int kRows = 8;        // query rows scored per pass (CUDA cores)
constexpr int kMaxWarps = 4;
constexpr int kSlabBudget = 26624;  // slab bytes a warp aims at: 2 CTAs a SM
constexpr int kSmemLimit = 232448;  // opt-in shared memory of one CTA
constexpr unsigned kFull = 0xffffffffu;

// dtype codes shared with ops/paged_attention.py and
// ops/decode_attention.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kI8 = 2;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
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
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- and 4-byte asynchronous copies global -> shared; with `valid`
// false nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// `N` elements of a shared-memory row -> fp32, with one or two vector
// loads (the slice is N * sizeof(T) bytes, aligned to that size).
template <typename T, int N>
__device__ __forceinline__ void load_slice(const T* p, float (&out)[N]) {
  constexpr int kBytes = N * sizeof(T);
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i)
        out[c * (16 / sizeof(T)) + i] = to_float(e[i]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  } else if constexpr (kBytes == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  } else {
    const uint16_t raw = *reinterpret_cast<const uint16_t*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core fragments (mma.sync.m16n8k16, bf16 in, fp32 accumulate).
// Accumulator layout: lane (g = lane / 4, t = lane % 4) holds rows g and
// g + 8, columns 2t and 2t + 1 of each 8-wide tile:
// c = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&f)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&f)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
      : "r"(smem_u32(p)));
}

// A[m][k] = a[m * lda + k], m and k in 0-15.
__device__ __forceinline__ void load_a(uint32_t (&f)[4], const bf16* a,
                                       int lda, int lane) {
  ldsm_x4(f, a + (lane & 15) * lda + (lane >> 4) * 8);
}

// B[k][n] = x[n * ldx + k], k and n in 0-15 (rows of x are n: K in
// q.K^T); f[0..1] is the fragment of n 0-7, f[2..3] of n 8-15.
__device__ __forceinline__ void load_b_nk(uint32_t (&f)[4], const bf16* x,
                                          int ldx, int lane) {
  ldsm_x4(f, x + ((lane >> 4) * 8 + (lane & 7)) * ldx +
                 ((lane >> 3) & 1) * 8);
}

// B[k][n] = x[k * ldx + n] (rows of x are k: V in P.V).
__device__ __forceinline__ void load_b_kn(uint32_t (&f)[4], const bf16* x,
                                          int ldx, int lane) {
  ldsm_x4_trans(f, x + (((lane >> 3) & 1) * 8 + (lane & 7)) * ldx +
                       (lane >> 4) * 8);
}

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a k16 step from the accumulators of its two 8-wide
// tiles (columns 0-7 in c0, 8-15 in c1).
__device__ __forceinline__ void acc_a(uint32_t (&f)[4], const float (&c0)[4],
                                      const float (&c1)[4]) {
  f[0] = pack_floats(c0[0], c0[1]);
  f[1] = pack_floats(c0[2], c0[3]);
  f[2] = pack_floats(c1[0], c1[1]);
  f[3] = pack_floats(c1[2], c1[3]);
}

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// ---------------------------------------------------------------------------
// The epilogue both kernels share
// ---------------------------------------------------------------------------

// The CTA's epilogue. Warp w's partial sits at smem + slabs + w *
// per_warp: acc [qg, D] at +off_acc, running max [qg] at +off_m and sum
// [qg] at +off_l, in log2 units (a warp that read nothing holds
// (NEG_INF, 0, 0)). Merges the warps; with one active split writes the
// output. Else the CTA's merged partial stays in its shared memory (acc
// over warp 0's, max and sum in s_row), and the cluster's rank 0 (the
// split CTAs of one (b, h) are one cluster) merges the active ranks'
// partials through distributed shared memory and writes the output.
// Every thread of an active CTA calls it.
template <typename TQ, int D>
__device__ __forceinline__ void finish(unsigned char* smem, int slabs,
                                       int per_warp, int off_acc, int off_m,
                                       int off_l, float* s_row, int qg,
                                       int bh, int active,
                                       TQ* __restrict__ out) {
  const int nw = blockDim.x / 32;
  auto warp_f = [&](int w, int off) {
    return reinterpret_cast<float*>(smem + slabs + w * per_warp + off);
  };
  __syncthreads();
  for (int r = threadIdx.x; r < qg; r += blockDim.x) {
    float m = kNegInf;
    for (int w = 0; w < nw; ++w) m = fmaxf(m, warp_f(w, off_m)[r]);
    float l = 0.f;
    for (int w = 0; w < nw; ++w)
      l += warp_f(w, off_l)[r] * exp2f(warp_f(w, off_m)[r] - m);
    s_row[r] = m;
    s_row[qg + r] = l;
  }
  __syncthreads();
  TQ* out_bh = out + static_cast<size_t>(bh) * qg * D;
  float* acc = warp_f(0, off_acc);
  for (int i = threadIdx.x; i < qg * D; i += blockDim.x) {
    const int r = i / D;
    float a = 0.f;
    for (int w = 0; w < nw; ++w)
      a += warp_f(w, off_acc)[i] * exp2f(warp_f(w, off_m)[r] - s_row[r]);
    if (active == 1)
      out_bh[i] = from_float<TQ>(a / fmaxf(s_row[qg + r], 1e-30f));
    else
      acc[i] = a;  // each element is read and written by one thread
  }
  if (active == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int i = threadIdx.x; i < qg * D; i += blockDim.x) {
      const int r = i / D;
      float m = kNegInf;
      float l = 0.f;
      float a = 0.f;
      for (int s = 0; s < active; ++s) {
        const float* row = cluster.map_shared_rank(s_row, s);
        const float ms = row[r];
        const float m_new = fmaxf(m, ms);
        const float c_old = exp2f(m - m_new);
        const float c_s = exp2f(ms - m_new);
        l = l * c_old + row[qg + r] * c_s;
        a = a * c_old + cluster.map_shared_rank(acc, s)[i] * c_s;
        m = m_new;
      }
      out_bh[i] = from_float<TQ>(a / fmaxf(l, 1e-30f));
    }
  }
  cluster.sync();  // the ranks' shared memory outlives rank 0's reads
}

// A split CTA with no blocks of its slot: its cluster's barriers only.
__device__ __forceinline__ void idle_split(int active) {
  if (active > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    cluster.sync();
  }
}

__host__ __device__ constexpr int clamp_stages(int n) {
  return n < 2 ? 2 : n > 4 ? 4 : n;
}

// Ring depth of one warp: as many 16-row stages (K and V, rows padded by
// 16 bytes) as fit in kSlabBudget beside the int8 widened tiles, 2 to 4.
__host__ __device__ constexpr int mma_stages(int kv_bytes, int d) {
  return clamp_stages(
      (kSlabBudget - (kv_bytes == 1 ? 2 * kMmaTile * (2 * d + 16) : 0)) /
      (2 * kMmaTile * (d * kv_bytes + 16)));
}

// 16 rows of an int8 tile (pitch D + 16 bytes) -> bf16 (pitch D + 8),
// exactly, on full-rate ALU instructions: byte x + 128 goes into the
// mantissa of 2^23, and 2^23 + 128 comes off in fp32.
template <int D>
__device__ __forceinline__ void widen(bf16* dst, const int8_t* src,
                                      int lane) {
  constexpr int kVecPerRow = D / 16;
#pragma unroll
  for (int c = 0; c < kMmaTile * kVecPerRow / 32; ++c) {
    const int v = c * 32 + lane;
    const int row = v / kVecPerRow;
    const int col = (v % kVecPerRow) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + row * (D + 16) +
                                                      col);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = words[i] ^ 0x80808080u;
      float f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[j] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + j)) -
               8388736.f;
      w[2 * i] = pack_floats(f[0], f[1]);
      w[2 * i + 1] = pack_floats(f[2], f[3]);
    }
    uint4* d = reinterpret_cast<uint4*>(dst + row * (D + 8) + col);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// Ring depth of one warp, by the bytes of a 32-row tile's K and V: two
// or three tiles stay in flight while the warp computes one.
__host__ __device__ constexpr int simt_stages(int kv_bytes, int d) {
  return 2 * kTile * d * kv_bytes <= 8192    ? 4
         : 2 * kTile * d * kv_bytes <= 16384 ? 3
                                             : 2;
}

int kv_bytes_of(int kv_dtype) {
  return kv_dtype == kF32 ? 4 : kv_dtype == kBF16 ? 2 : 1;
}

}  // namespace
