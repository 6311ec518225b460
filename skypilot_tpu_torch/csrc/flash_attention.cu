// Flash attention for Hopper (sm_90a): the causal / non-causal GQA
// forward, the dq backward and the dk/dv backward, each optionally
// segment-masked (packed sequences).
//
// Replaces the TPU kernels of skypilot_tpu/ops/pallas/flash_attention.py:
//   * _fwd_kernel      (:62)  and _fwd_kernel_seg      (:128) -> flash_fwd_kernel
//   * _bwd_dq_kernel   (:193) and _bwd_dq_kernel_seg   (:246) -> flash_dq_kernel
//   * _bwd_dkv_kernel  (:254) and _bwd_dkv_kernel_seg  (:325) -> flash_dkv_kernel
// The _seg bodies are the same body with a segment-id mask, so here each
// kernel is one template with SEG on or off.
//
// What they compute (q [B,S,H,D], k/v [B,S,KVH,D], the model layout read
// in place, no transposes; kv head of query head h is h / (H / KVH)):
//   fwd: o = softmax(q k^T * D^-0.5, masked) v and lse = m + log(l),
//        with an fp32 running max/sum, the finite NEG_INF mask and the
//        max(l, 1e-30) clamp of the reference; P is rounded to v's type
//        before the P.V product, as in the reference.
//   dq:  p = exp(s - lse), ds = p * (do v^T - delta), dq = ds k * scale,
//        delta = rowsum(do * o) precomputed by the wrapper.
//   dkv: dv = sum over the GQA group and q tiles of p^T do, dk = ds^T q *
//        scale, summed in fp32 inside the block and written once.
// Causal runs skip the key tiles past the diagonal (fwd, dq) and the
// query tiles before it (dkv).
//
// What bounds them on an H100: operations. A causal call at S = 2048,
// D = 128 does 2 (fwd), 3 (dq) or 4 (dkv) products of 2*B*H*S^2*D/2
// flops while reading each input once: about 1,000 flops per byte,
// far above the ~295 at which bf16 tensor cores stop waiting on memory.
//
// What the design does about it: bf16 inputs run every product on the
// tensor cores (warp-level mma.sync.m16n8k16, fp32 accumulation); fp32
// inputs run the same tiling with fp32 FMAs on CUDA cores (the fp32
// tolerance rules out TF32). One CTA of 4 warps owns 64 rows (q rows for
// fwd/dq, key rows for dkv), each warp 16; the other side streams
// through shared memory in tiles of 64 or 32 rows. Scores stay in
// registers in the mma accumulator layout; probabilities (or ds) go
// through a per-warp shared-memory slab to become the next product's
// A operand. The TPU kernel sums dk/dv across a sequential group grid
// axis in its output block; Hopper blocks run in no order, so the dkv
// block loops over the group's query heads itself: no atomics, and the
// result is deterministic. No cp.async/TMA pipelining and no wgmma yet:
// a simple kernel that is right first; speed is later work.
//
// C interface (loaded with ctypes by skypilot_tpu_torch/_build.py): each
// skyt_flash_* launches on the given stream, never synchronises,
// allocates nothing and returns cudaGetLastError() (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 16 * kWarps;  // rows a CTA owns: 16 per warp
constexpr int kDkvRows = 32;      // query rows a dkv step streams

// dtype codes shared with ops/flash_attention.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// Rows of a streamed tile: 64 when a row is 256 bytes (bf16, D = 128),
// else 32, so that the largest block (fp32, D = 256) fits the 227 KB of
// shared memory a block may opt into.
template <typename T, int D>
__host__ __device__ constexpr int stream_rows() {
  return sizeof(T) * D > 256 ? 32 : 64;
}

// Row pitch padding: 16 bytes keeps rows 16-byte aligned and spreads a
// fragment's rows over the shared-memory banks.
template <typename T>
__host__ __device__ constexpr int pad() {
  return 16 / sizeof(T);
}

// Copy `rows` rows of D elements (row r at src + r * stride) into dst,
// row pitch `pitch`, in 16-byte vectors.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int pitch, const T* src,
                                          long stride, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  for (int i = threadIdx.x; i < rows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    *reinterpret_cast<uint4*>(dst + r * pitch + c) =
        *reinterpret_cast<const uint4*>(src + (long)r * stride + c);
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[NT][4] += A (16 x KD) . B (KD x 8*NT) for one warp, in the
// m16n8 accumulator layout: lane (g = lane / 4, t = lane % 4) holds rows
// g and g + 8, columns 2t and 2t + 1 of each 8-wide tile nt, as
// acc[nt] = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
// A[m][k] = a[m * lda + k] (the warp's 16-row slab, shared memory).
// B_NK: B[k][n] = x[n * ldx + k]; else B[k][n] = x[k * ldx + n].
template <int NT, int KD, bool B_NK>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const bf16* a,
                                          int lda, const bf16* x, int ldx) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < KD; k0 += 16) {
    uint32_t af[4];
    af[0] = ld32(a + g * lda + k0 + 2 * t);
    af[1] = ld32(a + (g + 8) * lda + k0 + 2 * t);
    af[2] = ld32(a + g * lda + k0 + 2 * t + 8);
    af[3] = ld32(a + (g + 8) * lda + k0 + 2 * t + 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + g;
      uint32_t b0, b1;
      if (B_NK) {
        b0 = ld32(x + n * ldx + k0 + 2 * t);
        b1 = ld32(x + n * ldx + k0 + 2 * t + 8);
      } else {
        b0 = pack_bf16(x[(k0 + 2 * t) * ldx + n],
                       x[(k0 + 2 * t + 1) * ldx + n]);
        b1 = pack_bf16(x[(k0 + 2 * t + 8) * ldx + n],
                       x[(k0 + 2 * t + 9) * ldx + n]);
      }
      mma_bf16(acc[nt], af, b0, b1);
    }
  }
}

// The same product for fp32 operands with fp32 FMAs, into the same
// accumulator layout.
template <int NT, int KD, bool B_NK>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const float* a,
                                          int lda, const float* x, int ldx) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < KD; ++k) {
    const float a0 = a[g * lda + k];
    const float a1 = a[(g + 8) * lda + k];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * t;
      float b0, b1;
      if (B_NK) {
        b0 = x[n * ldx + k];
        b1 = x[(n + 1) * ldx + k];
      } else {
        b0 = x[k * ldx + n];
        b1 = x[k * ldx + n + 1];
      }
      acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
      acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
      acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
      acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
}

// Write a warp's accumulator tile (16 rows x 8*NT) into its slab.
template <typename T, int NT>
__device__ __forceinline__ void store_tile(T* slab, int pitch,
                                           const float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    store_pair(slab + g * pitch + nt * 8 + 2 * t, acc[nt][0], acc[nt][1]);
    store_pair(slab + (g + 8) * pitch + nt * 8 + 2 * t, acc[nt][2],
               acc[nt][3]);
  }
}

// Write rows (r, r + 8) of an accumulator, times `mul0` / `mul1`, to
// global memory: row r at dst, row r + 8 at dst + 8 * row_stride.
template <typename T, int NO>
__device__ __forceinline__ void store_rows(T* dst, long row_stride,
                                           const float (&acc)[NO][4],
                                           float mul0, float mul1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int no = 0; no < NO; ++no) {
    const int c = no * 8 + 2 * t;
    store_pair(dst + c, acc[no][0] * mul0, acc[no][1] * mul0);
    store_pair(dst + 8 * row_stride + c, acc[no][2] * mul1,
               acc[no][3] * mul1);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// Shared-memory sizes (bytes), also reported to the wrapper.
// ---------------------------------------------------------------------------

template <typename T, int D>
size_t fwd_smem() {
  constexpr int BN = stream_rows<T, D>();
  return sizeof(T) * ((size_t)(kBM + 2 * BN) * (D + pad<T>()) +
                      (size_t)kBM * (BN + pad<T>())) +
         sizeof(int) * BN;
}

template <typename T, int D>
size_t dq_smem() {
  constexpr int BN = stream_rows<T, D>();
  return sizeof(T) * ((size_t)(2 * kBM + 2 * BN) * (D + pad<T>()) +
                      (size_t)kBM * (BN + pad<T>())) +
         sizeof(int) * BN;
}

template <typename T, int D>
size_t dkv_smem() {
  constexpr int BN = kDkvRows;
  return sizeof(T) * ((size_t)(2 * kBM + 2 * BN) * (D + pad<T>()) +
                      (size_t)kBM * (BN + pad<T>())) +
         (2 * sizeof(float) + sizeof(int)) * BN;
}

// ---------------------------------------------------------------------------
// Forward: one CTA per (q tile of 64 rows, head, batch).
// ---------------------------------------------------------------------------

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg,
                     T* __restrict__ o, float* __restrict__ lse, int S, int H,
                     int KVH, int causal, float scale) {
  constexpr int BN = stream_rows<T, D>();
  constexpr int P = D + pad<T>();
  constexpr int PS = BN + pad<T>();
  constexpr int NT = BN / 8;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kBM * P;
  T* sV = sK + BN * P;
  T* sP = sV + BN * P;
  int* sSeg = reinterpret_cast<int*>(sP + kBM * PS);

  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long q_row = (long)H * D;
  const long kv_row = (long)KVH * D;

  load_rows<T, D>(sQ, P, q + ((long)b * S + q0) * q_row + (long)h * D, q_row,
                  kBM);
  const int r0 = q0 + warp * 16 + g;  // this lane's rows: r0, r0 + 8
  int seg_r[2] = {0, 0};
  if (SEG) {
    seg_r[0] = seg[(long)b * S + r0];
    seg_r[1] = seg[(long)b * S + r0 + 8];
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[NO][4];
  zero(acc);
  T* slab = sP + warp * 16 * PS;
  const T* k_base = k + (long)b * S * kv_row + (long)kh * D;
  const T* v_base = v + (long)b * S * kv_row + (long)kh * D;
  const int n_tiles = causal ? (q0 + kBM + BN - 1) / BN : S / BN;

  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<T, D>(sK, P, k_base + (long)kt * BN * kv_row, kv_row, BN);
    load_rows<T, D>(sV, P, v_base + (long)kt * BN * kv_row, kv_row, BN);
    if (SEG) {
      for (int i = threadIdx.x; i < BN; i += kThreads)
        sSeg[i] = seg[(long)b * S + kt * BN + i];
    }
    __syncthreads();

    float s[NT][4];
    zero(s);
    warp_gemm<NT, D, true>(s, sQ + warp * 16 * P, P, sK, P);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + (i >> 1) * 8;
        const int cl = nt * 8 + 2 * t + (i & 1);
        float x = s[nt][i] * scale;
        if (causal && kt * BN + cl > row) x = kNegInf;
        if (SEG && sSeg[cl] != seg_r[i >> 1]) x = kNegInf;
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float corr[2];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[nt][i] - m[i >> 1]);
        s[nt][i] = p;
        sum[i >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(sum[r]);
#pragma unroll
    for (int no = 0; no < NO; ++no) {
      acc[no][0] *= corr[0];
      acc[no][1] *= corr[0];
      acc[no][2] *= corr[1];
      acc[no][3] *= corr[1];
    }
    store_tile<T, NT>(slab, PS, s);  // P in v's type, as the reference
    __syncwarp();
    warp_gemm<NO, BN, false>(acc, slab, PS, sV, P);
  }

  const float ls0 = fmaxf(l[0], 1e-30f);
  const float ls1 = fmaxf(l[1], 1e-30f);
  T* o_row = o + ((long)b * S + r0) * q_row + (long)h * D;
#pragma unroll
  for (int no = 0; no < NO; ++no) {
    const int c = no * 8 + 2 * t;
    store_pair(o_row + c, acc[no][0] / ls0, acc[no][1] / ls0);
    store_pair(o_row + 8 * q_row + c, acc[no][2] / ls1, acc[no][3] / ls1);
  }
  if (t == 0) {
    float* lse_row = lse + ((long)b * H + h) * S + r0;
    lse_row[0] = m[0] + logf(ls0);
    lse_row[8] = m[1] + logf(ls1);
  }
}

// ---------------------------------------------------------------------------
// dq: one CTA per (q tile of 64 rows, head, batch).
// ---------------------------------------------------------------------------

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seg, T* __restrict__ dq, int S,
                    int H, int KVH, int causal, float scale) {
  constexpr int BN = stream_rows<T, D>();
  constexpr int P = D + pad<T>();
  constexpr int PS = BN + pad<T>();
  constexpr int NT = BN / 8;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + kBM * P;
  T* sK = sdO + kBM * P;
  T* sV = sK + BN * P;
  T* sS = sV + BN * P;
  int* sSeg = reinterpret_cast<int*>(sS + kBM * PS);

  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long q_row = (long)H * D;
  const long kv_row = (long)KVH * D;

  const long q_off = ((long)b * S + q0) * q_row + (long)h * D;
  load_rows<T, D>(sQ, P, q + q_off, q_row, kBM);
  load_rows<T, D>(sdO, P, dout + q_off, q_row, kBM);
  const int r0 = q0 + warp * 16 + g;
  const long stat = ((long)b * H + h) * S + r0;
  const float lse_r[2] = {lse[stat], lse[stat + 8]};
  const float delta_r[2] = {delta[stat], delta[stat + 8]};
  int seg_r[2] = {0, 0};
  if (SEG) {
    seg_r[0] = seg[(long)b * S + r0];
    seg_r[1] = seg[(long)b * S + r0 + 8];
  }
  float acc[NO][4];
  zero(acc);
  T* slab = sS + warp * 16 * PS;
  const T* k_base = k + (long)b * S * kv_row + (long)kh * D;
  const T* v_base = v + (long)b * S * kv_row + (long)kh * D;
  const int n_tiles = causal ? (q0 + kBM + BN - 1) / BN : S / BN;

  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    load_rows<T, D>(sK, P, k_base + (long)kt * BN * kv_row, kv_row, BN);
    load_rows<T, D>(sV, P, v_base + (long)kt * BN * kv_row, kv_row, BN);
    if (SEG) {
      for (int i = threadIdx.x; i < BN; i += kThreads)
        sSeg[i] = seg[(long)b * S + kt * BN + i];
    }
    __syncthreads();

    float s[NT][4];
    float dp[NT][4];
    zero(s);
    zero(dp);
    warp_gemm<NT, D, true>(s, sQ + warp * 16 * P, P, sK, P);
    warp_gemm<NT, D, true>(dp, sdO + warp * 16 * P, P, sV, P);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + (i >> 1) * 8;
        const int cl = nt * 8 + 2 * t + (i & 1);
        float x = s[nt][i] * scale;
        if (causal && kt * BN + cl > row) x = kNegInf;
        if (SEG && sSeg[cl] != seg_r[i >> 1]) x = kNegInf;
        const float p = expf(x - lse_r[i >> 1]);
        s[nt][i] = p * (dp[nt][i] - delta_r[i >> 1]);
      }
    }
    store_tile<T, NT>(slab, PS, s);
    __syncwarp();
    warp_gemm<NO, BN, false>(acc, slab, PS, sK, P);
  }
  store_rows<T, NO>(dq + ((long)b * S + r0) * q_row + (long)h * D, q_row, acc,
                    scale, scale);
}

// ---------------------------------------------------------------------------
// dk/dv: one CTA per (key tile of 64 rows, kv head, batch); it loops over
// the GQA group's query heads and the query tiles itself.
// ---------------------------------------------------------------------------

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ seg, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, int KVH, int causal,
                     float scale) {
  constexpr int BN = kDkvRows;
  constexpr int P = D + pad<T>();
  constexpr int PS = BN + pad<T>();
  constexpr int NT = BN / 8;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kBM * P;
  T* sQ = sV + kBM * P;
  T* sdO = sQ + BN * P;
  T* sS = sdO + BN * P;
  float* sLse = reinterpret_cast<float*>(sS + kBM * PS);
  float* sDelta = sLse + BN;
  int* sSeg = reinterpret_cast<int*>(sDelta + BN);

  const int k0 = blockIdx.x * kBM;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KVH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long q_row = (long)H * D;
  const long kv_row = (long)KVH * D;

  const long kv_off = ((long)b * S + k0) * kv_row + (long)kh * D;
  load_rows<T, D>(sK, P, k + kv_off, kv_row, kBM);
  load_rows<T, D>(sV, P, v + kv_off, kv_row, kBM);
  const int c0 = k0 + warp * 16 + g;  // this lane's keys: c0, c0 + 8
  int seg_c[2] = {0, 0};
  if (SEG) {
    seg_c[0] = seg[(long)b * S + c0];
    seg_c[1] = seg[(long)b * S + c0 + 8];
  }
  float dk_acc[NO][4];
  float dv_acc[NO][4];
  zero(dk_acc);
  zero(dv_acc);
  T* slab = sS + warp * 16 * PS;
  const int lower = causal ? k0 / BN : 0;

  for (int gi = 0; gi < group; ++gi) {
    const int h = kh * group + gi;
    const float* lse_h = lse + ((long)b * H + h) * S;
    const float* delta_h = delta + ((long)b * H + h) * S;
    for (int qt = lower; qt < S / BN; ++qt) {
      __syncthreads();  // every warp is done with the previous Q/dO tile
      const long q_off = ((long)b * S + qt * BN) * q_row + (long)h * D;
      load_rows<T, D>(sQ, P, q + q_off, q_row, BN);
      load_rows<T, D>(sdO, P, dout + q_off, q_row, BN);
      for (int i = threadIdx.x; i < BN; i += kThreads) {
        sLse[i] = lse_h[qt * BN + i];
        sDelta[i] = delta_h[qt * BN + i];
        if (SEG) sSeg[i] = seg[(long)b * S + qt * BN + i];
      }
      __syncthreads();

      // s^T: rows are this warp's keys, columns the tile's queries.
      float s[NT][4];
      zero(s);
      warp_gemm<NT, D, true>(s, sK + warp * 16 * P, P, sQ, P);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = c0 + (i >> 1) * 8;
          const int cl = nt * 8 + 2 * t + (i & 1);
          float x = s[nt][i] * scale;
          if (causal && qt * BN + cl < key) x = kNegInf;
          if (SEG && sSeg[cl] != seg_c[i >> 1]) x = kNegInf;
          s[nt][i] = expf(x - sLse[cl]);
        }
      }
      store_tile<T, NT>(slab, PS, s);
      __syncwarp();
      warp_gemm<NO, BN, false>(dv_acc, slab, PS, sdO, P);  // dv += p^T do
      float dp[NT][4];
      zero(dp);
      warp_gemm<NT, D, true>(dp, sV + warp * 16 * P, P, sdO, P);  // v do^T
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int cl = nt * 8 + 2 * t + (i & 1);
          s[nt][i] = s[nt][i] * (dp[nt][i] - sDelta[cl]);
        }
      }
      __syncwarp();  // every lane has read p from the slab
      store_tile<T, NT>(slab, PS, s);
      __syncwarp();
      warp_gemm<NO, BN, false>(dk_acc, slab, PS, sQ, P);  // dk += ds^T q
    }
  }
  const long out_off = ((long)b * S + c0) * kv_row + (long)kh * D;
  store_rows<T, NO>(dk + out_off, kv_row, dk_acc, scale, scale);
  store_rows<T, NO>(dv + out_off, kv_row, dv_acc, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  const int* seg;
  void* out0;  // o, dq or dk
  void* out1;  // dv
  float* lse_out;
  int b, s, h, kvh, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, bool SEG>
cudaError_t run_fwd(const Args& a) {
  auto kernel = flash_fwd_kernel<T, D, SEG>;
  const size_t smem = fwd_smem<T, D>();
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.s / kBM, a.h, a.b), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.seg, static_cast<T*>(a.out0), a.lse_out,
      a.s, a.h, a.kvh, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D, bool SEG>
cudaError_t run_dq(const Args& a) {
  auto kernel = flash_dq_kernel<T, D, SEG>;
  const size_t smem = dq_smem<T, D>();
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.s / kBM, a.h, a.b), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse_in,
      a.delta, a.seg, static_cast<T*>(a.out0), a.s, a.h, a.kvh, a.causal,
      a.scale);
  return cudaGetLastError();
}

template <typename T, int D, bool SEG>
cudaError_t run_dkv(const Args& a) {
  auto kernel = flash_dkv_kernel<T, D, SEG>;
  const size_t smem = dkv_smem<T, D>();
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.s / kBM, a.kvh, a.b), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse_in,
      a.delta, a.seg, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.s,
      a.h, a.kvh, a.causal, a.scale);
  return cudaGetLastError();
}

// which kernel a launch asks for
constexpr int kFwd = 0;
constexpr int kDq = 1;
constexpr int kDkv = 2;

template <typename T, int D, bool SEG>
cudaError_t run(int which, const Args& a) {
  switch (which) {
    case kFwd:
      return run_fwd<T, D, SEG>(a);
    case kDq:
      return run_dq<T, D, SEG>(a);
    case kDkv:
      return run_dkv<T, D, SEG>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
cudaError_t run_seg(int which, const Args& a) {
  return a.seg != nullptr ? run<T, D, true>(which, a)
                          : run<T, D, false>(which, a);
}

cudaError_t dispatch(int which, int dtype, int d, const Args& a) {
  if (a.s % kBM != 0 || a.kvh <= 0 || a.h % a.kvh != 0)
    return cudaErrorInvalidValue;
  if (dtype == kBF16 && d == 128) return run_seg<bf16, 128>(which, a);
  if (dtype == kBF16 && d == 256) return run_seg<bf16, 256>(which, a);
  if (dtype == kF32 && d == 128) return run_seg<float, 128>(which, a);
  if (dtype == kF32 && d == 256) return run_seg<float, 256>(which, a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// o [B,S,H,D] and lse [B,H,S] (fp32) from q [B,S,H,D], k/v [B,S,KVH,D];
// seg [B,S] int32 or null.
int skyt_flash_fwd(const void* q, const void* k, const void* v,
                   const int* seg, void* o, float* lse, int b, int s, int h,
                   int kvh, int d, int causal, float scale, int dtype,
                   void* stream) {
  Args a = {q, k, v, nullptr, nullptr, nullptr, seg, o, nullptr, lse,
            b, s, h, kvh, causal, scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(kFwd, dtype, d, a));
}

// dq [B,S,H,D] from q, k, v, do [B,S,H,D], lse and delta [B,H,S] fp32.
int skyt_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const int* seg, void* dq, int b, int s, int h, int kvh,
                      int d, int causal, float scale, int dtype,
                      void* stream) {
  Args a = {q, k, v, dout, lse, delta, seg, dq, nullptr, nullptr,
            b, s, h, kvh, causal, scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(kDq, dtype, d, a));
}

// dk, dv [B,S,KVH,D] from the same inputs.
int skyt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const int* seg, void* dk, void* dv, int b, int s,
                       int h, int kvh, int d, int causal, float scale,
                       int dtype, void* stream) {
  Args a = {q, k, v, dout, lse, delta, seg, dk, dv, nullptr,
            b, s, h, kvh, causal, scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(kDkv, dtype, d, a));
}

}  // extern "C"
