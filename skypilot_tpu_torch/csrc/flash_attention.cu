// Flash attention for Hopper (sm_90a): the causal / non-causal GQA
// forward, the dq backward and the dk/dv backward, each optionally
// segment-masked (packed sequences).
//
// Replaces the TPU kernels of skypilot_tpu/ops/pallas/flash_attention.py:
//   * _fwd_kernel (:62), _fwd_kernel_seg (:128)     -> flash_fwd_kernel
//   * _bwd_dq_kernel (:193), _bwd_dq_kernel_seg (:246)
//                          -> flash_dq_bf16 (bf16), flash_dq_f32 (fp32)
//   * _bwd_dkv_kernel (:254), _bwd_dkv_kernel_seg (:325)
//                          -> flash_dkv_bf16 (bf16), flash_dkv_f32 (fp32)
// The _seg bodies are the same body with a segment-id mask, so here each
// kernel is one template with SEG on or off.
//
// What they compute (q [B,S,H,D], k/v [B,S,KVH,D], the model layout read
// in place, no transposes; kv head of query head h is h / (H / KVH)):
//   fwd: o = softmax(q k^T * D^-0.5, masked) v and lse = m + log(l),
//        with an fp32 running max/sum, the finite NEG_INF mask and the
//        max(l, 1e-30) clamp of the reference; P is rounded to v's type
//        before the P.V product, as in the reference.
//   dq:  delta = rowsum(do * o) in fp32 (plain XLA in the reference,
//        :341), written out for dk/dv; p = exp(s - lse),
//        ds = p * (do v^T - delta), dq = ds k * scale.
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
// tolerance rules out TF32). A CTA owns 64 rows (q rows for fwd/dq, key
// rows for dkv), 4 warps of 16 (the bf16 dq: warps of 32, 128 rows a
// CTA where S allows); the other side streams through shared memory in tiles. The TPU
// kernel sums dk/dv across a sequential group grid axis in its output
// block; Hopper blocks run in no order, so the dkv block loops over the
// group's query heads itself: no atomics, and the result is
// deterministic.
//
// The bf16 backward kernels (flash_dq_bf16, flash_dkv_bf16) go further
// (PERF.md gives what each of these bought):
//   * delta is computed in the dq kernel from its dO rows and the
//     matching O rows, and written for dk/dv (no separate pass);
//   * every mma fragment comes from one ldmatrix.x4 (.trans for the
//     k-major B operands: K in ds.K, dO in p^T.dO, Q in ds^T.Q); rows
//     are padded by 16 bytes so the 8 rows of each 8x8 matrix fall in
//     distinct banks;
//   * P and dS stay in registers: the m16n8 accumulator of S (dq) or
//     S^T (dk/dv) is, register for register, the A fragment of the
//     next product once packed to bf16 pairs;
//   * the streamed tiles (K/V for dq; Q, dO, lse, delta and segment
//     ids for dk/dv) fill a two-stage ring with 16-byte cp.async, one
//     CTA barrier per tile, the next tile in flight during the current
//     one's products; dk/dv streams 64 query rows a step;
//   * causal grids put the tile index on the slowest grid axis, heavy
//     tiles first (the last q tiles for dq, the first key tiles for
//     dk/dv), so the longest CTAs start in the first wave;
//   * a dq warp owns two m16 tiles (32 rows) and streams 32-key tiles,
//     so each K/V fragment it loads feeds two products: with one m16
//     tile per warp, ldmatrix traffic, not the tensor cores, bounds
//     these kernels (the warps of a CTA load the same B fragments). A
//     dq CTA has four such warps (128 rows) when S is a multiple of
//     128, else two. dk/dv keeps one m16 tile (16 keys) per warp: its
//     dK and dV accumulators leave no registers for two.
// At D = 256 both kernels split the output columns over two CTAs (each
// recomputes S and dP over all of D) so that the accumulators fit in
// registers. The fp32 backward keeps the PR 2 kernels (slab
// round-trips, synchronous loads). No wgmma, TMA or warp
// specialisation yet.
//
// C interface (loaded with ctypes by skypilot_tpu_torch/_build.py): each
// skyt_flash_* launches on the given stream, never synchronises,
// allocates nothing and returns cudaGetLastError() (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 16 * kWarps;  // rows a CTA owns: 16 per warp
constexpr int kDkvRows = 32;      // query rows an fp32 dkv step streams

// bf16 backward tiles: a dq warp owns kDqMT m16 tiles of rows and
// streams kDqKeys key rows a step; a dk/dv step streams kDkvQueries
// query rows. Both fill a ring of kStages cp.async stages.
constexpr int kDqMT = 2;
constexpr int kDqKeys = 32;
constexpr int kDkvQueries = 64;
constexpr int kStages = 2;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying `rows` rows of D elements (row r at src + r * stride)
// into dst (row pitch `pitch`) with 16-byte cp.async, over the CTA's
// NTH threads; the caller commits the group.
template <int D, int NTH>
__device__ __forceinline__ void copy_rows(bf16* dst, int pitch,
                                          const bf16* src, long stride,
                                          int rows) {
  constexpr int kVecPerRow = D / 8;
  for (int i = threadIdx.x; i < rows * kVecPerRow; i += NTH) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    cp_async16(dst + r * pitch + c, src + (long)r * stride + c);
  }
}

// Start copying n 4-byte words (n a multiple of 4) with cp.async.
template <int NTH>
__device__ __forceinline__ void copy_words(void* dst, const void* src,
                                           int n) {
  for (int i = threadIdx.x; i < n / 4; i += NTH)
    cp_async16(static_cast<char*>(dst) + 16 * i,
               static_cast<const char*>(src) + 16 * i);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
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

// ---------------------------------------------------------------------------
// mma fragments from shared memory (bf16 backward), one ldmatrix.x4 per
// k16 step: an A fragment of a 16 x 16 tile, or the B fragments of two
// 8-wide n tiles ({f[0], f[1]} for n 0-7, {f[2], f[3]} for n 8-15).
// ---------------------------------------------------------------------------

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
                                       int lda) {
  const int lane = threadIdx.x & 31;
  // matrices: rows 0-7 / 8-15 (lane bit 3) x cols 0-7 / 8-15 (bit 4)
  ldsm_x4(f, a + (lane & 15) * lda + (lane >> 4) * 8);
}

// B[k][n] = x[n * ldx + k] (x's rows are n: K in q.K^T).
__device__ __forceinline__ void load_b_nk(uint32_t (&f)[4], const bf16* x,
                                          int ldx) {
  const int lane = threadIdx.x & 31;
  // matrices: k 0-7 / 8-15 (lane bit 3) x n 0-7 / 8-15 (bit 4)
  ldsm_x4(f, x + ((lane >> 4) * 8 + (lane & 7)) * ldx +
                 ((lane >> 3) & 1) * 8);
}

// B[k][n] = x[k * ldx + n] (x's rows are k: K in ds.K).
__device__ __forceinline__ void load_b_kn(uint32_t (&f)[4], const bf16* x,
                                          int ldx) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(f, x + (((lane >> 3) & 1) * 8 + (lane & 7)) * ldx +
                       (lane >> 4) * 8);
}

// The A fragment of k16 step j of the next product, straight from the
// fp32 accumulators of n tiles 2j and 2j + 1 (columns 16j..16j+15).
template <int NT>
__device__ __forceinline__ void acc_a(uint32_t (&f)[4], const float (&c)[NT][4],
                                      int j) {
  f[0] = pack_floats(c[2 * j][0], c[2 * j][1]);
  f[1] = pack_floats(c[2 * j][2], c[2 * j][3]);
  f[2] = pack_floats(c[2 * j + 1][0], c[2 * j + 1][1]);
  f[3] = pack_floats(c[2 * j + 1][2], c[2 * j + 1][3]);
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// delta = rowsum(do * o) in fp32 for 16 q rows: row i is o_rows + i *
// o_stride (global) and do_rows + i * pitch (shared). Writes the 16
// values to out[0..15] unless out is null; returns this lane's rows g
// and g + 8 in dl.
template <typename T, int D>
__device__ __forceinline__ void warp_delta(float (&dl)[2], const T* o_rows,
                                           long o_stride, const T* do_rows,
                                           int pitch, float* out) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int c = 2 * lane; c < D; c += 64) {
      const float2 a = load_pair(o_rows + i * o_stride + c);
      const float2 d = load_pair(do_rows + i * pitch + c);
      sum = fmaf(a.x, d.x, sum);
      sum = fmaf(a.y, d.y, sum);
    }
    sum = warp_sum(sum);
    if (i == g) dl[0] = sum;
    if (i == g + 8) dl[1] = sum;
    if (lane == 0 && out != nullptr) out[i] = sum;
  }
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

template <int D>
size_t dq_f32_smem() {
  constexpr int BN = stream_rows<float, D>();
  return sizeof(float) * ((size_t)(2 * kBM + 2 * BN) * (D + pad<float>()) +
                          (size_t)kBM * (BN + pad<float>())) +
         sizeof(int) * BN;
}

template <int D>
size_t dkv_f32_smem() {
  constexpr int BN = kDkvRows;
  return sizeof(float) * ((size_t)(2 * kBM + 2 * BN) * (D + pad<float>()) +
                          (size_t)kBM * (BN + pad<float>())) +
         (2 * sizeof(float) + sizeof(int)) * BN;
}

// Output columns a bf16 backward CTA owns: D = 256 splits them over two
// CTAs, so that the accumulators fit in registers.
template <int D>
__host__ __device__ constexpr int bf16_cols() {
  return D > 128 ? 128 : D;
}

template <int D, int WARPS>
size_t dq_bf16_smem() {
  constexpr int rows = 16 * kDqMT * WARPS;
  return sizeof(bf16) * (size_t)(2 * rows + kStages * 2 * kDqKeys) * (D + 8) +
         sizeof(int) * kStages * kDqKeys;
}

template <int D>
size_t dkv_bf16_smem() {
  return sizeof(bf16) * (size_t)(2 * kBM + kStages * 2 * kDkvQueries) *
             (D + 8) +
         (2 * sizeof(float) + sizeof(int)) * kStages * kDkvQueries;
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
// dq, fp32 (CUDA-core FMAs): one CTA per (q tile of 64 rows, head, batch).
// ---------------------------------------------------------------------------

template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads)
    flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 const int* __restrict__ seg, float* __restrict__ dq, int S,
                 int H, int KVH, int causal, float scale) {
  using T = float;
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
  __syncthreads();  // sdO complete
  float delta_r[2];
  warp_delta<T, D>(delta_r, o + q_off + warp * 16 * q_row, q_row,
                   sdO + warp * 16 * P, P, delta + stat - g);
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
// dk/dv, fp32 (CUDA-core FMAs): one CTA per (key tile of 64 rows, kv
// head, batch); it loops over the GQA group's query heads and the query
// tiles itself.
// ---------------------------------------------------------------------------

template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const int* __restrict__ seg, float* __restrict__ dk,
                  float* __restrict__ dv, int S, int H, int KVH, int causal,
                  float scale) {
  using T = float;
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
// dq, bf16 (tensor cores): one CTA of WARPS warps per (q tile of
// 32 * WARPS rows, head, output column part, batch), streaming K/V tiles
// of kDqKeys rows through the cp.async ring. Each warp owns kDqMT m16
// tiles of rows, so that every K/V fragment it loads feeds kDqMT
// products.
// ---------------------------------------------------------------------------

template <int D, bool SEG, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
    flash_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const bf16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  const int* __restrict__ seg, bf16* __restrict__ dq, int S,
                  int H, int KVH, int causal, float scale) {
  constexpr int MT = kDqMT;
  constexpr int NTH = 32 * WARPS;
  constexpr int ROWS = 16 * MT * WARPS;
  constexpr int BN = kDqKeys;
  constexpr int DO = bf16_cols<D>();
  constexpr int P = D + 8;
  constexpr int NT = BN / 8;
  constexpr int NO = DO / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + ROWS * P;
  bf16* sKV = sdO + ROWS * P;  // stage i: K at i * 2 * BN * P, then V
  int* sSeg = reinterpret_cast<int*>(sKV + kStages * 2 * BN * P);

  // q tiles go in launch order, the last first: in causal runs they
  // stream the most key tiles, so the heaviest CTAs start in the first
  // wave.
  constexpr int n_parts = D / DO;
  const int h = blockIdx.x / n_parts;
  const int col0 = (blockIdx.x % n_parts) * DO;  // output columns
  const int b = blockIdx.y;
  const int q0 = (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * ROWS;
  const int kh = h / (H / KVH);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long q_row = (long)H * D;
  const long kv_row = (long)KVH * D;
  const long q_off = ((long)b * S + q0) * q_row + (long)h * D;
  const bf16* k_base = k + (long)b * S * kv_row + (long)kh * D;
  const bf16* v_base = v + (long)b * S * kv_row + (long)kh * D;
  const int* seg_b = seg + (long)b * S;
  const int n_tiles = causal ? (q0 + ROWS) / BN : S / BN;

  auto load_tile = [&](int kt) {
    const int st = kt % kStages;
    bf16* tK = sKV + st * 2 * BN * P;
    copy_rows<D, NTH>(tK, P, k_base + (long)kt * BN * kv_row, kv_row, BN);
    copy_rows<D, NTH>(tK + BN * P, P, v_base + (long)kt * BN * kv_row,
                      kv_row, BN);
    if (SEG) copy_words<NTH>(sSeg + st * BN, seg_b + kt * BN, BN);
  };

  copy_rows<D, NTH>(sQ, P, q + q_off, q_row, ROWS);
  copy_rows<D, NTH>(sdO, P, dout + q_off, q_row, ROWS);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }

  // This lane's rows: r0[m] and r0[m] + 8 of m16 tile m.
  const int w0 = warp * 16 * MT;  // the warp's first row in the CTA
  int r0[MT];
  float lse_r[MT][2];
  int seg_r[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    r0[m] = q0 + w0 + 16 * m + g;
    const long stat = ((long)b * H + h) * S + r0[m];
    lse_r[m][0] = lse[stat] * kLog2e;
    lse_r[m][1] = lse[stat + 8] * kLog2e;
    seg_r[m][0] = SEG ? seg_b[r0[m]] : 0;
    seg_r[m][1] = SEG ? seg_b[r0[m] + 8] : 0;
  }
  const float scale_log2 = scale * kLog2e;

  cp_async_wait<kStages - 1>();  // Q and dO (K/V tiles may be in flight)
  __syncthreads();
  float delta_r[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int row = w0 + 16 * m;
    warp_delta<bf16, D>(
        delta_r[m], o + q_off + row * q_row, q_row, sdO + row * P, P,
        col0 == 0 ? delta + ((long)b * H + h) * S + q0 + row : nullptr);
  }

  float acc[MT][NO][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) zero(acc[m]);
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt is in
    __syncthreads();  // ... for every thread; tile kt - 1's stage is free
    if (kt + kStages - 1 < n_tiles) load_tile(kt + kStages - 1);
    cp_async_commit();
    const int st = kt % kStages;
    const bf16* tK = sKV + st * 2 * BN * P;
    const bf16* tV = tK + BN * P;
    const int* tSeg = sSeg + st * BN;

    // s = q k^T and dp = do v^T for the warp's rows.
    float s[MT][NT][4];
    float dp[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      zero(s[m]);
      zero(dp[m]);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[MT][4], ad[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        load_a(aq[m], sQ + (w0 + 16 * m) * P + kk * 16, P);
        load_a(ad[m], sdO + (w0 + 16 * m) * P + kk * 16, P);
      }
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t bk[4], bv[4];
        load_b_nk(bk, tK + j * 16 * P + kk * 16, P);
        load_b_nk(bv, tV + j * 16 * P + kk * 16, P);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(s[m][2 * j], aq[m], bk[0], bk[1]);
          mma_bf16(s[m][2 * j + 1], aq[m], bk[2], bk[3]);
          mma_bf16(dp[m][2 * j], ad[m], bv[0], bv[1]);
          mma_bf16(dp[m][2 * j + 1], ad[m], bv[2], bv[3]);
        }
      }
    }
    // ds = p (dp - delta), p = exp(s * scale - lse), masked p = 0.
    const bool diag = causal && kt * BN + BN - 1 > q0;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const int cl = nt * 8 + 2 * t + (i & 1);
          bool keep = !diag || kt * BN + cl <= r0[m] + 8 * r;
          if (SEG) keep = keep && tSeg[cl] == seg_r[m][r];
          const float p =
              keep ? exp2f(s[m][nt][i] * scale_log2 - lse_r[m][r]) : 0.f;
          s[m][nt][i] = p * (dp[m][nt][i] - delta_r[m][r]);
        }
      }
    }
    // dq += ds k
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) acc_a<NT>(a[m], s[m], kk);
#pragma unroll
      for (int j = 0; j < NO / 2; ++j) {
        uint32_t bk[4];
        load_b_kn(bk, tK + kk * 16 * P + col0 + j * 16, P);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc[m][2 * j], a[m], bk[0], bk[1]);
          mma_bf16(acc[m][2 * j + 1], a[m], bk[2], bk[3]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
    store_rows<bf16, NO>(
        dq + ((long)b * S + r0[m]) * q_row + (long)h * D + col0, q_row,
        acc[m], scale, scale);
}

// ---------------------------------------------------------------------------
// dk/dv, bf16 (tensor cores): one CTA per (key tile of 64 rows, kv head,
// output column part, batch); it walks the GQA group's query heads and
// their query tiles (BQ rows a step) as one stream through the cp.async
// ring, so the next head's first tile loads during this head's last.
// ---------------------------------------------------------------------------

template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const int* __restrict__ seg, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int S, int H, int KVH, int causal,
                   float scale) {
  constexpr int BQ = kDkvQueries;
  constexpr int DO = bf16_cols<D>();
  constexpr int P = D + 8;
  constexpr int PS = BQ + 8;
  constexpr int NT = BQ / 8;
  constexpr int NO = DO / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kBM * P;
  bf16* sQdO = sV + kBM * P;  // stage i: Q at i * 2 * BQ * P, then dO
  float* sLse = reinterpret_cast<float*>(sQdO + kStages * 2 * BQ * P);
  float* sDelta = sLse + kStages * BQ;
  int* sSeg = reinterpret_cast<int*>(sDelta + kStages * BQ);

  // Key tiles go in launch order: in causal runs the first walk the most
  // query tiles, so the heaviest CTAs start in the first wave.
  constexpr int n_parts = D / DO;
  const int kh = blockIdx.x / n_parts;
  const int col0 = (blockIdx.x % n_parts) * DO;  // output columns
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kBM;
  const int group = H / KVH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long q_row = (long)H * D;
  const long kv_row = (long)KVH * D;
  const int* seg_b = seg + (long)b * S;
  const int lower = causal ? k0 / BQ : 0;
  const int n_qt = S / BQ - lower;  // query tiles per head
  const int n_steps = group * n_qt;

  auto load_step = [&](int it) {
    const int st = it % kStages;
    const int h = kh * group + it / n_qt;
    const int qt = lower + it % n_qt;
    const long q_off = ((long)b * S + qt * BQ) * q_row + (long)h * D;
    bf16* tQ = sQdO + st * 2 * BQ * P;
    copy_rows<D, kThreads>(tQ, P, q + q_off, q_row, BQ);
    copy_rows<D, kThreads>(tQ + BQ * P, P, dout + q_off, q_row, BQ);
    const long stat = ((long)b * H + h) * S + qt * BQ;
    copy_words<kThreads>(sLse + st * BQ, lse + stat, BQ);
    copy_words<kThreads>(sDelta + st * BQ, delta + stat, BQ);
    if (SEG) copy_words<kThreads>(sSeg + st * BQ, seg_b + qt * BQ, BQ);
  };

  const long kv_off = ((long)b * S + k0) * kv_row + (long)kh * D;
  copy_rows<D, kThreads>(sK, P, k + kv_off, kv_row, kBM);
  copy_rows<D, kThreads>(sV, P, v + kv_off, kv_row, kBM);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_steps) load_step(i);
    cp_async_commit();
  }

  const int c0 = k0 + warp * 16 + g;  // this lane's keys: c0, c0 + 8
  int seg_c[2] = {0, 0};
  if (SEG) {
    seg_c[0] = seg_b[c0];
    seg_c[1] = seg_b[c0 + 8];
  }
  const float scale_log2 = scale * kLog2e;
  const bf16* sKw = sK + warp * 16 * P;
  const bf16* sVw = sV + warp * 16 * P;
  float dk_acc[NO][4];
  float dv_acc[NO][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int it = 0; it < n_steps; ++it) {
    cp_async_wait<kStages - 2>();  // step it is in
    __syncthreads();  // ... for every thread; step it - 1's stage is free
    if (it + kStages - 1 < n_steps) load_step(it + kStages - 1);
    cp_async_commit();
    const int st = it % kStages;
    const bf16* tQ = sQdO + st * 2 * BQ * P;
    const bf16* tdO = tQ + BQ * P;
    const float* tLse = sLse + st * BQ;
    const float* tDelta = sDelta + st * BQ;
    const int* tSeg = sSeg + st * BQ;
    const int qr0 = (lower + it % n_qt) * BQ;  // the tile's first query

    // s^T = k q^T: rows are this warp's keys, columns the tile's queries.
    float s[NT][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sKw + kk * 16, P);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t bq[4];
        load_b_nk(bq, tQ + j * 16 * P + kk * 16, P);
        mma_bf16(s[2 * j], a, bq[0], bq[1]);
        mma_bf16(s[2 * j + 1], a, bq[2], bq[3]);
      }
    }
    // p^T = exp(s^T * scale - lse), masked p = 0.
    const bool diag = causal && qr0 < k0 + kBM - 1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 ls = *reinterpret_cast<const float2*>(tLse + nt * 8 + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int cl = nt * 8 + 2 * t + (i & 1);
        bool keep = !diag || qr0 + cl >= c0 + 8 * r;
        if (SEG) keep = keep && tSeg[cl] == seg_c[r];
        s[nt][i] = keep ? exp2f(s[nt][i] * scale_log2 -
                                ((i & 1) ? ls.y : ls.x) * kLog2e)
                        : 0.f;
      }
    }
    // dv += p^T do
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      acc_a<NT>(a, s, kk);
#pragma unroll
      for (int j = 0; j < NO / 2; ++j) {
        uint32_t bd[4];
        load_b_kn(bd, tdO + kk * 16 * P + col0 + j * 16, P);
        mma_bf16(dv_acc[2 * j], a, bd[0], bd[1]);
        mma_bf16(dv_acc[2 * j + 1], a, bd[2], bd[3]);
      }
    }
    // dp^T = v do^T; ds^T = p^T (dp^T - delta)
    float dp[NT][4];
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sVw + kk * 16, P);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t bd[4];
        load_b_nk(bd, tdO + j * 16 * P + kk * 16, P);
        mma_bf16(dp[2 * j], a, bd[0], bd[1]);
        mma_bf16(dp[2 * j + 1], a, bd[2], bd[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 dl =
          *reinterpret_cast<const float2*>(tDelta + nt * 8 + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dp[nt][i] = s[nt][i] * (dp[nt][i] - ((i & 1) ? dl.y : dl.x));
    }
    // dk += ds^T q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      acc_a<NT>(a, dp, kk);
#pragma unroll
      for (int j = 0; j < NO / 2; ++j) {
        uint32_t bq[4];
        load_b_kn(bq, tQ + kk * 16 * P + col0 + j * 16, P);
        mma_bf16(dk_acc[2 * j], a, bq[0], bq[1]);
        mma_bf16(dk_acc[2 * j + 1], a, bq[2], bq[3]);
      }
    }
  }
  const long out_off = ((long)b * S + c0) * kv_row + (long)kh * D + col0;
  store_rows<bf16, NO>(dk + out_off, kv_row, dk_acc, scale, scale);
  store_rows<bf16, NO>(dv + out_off, kv_row, dv_acc, 1.f, 1.f);
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

template <typename K, typename... Xs>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, Xs... xs) {
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(xs...);
  return cudaGetLastError();
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o_in;
  const void* dout;
  const float* lse_in;
  float* delta;  // written by dq, read by dk/dv
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
  return launch(flash_fwd_kernel<T, D, SEG>, dim3(a.s / kBM, a.h, a.b),
                kThreads, fwd_smem<T, D>(), a.stream,
                static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), a.seg, static_cast<T*>(a.out0),
                a.lse_out, a.s, a.h, a.kvh, a.causal, a.scale);
}

// A bf16 dq CTA has 4 warps (128 rows) where S allows, else 2 (64 rows).
template <int D, bool SEG, int WARPS>
cudaError_t run_dq_bf16(const Args& a) {
  return launch(flash_dq_bf16<D, SEG, WARPS>,
                dim3(a.h * (D / bf16_cols<D>()), a.b, a.s / (32 * WARPS)),
                32 * WARPS, dq_bf16_smem<D, WARPS>(), a.stream,
                static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
                static_cast<const bf16*>(a.v),
                static_cast<const bf16*>(a.o_in),
                static_cast<const bf16*>(a.dout), a.lse_in, a.delta, a.seg,
                static_cast<bf16*>(a.out0), a.s, a.h, a.kvh, a.causal,
                a.scale);
}

template <typename T, int D, bool SEG>
cudaError_t run_dq(const Args& a) {
  if constexpr (std::is_same<T, bf16>::value)
    return a.s % 128 == 0 ? run_dq_bf16<D, SEG, 4>(a)
                          : run_dq_bf16<D, SEG, 2>(a);
  else
    return launch(flash_dq_f32<D, SEG>, dim3(a.s / kBM, a.h, a.b), kThreads,
                  dq_f32_smem<D>(), a.stream, static_cast<const T*>(a.q),
                  static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                  static_cast<const T*>(a.o_in),
                  static_cast<const T*>(a.dout), a.lse_in, a.delta, a.seg,
                  static_cast<T*>(a.out0), a.s, a.h, a.kvh, a.causal,
                  a.scale);
}

template <typename T, int D, bool SEG>
cudaError_t run_dkv(const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  T* dk = static_cast<T*>(a.out0);
  T* dv = static_cast<T*>(a.out1);
  if constexpr (std::is_same<T, bf16>::value)
    return launch(flash_dkv_bf16<D, SEG>,
                  dim3(a.kvh * (D / bf16_cols<D>()), a.b, a.s / kBM),
                  kThreads, dkv_bf16_smem<D>(), a.stream, q, k, v, dout,
                  a.lse_in, a.delta, a.seg, dk, dv, a.s, a.h, a.kvh, a.causal,
                  a.scale);
  else
    return launch(flash_dkv_f32<D, SEG>, dim3(a.s / kBM, a.kvh, a.b),
                  kThreads, dkv_f32_smem<D>(), a.stream, q, k, v, dout,
                  a.lse_in, a.delta, a.seg, dk, dv, a.s, a.h, a.kvh, a.causal,
                  a.scale);
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
  Args a = {q, k, v, nullptr, nullptr, nullptr, nullptr, seg, o, nullptr,
            lse, b, s, h, kvh, causal, scale,
            static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(kFwd, dtype, d, a));
}

// dq [B,S,H,D] and delta = rowsum(do * o) [B,H,S] fp32 from q, o, do
// [B,S,H,D], k, v and lse [B,H,S] fp32.
int skyt_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, const int* seg, void* dq, int b, int s,
                      int h, int kvh, int d, int causal, float scale,
                      int dtype, void* stream) {
  Args a = {q, k, v, o, dout, lse, delta, seg, dq, nullptr, nullptr,
            b, s, h, kvh, causal, scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(kDq, dtype, d, a));
}

// dk, dv [B,S,KVH,D] from q, k, v, do, lse and the dq kernel's delta.
int skyt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const int* seg, void* dk, void* dv, int b, int s,
                       int h, int kvh, int d, int causal, float scale,
                       int dtype, void* stream) {
  Args a = {q, k, v, nullptr, dout, lse, const_cast<float*>(delta), seg, dk,
            dv, nullptr, b, s, h, kvh, causal, scale,
            static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(kDkv, dtype, d, a));
}

}  // extern "C"
