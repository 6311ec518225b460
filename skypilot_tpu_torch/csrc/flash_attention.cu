// Flash attention for Hopper (sm_90a): the causal / non-causal GQA
// forward, the dq backward and the dk/dv backward, each optionally
// segment-masked (packed sequences).
//
// Replaces the TPU kernels of skypilot_tpu/ops/pallas/flash_attention.py:
//   * _fwd_kernel (:62), _fwd_kernel_seg (:128)
//                          -> flash_fwd_bf16 (bf16), flash_fwd_f32 (fp32)
//   * _bwd_dq_kernel (:193), _bwd_dq_kernel_seg (:246)
//                          -> flash_dq_bf16 (bf16), flash_dq_f32 (fp32)
//   * _bwd_dkv_kernel (:254), _bwd_dkv_kernel_seg (:325)
//                          -> flash_dkv_bf16 (bf16), flash_dkv_f32 (fp32)
// The _seg bodies are the same body with a segment-id mask, so here each
// kernel is one template with SEG on or off. As the TPU kernel's
// seg_q_ref / seg_k_ref, the query rows' and the key rows' ids are two
// arrays (seg, seg_k), the same one unless the caller gives both: a ring
// attention block pairs one rank's query rows with another's keys.
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
// tensor cores with fp32 accumulation; fp32 inputs run a 64-row tiling
// with fp32 FMAs on CUDA cores (the fp32 tolerance rules out TF32), a
// CTA of 4 warps of 16 rows (q rows for fwd/dq, key rows for dkv), the
// other side streamed through shared memory in tiles. The TPU kernel
// sums dk/dv across a sequential group grid axis in its output block;
// Hopper blocks run in no order, so the dkv block loops over the group's
// query heads itself: no atomics, and the result is deterministic.
//
// The bf16 forward (flash_fwd_bf16) is laid out the way Hopper reaches
// its tensor-core rate (PERF.md gives what each step bought):
//   * warpgroup MMA: each consumer warpgroup owns 64 query rows; s =
//     q k^T is a wgmma.m64nBNk16 chain with Q and K in shared memory,
//     o += p v one with P in registers (S's accumulator, packed to bf16,
//     is its A fragment) and V read transposed from shared memory;
//   * tiles sit in shared memory in the 128-byte swizzle that TMA writes
//     and the wgmma descriptors read; one thread of a producer
//     warpgroup loads Q and the 3-stage K and V rings with TMA, and
//     full / empty mbarriers hand the stages over, so no CTA barrier
//     stops the loop; setmaxnreg moves the producer's registers to the
//     consumers;
//   * step i issues q k_i^T and p_{i-1} v_{i-1} together, so its
//     softmax runs beside the step before's P.V, and the two consumer
//     warpgroups take turns to issue (named barriers), so one's softmax
//     runs beside the other's products;
//   * exp2 on log2-scaled scores, the causal mask only on the tiles that
//     cross the diagonal, the heaviest q tiles first;
//   * with segment ids, a key tile whose id range [min, max] (of seg_k)
//     misses the q tile's (of seg) is skipped with its loads: exact for
//     ids in any order; a q tile that meets no key tile writes o = 0 and
//     the lse of an empty row (no weight in a merge over key blocks).
// At D = 128 a CTA has two consumer warpgroups (128 rows) and streams
// 128-key tiles where S % 128 = 0; else, and at D = 256, one (64 rows,
// 64-key tiles).
//
// The bf16 backward kernels (flash_dq_bf16, flash_dkv_bf16) use
// warp-level mma.sync.m16n8k16 (PERF.md gives what each of these
// bought):
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
// At D = 256 both backward kernels split the output columns over two
// CTAs (each recomputes S and dP over all of D) so that the accumulators
// fit in registers. The fp32 kernels keep the first, simple design (slab
// round-trips, synchronous loads).
//
// C interface (loaded with ctypes by skypilot_tpu_torch/_build.py): each
// skyt_flash_* launches on the given stream, never synchronises,
// allocates nothing and returns cudaGetLastError() (0 = success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include <climits>
#include <cmath>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
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
// The bf16 forward's K and V rings: K two tiles ahead of its use, V one.
constexpr int kFwdStages = 3;

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

// acc[NT][4] += A (16 x KD) . B (KD x 8*NT) for one warp with fp32
// FMAs, in the m16n8 accumulator layout: lane (g = lane / 4, t = lane %
// 4) holds rows g and g + 8, columns 2t and 2t + 1 of each 8-wide tile
// nt, as acc[nt] = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
// A[m][k] = a[m * lda + k] (the warp's 16-row slab, shared memory).
// B_NK: B[k][n] = x[n * ldx + k]; else B[k][n] = x[k * ldx + n].
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
// Warpgroup MMA (wgmma, sm_90a) for the bf16 forward. A warpgroup is 4
// consecutive warps; one wgmma.m64nNk16 multiplies its 64 x 16 A tile by
// a 16 x N B tile read from shared memory through a matrix descriptor.
// The fp32 accumulator of warp w holds rows 16w..16w+15 in the m16n8
// layout above (d[j] is columns 8j..8j+7), so that, once packed to bf16
// pairs, S's accumulator is P's register A fragment (acc_a).
// ---------------------------------------------------------------------------

// wgmma operands, and the TMA boxes that fill them, sit in shared memory
// in the 128-byte swizzle: a tile of ROWS rows x D bf16 is D / 64 column
// chunks of ROWS x 128 bytes, 1024-byte aligned, with the 16-byte vector
// c of row r stored at vector (c ^ (r % 8)) of that row.
// Descriptor of such an operand at p (a 16-byte multiple): lbo / sbo in
// bytes; layout type 1 (bits 62-63) is the 128-byte swizzle.
__device__ __forceinline__ uint64_t gmma_desc(const bf16* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

// k16 step kk of a K-major operand (rows of the tile are M or N, its D
// columns are K): 32 bytes a step inside a 128-byte chunk row, then the
// next chunk. 8-row groups lie 1024 bytes apart (sbo); lbo is unused.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k_major(const bf16* tile, int row0,
                                                 int kk) {
  return gmma_desc(tile + (kk >> 2) * ROWS * 64 + row0 * 64 + (kk & 3) * 16,
                   16, 1024);
}

// k16 step kk of an MN-major B operand (V in P.V: rows are K = keys, the
// D columns are N): 16 rows a step; N's 64-column chunks lie ROWS * 128
// bytes apart (lbo), K's 8-row groups 1024 bytes (sbo).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn_major(const bf16* tile, int kk) {
  return gmma_desc(tile + kk * 16 * 64, ROWS * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator, or
// of a register A operand, across the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
  }
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
  }
}

// mbarriers (shared memory, 8 bytes each): a phase completes when its
// count of arrivals has come; a wait for parity p returns once the
// barrier's phase is no longer p.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// TMA: copy the box of `map` at coordinates (c0, c1, c2) into dst, with
// completion (its bytes) reported to bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// Bulk copy of `bytes` (a multiple of 16) into dst, reported to bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// d (+)= A . B for a warpgroup: ss, A and B in shared memory (both
// K-major); rs, A in registers and B MN-major (transposed). scale_d = 0
// overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4],
    uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, "
      "0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, "
      "%1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4],
    uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, "
      "0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, "
      "%1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, "
      "0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, "
      "%1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[32][4],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, "
      "0;\nwgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, "
      "%1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, scale_d);
  else
    wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 128)
    wgmma_rs_n128(d, a, db, scale_d);
  else
    wgmma_rs_n256(d, a, db, scale_d);
}

// ---------------------------------------------------------------------------
// Shared-memory sizes (bytes), also reported to the wrapper.
// ---------------------------------------------------------------------------

template <int D>
size_t fwd_f32_smem() {
  constexpr int BN = stream_rows<float, D>();
  return sizeof(float) * ((size_t)(kBM + 2 * BN) * (D + pad<float>()) +
                          (size_t)kBM * (BN + pad<float>())) +
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
// Forward, fp32 (CUDA-core FMAs): one CTA per (q tile of 64 rows, head,
// batch).
// ---------------------------------------------------------------------------

template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ seg,
                  const int* __restrict__ seg_k, float* __restrict__ o,
                  float* __restrict__ lse, int S, int H, int KVH, int causal,
                  float scale) {
  using T = float;
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
        sSeg[i] = seg_k[(long)b * S + kt * BN + i];
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
    store_tile<T, NT>(slab, PS, s);
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
                 const int* __restrict__ seg, const int* __restrict__ seg_k,
                 float* __restrict__ dq, int S, int H, int KVH, int causal,
                 float scale) {
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
        sSeg[i] = seg_k[(long)b * S + kt * BN + i];
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
                  const int* __restrict__ seg, const int* __restrict__ seg_k,
                  float* __restrict__ dk, float* __restrict__ dv, int S, int H,
                  int KVH, int causal, float scale) {
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
    seg_c[0] = seg_k[(long)b * S + c0];
    seg_c[1] = seg_k[(long)b * S + c0 + 8];
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
                  const int* __restrict__ seg, const int* __restrict__ seg_k,
                  bf16* __restrict__ dq, int S, int H, int KVH, int causal,
                  float scale) {
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
  const int* segk_b = seg_k + (long)b * S;
  const int n_tiles = causal ? (q0 + ROWS) / BN : S / BN;

  auto load_tile = [&](int kt) {
    const int st = kt % kStages;
    bf16* tK = sKV + st * 2 * BN * P;
    copy_rows<D, NTH>(tK, P, k_base + (long)kt * BN * kv_row, kv_row, BN);
    copy_rows<D, NTH>(tK + BN * P, P, v_base + (long)kt * BN * kv_row,
                      kv_row, BN);
    if (SEG) copy_words<NTH>(sSeg + st * BN, segk_b + kt * BN, BN);
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
                   const int* __restrict__ seg, const int* __restrict__ seg_k,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
                   int KVH, int causal, float scale) {
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
    seg_c[0] = seg_k[(long)b * S + c0];
    seg_c[1] = seg_k[(long)b * S + c0 + 8];
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
// Forward, bf16 (wgmma, TMA): one CTA per (q tile of 64 * WG rows, head,
// batch) of WG consumer warpgroups, each owning 64 query rows, and one
// producer warpgroup that streams the key tiles (BN rows) into rings of
// kFwdStages stages.
// ---------------------------------------------------------------------------

// Key rows a bf16 forward step streams: 128 with two consumer
// warpgroups (D = 128), else 64, so that the rings fit shared memory.
template <int D, int WG>
__host__ __device__ constexpr int fwd_keys() {
  return D == 128 && WG == 2 ? 128 : 64;
}

// Shared memory of a bf16 forward CTA: Q, the K and V rings (1024-byte
// aligned tiles first), then the segment ids of the K stages, the
// barriers, and the bitmask of the key tiles to visit.
template <int D, int WG>
__host__ __device__ constexpr size_t fwd_tiles_bytes() {
  return sizeof(bf16) * D *
         (size_t)(64 * WG + 2 * kFwdStages * fwd_keys<D, WG>());
}

template <int D, bool SEG, int WG>
size_t fwd_bf16_smem(int s) {
  constexpr int BN = fwd_keys<D, WG>();
  return fwd_tiles_bytes<D, WG>() + sizeof(int) * kFwdStages * BN +
         sizeof(uint64_t) * (4 * kFwdStages + 1) +
         (SEG ? sizeof(uint32_t) * (s / BN / 32 + 1) : 0);
}

// SEG: the key tiles among the first n_tiles whose segment-id range
// [min, max] (of the key ids segk_b) meets the query tile's (of seg_b),
// as bits of `bits`; returns their count. A tile outside that range holds
// no key of any query's segment, whatever the order of the ids, so
// skipping it is exact. With key ids apart from the query ids (a block of
// another rank's keys) the count can be 0.
template <int NTH, int BM, int BN>
__device__ int visited_tiles(uint32_t* bits, int* count, const int* seg_b,
                             const int* segk_b, int q0, int n_tiles) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x; w <= n_tiles / 32; w += NTH) bits[w] = 0;
  if (threadIdx.x == 0) *count = 0;
  int q_lo = INT_MAX, q_hi = INT_MIN;
#pragma unroll
  for (int i = lane; i < BM; i += 32) {
    const int x = seg_b[q0 + i];
    q_lo = min(q_lo, x);
    q_hi = max(q_hi, x);
  }
  q_lo = __reduce_min_sync(0xffffffffu, q_lo);
  q_hi = __reduce_max_sync(0xffffffffu, q_hi);
  __syncthreads();  // bits and count are cleared
  for (int kt = warp; kt < n_tiles; kt += NTH / 32) {
    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int i = lane; i < BN; i += 32) {
      const int x = segk_b[kt * BN + i];
      lo = min(lo, x);
      hi = max(hi, x);
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0 && hi >= q_lo && lo <= q_hi) {
      atomicOr(&bits[kt >> 5], 1u << (kt & 31));
      atomicAdd(count, 1);
    }
  }
  __syncthreads();
  // read through a shuffle, so that the compiler knows it is the same
  // in every lane: wgmma in a loop it cannot prove uniform is serialized
  return __shfl_sync(0xffffffffu, *count, 0);
}

// The first key tile after kt (-1: the first) whose bit is set; one is.
__device__ __forceinline__ int next_tile(const uint32_t* bits, int kt) {
  int w = (kt + 1) >> 5;
  uint32_t word = bits[w] & (0xffffffffu << ((kt + 1) & 31));
  while (word == 0) word = bits[++w];
  return (w << 5) + __ffs(word) - 1;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D, bool SEG, int WG>
__global__ void __launch_bounds__(128 * (WG + 1), 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const int* __restrict__ seg,
                   const int* __restrict__ seg_k, bf16* __restrict__ o,
                   float* __restrict__ lse, int S, int H, int KVH,
                   int causal, float scale) {
  constexpr int NTH = 128 * WG;  // consumer threads
  constexpr int BM = 64 * WG;
  constexpr int BN = fwd_keys<D, WG>();
  constexpr int NS = BN / 8;  // n8 tiles of S
  constexpr int NO = D / 8;   // n8 tiles of O
  constexpr int kTile = BN * D;
  // The tiles need 1024-byte alignment (the 128-byte swizzle): the
  // kernel has no static shared memory, so the dynamic part starts on a
  // 1024-byte boundary.
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BM * D;             // K ring: stage i at i * kTile
  bf16* sV = sK + kFwdStages * kTile;  // V ring, the same
  int* sSeg = reinterpret_cast<int*>(smem_raw + fwd_tiles_bytes<D, WG>());
  // full[0][i] / full[1][i]: stage i of the K / V ring is loaded;
  // empty[r][i]: every thread is done reading it.
  uint64_t(*full)[kFwdStages] =
      reinterpret_cast<uint64_t(*)[kFwdStages]>(sSeg + kFwdStages * BN);
  uint64_t(*empty)[kFwdStages] = full + 2;
  int* count = reinterpret_cast<int*>(empty + 2);
  uint32_t* bits = reinterpret_cast<uint32_t*>(count + 2);  // SEG

  // q tiles go in launch order, the last first: in causal runs they
  // stream the most key tiles, so the heaviest CTAs start in the first
  // wave.
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * BM;
  const int kh = h / (H / KVH);
  // read through a shuffle, so that the compiler knows it is the same
  // in every lane: wgmma on a path it cannot prove uniform is serialized
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int warp = (threadIdx.x >> 5) & 3;  // in the warpgroup
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int* seg_b = seg + (long)b * S;
  const int* segk_b = seg_k + (long)b * S;
  if (threadIdx.x == 0) {
    for (int r = 0; r < 2; ++r) {
      for (int i = 0; i < kFwdStages; ++i) {
        mbar_init(&full[r][i], 1);
        mbar_init(&empty[r][i], NTH);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int n_tiles = causal ? (q0 + BM) / BN : S / BN;
  if constexpr (SEG) {
    n_tiles = visited_tiles<NTH + 128, BM, BN>(bits, count, seg_b, segk_b,
                                               q0, n_tiles);
    if (n_tiles == 0) {
      // No key of the tile's documents in this block: every row is
      // masked, as a row is whose visited keys are all masked (o = 0,
      // lse of l = 0), so that a merge over key blocks gives it no
      // weight. n_tiles is the same in every thread.
      const long q_row = (long)H * D;
      for (int i = threadIdx.x; i < BM * D; i += blockDim.x)
        o[((long)b * S + q0 + i / D) * q_row + (long)h * D + i % D] =
            __float2bfloat16(0.f);
      for (int i = threadIdx.x; i < BM; i += blockDim.x)
        lse[((long)b * H + h) * S + q0 + i] = kNegInf * kLn2 + logf(1e-30f);
      return;
    }
  } else {
    __syncthreads();  // the barriers are initialised
  }

  if (wg == WG) {
    // The producer warpgroup hands most of its registers to the
    // consumers, and one of its threads issues every load. Step i
    // multiplies q by K tile i and p_{i-1} by V tile i - 1, so K tiles
    // are loaded one ahead of V tiles. A stage is refilled once every
    // consumer thread has released it (its empty barrier); its full
    // barrier completes when TMA has written its bytes. Nothing else
    // makes the warpgroups wait for each other.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == NTH) {
      int k_tile = -1, v_tile = -1;
      for (int i = 0; i <= n_tiles; ++i) {
        if (i < n_tiles) {  // K tile i, with Q at i = 0
          const int st = i % kFwdStages;
          k_tile = SEG ? next_tile(bits, k_tile) : i;
          mbar_wait(&empty[0][st], ((i / kFwdStages) & 1) ^ 1);
          mbar_expect_tx(&full[0][st],
                         sizeof(bf16) * (kTile + (i == 0 ? BM * D : 0)) +
                             (SEG ? sizeof(int) * BN : 0));
          if (i == 0) {
#pragma unroll
            for (int c = 0; c < D / 64; ++c)
              tma_load(sQ + c * BM * 64, &tq, 64 * c, h, b * S + q0,
                       &full[0][0]);
          }
#pragma unroll
          for (int c = 0; c < D / 64; ++c)
            tma_load(sK + st * kTile + c * BN * 64, &tk, 64 * c, kh,
                     b * S + k_tile * BN, &full[0][st]);
          if (SEG)
            bulk_load(sSeg + st * BN, segk_b + k_tile * BN, sizeof(int) * BN,
                      &full[0][st]);
        }
        if (i > 0) {  // V tile i - 1
          const int st = (i - 1) % kFwdStages;
          v_tile = SEG ? next_tile(bits, v_tile) : i - 1;
          mbar_wait(&empty[1][st], (((i - 1) / kFwdStages) & 1) ^ 1);
          mbar_expect_tx(&full[1][st], sizeof(bf16) * kTile);
#pragma unroll
          for (int c = 0; c < D / 64; ++c)
            tma_load(sV + st * kTile + c * BN * 64, &tv, 64 * c, kh,
                     b * S + v_tile * BN, &full[1][st]);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int wr0 = q0 + 64 * wg;        // the warpgroup's first row
  const int r0 = wr0 + 16 * warp + g;  // this lane's rows: r0, r0 + 8
  int seg_r[2] = {0, 0};
  if (SEG) {
    seg_r[0] = seg_b[r0];
    seg_r[1] = seg_b[r0 + 8];
  }
  const float scale_log2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf};  // running max of s * scale * log2(e)
  float l[2] = {0.f, 0.f};          // this lane's part of the running sum
  float acc[NO][4];
  zero(acc);
  float s[NS][4];
  uint32_t p[NS / 2][4];  // P of the step before, bf16 A fragments
  int kt = -1;            // this step's key tile
  // The two warpgroups take turns to issue their products (named
  // barriers 1 and 2), so that one's softmax runs beside the other's
  // products on the tensor cores.
  if (WG == 2 && wg == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kFwdStages;
    const int pst = (i + kFwdStages - 1) % kFwdStages;  // V tile i - 1's
    kt = SEG ? next_tile(bits, kt) : i;
    mbar_wait(&full[0][st], (i / kFwdStages) & 1);
    if (i > 0) mbar_wait(&full[1][pst], ((i - 1) / kFwdStages) & 1);
    if (WG == 2) {
      if (wg == 0)
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
      else
        asm volatile("bar.sync 2, 256;\n" ::: "memory");
    }
    // s = q k^T for the warpgroup's 64 rows; then o += p v of the step
    // before, which runs on the tensor cores during this step's softmax
    fence_regs(s);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BN>(s, desc_k_major<BM>(sQ, 64 * wg, kk),
                   desc_k_major<BN>(sK + st * kTile, 0, kk), kk > 0);
    wgmma_commit();
    if (i > 0) {
      fence_regs(p);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<D>(acc, p[kk], desc_mn_major<BN>(sV + pst * kTile, kk), 1);
    }
    wgmma_commit();
    if (WG == 2 && !(wg == 1 && i + 1 == n_tiles)) {
      if (wg == 0)
        asm volatile("bar.arrive 2, 256;\n" ::: "memory");
      else
        asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    }
    wgmma_wait<1>();  // s is in
    fence_regs(s);

    // p = exp2(s * scale * log2(e) - m), masked p = 0; the causal mask
    // only on the tiles that cross the diagonal. A masked score is -inf
    // here: with m starting at the reference's finite NEG_INF, a row
    // whose keys so far are all masked keeps p = 0 and l = 0 where the
    // reference sums exp(0) terms that the first kept key's correction
    // exp(NEG_INF - m) zeroes, so o and lse are the same. (A finite mask
    // would leave exp2 of fma's rounding residual, up to 1e21, there.)
    if (SEG) {
      const int* tSeg = sSeg + st * BN;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int2 ks = *reinterpret_cast<const int2*>(tSeg + j * 8 + 2 * t);
        if (ks.x != seg_r[0]) s[j][0] = -INFINITY;
        if (ks.y != seg_r[0]) s[j][1] = -INFINITY;
        if (ks.x != seg_r[1]) s[j][2] = -INFINITY;
        if (ks.y != seg_r[1]) s[j][3] = -INFINITY;
      }
    }
    mbar_arrive(&empty[0][st]);  // K tile i and its ids are read
    if (causal && kt * BN + BN - 1 > wr0) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kt * BN + j * 8 + 2 * t + (e & 1) > r0 + 8 * (e >> 1))
            s[j][e] = -INFINITY;
        }
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx) * scale_log2);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], scale_log2, -m[e >> 1]));
        l[e >> 1] += s[j][e];
      }
    }
    wgmma_wait<0>();  // the step before's o += p v is done
    fence_regs(acc);
    fence_regs(p);
    if (i > 0) mbar_arrive(&empty[1][pst]);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    // P rounded to bf16 before P.V, as the reference does
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_a<NS>(p[kk], s, kk);
  }
  // the last o += p v
  const int pst = (n_tiles - 1) % kFwdStages;
  mbar_wait(&full[1][pst], ((n_tiles - 1) / kFwdStages) & 1);
  fence_regs(acc);
  fence_regs(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs<D>(acc, p[kk], desc_mn_major<BN>(sV + pst * kTile, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

  float ls[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) ls[r] = fmaxf(quad_sum(l[r]), 1e-30f);
  const long q_row = (long)H * D;
  store_rows<bf16, NO>(o + ((long)b * S + r0) * q_row + (long)h * D, q_row,
                       acc, 1.f / ls[0], 1.f / ls[1]);
  if (t == 0) {
    float* lse_row = lse + ((long)b * H + h) * S + r0;
    lse_row[0] = m[0] * kLn2 + logf(ls[0]);
    lse_row[8] = m[1] * kLn2 + logf(ls[1]);
  }
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
  const int* seg;    // query rows' segment ids
  const int* seg_k;  // key rows' (seg when the caller passed none)
  void* out0;  // o, dq or dk
  void* out1;  // dv
  float* lse_out;
  int b, s, h, kvh, causal;
  float scale;
  cudaStream_t stream;
};

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A TMA map of x [B * S rows, heads, D] bf16 (the model layout) whose box
// is `rows` rows of one head and 64 columns (128 bytes), written into
// shared memory in the 128-byte swizzle.
bool tensor_map(CUtensorMap* map, const void* x, int d, int heads,
                long rows_total, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)rows_total};
  const cuuint64_t strides[2] = {sizeof(bf16) * (cuuint64_t)d,
                                 sizeof(bf16) * (cuuint64_t)d * heads};
  const cuuint32_t box[3] = {64, 1, (cuuint32_t)rows};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(x), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 forward CTA has 2 consumer warpgroups (128 rows) where S % 128
// = 0 and D = 128, else 1 (at D = 256 the rings fill shared memory).
template <int D, bool SEG, int WG>
cudaError_t run_fwd_bf16(const Args& a) {
  constexpr int BN = fwd_keys<D, WG>();
  CUtensorMap tq, tk, tv;
  const long rows = (long)a.b * a.s;
  if (!tensor_map(&tq, a.q, D, a.h, rows, 64 * WG) ||
      !tensor_map(&tk, a.k, D, a.kvh, rows, BN) ||
      !tensor_map(&tv, a.v, D, a.kvh, rows, BN))
    return cudaErrorInvalidValue;
  return launch(flash_fwd_bf16<D, SEG, WG>, dim3(a.h, a.b, a.s / (64 * WG)),
                128 * (WG + 1), fwd_bf16_smem<D, SEG, WG>(a.s), a.stream, tq,
                tk, tv, a.seg, a.seg_k, static_cast<bf16*>(a.out0), a.lse_out,
                a.s, a.h, a.kvh, a.causal, a.scale);
}

template <typename T, int D, bool SEG>
cudaError_t run_fwd(const Args& a) {
  if constexpr (std::is_same<T, bf16>::value) {
    if constexpr (D == 128)
      if (a.s % 128 == 0) return run_fwd_bf16<D, SEG, 2>(a);
    return run_fwd_bf16<D, SEG, 1>(a);
  } else {
    return launch(flash_fwd_f32<D, SEG>, dim3(a.s / kBM, a.h, a.b), kThreads,
                  fwd_f32_smem<D>(), a.stream, static_cast<const T*>(a.q),
                  static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                  a.seg, a.seg_k, static_cast<T*>(a.out0), a.lse_out, a.s, a.h,
                  a.kvh, a.causal, a.scale);
  }
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
                a.seg_k, static_cast<bf16*>(a.out0), a.s, a.h, a.kvh,
                a.causal, a.scale);
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
                  a.seg_k, static_cast<T*>(a.out0), a.s, a.h, a.kvh, a.causal,
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
                  a.lse_in, a.delta, a.seg, a.seg_k, dk, dv, a.s, a.h, a.kvh,
                  a.causal, a.scale);
  else
    return launch(flash_dkv_f32<D, SEG>, dim3(a.s / kBM, a.kvh, a.b),
                  kThreads, dkv_f32_smem<D>(), a.stream, q, k, v, dout,
                  a.lse_in, a.delta, a.seg, a.seg_k, dk, dv, a.s, a.h, a.kvh,
                  a.causal, a.scale);
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
// seg [B,S] int32 or null: the query rows' segment ids; seg_k [B,S] the
// key rows' (a ring block pairs one rank's queries with another's keys),
// null for seg itself.
int skyt_flash_fwd(const void* q, const void* k, const void* v,
                   const int* seg, const int* seg_k, void* o, float* lse,
                   int b, int s, int h, int kvh, int d, int causal,
                   float scale, int dtype, void* stream) {
  Args a = {q, k, v, nullptr, nullptr, nullptr, nullptr, seg,
            seg_k != nullptr ? seg_k : seg, o, nullptr, lse, b, s, h, kvh,
            causal, scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(kFwd, dtype, d, a));
}

// dq [B,S,H,D] and delta = rowsum(do * o) [B,H,S] fp32 from q, o, do
// [B,S,H,D], k, v and lse [B,H,S] fp32; seg and seg_k as for the forward.
int skyt_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, const int* seg, const int* seg_k,
                      void* dq, int b, int s, int h, int kvh, int d,
                      int causal, float scale, int dtype, void* stream) {
  Args a = {q, k, v, o, dout, lse, delta, seg,
            seg_k != nullptr ? seg_k : seg, dq, nullptr, nullptr, b, s, h,
            kvh, causal, scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(kDq, dtype, d, a));
}

// dk, dv [B,S,KVH,D] from q, k, v, do, lse and the dq kernel's delta;
// seg and seg_k as for the forward.
int skyt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const int* seg, const int* seg_k, void* dk, void* dv,
                       int b, int s, int h, int kvh, int d, int causal,
                       float scale, int dtype, void* stream) {
  Args a = {q, k, v, nullptr, dout, lse, const_cast<float*>(delta), seg,
            seg_k != nullptr ? seg_k : seg, dk, dv, nullptr, b, s, h, kvh,
            causal, scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(kDkv, dtype, d, a));
}

}  // extern "C"
