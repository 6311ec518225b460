// Paged attention for Hopper (sm_90a): the attention of every decode and
// verify step of the continuous engine, read straight from the paged KV
// pool through per-slot block tables.
//
// Replaces the TPU kernels of skypilot_tpu/ops/pallas/paged_attention.py:
//   * _paged_kernel        (fp pool)    -> TKV = __nv_bfloat16 or float
//   * _paged_kernel_quant  (int8 pool)  -> TKV = int8_t, fp32 row scales
// both launched there through _pallas_paged (pl.pallas_call).
//
// What it computes, per (sequence b, kv head h): the Q*G query rows of
// the kv head's GQA group (row r is window position r / G) attend the
// slot's pool rows through block_tables[b, :], with an fp32 running max
// and sum, the window mask  pos < n_valid[b] - (Q - 1 - r / G)  and the
// finite NEG_INF of the reference (a fully masked row gives uniform
// weights over the blocks read, never NaN). Only the first
// ceil(n_valid[b] / BS) pool blocks are read. For a bf16 pool P is
// rounded to bf16 before P.V (the reference's p.astype(v.dtype)); for an
// int8 pool V is dequantized to fp32 and P stays fp32. The result is
// acc / max(l, 1e-30), in the query dtype.
//
// What bounds it on an H100: bytes. A launch must read
//   sum_b ceil(n_valid_b / BS) * BS * KVH * D * 2 * itemsize(pool)
// bytes of K and V (an int8 pool reads half of a bf16 one, plus 8 bytes
// of scales per row and head), against 4 flops per (query row, key row,
// head dim): at Q=1 and G=4 that is ~4 flops a bf16 byte, far below the
// ~295 flop/byte at which the tensor cores would bind.
//
// What the design does about it: it keeps bytes in flight on every SM
// from the first cycle and spends few instructions on each byte.
//   * One CTA owns a (b, h, split). The wrapper picks the split count
//     from B and KVH alone (about one wave of CTAs at small batch, one
//     split at large batch), so the host never reads the lengths.
//   * The CTA reads its split's block-table entries into shared memory
//     before the loop, so every pool address is known ahead of its copy.
//   * Each warp owns whole tiles of the split's rows and copies their K
//     and V rows (and int8 row scales) in the stored type with 16-byte
//     cp.async into its own ring of stages: while it computes one tile
//     the next ones are in flight, and the loop has no CTA barrier. The
//     warp keeps its own running max (exp2 on log2-scaled scores), sum
//     and accumulator.
//   * bf16 queries (the engine's): tensor cores. A warp takes 16 rows a
//     step; S = q.K^T and O += P.V are mma.sync.m16n8k16 with ldmatrix
//     fragments, for up to 32 query rows (Q*G; 16 at D=256), P comes
//     straight from S's accumulators. An int8 tile is widened to bf16
//     in shared memory (its integers are exact), its row scales go on
//     the fp32 scores and on P, and P.V takes P as the sum of three
//     bf16 terms, which hold its fp32 value exactly.
//   * fp32 queries, and wider windows: CUDA cores, 32 rows a step, lane
//     j scoring row j against every query row in fp32.
//   * The CTA merges its warps once. The split CTAs of one (b, h) are one
//     thread-block cluster: each keeps its partial (max, sum, acc) in its
//     shared memory, and rank 0 merges them through distributed shared
//     memory and writes the output. One launch, no scratch in device
//     memory, no atomics.
//
// C interface (loaded with ctypes by skypilot_tpu_torch/_build.py):
// skyt_paged_attention(...) returns the launch's error code (0 =
// cudaSuccess); it launches on the given stream, never synchronises and
// allocates nothing.

#include "attention_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Pieces both kernels share
// ---------------------------------------------------------------------------

// A CTA's share of its slot: the split's first block and rows, and how
// many splits of the slot hold blocks (1 for an empty slot, whose split 0
// writes zeros).
struct Split {
  int nv, active, blk0, nrows, pos0;
};

__device__ __forceinline__ Split split_of(int nv, int bs, int bps, int split,
                                          int num_splits) {
  Split s;
  s.nv = nv;
  const int nblk = nv > 0 ? min((nv + bs - 1) / bs, bps) : 0;
  const int per = (nblk + num_splits - 1) / num_splits;
  s.active = per > 0 ? (nblk + per - 1) / per : 1;
  s.blk0 = split * per;
  s.nrows = max(min(per, nblk - s.blk0), 0) * bs;
  s.pos0 = s.blk0 * bs;
  return s;
}

// Start copying the split's rows [srow0, srow0 + ROWS) into a K and a V
// tile (row pitch `pitch` elements) and, for an int8 pool, their row
// scales; rows past the split are zero-filled. Pool rows come from the
// block-table entries in shared memory; lane i finds row i's.
template <typename TKV, int D, int ROWS>
__device__ __forceinline__ void issue_tile(
    TKV* sk, TKV* sv, float* sks, float* svs, int pitch,
    const TKV* __restrict__ k_pool, const TKV* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* s_bt, int srow0, int nrows, int bs, int kvh, int h, int lane) {
  constexpr int kVec = 16 / sizeof(TKV);
  constexpr int kVecPerRow = D / kVec;
  const int srow = srow0 + lane % ROWS;
  const int prow = srow < nrows ? s_bt[srow / bs] * bs + srow % bs : -1;
#pragma unroll 4
  for (int c = 0; c < ROWS * kVecPerRow / 32; ++c) {
    const int vi = c * 32 + lane;
    const int row = vi / kVecPerRow;
    const int col = (vi % kVecPerRow) * kVec;
    const int pr = __shfl_sync(kFull, prow, row);
    const size_t off =
        pr >= 0 ? (static_cast<size_t>(pr) * kvh + h) * D + col : 0;
    cp_async16(sk + row * pitch + col, k_pool + off, pr >= 0);
    cp_async16(sv + row * pitch + col, v_pool + off, pr >= 0);
  }
  if (k_scale != nullptr && lane < ROWS) {
    const size_t so = prow >= 0 ? static_cast<size_t>(prow) * kvh + h : 0;
    cp_async4(sks + lane, k_scale + so, prow >= 0);
    cp_async4(svs + lane, v_scale + so, prow >= 0);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core kernel: bf16 queries, bf16 or int8 pool, up to 16 * M
// query rows.
// ---------------------------------------------------------------------------

// Byte offsets of the tensor-core kernel's dynamic shared memory: the
// query rows (bf16, zero past Q*G), the split's block-table entries,
// the merged rows' (max, sum); then one slab per warp: its ring (K and V
// tiles in the stored type, rows padded by 16 bytes so ldmatrix reads
// fall in distinct banks, int8 row scales) and, for an int8 pool, the
// bf16 K and V tiles widened from it. After the loop the warp's partial
// (acc, max, sum) overlays its slab.
struct MmaLayout {
  int q, bt, rows, slabs;                // CTA-wide
  int k, v, ks, vs, wk, wv, stage;       // slab: ring, widened tiles
  int acc, m, l;                         // slab after the loop
  int per_warp;
};

__host__ __device__ inline MmaLayout mma_layout(int m_tiles, int per, int d,
                                                int kv_bytes) {
  const int stages = mma_stages(kv_bytes, d);
  const int rows = kMmaTile * m_tiles;
  MmaLayout s;
  s.q = 0;
  s.bt = align16(rows * (2 * d + 16));
  s.rows = s.bt + align16(4 * per);
  s.slabs = s.rows + align16(4 * 2 * rows);
  s.stage = kMmaTile * (d * kv_bytes + 16);
  s.k = 0;
  s.v = s.k + stages * s.stage;
  s.ks = s.v + stages * s.stage;
  s.vs = s.ks + stages * kMmaTile * 4;
  s.wk = s.vs + stages * kMmaTile * 4;
  const int wide = kv_bytes == 1 ? kMmaTile * (2 * d + 16) : 0;
  s.wv = s.wk + wide;
  s.acc = 0;
  s.m = 4 * rows * d;
  s.l = s.m + 4 * rows;
  s.per_warp = align16(s.wv + wide > s.l + 4 * rows ? s.wv + wide
                                                    : s.l + 4 * rows);
  return s;
}

template <typename TKV, int D, int M>
__global__ void __launch_bounds__(kMaxWarps * 32)
    paged_attention_mma(const bf16* __restrict__ q,          // [B,KVH,QG,D]
                        const TKV* __restrict__ k_pool,      // [NB,BS,KVH,D]
                        const TKV* __restrict__ v_pool,
                        const float* __restrict__ k_scale,   // [NB,BS,KVH]
                        const float* __restrict__ v_scale,
                        const int* __restrict__ block_tables,  // [B,BPS]
                        const int* __restrict__ n_valid,       // [B]
                        bf16* __restrict__ out,            // [B,KVH,QG,D]
                        int kvh, int qg, int q_len, int bs, int bps,
                        float scale) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int kStages = mma_stages(sizeof(TKV), D);
  constexpr int kPitch = D + 16 / sizeof(TKV);  // ring row, elements
  constexpr int kP = D + 8;                     // bf16 row, elements
  constexpr int kNT = D / 8;                    // 8-wide output tiles
  const float kMaskOut = -__int_as_float(0x7f800000);  // a row not read

  const int nw = blockDim.x / 32;
  const int bh = blockIdx.y;  // b * kvh + h; blockIdx.x is the split
  const int b = bh / kvh;
  const int h = bh % kvh;
  const int group = qg / q_len;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem[];
  const MmaLayout lay =
      mma_layout(M, (bps + gridDim.x - 1) / gridDim.x, D, sizeof(TKV));
  bf16* s_q = reinterpret_cast<bf16*>(smem + lay.q);
  int* s_bt = reinterpret_cast<int*>(smem + lay.bt);
  unsigned char* slab = smem + lay.slabs + warp * lay.per_warp;
  TKV* s_k = reinterpret_cast<TKV*>(slab + lay.k);
  TKV* s_v = reinterpret_cast<TKV*>(slab + lay.v);
  float* s_ks = reinterpret_cast<float*>(slab + lay.ks);
  float* s_vs = reinterpret_cast<float*>(slab + lay.vs);
  bf16* w_k = reinterpret_cast<bf16*>(slab + lay.wk);
  bf16* w_v = reinterpret_cast<bf16*>(slab + lay.wv);

  // The query rows (zero past Q*G) need no length: their copies are in
  // flight while n_valid is read.
  const bf16* q_bh = q + static_cast<size_t>(bh) * qg * D;
  for (int i = threadIdx.x; i < kMmaTile * M * (D / 8); i += blockDim.x) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    cp_async16(s_q + r * kP + c, q_bh + (r < qg ? r * D + c : 0), r < qg);
  }
  cp_async_commit();
  const Split sp = split_of(n_valid[b], bs, bps, blockIdx.x, gridDim.x);
  if (static_cast<int>(blockIdx.x) >= sp.active) {
    cp_async_wait<0>();
    idle_split(sp.active);
    return;
  }
  const int* bt = block_tables + static_cast<size_t>(b) * bps + sp.blk0;
  for (int i = threadIdx.x; i < sp.nrows / bs; i += blockDim.x)
    s_bt[i] = bt[i];
  cp_async_wait<0>();
  __syncthreads();

  // This warp's tiles: t = warp, warp + nw, ...; its k-th tile goes to
  // ring stage k % kStages. Every call commits one cp.async group (empty
  // past the last tile), so group k is tile k.
  const int ntiles = (sp.nrows + kMmaTile - 1) / kMmaTile;
  const int my_tiles = warp < ntiles ? (ntiles - warp + nw - 1) / nw : 0;
  auto issue = [&](int k) {
    if (k < my_tiles) {
      const int st = k % kStages;
      issue_tile<TKV, D, kMmaTile>(
          s_k + st * (lay.stage / sizeof(TKV)),
          s_v + st * (lay.stage / sizeof(TKV)), s_ks + st * kMmaTile,
          s_vs + st * kMmaTile, kPitch, k_pool, v_pool, k_scale, v_scale,
          s_bt, (warp + k * nw) * kMmaTile, sp.nrows, bs, kvh, h, lane);
    }
    cp_async_commit();
  };

  float acc[M][kNT][4];
  float m_run[M][2];
  float l_run[M][2];  // this lane's share of the row sums
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m_run[m][hh] = kNegInf;
      l_run[m][hh] = 0.f;
    }
  }
  const float q_scale = scale * kLog2e;

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(k);
  for (int k = 0; k < my_tiles; ++k) {
    issue(k + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();  // every lane's copies of tile k have landed

    const int st = k % kStages;
    const int srow0 = (warp + k * nw) * kMmaTile;
    const bf16* tk;
    const bf16* tv;
    if constexpr (kQuant) {
      widen<D>(w_k, reinterpret_cast<const int8_t*>(s_k) + st * lay.stage,
               lane);
      widen<D>(w_v, reinterpret_cast<const int8_t*>(s_v) + st * lay.stage,
               lane);
      __syncwarp();
      tk = w_k;
      tv = w_v;
    } else {
      tk = reinterpret_cast<const bf16*>(s_k) + st * (lay.stage / 2);
      tv = reinterpret_cast<const bf16*>(s_v) + st * (lay.stage / 2);
    }

    // S = q.K^T over the 16 rows: s[m][0] keys 0-7, s[m][1] keys 8-15.
    float s[M][2][4];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[m][n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t bk[4];
      load_b_nk(bk, tk + kk * 16, kP, lane);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        uint32_t aq[4];
        load_a(aq, s_q + m * kMmaTile * kP + kk * 16, kP, lane);
        mma_bf16(s[m][0], aq, bk[0], bk[1]);
        mma_bf16(s[m][1], aq, bk[2], bk[3]);
      }
    }

    // Scale (and the int8 K row scale), mask, online softmax in log2
    // units: m_run is the row's max over this warp's rows so far.
    float ksc[2][2];
    float vsc[2][2];
    bool rd[2][2];
    int pos[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n * 8 + 2 * t + j;
        ksc[n][j] = kQuant ? q_scale * s_ks[st * kMmaTile + col] : q_scale;
        vsc[n][j] = kQuant ? s_vs[st * kMmaTile + col] : 1.f;
        rd[n][j] = srow0 + col < sp.nrows;
        pos[n][j] = sp.pos0 + srow0 + col;
      }
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m * kMmaTile + g + 8 * hh;
        const int lim = sp.nv - (q_len - 1 - r / group);
        float mx = kMaskOut;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = s[m][n][2 * hh + j];
            x = !rd[n][j] ? kMaskOut
                          : pos[n][j] < lim ? x * ksc[n][j] : kNegInf;
            mx = fmaxf(mx, x);
          }
        const float m_new = fmaxf(m_run[m][hh], quad_max(mx));
        const float corr = exp2f(m_run[m][hh] - m_new);
        m_run[m][hh] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = s[m][n][2 * hh + j];
            x = exp2f(x - m_new);
            sum += x;
          }
        l_run[m][hh] = l_run[m][hh] * corr + sum;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          acc[m][n][2 * hh] *= corr;
          acc[m][n][2 * hh + 1] *= corr;
        }
      }
    }

    // O += P.V: a bf16 pool rounds P to bf16 (the reference's
    // p.astype(v.dtype)); an int8 pool folds V's row scales into P and
    // feeds P as hi + mid + lo, three bf16 terms that sum to it exactly.
    if constexpr (!kQuant) {
      uint32_t pa[M][4];
#pragma unroll
      for (int m = 0; m < M; ++m) acc_a(pa[m], s[m][0], s[m][1]);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bv[4];
        load_b_kn(bv, tv + nd * 16, kP, lane);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          mma_bf16(acc[m][2 * nd], pa[m], bv[0], bv[1]);
          mma_bf16(acc[m][2 * nd + 1], pa[m], bv[2], bv[3]);
        }
      }
    } else {
      uint32_t pa[3][M][4];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float part[3][2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = s[m][n][i] * vsc[n][i & 1];
            const float hi = __bfloat162float(__float2bfloat16(x));
            const float mid = __bfloat162float(__float2bfloat16(x - hi));
            part[0][n][i] = hi;
            part[1][n][i] = mid;
            part[2][n][i] = x - hi - mid;
          }
#pragma unroll
        for (int p = 0; p < 3; ++p) acc_a(pa[p][m], part[p][0], part[p][1]);
      }
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bv[4];
        load_b_kn(bv, tv + nd * 16, kP, lane);
#pragma unroll
        for (int p = 2; p >= 0; --p)
#pragma unroll
          for (int m = 0; m < M; ++m) {
            mma_bf16(acc[m][2 * nd], pa[p][m], bv[0], bv[1]);
            mma_bf16(acc[m][2 * nd + 1], pa[p][m], bv[2], bv[3]);
          }
      }
    }
    __syncwarp();  // the stage (and the widened tiles) are refilled next
  }
  cp_async_wait<0>();
  __syncwarp();

  // This warp's partial over its slab.
  float* w_acc = reinterpret_cast<float*>(slab + lay.acc);
  float* w_m = reinterpret_cast<float*>(slab + lay.m);
  float* w_l = reinterpret_cast<float*>(slab + lay.l);
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = m * kMmaTile + g + 8 * hh;
      const float l = quad_sum(l_run[m][hh]);
      if (r < qg) {
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          *reinterpret_cast<float2*>(w_acc + r * D + n * 8 + 2 * t) =
              make_float2(acc[m][n][2 * hh], acc[m][n][2 * hh + 1]);
        if (t == 0) {
          w_m[r] = m_run[m][hh];
          w_l[r] = l;
        }
      }
    }
  }
  finish<bf16, D>(smem, lay.slabs, lay.per_warp, lay.acc, lay.m, lay.l,
                  reinterpret_cast<float*>(smem + lay.rows), qg, bh,
                  sp.active, out);
}

// ---------------------------------------------------------------------------
// CUDA-core kernel: fp32 queries (and windows wider than the tensor-core
// kernel takes), any pool.
// ---------------------------------------------------------------------------

// Byte offsets of the CUDA-core kernel's dynamic shared memory: the
// scaled query rows (fp32), the split's block-table entries, the merged
// rows' (max, sum), then one slab per warp: its ring (K and V tiles with
// rows padded by 16 bytes so that lane j's reads of row j fall in
// distinct banks, int8 row scales), its P tile, accumulator, lane sums
// (then its row sums) and running max.
struct SimtLayout {
  int q, bt, rows, slabs;          // CTA-wide
  int k, v, ks, vs, p, acc, l, m;  // inside a slab
  int stage;                       // bytes of one K (or V) tile
  int per_warp;
};

__host__ __device__ inline SimtLayout simt_layout(int qg, int per, int d,
                                                  int kv_bytes) {
  const int stages = simt_stages(kv_bytes, d);
  SimtLayout s;
  s.q = 0;
  s.bt = align16(4 * qg * d);
  s.rows = s.bt + align16(4 * per);
  s.slabs = s.rows + align16(4 * 2 * qg);
  s.stage = kTile * (d * kv_bytes + 16);
  s.k = 0;
  s.v = s.k + stages * s.stage;
  s.ks = s.v + stages * s.stage;
  s.vs = s.ks + stages * kTile * 4;
  s.p = s.vs + stages * kTile * 4;
  s.acc = s.p + kTile * kRows * 4;
  s.l = s.acc + 4 * qg * d;
  s.m = s.l + 4 * qg * kTile;
  s.per_warp = align16(s.m + 4 * qg);
  return s;
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
    paged_attention_simt(const TQ* __restrict__ q,         // [B,KVH,QG,D]
                         const TKV* __restrict__ k_pool,   // [NB,BS,KVH,D]
                         const TKV* __restrict__ v_pool,
                         const float* __restrict__ k_scale,  // [NB,BS,KVH]
                         const float* __restrict__ v_scale,
                         const int* __restrict__ block_tables,  // [B,BPS]
                         const int* __restrict__ n_valid,       // [B]
                         TQ* __restrict__ out,          // [B,KVH,QG,D]
                         int kvh, int qg, int q_len, int bs, int bps,
                         float scale) {
  constexpr int kStages = simt_stages(sizeof(TKV), D);
  constexpr int kVec = 16 / sizeof(TKV);  // elements per 16-byte vector
  constexpr int kVecPerRow = D / kVec;
  constexpr int kPitch = D + kVec;        // padded tile row, elements
  constexpr int kSlice = D / 32;          // head dims a lane owns in P.V
  constexpr bool kRoundP = std::is_same<TKV, bf16>::value;
  const float kMaskOut = -__int_as_float(0x7f800000);  // a row not read

  const int nw = blockDim.x / 32;
  const int bh = blockIdx.y;  // b * kvh + h; blockIdx.x is the split
  const int b = bh / kvh;
  const int h = bh % kvh;
  const int group = qg / q_len;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool quant = k_scale != nullptr;
  const Split sp = split_of(n_valid[b], bs, bps, blockIdx.x, gridDim.x);
  if (static_cast<int>(blockIdx.x) >= sp.active) {
    idle_split(sp.active);
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const SimtLayout lay =
      simt_layout(qg, (bps + gridDim.x - 1) / gridDim.x, D, sizeof(TKV));
  float* s_q = reinterpret_cast<float*>(smem + lay.q);
  int* s_bt = reinterpret_cast<int*>(smem + lay.bt);
  unsigned char* slab = smem + lay.slabs + warp * lay.per_warp;
  TKV* s_k = reinterpret_cast<TKV*>(slab + lay.k);
  TKV* s_v = reinterpret_cast<TKV*>(slab + lay.v);
  float* s_ks = reinterpret_cast<float*>(slab + lay.ks);
  float* s_vs = reinterpret_cast<float*>(slab + lay.vs);
  float* s_p = reinterpret_cast<float*>(slab + lay.p);
  float* s_acc = reinterpret_cast<float*>(slab + lay.acc);
  float* s_l = reinterpret_cast<float*>(slab + lay.l);
  float* s_m = reinterpret_cast<float*>(slab + lay.m);

  const TQ* q_bh = q + static_cast<size_t>(bh) * qg * D;
  const float q_scale = scale * kLog2e;
  for (int i = threadIdx.x; i < qg * D; i += blockDim.x)
    s_q[i] = to_float(q_bh[i]) * q_scale;
  const int* bt = block_tables + static_cast<size_t>(b) * bps + sp.blk0;
  for (int i = threadIdx.x; i < sp.nrows / bs; i += blockDim.x)
    s_bt[i] = bt[i];
  for (int i = lane; i < qg * D; i += 32) s_acc[i] = 0.f;
  for (int i = lane; i < qg * kTile; i += 32) s_l[i] = 0.f;
  for (int r = lane; r < qg; r += 32) s_m[r] = kNegInf;
  __syncthreads();

  // This warp's tiles: t = warp, warp + nw, ...; its k-th tile goes to
  // ring stage k % kStages. Every call commits one cp.async group (empty
  // past the last tile), so group k is tile k.
  const int ntiles = (sp.nrows + kTile - 1) / kTile;
  const int my_tiles = warp < ntiles ? (ntiles - warp + nw - 1) / nw : 0;
  auto issue = [&](int k) {
    if (k < my_tiles) {
      const int st = k % kStages;
      issue_tile<TKV, D, kTile>(
          s_k + st * (lay.stage / sizeof(TKV)),
          s_v + st * (lay.stage / sizeof(TKV)), s_ks + st * kTile,
          s_vs + st * kTile, kPitch, k_pool, v_pool, k_scale, v_scale, s_bt,
          (warp + k * nw) * kTile, sp.nrows, bs, kvh, h, lane);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(k);
  for (int k = 0; k < my_tiles; ++k) {
    issue(k + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();  // every lane's copies of tile k have landed

    const int st = k % kStages;
    const int srow = (warp + k * nw) * kTile + lane;
    const int pos = sp.pos0 + srow;  // this lane's row in the slot
    const bool read = srow < sp.nrows;
    const TKV* k_row = s_k + st * (lay.stage / sizeof(TKV)) + lane * kPitch;
    const TKV* v_tile = s_v + st * (lay.stage / sizeof(TKV));
    const float ks = quant ? s_ks[st * kTile + lane] : 1.f;
    const float* vs = s_vs + st * kTile;

    for (int r0 = 0; r0 < qg; r0 += kRows) {
      // Scores of this lane's row against query rows r0 .. r0 + kRows - 1.
      float dot[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) dot[rr] = 0.f;
#pragma unroll 2
      for (int cv = 0; cv < kVecPerRow; ++cv) {
        float kf[kVec];
        load_slice<TKV, kVec>(k_row + cv * kVec, kf);
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          if (r0 + rr < qg) {
            const float4* qr = reinterpret_cast<const float4*>(
                s_q + (r0 + rr) * D + cv * kVec);
#pragma unroll
            for (int i = 0; i < kVec / 4; ++i) {
              const float4 qv = qr[i];
              dot[rr] += qv.x * kf[4 * i] + qv.y * kf[4 * i + 1] +
                         qv.z * kf[4 * i + 2] + qv.w * kf[4 * i + 3];
            }
          }
        }
      }
      // Online softmax in log2 units; each lane keeps its own share of
      // the row sums, the max is the warp's.
      float p[kRows];
      float corr[kRows];
      float m_new[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const int r = r0 + rr;
        p[rr] = 0.f;
        corr[rr] = 1.f;
        m_new[rr] = kNegInf;
        if (r < qg) {  // uniform across the warp
          const bool valid = pos < sp.nv - (q_len - 1 - r / group);
          const float s = !read ? kMaskOut : valid ? dot[rr] * ks : kNegInf;
          const float m_prev = s_m[r];
          m_new[rr] = fmaxf(m_prev, warp_max(s));
          const float e = exp2f(s - m_new[rr]);
          corr[rr] = exp2f(m_prev - m_new[rr]);
          s_l[r * kTile + lane] = s_l[r * kTile + lane] * corr[rr] + e;
          p[rr] = kRoundP ? __bfloat162float(__float2bfloat16(e)) : e;
        }
      }
      float4* pw = reinterpret_cast<float4*>(s_p + lane * kRows);
#pragma unroll
      for (int i = 0; i < kRows / 4; ++i)
        pw[i] = make_float4(p[4 * i], p[4 * i + 1], p[4 * i + 2],
                            p[4 * i + 3]);
      __syncwarp();  // P visible; every lane has read s_m
      if (lane == 0) {
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr)
          if (r0 + rr < qg) s_m[r0 + rr] = m_new[rr];
      }

      // P.V: lane owns head dims [lane * kSlice, + kSlice) of each row.
      float a[kRows][kSlice];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
        for (int i = 0; i < kSlice; ++i)
          a[rr][i] = r0 + rr < qg
                         ? s_acc[(r0 + rr) * D + lane * kSlice + i] * corr[rr]
                         : 0.f;
      }
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        float pj[kRows];
        const float4* pr = reinterpret_cast<const float4*>(s_p + j * kRows);
#pragma unroll
        for (int i = 0; i < kRows / 4; ++i) {
          const float4 x = pr[i];
          pj[4 * i] = x.x;
          pj[4 * i + 1] = x.y;
          pj[4 * i + 2] = x.z;
          pj[4 * i + 3] = x.w;
        }
        float v[kSlice];
        load_slice<TKV, kSlice>(v_tile + j * kPitch + lane * kSlice, v);
        if (quant) {
          const float vsj = vs[j];
#pragma unroll
          for (int i = 0; i < kSlice; ++i) v[i] *= vsj;
        }
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          if (r0 + rr < qg) {
#pragma unroll
            for (int i = 0; i < kSlice; ++i) a[rr][i] += pj[rr] * v[i];
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        if (r0 + rr < qg) {
#pragma unroll
          for (int i = 0; i < kSlice; ++i)
            s_acc[(r0 + rr) * D + lane * kSlice + i] = a[rr][i];
        }
      }
      __syncwarp();  // s_p is rewritten by the next pass
    }
  }
  cp_async_wait<0>();
  // Row sums: the lanes' shares of row r, summed into s_l[r] (row r's
  // shares sit past every earlier row's, which are summed already).
  for (int r = 0; r < qg; ++r) {
    const float l = warp_sum(s_l[r * kTile + lane]);
    __syncwarp();
    if (lane == 0) s_l[r] = l;
  }
  finish<TQ, D>(smem, lay.slabs, lay.per_warp, lay.acc, lay.m, lay.l,
                reinterpret_cast<float*>(smem + lay.rows), qg, bh, sp.active,
                out);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Which kernel a call runs, with how many warps a CTA (0: its shared
// memory would not fit) and how much dynamic shared memory.
struct Plan {
  int m_tiles;  // 16-row query tiles of the tensor-core kernel; 0: CUDA cores
  int nw, smem;
};

Plan plan(int qg, int d, int bps, int num_splits, int q_dtype,
          int kv_dtype) {
  const int per = (bps + num_splits - 1) / num_splits;
  const int kv_bytes = kv_bytes_of(kv_dtype);
  Plan p;
  p.m_tiles = 0;
  if (q_dtype == kBF16 && kv_dtype != kF32) {
    if (qg <= kMmaTile) p.m_tiles = 1;
    else if (qg <= 2 * kMmaTile && d <= 128) p.m_tiles = 2;
  }
  int fixed, per_warp;
  if (p.m_tiles > 0) {
    const MmaLayout s = mma_layout(p.m_tiles, per, d, kv_bytes);
    fixed = s.slabs;
    per_warp = s.per_warp;
  } else {
    const SimtLayout s = simt_layout(qg, per, d, kv_bytes);
    fixed = s.slabs;
    per_warp = s.per_warp;
  }
  const int nw = (kSmemLimit - 16 - fixed) / per_warp;
  p.nw = nw < 0 ? 0 : nw > kMaxWarps ? kMaxWarps : nw;
  p.smem = fixed + p.nw * per_warp;
  return p;
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* block_tables;
  const int* n_valid;
  void* out;
  int b, kvh, qg, q_len, bs, bps, num_splits;
  float scale;
  cudaStream_t stream;
};

// Grid (splits, B * KVH); the splits of one (b, h) are one cluster.
template <typename TQ, typename TKV, typename... KArgs>
cudaError_t launch(void (*kernel)(KArgs...), const Plan& p, const Args& a) {
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.num_splits, a.b * a.kvh);
  cfg.blockDim = dim3(p.nw * 32);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.num_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(a.q),
      static_cast<const TKV*>(a.k_pool), static_cast<const TKV*>(a.v_pool),
      a.k_scale, a.v_scale, a.block_tables, a.n_valid,
      static_cast<TQ*>(a.out), a.kvh, a.qg, a.q_len, a.bs, a.bps, a.scale);
}

template <typename TKV, int D, int M>
cudaError_t launch_mma(const Plan& p, const Args& a) {
  return launch<bf16, TKV>(paged_attention_mma<TKV, D, M>, p, a);
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_simt(const Plan& p, const Args& a) {
  return launch<TQ, TKV>(paged_attention_simt<TQ, TKV, D>, p, a);
}

template <typename TKV, int D>
cudaError_t launch_mma_m(const Plan& p, const Args& a) {
  if (p.m_tiles == 1) return launch_mma<TKV, D, 1>(p, a);
  if constexpr (D <= 128) {
    if (p.m_tiles == 2) return launch_mma<TKV, D, 2>(p, a);
  }
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_d(const Plan& p, int q_dtype, int kv_dtype,
                     const Args& a) {
  if (p.m_tiles > 0) {
    if (kv_dtype == kBF16) return launch_mma_m<bf16, D>(p, a);
    return launch_mma_m<int8_t, D>(p, a);
  }
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_simt<bf16, bf16, D>(p, a);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch_simt<float, float, D>(p, a);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch_simt<bf16, int8_t, D>(p, a);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return launch_simt<float, int8_t, D>(p, a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Warps a CTA runs with for this call (0: its shared memory would not
// fit; the wrapper raises before launching).
int skyt_paged_attention_warps(int qg, int d, int bps, int num_splits,
                               int q_dtype, int kv_dtype) {
  return plan(qg, d, bps, num_splits, q_dtype, kv_dtype).nw;
}

int skyt_paged_attention(const void* q, const void* k_pool,
                         const void* v_pool, const float* k_scale,
                         const float* v_scale, const int* block_tables,
                         const int* n_valid, void* out, int b, int kvh, int qg,
                         int q_len, int d, int bs, int bps, int num_splits,
                         float scale, int q_dtype, int kv_dtype,
                         void* stream) {
  const Plan p = plan(qg, d, bps, num_splits, q_dtype, kv_dtype);
  if (p.nw == 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,     k_pool, v_pool, k_scale, v_scale,    block_tables,
               n_valid, out,  b,     kvh,     qg,         q_len,
               bs,    bps,    num_splits, scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  switch (d) {
    case 64:
      err = launch_d<64>(p, q_dtype, kv_dtype, a);
      break;
    case 128:
      err = launch_d<128>(p, q_dtype, kv_dtype, a);
      break;
    case 256:
      err = launch_d<256>(p, q_dtype, kv_dtype, a);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
