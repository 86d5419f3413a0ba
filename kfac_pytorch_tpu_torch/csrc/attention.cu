// Flash-attention block kernels for Hopper (sm_90a), bound through a plain C
// interface (ops/_cuda_build.py compiles this file with nvcc and loads it
// with ctypes; ops/attention_kernels.py holds the wrappers).
//
// K4  kfac_flash_fwd     replaces kfac_pytorch_tpu/ops/pallas_attention.py
//                        _fwd_kernel (via _pallas_fwd): the unnormalized
//                        online-softmax pieces (m, l, pv) of one attention
//                        block, the [Lq, Lk] scores never stored.
// K5a kfac_flash_bwd_dq  replaces _bwd_dq_kernel (via _pallas_bwd, with the
//                        shared _tile_p_ds): dq from the cotangents
//                        (dl, dpv), scores recomputed.
// K5b kfac_flash_bwd_dkv replaces _bwd_dkv_kernel (via _pallas_bwd, with
//                        _tile_p_ds): dk and dv.
//
// What bounds them on an H100: at the long-context trainer's shapes (32
// heads x batch, L = 2048, head dim D = 32, causal, fp32) each causal
// (query, key) pair costs 4D (K4), 6D (K5a) or 8D (K5b) operations against
// a few bytes of q/k/v per row, so all three are bound by arithmetic, not
// by memory.
//
// All three run on the tensor cores at fp32 accuracy, so they are bound by
// TF32 tensor-core throughput taken three times (495 TFLOP/s / 3). Every
// product is split TF32: each fp32 operand x becomes big = rna_tf32(x) and
// small = rna_tf32(x - big) (x = big + small to 2^-22 |x|), and a product
// is small*big + big*small + big*big, summed in fp32 -- one TF32 pass
// rounds each input to 2^-11 and the exp of the scores amplifies it. The
// split is made once per value: where a tile is staged, or where a scores
// accumulator becomes an operand. One warpgroup (128 threads) owns one
// 64-row tile of its side (queries for K4 and K5a, keys for K5b) of one
// (batch, head) and walks the other side's 64-row tiles in a loop:
//
//   K4   s = q k^T (wgmma m64n64k8, both operands in shared memory); the
//        online softmax in registers (the row max over the four lanes
//        that hold an accumulator row, m_new = max(m, max_j s),
//        p = exp(s - m_new), l = l exp(m - m_new) + sum_j p); then
//        pv = pv exp(m - m_new) + p v (m64nDk8, p from registers).
//   K5a  s = q k^T, dp = dpv v^T; ds = p (dl + dp) in registers;
//        dq += ds k (m64nDk8, ds from registers).
//   K5b  s^T = k q^T, dp^T = v dpv^T; dk += ds^T q, dv += p^T dpv.
//
// Two traps of TF32 wgmma and what the design does about them:
//  - Both operands of a TF32 wgmma must be K-major in shared memory (only
//    16-bit types can be transposed), and q k^T, dpv v^T, k q^T and
//    v dpv^T are K-major as the data lies, but p v, ds k, ds^T q and
//    p^T dpv need v, k, q and dpv transposed. Those tiles are written
//    transposed when they are split (K4's v only so).
//  - A thread's accumulator holds columns (2t, 2t+1) of every 8, where the
//    k8 A fragment in registers wants columns (t, t+4). Rather than send
//    p or ds through shared memory, the transposed copy orders B's rows of
//    every 8 as (0, 2, 4, 6, 1, 3, 5, 7) (perm_col): the contraction does
//    not care about its order, and the accumulator feeds the next product
//    as it lies.
// Tiles are laid out as wgmma's no-swizzle core matrices (8 rows x 16
// bytes). The other side's tiles stream through a ring of two stages filled
// by cp.async (rows at or past L read nothing and land as zeros), so tile
// j+1 loads while tile j is split and multiplied; a stage is split in place
// (big over the raw values). K4 writes v's transposed pair while q k^T
// runs; K5 commits its two score products apart, so p is taken while the
// dp product still runs. Each tile's pv (dq, dk, dv) product starts from
// zero and is added to the running sum in fp32 registers (for K4 the
// Pallas acc * c + dot): the tensor cores' own accumulation drops low bits
// at every step, and carried over the whole loop that loss would build up.
// Shared memory per block, T = 64 D floats: K4 9 T + 192 floats (72.8 KB
// at D = 32), K5a 12 T + 192 floats (96.8 KB at D = 32), K5b 14 T + 256
// floats (113 KB at D = 32, two blocks an SM; 225 KB at D = 64, one).
//
// The TPU kernels run a serial grid whose innermost axis walks the other
// side's tiles and carries the online-softmax state (or the gradient
// accumulator) in VMEM scratch; here that axis is the loop inside the
// block. Nothing is summed across blocks, so there are no atomics and a
// result has the same bits on every run.
//
// Numerics follow the Pallas kernels: s = (q . k) * scale, then the
// additive causal bias (0 or -1e30), then the additive key-mask bias (0 or
// -1e30) -- biases, not replacement, so a row whose every key is masked
// keeps its exp(s - m) terms as the reference does. A tile is computed
// unless causal and its last query lies before its first key (the Pallas
// `last_q >= first_k` condition with global q_start/k_start offsets, the
// last query clipped to Lq), decided at 64-row tiles on both sides; a row
// whose every tile is skipped emits m = -1e30, l = 0, pv = 0 (K4) and
// zero gradients. K4 starts m at -1e30 and takes p = exp(s - m_new), as
// the Pallas forward does; the backward recomputes p = exp(min(s - m, 0))
// and ds = p * (dl + dpv . v). Ragged lengths are bounds-checked: a key at
// or past Lk contributes nothing (its bias is -inf), a query at or past
// Lq is neither written nor contributes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;            // rows of one tile (both sides)
constexpr int kWgThreads = 128;      // one warpgroup: four warps of 16 rows
constexpr float kMaskBias = -1e30f;  // the JAX package's _NEG_INF

// Whether the (query tile iq, key tile j) pair is computed: the Pallas
// `last_q >= first_k` causal skip, with the tile's last query clipped to
// Lq (a block wholly in the queries' future is skipped whatever Lq is).
__device__ __forceinline__ bool tile_needed(int causal, int q_start,
                                            int k_start, int Lq, int iq,
                                            int j) {
  return !causal ||
         q_start + min((iq + 1) * kTile, Lq) - 1 >= k_start + j * kTile;
}

// Max and sum over the four lanes that hold one accumulator row (lanes
// 4g..4g+3 of a warp).
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// The tensor-core building blocks of K4, K5a and K5b: one warpgroup (128
// threads) per block; see the note at the top of the file.
// ---------------------------------------------------------------------------


// wgmma m64nNk8 (N = 16, 32, 64: d holds N/2 values a thread), TF32
// inputs, A from registers (the k8 fragment a), B from shared memory
// (descriptor db); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Thread e of a [kTile, D] plane's pass: row and first column, with eight
// consecutive threads on the eight rows of one core matrix (its 128 bytes
// written without bank conflicts).
template <int D>
__device__ __forceinline__ void core_pos(int e, int& r, int& c) {
  constexpr int V = D / 4;
  r = (e / (8 * V)) * 8 + (e & 7);
  c = 4 * ((e >> 3) % V);
}

// Rows [row0, row0 + kTile) of a [L, D] matrix (zero past L) as a split
// pair of planes, with plain loads: a block's own rows, staged once.
template <int D>
__device__ __forceinline__ void load_split(const float* __restrict__ src,
                                           int L, int row0, float* big,
                                           float* small) {
  for (int e = threadIdx.x; e < kTile * D / 4; e += kWgThreads) {
    int r, c;
    core_pos<D>(e, r, c);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < L)
      x = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c);
    store_split<D, false>(x, r, c, big, small, nullptr, nullptr);
  }
}

// Start the asynchronous copy of rows [row0, row0 + kTile) of a [L, D]
// matrix into a plane laid out by core_off<D>; rows at or past L read
// nothing and land as zeros.
template <int D>
__device__ __forceinline__ void copy_rows_async(const float* __restrict__ src,
                                                int L, int row0, float* dst) {
  for (int e = threadIdx.x; e < kTile * D / 4; e += kWgThreads) {
    int r, c;
    core_pos<D>(e, r, c);
    const bool ok = row0 + r < L;
    cp_async16(dst + core_off<D>(r, c),
               src + (size_t)(ok ? row0 + r : 0) * D + c, ok);
  }
}

// The same for entries [row0, row0 + kTile) of a [L] vector.
__device__ __forceinline__ void copy_vec_async(const float* __restrict__ src,
                                               int L, int row0, float* dst) {
  if (threadIdx.x < kTile) {
    const int i = row0 + threadIdx.x;
    cp_async4(dst + threadIdx.x, src + (i < L ? i : 0), i < L);
  }
}

// Split a landed plane in place (big over the raw values, small beside
// it; not with !kPlain, which leaves the raw values) and, with kTrans,
// write its transposed pair.
template <int D, bool kTrans, bool kPlain = true>
__device__ __forceinline__ void split_staged(float* big, float* small,
                                             float* tbig, float* tsmall) {
  for (int e = threadIdx.x; e < kTile * D / 4; e += kWgThreads) {
    int r, c;
    core_pos<D>(e, r, c);
    const float4 x = *reinterpret_cast<const float4*>(big + core_off<D>(r, c));
    store_split<D, kTrans, kPlain>(x, r, c, big, small, tbig, tsmall);
  }
}

// acc = A B^T, [64, 64] over a contraction of D, from two split plane
// pairs laid out by core_off<D> (their slice-0 descriptors): small(A)
// big(B) + big(A) small(B) + big(A) big(B) for each k8 slice. Overwrites
// acc.
template <int D>
__device__ __forceinline__ void scores_3x(float (&acc)[32], uint64_t ab,
                                          uint64_t as, uint64_t bb,
                                          uint64_t bs) {
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    wgmma_ss(acc, slice(as, ks), slice(bb, ks), ks > 0);
    wgmma_ss(acc, slice(ab, ks), slice(bs, ks), 1);
    wgmma_ss(acc, slice(ab, ks), slice(bb, ks), 1);
  }
}

// The A fragments of W [64, kTile], an accumulator in registers, split:
// k8 slice kk takes accumulator entries 4kk..4kk+3, (row g, columns 2t and
// 2t+1) and (row g+8, the same), as its (t, t+4) columns (perm_col).
__device__ __forceinline__ void split_frags(const float (&w)[32],
                                            uint32_t (&big)[32],
                                            uint32_t (&small)[32]) {
  constexpr int src[4] = {0, 2, 1, 3};
#pragma unroll
  for (int kk = 0; kk < kTile / 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_tf32(w[4 * kk + src[i]], big[4 * kk + i], small[4 * kk + i]);
  }
}

// acc = W B, [64, D] over a contraction of kTile, W's fragments from
// split_frags, B a transposed pair [D, kTile] laid out by core_off<kTile>
// with perm_col columns (slice-0 descriptors). Overwrites acc: the caller
// adds each tile's product into its running sum in fp32, as the tensor
// cores' own accumulation, carried over every tile, would lose low bits
// on each of its steps. Starts the wgmmas; the caller commits and waits.
template <int D>
__device__ __forceinline__ void weighted_3x(float (&acc)[D / 2],
                                            const uint32_t (&big)[32],
                                            const uint32_t (&small)[32],
                                            uint64_t bb, uint64_t bs) {
#pragma unroll
  for (int kk = 0; kk < kTile / 8; ++kk) {
    const uint32_t ab[4] = {big[4 * kk], big[4 * kk + 1], big[4 * kk + 2],
                            big[4 * kk + 3]};
    const uint32_t as[4] = {small[4 * kk], small[4 * kk + 1],
                            small[4 * kk + 2], small[4 * kk + 3]};
    wgmma_rs(acc, as, slice(bb, kk), kk > 0);
    wgmma_rs(acc, ab, slice(bs, kk), 1);
    wgmma_rs(acc, ab, slice(bb, kk), 1);
  }
}


// Row of accumulator entry i (0..3 of each 8 columns) of this thread,
// relative to the warpgroup's 64 rows, and its column.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1);
}

// Store rows [row0, row0 + 64) of acc * mul (an m64nD accumulator) into a
// [L, D] matrix, rows at or past L dropped.
template <int D>
__device__ __forceinline__ void store_acc(float* dst, int L, int row0,
                                          const float (&acc)[D / 2],
                                          float mul) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = row0 + acc_row(i);
    if (row < L)
      *reinterpret_cast<float2*>(dst + (size_t)row * D + acc_col(i)) =
          make_float2(acc[i] * mul, acc[i + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// K4: forward. Block (iq, bh): query tile iq, walking the key tiles j that
// the causal skip keeps, in order. Shared memory (floats, T = kTile * D):
// the query tile's split pair (2T); a ring of two stages, each the raw k
// and v tiles (k split in place into its big plane) and the raw key mask
// (2 x (2T + kTile)); k's small plane and v's transposed pair (3T); the
// key bias.
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (9 * kTile * D + 3 * kTile);
}

// The online softmax of one tile pair [64 queries, 64 keys], p in place
// over the scores: s * scale + causal bias (kDiag: the pair straddles the
// causal diagonal; elsewhere that bias is 0 and is not added) + key bias
// (kb, in shared memory, read in pairs); m_new = max(m, the row's max),
// p = exp(s - m_new), corr = exp(m - m_new), l = l corr + the row's sum of
// p. m, l, corr and qpos are of the thread's rows g and g+8 of its warp's
// 16; a row's 64 columns lie on the four lanes 4g..4g+3.
template <bool kDiag>
__device__ __forceinline__ void online_softmax(float (&s)[32], float scale,
                                               const int (&qpos)[2],
                                               int kpos0, const float* kb,
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2]) {
  const int t = threadIdx.x % 4;
  float mj[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n) {
    const int c0 = 8 * n + 2 * t;
    const float2 b = *reinterpret_cast<const float2*>(kb + c0);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = 4 * n + u, h = u >> 1;
      float x = s[i] * scale;
      if (kDiag) x += qpos[h] >= kpos0 + c0 + (u & 1) ? 0.f : kMaskBias;
      x += (u & 1) ? b.y : b.x;
      s[i] = x;
      mj[h] = fmaxf(mj[h], x);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(m[h], row_max(mj[h]));
    corr[h] = expf(m[h] - mn);
    m[h] = mn;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = expf(s[i] - m[h]);
    sum[h] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + row_sum(sum[h]);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ mask,
               int Lq, int Lk, int q_start, int k_start, float scale,
               int causal, float* __restrict__ m_out,
               float* __restrict__ l_out, float* __restrict__ pv_out) {
  constexpr int T = kTile * D;
  constexpr int kStage = 2 * T + kTile;
  extern __shared__ float4 smem4[];
  float* qb = reinterpret_cast<float*>(smem4);
  float* qs = qb + T;
  float* ring = qs + T;  // [2][k big | v | mask]
  float* ksm = ring + 2 * kStage;
  float* vtb = ksm + T;  // v transposed: [D][kTile], perm_col columns
  float* vts = vtb + T;
  float* kb = vts + T;  // [kTile] key bias of the current tile

  const int bh = blockIdx.y;
  // the last query tiles have the most key tiles below the diagonal:
  // start them first
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int q0 = iq * kTile;
  q += (size_t)bh * Lq * D;
  k += (size_t)bh * Lk * D;
  v += (size_t)bh * Lk * D;
  mask += (size_t)bh * Lk;

  const int nk = (Lk + kTile - 1) / kTile;
  int nj = 0;
  while (nj < nk && tile_needed(causal, q_start, k_start, Lq, iq, nj)) ++nj;

  // the first key tile's copies fly while the block stages its queries
  if (nj > 0) {
    copy_rows_async<D>(k, Lk, 0, ring);
    copy_rows_async<D>(v, Lk, 0, ring + T);
    copy_vec_async(mask, Lk, 0, ring + 2 * T);
  }
  cp_async_commit();
  load_split<D>(q, Lq, q0, qb, qs);
  const uint64_t dqb = plane_desc(qb, D), dqs = plane_desc(qs, D);
  const uint64_t dks = plane_desc(ksm, D);
  const uint64_t dvtb = plane_desc(vtb, kTile), dvts = plane_desc(vts, kTile);

  int qpos[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qpos[h] = q_start + q0 + acc_row(2 * h);
    m[h] = kMaskBias;
    l[h] = 0.f;
  }
  float pv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) pv[i] = 0.f;

  for (int j = 0; j < nj; ++j) {
    float* stage = ring + (j & 1) * kStage;
    cp_async_wait_all();
    __syncthreads();  // tile j has landed; tile j-1's readers are done
    if (j + 1 < nj) {
      float* next = ring + ((j + 1) & 1) * kStage;
      copy_rows_async<D>(k, Lk, (j + 1) * kTile, next);
      copy_rows_async<D>(v, Lk, (j + 1) * kTile, next + T);
      copy_vec_async(mask, Lk, (j + 1) * kTile, next + 2 * T);
    }
    cp_async_commit();
    split_staged<D, false>(stage, ksm, nullptr, nullptr);
    if (threadIdx.x < kTile) {
      const int kk = j * kTile + threadIdx.x;
      kb[threadIdx.x] = kk < Lk ? (stage[2 * T + threadIdx.x] > 0.5f
                                       ? 0.f : kMaskBias)
                                : -INFINITY;
    }
    fence_async_proxy();
    __syncthreads();

    // s = q k^T, [64 queries, 64 keys]; v's transposed pair is written
    // while it runs
    float s[32];
    wg_fence();
    scores_3x<D>(s, dqb, dqs, plane_desc(stage, D), dks);
    wg_commit();
    split_staged<D, true, false>(stage + T, nullptr, vtb, vts);
    fence_async_proxy();
    __syncthreads();
    wg_wait<0>();
    reg_fence(s);
    float corr[2];
    const int kpos0 = k_start + j * kTile;
    if (causal && kpos0 + kTile - 1 > q_start + q0)
      online_softmax<true>(s, scale, qpos, kpos0, kb, m, l, corr);
    else
      online_softmax<false>(s, scale, qpos, kpos0, kb, m, l, corr);

    // pv = pv corr + p v, the tile's product from a fresh accumulator
    uint32_t fb[32], fs[32];
    float part[D / 2];
    split_frags(s, fb, fs);
    wg_fence();
    weighted_3x<D>(part, fb, fs, dvtb, dvts);
    wg_commit();
    wg_wait<0>();
    reg_fence(part);
    reg_fence(fb);
    reg_fence(fs);
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      pv[i] = pv[i] * corr[(i >> 1) & 1] + part[i];
  }
  if (threadIdx.x % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + acc_row(2 * h);
      if (row < Lq) {
        m_out[(size_t)bh * Lq + row] = m[h];
        l_out[(size_t)bh * Lq + row] = l[h];
      }
    }
  }
  store_acc<D>(pv_out + (size_t)bh * Lq * D, Lq, q0, pv, 1.f);
}

// ---------------------------------------------------------------------------
// K5a and K5b: the backward.
// ---------------------------------------------------------------------------

// The probabilities of one tile pair, [64 rows of the block's side, 64 of
// the other], in place over the scores: p = exp(min(s * scale + causal
// bias + key bias - m, 0)). K5a (kRowsAreQueries): row_v holds m of the
// thread's rows (g and g+8 of its warp's 16), col_v the key bias of the
// tile's columns (in shared memory, read in pairs). K5b: row_v holds the
// key bias, col_v m, and columns at or past col_limit (queries past Lq)
// give 0. kDiag: the tile pair straddles the causal diagonal (elsewhere
// the causal bias is 0 and is not added).
template <bool kDiag, bool kRowsAreQueries>
__device__ __forceinline__ void probs(float (&s)[32], float scale,
                                      const int (&row_pos)[2], int col_pos0,
                                      const float (&row_v)[2],
                                      const float* col_v, int col_limit) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n) {
    const int c0 = 8 * n + 2 * t;
    const float2 cv = *reinterpret_cast<const float2*>(col_v + c0);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = 4 * n + u, h = u >> 1, col = c0 + (u & 1);
      const float c = (u & 1) ? cv.y : cv.x;
      float x = s[i] * scale;
      if (kRowsAreQueries) {
        if (kDiag) x += row_pos[h] >= col_pos0 + col ? 0.f : kMaskBias;
        s[i] = expf(fminf(x + c - row_v[h], 0.f));
      } else {
        if (kDiag) x += col_pos0 + col >= row_pos[h] ? 0.f : kMaskBias;
        s[i] = col < col_limit ? expf(fminf(x + row_v[h] - c, 0.f)) : 0.f;
      }
    }
  }
}

// ds = p (dl + dp) in place over dp: dl per row (K5a) or per column (K5b).
template <bool kRowsAreQueries>
__device__ __forceinline__ void score_grads(const float (&p)[32],
                                            float (&dp)[32],
                                            const float (&row_dl)[2],
                                            const float* col_dl) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n) {
    float2 cd = make_float2(0.f, 0.f);
    if (!kRowsAreQueries)
      cd = *reinterpret_cast<const float2*>(col_dl + 8 * n + 2 * t);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = 4 * n + u;
      const float d = kRowsAreQueries ? row_dl[u >> 1] : (u & 1) ? cd.y : cd.x;
      dp[i] = p[i] * (d + dp[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// K5a: dq. Block (iq, bh): query tile iq, walking key tiles j in order.
// Shared memory (floats, T = kTile * D): the query tile's q and dpv split
// pairs (4T); a ring of two stages, each the raw k and v tiles (split in
// place into their big planes) and the raw key mask (2 x (2T + kTile));
// the small planes of k and v and k's transposed pair (4T); the key bias.
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (12 * kTile * D + 3 * kTile);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ mask,
              const float* __restrict__ m_in, const float* __restrict__ dl,
              const float* __restrict__ dpv, int Lq, int Lk, int q_start,
              int k_start, float scale, int causal,
              float* __restrict__ dq_out) {
  constexpr int T = kTile * D;
  constexpr int kStage = 2 * T + kTile;
  extern __shared__ float4 smem4[];
  float* qb = reinterpret_cast<float*>(smem4);
  float* qs = qb + T;
  float* pb = qs + T;
  float* ps = pb + T;
  float* ring = ps + T;  // [2][k big | v big | mask]
  float* ksm = ring + 2 * kStage;
  float* vsm = ksm + T;
  float* ktb = vsm + T;  // k transposed: [D][kTile], perm_col columns
  float* kts = ktb + T;
  float* kb = kts + T;  // [kTile] key bias of the current tile

  const int bh = blockIdx.y;
  // the last query tiles have the most key tiles below the diagonal:
  // start them first
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int q0 = iq * kTile;
  q += (size_t)bh * Lq * D;
  dpv += (size_t)bh * Lq * D;
  m_in += (size_t)bh * Lq;
  dl += (size_t)bh * Lq;
  dq_out += (size_t)bh * Lq * D;
  k += (size_t)bh * Lk * D;
  v += (size_t)bh * Lk * D;
  mask += (size_t)bh * Lk;

  const int nk = (Lk + kTile - 1) / kTile;
  int nj = 0;
  while (nj < nk && tile_needed(causal, q_start, k_start, Lq, iq, nj)) ++nj;

  // the first key tile's copies fly while the block stages its own rows
  if (nj > 0) {
    copy_rows_async<D>(k, Lk, 0, ring);
    copy_rows_async<D>(v, Lk, 0, ring + T);
    copy_vec_async(mask, Lk, 0, ring + 2 * T);
  }
  cp_async_commit();
  load_split<D>(q, Lq, q0, qb, qs);
  load_split<D>(dpv, Lq, q0, pb, ps);
  const uint64_t dqb = plane_desc(qb, D), dqs = plane_desc(qs, D);
  const uint64_t dpb = plane_desc(pb, D), dps = plane_desc(ps, D);
  const uint64_t dks = plane_desc(ksm, D), dvs = plane_desc(vsm, D);
  const uint64_t dktb = plane_desc(ktb, kTile), dkts = plane_desc(kts, kTile);

  float mrow[2], dlrow[2];
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + acc_row(2 * h);
    mrow[h] = row < Lq ? m_in[row] : 0.f;
    dlrow[h] = row < Lq ? dl[row] : 0.f;
    qpos[h] = q_start + row;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  for (int j = 0; j < nj; ++j) {
    float* stage = ring + (j & 1) * kStage;
    cp_async_wait_all();
    __syncthreads();  // tile j has landed; tile j-1's readers are done
    if (j + 1 < nj) {
      float* next = ring + ((j + 1) & 1) * kStage;
      copy_rows_async<D>(k, Lk, (j + 1) * kTile, next);
      copy_rows_async<D>(v, Lk, (j + 1) * kTile, next + T);
      copy_vec_async(mask, Lk, (j + 1) * kTile, next + 2 * T);
    }
    cp_async_commit();
    split_staged<D, true>(stage, ksm, ktb, kts);
    split_staged<D, false>(stage + T, vsm, nullptr, nullptr);
    if (threadIdx.x < kTile) {
      const int kk = j * kTile + threadIdx.x;
      kb[threadIdx.x] = kk < Lk ? (stage[2 * T + threadIdx.x] > 0.5f
                                       ? 0.f : kMaskBias)
                                : -INFINITY;
    }
    fence_async_proxy();
    __syncthreads();

    // s = q k^T and dp = dpv v^T, [64 queries, 64 keys]
    const uint64_t dkb = plane_desc(stage, D), dvb = plane_desc(stage + T, D);
    float s[32], dp[32];
    wg_fence();
    scores_3x<D>(s, dqb, dqs, dkb, dks);
    wg_commit();
    scores_3x<D>(dp, dpb, dps, dvb, dvs);
    wg_commit();
    wg_wait<1>();  // s is in; p is taken while dp is computed
    reg_fence(s);
    const int kpos0 = k_start + j * kTile;
    if (causal && kpos0 + kTile - 1 > q_start + q0)
      probs<true, true>(s, scale, qpos, kpos0, mrow, kb, kTile);
    else
      probs<false, true>(s, scale, qpos, kpos0, mrow, kb, kTile);
    wg_wait<0>();
    reg_fence(dp);
    score_grads<true>(s, dp, dlrow, nullptr);

    // dq += ds k
    uint32_t fb[32], fs[32];
    float part[D / 2];
    split_frags(dp, fb, fs);
    wg_fence();
    weighted_3x<D>(part, fb, fs, dktb, dkts);
    wg_commit();
    wg_wait<0>();
    reg_fence(part);
    reg_fence(fb);
    reg_fence(fs);
    add_to(dq, part);
  }
  store_acc<D>(dq_out, Lq, q0, dq, scale);
}

// ---------------------------------------------------------------------------
// K5b: dk and dv. Block (j, bh): key tile j, walking the query tiles iq
// that the causal skip keeps, in order. Shared memory (floats): the key
// tile's k and v split pairs (4T); a ring of two stages, each the raw q and
// dpv tiles (split in place) and the queries' m and dl (2 x (2T + 2 kTile));
// the small planes of q and dpv and their transposed pairs (6T).
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (14 * kTile * D + 4 * kTile);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ mask,
               const float* __restrict__ m_in, const float* __restrict__ dl,
               const float* __restrict__ dpv, int Lq, int Lk, int q_start,
               int k_start, float scale, int causal,
               float* __restrict__ dk_out, float* __restrict__ dv_out) {
  constexpr int T = kTile * D;
  constexpr int kStage = 2 * T + 2 * kTile;
  extern __shared__ float4 smem4[];
  float* kbg = reinterpret_cast<float*>(smem4);
  float* ksm = kbg + T;
  float* vbg = ksm + T;
  float* vsm = vbg + T;
  float* ring = vsm + T;  // [2][q big | dpv big | m | dl]
  float* qsm = ring + 2 * kStage;
  float* psm = qsm + T;
  float* qtb = psm + T;  // q transposed: [D][kTile], perm_col columns
  float* qts = qtb + T;
  float* ptb = qts + T;  // dpv transposed
  float* pts = ptb + T;

  const int bh = blockIdx.y;
  // the first key tiles have the most query tiles below the diagonal and
  // run first in block order
  const int j = blockIdx.x;
  const int k0 = j * kTile;
  q += (size_t)bh * Lq * D;
  dpv += (size_t)bh * Lq * D;
  m_in += (size_t)bh * Lq;
  dl += (size_t)bh * Lq;
  k += (size_t)bh * Lk * D;
  v += (size_t)bh * Lk * D;
  mask += (size_t)bh * Lk;
  dk_out += (size_t)bh * Lk * D;
  dv_out += (size_t)bh * Lk * D;

  // tile_needed grows with iq: the kept query tiles are [iq0, nq)
  const int nq = (Lq + kTile - 1) / kTile;
  int iq0 = 0;
  while (iq0 < nq && !tile_needed(causal, q_start, k_start, Lq, iq0, j))
    ++iq0;

  if (iq0 < nq) {
    copy_rows_async<D>(q, Lq, iq0 * kTile, ring);
    copy_rows_async<D>(dpv, Lq, iq0 * kTile, ring + T);
    copy_vec_async(m_in, Lq, iq0 * kTile, ring + 2 * T);
    copy_vec_async(dl, Lq, iq0 * kTile, ring + 2 * T + kTile);
  }
  cp_async_commit();
  load_split<D>(k, Lk, k0, kbg, ksm);
  load_split<D>(v, Lk, k0, vbg, vsm);
  const uint64_t dkb = plane_desc(kbg, D), dks = plane_desc(ksm, D);
  const uint64_t dvb = plane_desc(vbg, D), dvs = plane_desc(vsm, D);
  const uint64_t dqs = plane_desc(qsm, D), dps = plane_desc(psm, D);
  const uint64_t dqtb = plane_desc(qtb, kTile), dqts = plane_desc(qts, kTile);
  const uint64_t dptb = plane_desc(ptb, kTile), dpts = plane_desc(pts, kTile);

  float kbias[2];
  int kpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + acc_row(2 * h);
    kbias[h] = key < Lk ? (mask[key] > 0.5f ? 0.f : kMaskBias) : 0.f;
    kpos[h] = k_start + key;
  }
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int iq = iq0; iq < nq; ++iq) {
    float* stage = ring + ((iq - iq0) & 1) * kStage;
    cp_async_wait_all();
    __syncthreads();  // tile iq has landed; tile iq-1's readers are done
    if (iq + 1 < nq) {
      float* next = ring + ((iq + 1 - iq0) & 1) * kStage;
      copy_rows_async<D>(q, Lq, (iq + 1) * kTile, next);
      copy_rows_async<D>(dpv, Lq, (iq + 1) * kTile, next + T);
      copy_vec_async(m_in, Lq, (iq + 1) * kTile, next + 2 * T);
      copy_vec_async(dl, Lq, (iq + 1) * kTile, next + 2 * T + kTile);
    }
    cp_async_commit();
    split_staged<D, true>(stage, qsm, qtb, qts);
    split_staged<D, true>(stage + T, psm, ptb, pts);
    fence_async_proxy();
    __syncthreads();

    // s^T = k q^T and dp^T = v dpv^T, [64 keys, 64 queries]
    float s[32], dp[32];
    wg_fence();
    scores_3x<D>(s, dkb, dks, plane_desc(stage, D), dqs);
    wg_commit();
    scores_3x<D>(dp, dvb, dvs, plane_desc(stage + T, D), dps);
    wg_commit();
    wg_wait<1>();  // s^T is in; p is taken while dp^T is computed
    reg_fence(s);
    const int qpos0 = q_start + iq * kTile;
    const float* mq = stage + 2 * T;
    if (causal && k_start + k0 + kTile - 1 > qpos0)
      probs<true, false>(s, scale, kpos, qpos0, kbias, mq, Lq - iq * kTile);
    else
      probs<false, false>(s, scale, kpos, qpos0, kbias, mq, Lq - iq * kTile);
    wg_wait<0>();
    reg_fence(dp);
    score_grads<false>(s, dp, kbias, mq + kTile);

    // dk += ds^T q, then dv += p^T dpv
    uint32_t fb[32], fs[32];
    float part[D / 2];
    split_frags(dp, fb, fs);
    wg_fence();
    weighted_3x<D>(part, fb, fs, dqtb, dqts);
    wg_commit();
    wg_wait<0>();
    reg_fence(part);
    reg_fence(fb);
    reg_fence(fs);
    add_to(dk, part);
    split_frags(s, fb, fs);
    wg_fence();
    weighted_3x<D>(part, fb, fs, dptb, dpts);
    wg_commit();
    wg_wait<0>();
    reg_fence(part);
    reg_fence(fb);
    reg_fence(fs);
    add_to(dv, part);
  }
  store_acc<D>(dk_out, Lk, k0, dk, scale);
  store_acc<D>(dv_out, Lk, k0, dv, 1.f);
}

template <int D>
int fwd(const float* q, const float* k, const float* v, const float* mask,
        int BH, int Lq, int Lk, int q_start, int k_start, float scale,
        int causal, float* m, float* l, float* pv, cudaStream_t st) {
  const dim3 grid((Lq + kTile - 1) / kTile, BH);
  return launch<kWgThreads>(fwd_kernel<D>, grid, fwd_smem<D>(), st, q, k, v,
                            mask, Lq, Lk, q_start, k_start, scale, causal, m,
                            l, pv);
}

template <int D>
int bwd_dq(const float* q, const float* k, const float* v, const float* mask,
           const float* m, const float* dl, const float* dpv, int BH, int Lq,
           int Lk, int q_start, int k_start, float scale, int causal,
           float* dq, cudaStream_t st) {
  const dim3 grid((Lq + kTile - 1) / kTile, BH);
  return launch<kWgThreads>(dq_kernel<D>, grid, dq_smem<D>(), st, q, k, v,
                            mask, m, dl, dpv, Lq, Lk, q_start, k_start, scale,
                            causal, dq);
}

template <int D>
int bwd_dkv(const float* q, const float* k, const float* v, const float* mask,
            const float* m, const float* dl, const float* dpv, int BH, int Lq,
            int Lk, int q_start, int k_start, float scale, int causal,
            float* dk, float* dv, cudaStream_t st) {
  const dim3 grid((Lk + kTile - 1) / kTile, BH);
  return launch<kWgThreads>(dkv_kernel<D>, grid, dkv_smem<D>(), st, q, k, v,
                            mask, m, dl, dpv, Lq, Lk, q_start, k_start, scale,
                            causal, dk, dv);
}

// Dynamic shared memory of one block and resident blocks per SM.
template <typename K>
int occupancy(K kernel, size_t smem, int* smem_bytes, int* blocks) {
  cudaError_t e = opt_in(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                      kWgThreads, smem);
  *smem_bytes = (int)smem;
  return (int)e;
}

template <int D>
int kernel_occupancy(int which, int* smem_bytes, int* blocks) {
  switch (which) {
    case 0: return occupancy(fwd_kernel<D>, fwd_smem<D>(), smem_bytes, blocks);
    case 1: return occupancy(dq_kernel<D>, dq_smem<D>(), smem_bytes, blocks);
    case 2: return occupancy(dkv_kernel<D>, dkv_smem<D>(), smem_bytes, blocks);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q: [BH, Lq, D], k/v: [BH, Lk, D], mask: [BH, Lk] fp32, all contiguous;
// D is 16, 32 or 64. m/l: [BH, Lq], pv: [BH, Lq, D]. Returns a cudaError_t
// code (cudaErrorInvalidValue for an unsupported D).
int kfac_flash_fwd(const float* q, const float* k, const float* v,
                   const float* mask, int BH, int Lq, int Lk, int D,
                   int q_start, int k_start, float scale, int causal,
                   float* m, float* l, float* pv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return fwd<16>(q, k, v, mask, BH, Lq, Lk, q_start, k_start,
                            scale, causal, m, l, pv, st);
    case 32: return fwd<32>(q, k, v, mask, BH, Lq, Lk, q_start, k_start,
                            scale, causal, m, l, pv, st);
    case 64: return fwd<64>(q, k, v, mask, BH, Lq, Lk, q_start, k_start,
                            scale, causal, m, l, pv, st);
  }
  return (int)cudaErrorInvalidValue;
}

// m: the forward's [BH, Lq]; dl: [BH, Lq]; dpv: [BH, Lq, D]; dq: [BH, Lq, D].
int kfac_flash_bwd_dq(const float* q, const float* k, const float* v,
                      const float* mask, const float* m, const float* dl,
                      const float* dpv, int BH, int Lq, int Lk, int D,
                      int q_start, int k_start, float scale, int causal,
                      float* dq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return bwd_dq<16>(q, k, v, mask, m, dl, dpv, BH, Lq, Lk, q_start,
                               k_start, scale, causal, dq, st);
    case 32: return bwd_dq<32>(q, k, v, mask, m, dl, dpv, BH, Lq, Lk, q_start,
                               k_start, scale, causal, dq, st);
    case 64: return bwd_dq<64>(q, k, v, mask, m, dl, dpv, BH, Lq, Lk, q_start,
                               k_start, scale, causal, dq, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dk/dv: [BH, Lk, D].
int kfac_flash_bwd_dkv(const float* q, const float* k, const float* v,
                       const float* mask, const float* m, const float* dl,
                       const float* dpv, int BH, int Lq, int Lk, int D,
                       int q_start, int k_start, float scale, int causal,
                       float* dk, float* dv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return bwd_dkv<16>(q, k, v, mask, m, dl, dpv, BH, Lq, Lk,
                                q_start, k_start, scale, causal, dk, dv, st);
    case 32: return bwd_dkv<32>(q, k, v, mask, m, dl, dpv, BH, Lq, Lk,
                                q_start, k_start, scale, causal, dk, dv, st);
    case 64: return bwd_dkv<64>(q, k, v, mask, m, dl, dpv, BH, Lq, Lk,
                                q_start, k_start, scale, causal, dk, dv, st);
  }
  return (int)cudaErrorInvalidValue;
}


// K4 (which = 0), K5a (1) or K5b (2) at head dim D: the dynamic shared
// memory of one block in bytes and the blocks resident on one SM.
int kfac_flash_occupancy(int which, int D, int* smem_bytes, int* blocks) {
  switch (D) {
    case 16: return kernel_occupancy<16>(which, smem_bytes, blocks);
    case 32: return kernel_occupancy<32>(which, smem_bytes, blocks);
    case 64: return kernel_occupancy<64>(which, smem_bytes, blocks);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
