// Flash-attention block kernels for Hopper (sm_90a), bound through a plain C
// interface (ops/_cuda_build.py compiles this file with nvcc and loads it
// with ctypes; ops/attention_kernels.py holds the wrappers).
//
// K4  kfac_flash_fwd     replaces kfac_pytorch_tpu/ops/pallas_attention.py
//                        _fwd_kernel (via _pallas_fwd): the unnormalized
//                        online-softmax pieces (m, l, pv) of one attention
//                        block, the [Lq, Lk] scores never stored.
// K5a kfac_flash_bwd_dq  replaces _bwd_dq_kernel (via _pallas_bwd): dq from
//                        the cotangents (dl, dpv), scores recomputed.
// K5b kfac_flash_bwd_dkv replaces _bwd_dkv_kernel (via _pallas_bwd): dk, dv.
//
// What bounds them on an H100: at the long-context trainer's shapes (32
// heads x batch, L = 2048, head dim D = 32, causal, fp32 with TF32 off)
// each causal (query, key) pair costs 4D (K4), 6D (K5a) or 8D (K5b) fp32
// operations against a few bytes of q/k/v per row, so all three are bound
// by fp32 FMA throughput (67 TFLOP/s), not by memory. The design keeps the
// FMAs fed from registers and 16-byte shared-memory loads that most lanes
// share (broadcast), and skips tiles above the causal diagonal.
//
// Design. The TPU kernels run a serial grid whose innermost axis walks the
// other side's tiles and carries the online-softmax state (or the gradient
// accumulator) in VMEM scratch. Here one block owns one 64-row tile of its
// side (queries for K4/K5a, keys for K5b) of one (batch, head) and walks
// the other side's 64-row tiles in a loop, keeping its state in registers:
// 256 threads, four per row, each thread holding its row's q (or k and v)
// in registers and D/4 output columns. Scores, probabilities and score
// gradients of the current tile pass through shared memory so that the
// four threads of a row can share them. Nothing is summed across blocks,
// so there are no atomics and a result has the same bits on every run.
//
// Numerics follow the Pallas kernels: s = (q . k) * scale, then the
// additive causal bias (0 or -1e30), then the additive key-mask bias (0 or
// -1e30) -- biases, not replacement, so a row whose every key is masked
// keeps its exp(s - m) terms as the reference does. A tile is computed
// unless causal and its last query lies before its first key (the Pallas
// `last_q >= first_k` condition with global q_start/k_start offsets, the
// last query clipped to Lq); a row whose every tile is skipped emits
// m = -1e30, l = 0, pv = 0. The
// backward recomputes p = exp(min(s - m, 0)) and ds = p * (dl + dpv . v).
// Ragged lengths are bounds-checked: a key at or past Lk contributes
// nothing, a query at or past Lq is neither written nor contributes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;                // rows of one tile (both sides)
constexpr int kLanes = 4;                // threads that share one row
constexpr int kThreads = kTile * kLanes;
constexpr int kPer = kTile / kLanes;     // other-side rows per thread per tile
constexpr int kPS = kTile + 4;           // row stride of the [kTile, kTile] tiles
constexpr float kMaskBias = -1e30f;      // the JAX package's _NEG_INF

// Row stride of a staged [kTile, D] tile: D + 4 keeps rows 16-byte aligned
// and puts the four rows that one warp reads at once on distinct banks.
template <int D>
__host__ __device__ constexpr int row_stride() {
  return D + 4;
}

// Whether the (query tile iq, key tile j) pair is computed: the Pallas
// `last_q >= first_k` causal skip, with the tile's last query clipped to
// Lq (a block wholly in the queries' future is skipped whatever Lq is).
__device__ __forceinline__ bool tile_needed(int causal, int q_start,
                                            int k_start, int Lq, int iq,
                                            int j) {
  return !causal ||
         q_start + min((iq + 1) * kTile, Lq) - 1 >= k_start + j * kTile;
}

// Max and sum over the four lanes of one row (adjacent lanes of a warp).
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__device__ __forceinline__ float dot_row(const float (&reg)[D],
                                         const float* sm) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(sm + d);
    acc = fmaf(reg[d], x.x, acc);
    acc = fmaf(reg[d + 1], x.y, acc);
    acc = fmaf(reg[d + 2], x.z, acc);
    acc = fmaf(reg[d + 3], x.w, acc);
  }
  return acc;
}

// out[jj] += sum_r w[r] * tile[r][c*DC + jj] over the kTile rows of a
// staged tile, w read four at a time from a [kTile] row of shared memory.
template <int D>
__device__ __forceinline__ void weighted_rows(const float* w, const float* tile,
                                              int c, float (&out)[D / kLanes]) {
  constexpr int DC = D / kLanes;
  constexpr int SD = row_stride<D>();
#pragma unroll 2
  for (int r = 0; r < kTile; r += 4) {
    const float4 w4 = *reinterpret_cast<const float4*>(w + r);
    const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* src = tile + (r + u) * SD + c * DC;
#pragma unroll
      for (int jj = 0; jj < DC; jj += 4) {
        const float4 x = *reinterpret_cast<const float4*>(src + jj);
        out[jj] = fmaf(ws[u], x.x, out[jj]);
        out[jj + 1] = fmaf(ws[u], x.y, out[jj + 1]);
        out[jj + 2] = fmaf(ws[u], x.z, out[jj + 2]);
        out[jj + 3] = fmaf(ws[u], x.w, out[jj + 3]);
      }
    }
  }
}

// Copy rows [row0, row0 + kTile) of a [L, D] matrix into a staged tile,
// zero past L.
template <int D>
__device__ __forceinline__ void stage(const float* __restrict__ src, int L,
                                      int row0, float* dst) {
  constexpr int SD = row_stride<D>();
  constexpr int V = D / 4;
  for (int e = threadIdx.x; e < kTile * V; e += kThreads) {
    const int r = e / V, d4 = e % V;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < L)
      x = reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D)[d4];
    *reinterpret_cast<float4*>(dst + r * SD + 4 * d4) = x;
  }
}

template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         bool ok, float (&reg)[D]) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) x = reinterpret_cast<const float4*>(src)[d / 4];
    reg[d] = x.x;
    reg[d + 1] = x.y;
    reg[d + 2] = x.z;
    reg[d + 3] = x.w;
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* dst, int c,
                                          const float (&val)[D / kLanes],
                                          float mul) {
  constexpr int DC = D / kLanes;
#pragma unroll
  for (int jj = 0; jj < DC; jj += 4)
    *reinterpret_cast<float4*>(dst + c * DC + jj) =
        make_float4(val[jj] * mul, val[jj + 1] * mul, val[jj + 2] * mul,
                    val[jj + 3] * mul);
}

// Key-mask bias of the staged key tile: 0 or -1e30, and -inf for a key at
// or past Lk (it then contributes exp(-inf) = 0 wherever it appears).
__device__ __forceinline__ void stage_key_bias(const float* __restrict__ mask,
                                               int Lk, int k0, float* kb) {
  if (threadIdx.x < kTile) {
    const int kk = k0 + threadIdx.x;
    kb[threadIdx.x] =
        kk < Lk ? (mask[kk] > 0.5f ? 0.f : kMaskBias) : -INFINITY;
  }
}

__device__ __forceinline__ float biased(float dot, float scale, int causal,
                                        int qpos, int kpos, float kbias) {
  float s = dot * scale;
  if (causal) s += qpos >= kpos ? 0.f : kMaskBias;
  return s + kbias;
}

// ---------------------------------------------------------------------------
// K4: forward. Block (iq, bh): query tile iq, walking key tiles j in order.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ mask,
               int Lq, int Lk, int q_start, int k_start, float scale,
               int causal, float* __restrict__ m_out,
               float* __restrict__ l_out, float* __restrict__ pv_out) {
  constexpr int DC = D / kLanes;
  constexpr int SD = row_stride<D>();
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kTile][SD]
  float* vs = ks + kTile * SD;                  // [kTile][SD]
  float* ps = vs + kTile * SD;                  // [kTile][kPS]
  float* kb = ps + kTile * kPS;                 // [kTile]

  const int bh = blockIdx.y;
  // the last query tiles have the most key tiles below the diagonal:
  // start them first
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int r = threadIdx.x / kLanes, c = threadIdx.x % kLanes;
  const int row = iq * kTile + r;
  const bool row_ok = row < Lq;
  const int qpos = q_start + row;
  q += (size_t)bh * Lq * D;
  k += (size_t)bh * Lk * D;
  v += (size_t)bh * Lk * D;
  mask += (size_t)bh * Lk;

  float qr[D];
  load_row<D>(q + (size_t)row * D, row_ok, qr);
  float acc[DC];
#pragma unroll
  for (int jj = 0; jj < DC; ++jj) acc[jj] = 0.f;
  float m = kMaskBias, l = 0.f;

  const int nk = (Lk + kTile - 1) / kTile;
  for (int j = 0; j < nk && tile_needed(causal, q_start, k_start, Lq, iq, j);
       ++j) {
    __syncthreads();  // the previous tile's readers are done
    stage<D>(k, Lk, j * kTile, ks);
    stage<D>(v, Lk, j * kTile, vs);
    stage_key_bias(mask, Lk, j * kTile, kb);
    __syncthreads();

    float s[kPer];
    float mj = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int kr = i * kLanes + c;
      s[i] = biased(dot_row<D>(qr, ks + kr * SD), scale, causal, qpos,
                    k_start + j * kTile + kr, kb[kr]);
      mj = fmaxf(mj, s[i]);
    }
    const float mn = fmaxf(m, row_max(mj));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float p = expf(s[i] - mn);
      ps[r * kPS + i * kLanes + c] = p;
      sum += p;
    }
    const float corr = expf(m - mn);
    l = l * corr + row_sum(sum);
    m = mn;
    __syncwarp();  // a row's p are written and read by its own four lanes
    float pv[DC];
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) pv[jj] = 0.f;
    weighted_rows<D>(ps + r * kPS, vs, c, pv);
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[jj] = acc[jj] * corr + pv[jj];
  }
  if (row_ok) {
    const size_t o = (size_t)bh * Lq + row;
    if (c == 0) {
      m_out[o] = m;
      l_out[o] = l;
    }
    store_row<D>(pv_out + o * D, c, acc, 1.f);
  }
}

// ---------------------------------------------------------------------------
// K5a: dq. Block (iq, bh): query tile iq, walking key tiles j in order.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ mask,
              const float* __restrict__ m_in, const float* __restrict__ dl,
              const float* __restrict__ dpv, int Lq, int Lk, int q_start,
              int k_start, float scale, int causal,
              float* __restrict__ dq_out) {
  constexpr int DC = D / kLanes;
  constexpr int SD = row_stride<D>();
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kTile][SD]
  float* vs = ks + kTile * SD;                  // [kTile][SD]
  float* dss = vs + kTile * SD;                 // [kTile][kPS]
  float* kb = dss + kTile * kPS;                // [kTile]

  const int bh = blockIdx.y;
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int r = threadIdx.x / kLanes, c = threadIdx.x % kLanes;
  const int row = iq * kTile + r;
  const bool row_ok = row < Lq;
  const int qpos = q_start + row;
  const size_t o = (size_t)bh * Lq + row;
  k += (size_t)bh * Lk * D;
  v += (size_t)bh * Lk * D;
  mask += (size_t)bh * Lk;

  float qr[D], dpr[D];
  load_row<D>(q + o * D, row_ok, qr);
  load_row<D>(dpv + o * D, row_ok, dpr);
  const float mrow = row_ok ? m_in[o] : 0.f;
  const float dlrow = row_ok ? dl[o] : 0.f;
  float dq[DC];
#pragma unroll
  for (int jj = 0; jj < DC; ++jj) dq[jj] = 0.f;

  const int nk = (Lk + kTile - 1) / kTile;
  for (int j = 0; j < nk && tile_needed(causal, q_start, k_start, Lq, iq, j);
       ++j) {
    __syncthreads();
    stage<D>(k, Lk, j * kTile, ks);
    stage<D>(v, Lk, j * kTile, vs);
    stage_key_bias(mask, Lk, j * kTile, kb);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kPer; ++i) {
      const int kr = i * kLanes + c;
      const float s = biased(dot_row<D>(qr, ks + kr * SD), scale, causal,
                             qpos, k_start + j * kTile + kr, kb[kr]);
      const float p = expf(fminf(s - mrow, 0.f));
      dss[r * kPS + kr] = p * (dlrow + dot_row<D>(dpr, vs + kr * SD));
    }
    __syncwarp();
    float t[DC];
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) t[jj] = 0.f;
    weighted_rows<D>(dss + r * kPS, ks, c, t);
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) dq[jj] += t[jj] * scale;
  }
  if (row_ok) store_row<D>(dq_out + o * D, c, dq, 1.f);
}

// ---------------------------------------------------------------------------
// K5b: dk and dv. Block (j, bh): key tile j, walking query tiles iq in order.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ mask,
               const float* __restrict__ m_in, const float* __restrict__ dl,
               const float* __restrict__ dpv, int Lq, int Lk, int q_start,
               int k_start, float scale, int causal,
               float* __restrict__ dk_out, float* __restrict__ dv_out) {
  constexpr int DC = D / kLanes;
  constexpr int SD = row_stride<D>();
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kTile][SD] queries
  float* dps = qs + kTile * SD;                 // [kTile][SD] dpv rows
  float* ps = dps + kTile * SD;                 // [kTile keys][kPS]
  float* dss = ps + kTile * kPS;                // [kTile keys][kPS]
  float* mq = dss + kTile * kPS;                // [kTile] m of the queries
  float* dlq = mq + kTile;                      // [kTile] dl of the queries

  const int bh = blockIdx.y;
  // the first key tiles have the most query tiles below the diagonal and
  // run first in block order
  const int j = blockIdx.x;
  const int r = threadIdx.x / kLanes, c = threadIdx.x % kLanes;
  const int key = j * kTile + r;
  const bool key_ok = key < Lk;
  const int kpos = k_start + key;
  const size_t o = (size_t)bh * Lk + key;
  q += (size_t)bh * Lq * D;
  dpv += (size_t)bh * Lq * D;
  m_in += (size_t)bh * Lq;
  dl += (size_t)bh * Lq;

  float kr_[D], vr[D];
  load_row<D>(k + o * D, key_ok, kr_);
  load_row<D>(v + o * D, key_ok, vr);
  const float kbias = key_ok ? (mask[o] > 0.5f ? 0.f : kMaskBias) : 0.f;
  float dk[DC], dv[DC];
#pragma unroll
  for (int jj = 0; jj < DC; ++jj) dk[jj] = dv[jj] = 0.f;

  const int nq = (Lq + kTile - 1) / kTile;
  for (int iq = 0; iq < nq; ++iq) {
    if (!tile_needed(causal, q_start, k_start, Lq, iq, j)) continue;
    __syncthreads();
    stage<D>(q, Lq, iq * kTile, qs);
    stage<D>(dpv, Lq, iq * kTile, dps);
    if (threadIdx.x < kTile) {
      const int qq = iq * kTile + threadIdx.x;
      mq[threadIdx.x] = qq < Lq ? m_in[qq] : 0.f;
      dlq[threadIdx.x] = qq < Lq ? dl[qq] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kPer; ++i) {
      const int qq = i * kLanes + c;
      const int qrow = iq * kTile + qq;
      float p = 0.f, ds = 0.f;
      if (qrow < Lq) {
        const float s = biased(dot_row<D>(kr_, qs + qq * SD), scale, causal,
                               q_start + qrow, kpos, kbias);
        p = expf(fminf(s - mq[qq], 0.f));
        ds = p * (dlq[qq] + dot_row<D>(vr, dps + qq * SD));
      }
      ps[r * kPS + qq] = p;
      dss[r * kPS + qq] = ds;
    }
    __syncwarp();
    float tk[DC];
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) tk[jj] = 0.f;
    weighted_rows<D>(dss + r * kPS, qs, c, tk);
    weighted_rows<D>(ps + r * kPS, dps, c, dv);
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) dk[jj] += tk[jj] * scale;
  }
  if (key_ok) {
    store_row<D>(dk_out + o * D, c, dk, 1.f);
    store_row<D>(dv_out + o * D, c, dv, 1.f);
  }
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * kTile * row_stride<D>() + kTile * kPS + kTile);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (2 * kTile * row_stride<D>() + 2 * kTile * kPS + 2 * kTile);
}

// Opt a kernel in to more than 48 KB of dynamic shared memory, then launch.
template <typename K, typename... Args>
int launch(K kernel, dim3 grid, size_t smem, cudaStream_t st,
           Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <int D>
int fwd(const float* q, const float* k, const float* v, const float* mask,
        int BH, int Lq, int Lk, int q_start, int k_start, float scale,
        int causal, float* m, float* l, float* pv, cudaStream_t st) {
  const dim3 grid((Lq + kTile - 1) / kTile, BH);
  return launch(fwd_kernel<D>, grid, fwd_smem<D>(), st, q, k, v, mask, Lq, Lk,
                q_start, k_start, scale, causal, m, l, pv);
}

template <int D>
int bwd_dq(const float* q, const float* k, const float* v, const float* mask,
           const float* m, const float* dl, const float* dpv, int BH, int Lq,
           int Lk, int q_start, int k_start, float scale, int causal,
           float* dq, cudaStream_t st) {
  const dim3 grid((Lq + kTile - 1) / kTile, BH);
  return launch(dq_kernel<D>, grid, fwd_smem<D>(), st, q, k, v, mask, m, dl,
                dpv, Lq, Lk, q_start, k_start, scale, causal, dq);
}

template <int D>
int bwd_dkv(const float* q, const float* k, const float* v, const float* mask,
            const float* m, const float* dl, const float* dpv, int BH, int Lq,
            int Lk, int q_start, int k_start, float scale, int causal,
            float* dk, float* dv, cudaStream_t st) {
  const dim3 grid((Lk + kTile - 1) / kTile, BH);
  return launch(dkv_kernel<D>, grid, dkv_smem<D>(), st, q, k, v, mask, m, dl,
                dpv, Lq, Lk, q_start, k_start, scale, causal, dk, dv);
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

}  // extern "C"
