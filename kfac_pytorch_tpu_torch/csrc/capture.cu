// K-FAC capture kernels for Hopper (sm_90a), bound through a plain C
// interface (ops/_cuda_build.py compiles this file with nvcc and loads it
// with ctypes; ops/capture_kernels.py holds the wrappers).
//
// K1  kfac_conv_a   replaces kfac_pytorch_tpu/ops/pallas_capture.py
//                   _conv_a_kernel (via compute_a_conv): factor A of a conv
//                   layer, the im2col patch rows built on the fly from the
//                   NHWC activation, `rows^T (rows / N)` in fp32.
// K2  kfac_stat_rows replaces pallas_capture.py _stat_kernel (via
//                   _stat_rows): `t^T (t / denom)` over a row matrix with the
//                   row prep (x N, x spatial, ones column) applied at load.
//
// What bounds them on an H100: K1 at the ResNet-32 shapes is fp32 FMA work
// (2 * rows * F^2 operations, F up to 577, rows up to 131072: about 5.4
// GFLOP for most convs, TF32 off for parity), so the design is a tiled
// register-blocked GEMM whose A and B operands are generated from the
// activation instead of read from a materialized patch matrix: the patch
// matrix never exists in device memory. K2 at its shapes (d <= 65) reads
// far more bytes than it computes and is bound by bytes and launches.
//
// Design. The TPU kernels run a serial grid that carries one [F, F]
// accumulator in VMEM. Here the blocks run in parallel: a 2-D grid over
// output tiles of [F, F] times a split of the rows. Each block stages
// kBK rows of both operands in shared memory, accumulates TM x TM outputs
// per thread in registers (tiles of 16*TM, TM 1, 2 or 4 by F) and writes
// its split's partial [F, F]. A second small kernel sums the partials in
// a fixed order (no atomics, so a result never changes from run to run)
// and applies the EMA epilogue `cur * (1 - alpha) + stat * alpha` without
// FMA contraction, which is the rounding sequence of the plain PyTorch
// version.
//
// Numerics follow ops/factors.py op for op: every elementwise scaling is
// rounded to the input dtype (fp32 or bf16) in the reference's order
// (x / spatial, then / N for conv A; x N, then x spatial, then the ones
// column, then / denom for K2); products accumulate in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;  // rows staged per shared-memory round

template <typename T>
__device__ __forceinline__ float load_f(const T* p);
template <>
__device__ __forceinline__ float load_f<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Round an fp32 result to the input dtype, as the reference rounds each
// elementwise op in the activation dtype.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// TM consecutive elements of global memory as one vector load (the caller
// guarantees the alignment), widened to fp32.
template <typename T, int TM>
__device__ __forceinline__ void ldv(float (&v)[TM], const T* p) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (TM == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else if constexpr (TM == 2) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = q.x;
      v[1] = q.y;
    } else {
      v[0] = __ldg(p);
    }
  } else {
    if constexpr (TM == 4) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&q.x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&q.y));
      v[0] = lo.x;
      v[1] = lo.y;
      v[2] = hi.x;
      v[3] = hi.y;
    } else if constexpr (TM == 2) {
      const float2 q = __bfloat1622float2(
          __ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
      v[0] = q.x;
      v[1] = q.y;
    } else {
      v[0] = __bfloat162float(p[0]);
    }
  }
}

// x / d as the reference rounds it: a multiply by the reciprocal when d is
// a power of two (then exact and identical), a true division otherwise.
struct Divisor {
  float d, inv;
  int pow2;
  __host__ __device__ static Divisor make(float v) {
    Divisor q;
    q.d = v;
    q.inv = 1.f / v;
    int e;
    q.pow2 = frexpf(v, &e) == 0.5f;
    return q;
  }
  __device__ __forceinline__ float div(float x) const {
    return pow2 ? x * inv : x / d;
  }
};

// Conv factor A operand: value of patch row r, feature f (kh, kw, c order;
// feature K = kh*kw*C is the bias ones column), already divided by
// `spatial` in the input dtype. A thread walks its rows incrementally, so
// the row -> (image, oy, ox) split costs no division in the main loop.
template <typename T>
struct ConvRows {
  const T* x;
  int H, W, C, kw, sh, sw, pt, pl, OH, OW;
  int K;  // kh * kw * C
  int F;  // K (+1 with bias)
  Divisor spatial;
  int vec_ok;  // C % 4 == 0 and a 16-byte aligned input

  struct Col {
    int ki, kj, c;
    int kind;  // 0 tap, 1 ones column, 2 past F
  };
  struct Row {
    long long base;  // element offset of the row's image
    int oy, ox, iy0, ix0;
  };
  // TM consecutive features from f0; `vec` when they are TM adjacent
  // channels of one tap (one vector load)
  struct Group {
    Col c0;
    int f0;
    bool vec;
  };

  __device__ Col col(int f) const {
    Col cl;
    cl.ki = cl.kj = cl.c = 0;
    if (f >= F) {
      cl.kind = 2;
    } else if (f >= K) {
      cl.kind = 1;
    } else {
      cl.kind = 0;
      cl.ki = f / (kw * C);
      int rem = f - cl.ki * kw * C;
      cl.kj = rem / C;
      cl.c = rem - cl.kj * C;
    }
    return cl;
  }
  __device__ void locate(Row& rw) const {
    rw.iy0 = rw.oy * sh - pt;
    rw.ix0 = rw.ox * sw - pl;
  }
  __device__ Row row(int r) const {
    Row rw;
    const int per_img = OH * OW;
    const int b = r / per_img;
    const int p = r - b * per_img;
    rw.oy = p / OW;
    rw.ox = p - rw.oy * OW;
    rw.base = (long long)b * H * W * C;
    locate(rw);
    return rw;
  }
  __device__ void advance(Row& rw, int step) const {
    rw.ox += step;
    while (rw.ox >= OW) {
      rw.ox -= OW;
      ++rw.oy;
    }
    while (rw.oy >= OH) {
      rw.oy -= OH;
      rw.base += (long long)H * W * C;
    }
    locate(rw);
  }
  template <int TM>
  __device__ Group group(int f0) const {
    Group g;
    g.f0 = f0;
    g.c0 = col(f0);
    g.vec = TM > 1 && vec_ok && g.c0.kind == 0 && f0 + TM <= K;
    return g;
  }
  // the column of feature f + 1, stepped from that of feature f without a
  // division
  __device__ void next_col(Col& cl, int f) const {
    if (cl.kind == 0) {
      if (++cl.c == C) {
        cl.c = 0;
        if (++cl.kj == kw) {
          cl.kj = 0;
          ++cl.ki;
        }
      }
    }
    if (f + 1 >= F) {
      cl.kind = 2;
    } else if (f + 1 >= K) {
      cl.kind = 1;
    }
  }
  template <int TM>
  __device__ void load(float (&v)[TM], const Row& rw, const Group& g) const {
    if (g.vec) {
      const int iy = rw.iy0 + g.c0.ki;
      const int ix = rw.ix0 + g.c0.kj;
      if (iy < 0 || iy >= H || ix < 0 || ix >= W) {
#pragma unroll
        for (int i = 0; i < TM; ++i) v[i] = 0.f;
        return;
      }
      ldv<T, TM>(v, x + rw.base + ((long long)iy * W + ix) * C + g.c0.c);
#pragma unroll
      for (int i = 0; i < TM; ++i) v[i] = round_to<T>(spatial.div(v[i]));
      return;
    }
    Col cl = g.c0;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      v[i] = val(rw, cl);
      next_col(cl, g.f0 + i);
    }
  }
  __device__ float val(const Row& rw, const Col& cl) const {
    if (cl.kind == 2) return 0.f;
    if (cl.kind == 1) return round_to<T>(spatial.div(1.f));
    const int iy = rw.iy0 + cl.ki;
    const int ix = rw.ix0 + cl.kj;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) return 0.f;
    const float v = load_f<T>(x + rw.base + ((long long)iy * W + ix) * C + cl.c);
    return round_to<T>(spatial.div(v));
  }
};

// Row-statistic operand: row r of a [R, d] matrix with up to two
// multipliers applied in order, and an optional ones column at f == d.
template <typename T>
struct StatRows {
  const T* x;
  int d;
  int F;  // d (+1 with the ones column)
  int nmult;
  float mult0, mult1;
  int vec_ok;  // d % 4 == 0 and a 16-byte aligned input

  struct Col {
    int f;
    int kind;  // 0 value, 1 ones column, 2 past F
  };
  struct Row {
    long long off;
  };
  struct Group {
    int f0;
    bool vec;
  };

  __device__ Col col(int f) const {
    Col cl;
    cl.f = f;
    cl.kind = f >= F ? 2 : (f >= d ? 1 : 0);
    return cl;
  }
  __device__ Row row(int r) const {
    Row rw;
    rw.off = (long long)r * d;
    return rw;
  }
  __device__ void advance(Row& rw, int step) const {
    rw.off += (long long)step * d;
  }
  __device__ float prep(float t) const {
    if (nmult > 0) t = round_to<T>(t * mult0);
    if (nmult > 1) t = round_to<T>(t * mult1);
    return t;
  }
  template <int TM>
  __device__ Group group(int f0) const {
    Group g;
    g.f0 = f0;
    g.vec = TM > 1 && vec_ok && f0 + TM <= d;
    return g;
  }
  template <int TM>
  __device__ void load(float (&v)[TM], const Row& rw, const Group& g) const {
    if (g.vec) {
      ldv<T, TM>(v, x + rw.off + g.f0);
#pragma unroll
      for (int i = 0; i < TM; ++i) v[i] = prep(v[i]);
      return;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) v[i] = val(rw, col(g.f0 + i));
  }
  __device__ float val(const Row& rw, const Col& cl) const {
    if (cl.kind == 2) return 0.f;
    if (cl.kind == 1) return 1.f;
    return prep(load_f<T>(x + rw.off + cl.f));
  }
};

// TM consecutive floats of shared memory, as one vector access where TM
// allows (TM = 2, 4).
template <int TM>
__device__ __forceinline__ void lds(float (&v)[TM], const float* p) {
  if constexpr (TM == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (TM == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

template <int TM>
__device__ __forceinline__ void sts(float* p, const float (&v)[TM]) {
  if constexpr (TM == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (TM == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// One block: output tile (blockIdx.x, blockIdx.y) of [F, F], rows of split
// blockIdx.z. out[i][j] = sum_r u[r][i] * round(u[r][j] / denom). Each
// round stages kBK rows: thread t loads TM consecutive features of row
// t / 16 for each operand (a vector load where the layout allows). The
// next round's loads are issued before this round's FMAs, into registers,
// and shared memory is double-buffered, so the gathers overlap the
// arithmetic. Thread (tx, ty) owns outputs i = ty*TM + a, j = tx*TM + b.
template <int TM, typename T, class Rows>
__global__ void __launch_bounds__(kThreads)
    partial_kernel(Rows rows, int R, int rows_per_split, Divisor denom,
                   float* __restrict__ part) {
  constexpr int TILE = 16 * TM;
  static_assert(kThreads / 16 == kBK, "one staged row per 16 threads");
  __shared__ __align__(16) float As[2][kBK][TILE];
  __shared__ __align__(16) float Bs[2][kBK][TILE];

  const int F = rows.F;
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * TILE;
  const int j0 = blockIdx.y * TILE;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);

  const int lr = tid / 16;
  const int lf = (tid % 16) * TM;
  const auto ga = rows.template group<TM>(i0 + lf);
  const auto gb = rows.template group<TM>(j0 + lf);
  auto rw = rows.row(r_begin + lr);
  float va[TM], vb[TM];
  auto stage = [&](int r0) {
    if (r0 + lr < r_end) {
      rows.template load<TM>(va, rw, ga);
      rows.template load<TM>(vb, rw, gb);
#pragma unroll
      for (int i = 0; i < TM; ++i) vb[i] = round_to<T>(denom.div(vb[i]));
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) va[i] = vb[i] = 0.f;
    }
    rows.advance(rw, kBK);
  };

  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[TM][TM];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TM; ++b) acc[a][b] = 0.f;

  stage(r_begin);
  int buf = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += kBK) {
    sts<TM>(&As[buf][lr][lf], va);
    sts<TM>(&Bs[buf][lr][lf], vb);
    __syncthreads();
    if (r0 + kBK < r_end) stage(r0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[TM], bv[TM];
      lds<TM>(av, &As[buf][kk][ty * TM]);
      lds<TM>(bv, &Bs[buf][kk][tx * TM]);
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TM; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    buf ^= 1;
  }

  float* out = part + (long long)blockIdx.z * F * F;
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int i = i0 + ty * TM + a;
    if (i >= F) continue;
#pragma unroll
    for (int b = 0; b < TM; ++b) {
      const int j = j0 + tx * TM + b;
      if (j < F) out[(long long)i * F + j] = acc[a][b];
    }
  }
}

// Sum the S partials of each element in split order, then the EMA
// epilogue. __fmul_rn/__fadd_rn keep the compiler from contracting the
// combine into an FMA, so it rounds exactly as the plain version does.
__global__ void reduce_ema_kernel(const float* __restrict__ part, int S,
                                  long long FF, const float* __restrict__ cur,
                                  float alpha, float comp, int has_ema,
                                  float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= FF) return;
  float acc = part[e];
#pragma unroll 8
  for (int s = 1; s < S; ++s) acc = __fadd_rn(acc, part[(long long)s * FF + e]);
  if (has_ema) acc = __fadd_rn(__fmul_rn(cur[e], comp), __fmul_rn(acc, alpha));
  out[e] = acc;
}

template <int TM, typename T, class Rows>
int launch_pair(const Rows& rows, int R, int rows_per_split, int S,
                Divisor denom, const float* cur, float alpha, int has_ema,
                float* part, float* out, cudaStream_t stream) {
  constexpr int TILE = 16 * TM;
  const int F = rows.F;
  const int tiles = (F + TILE - 1) / TILE;
  dim3 grid(tiles, tiles, S);
  partial_kernel<TM, T, Rows>
      <<<grid, kThreads, 0, stream>>>(rows, R, rows_per_split, denom, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long FF = (long long)F * F;
  const int rthreads = 256;
  const long long rblocks = (FF + rthreads - 1) / rthreads;
  // the complement is taken in fp32, as update_running_avg does
  const float comp = 1.0f - alpha;
  reduce_ema_kernel<<<(unsigned)rblocks, rthreads, 0, stream>>>(
      part, S, FF, cur, alpha, comp, has_ema, out);
  return (int)cudaGetLastError();
}

template <typename T, class Rows>
int dispatch_tm(int tm, const Rows& rows, int R, int rows_per_split, int S,
                Divisor denom, const float* cur, float alpha, int has_ema,
                float* part, float* out, cudaStream_t stream) {
  switch (tm) {
    case 1:
      return launch_pair<1, T>(rows, R, rows_per_split, S, denom, cur, alpha,
                               has_ema, part, out, stream);
    case 2:
      return launch_pair<2, T>(rows, R, rows_per_split, S, denom, cur, alpha,
                               has_ema, part, out, stream);
    case 4:
      return launch_pair<4, T>(rows, R, rows_per_split, S, denom, cur, alpha,
                               has_ema, part, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int conv_a(const void* x, int N, int H, int W, int C, int kh, int kw, int sh,
           int sw, int pt, int pl, int OH, int OW, int use_bias, int tm,
           int S, int rows_per_split, const float* cur, float alpha,
           int has_ema, float* part, float* out, cudaStream_t stream) {
  ConvRows<T> rows;
  rows.x = static_cast<const T*>(x);
  rows.H = H;
  rows.W = W;
  rows.C = C;
  rows.kw = kw;
  rows.sh = sh;
  rows.sw = sw;
  rows.pt = pt;
  rows.pl = pl;
  rows.OH = OH;
  rows.OW = OW;
  rows.K = kh * kw * C;
  rows.F = rows.K + (use_bias ? 1 : 0);
  rows.spatial = Divisor::make((float)(OH * OW));
  rows.vec_ok = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int R = N * OH * OW;
  return dispatch_tm<T>(tm, rows, R, rows_per_split, S,
                        Divisor::make((float)N), cur, alpha, has_ema, part,
                        out, stream);
}

template <typename T>
int stat_rows(const void* x, int R, int d, int append_ones, int nmult,
              float mult0, float mult1, float denom, int tm, int S,
              int rows_per_split, const float* cur, float alpha,
              int has_ema, float* part, float* out, cudaStream_t stream) {
  StatRows<T> rows;
  rows.x = static_cast<const T*>(x);
  rows.d = d;
  rows.F = d + (append_ones ? 1 : 0);
  rows.nmult = nmult;
  rows.mult0 = mult0;
  rows.mult1 = mult1;
  rows.vec_ok = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return dispatch_tm<T>(tm, rows, R, rows_per_split, S, Divisor::make(denom),
                        cur, alpha, has_ema, part, out, stream);
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16. part: [S, F, F] fp32 scratch; out: [F, F] fp32;
// cur: [F, F] fp32 (read only when has_ema). Returns a cudaError_t code.
int kfac_conv_a(const void* x, int dtype, int N, int H, int W, int C, int kh,
                int kw, int sh, int sw, int pt, int pl, int OH, int OW,
                int use_bias, int tm, int S, int rows_per_split,
                const float* cur, float alpha, int has_ema, float* part,
                float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return conv_a<float>(x, N, H, W, C, kh, kw, sh, sw, pt, pl, OH, OW,
                         use_bias, tm, S, rows_per_split, cur, alpha, has_ema,
                         part, out, st);
  if (dtype == 1)
    return conv_a<__nv_bfloat16>(x, N, H, W, C, kh, kw, sh, sw, pt, pl, OH, OW,
                                 use_bias, tm, S, rows_per_split, cur, alpha,
                                 has_ema, part, out, st);
  return (int)cudaErrorInvalidValue;
}

int kfac_stat_rows(const void* x, int dtype, int R, int d, int append_ones,
                   int nmult, float mult0, float mult1, float denom, int tm,
                   int S, int rows_per_split,
                   const float* cur, float alpha, int has_ema, float* part,
                   float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return stat_rows<float>(x, R, d, append_ones, nmult, mult0, mult1, denom,
                            tm, S, rows_per_split, cur, alpha, has_ema, part,
                            out, st);
  if (dtype == 1)
    return stat_rows<__nv_bfloat16>(x, R, d, append_ones, nmult, mult0, mult1,
                                    denom, tm, S, rows_per_split, cur, alpha,
                                    has_ema, part, out, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
