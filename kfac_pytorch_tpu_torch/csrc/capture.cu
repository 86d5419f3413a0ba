// K-FAC capture kernels for Hopper (sm_90a), bound through a plain C
// interface (ops/_cuda_build.py compiles this file with nvcc and loads it
// with ctypes; ops/capture_kernels.py holds the wrappers and plans the
// launches: _k1_plan, _k2_plan).
//
// K1  kfac_conv_a    replaces kfac_pytorch_tpu/ops/pallas_capture.py
//                    _conv_a_kernel (via compute_a_conv): factor A of a
//                    conv layer, `rows^T (rows / N)` in fp32 over the im2col
//                    patch rows, built in the kernel from the NHWC activation
//                    (the patch matrix never exists in device memory).
// K2  kfac_stat_rows replaces pallas_capture.py _stat_kernel (via
//                    _stat_rows): `t^T (t / denom)` over a row matrix with the
//                    row prep (x mult0, x mult1, ones column) applied at load.
// K3  kfac_ef_quantize replaces pallas_capture.py _ef_kernel (via
//                    ef_quantize): the compressed factor reduce's prep.
//
// K1. At the ResNet-32 shapes (F = 27 to 576 features, R = N*OH*OW up to
// 131072 rows) the symmetric output costs R*F*(F+1) operations, about 78
// GFLOP a factor step: the work bounds it, not the bytes. So its products
// run on the tensor cores at fp32 accuracy, as K5's do: every operand x is
// split into big = rna_tf32(x) and small = rna_tf32(x - big), and a product
// is small*big + big*small + big*big (wgmma m64nNk8, TF32; its bound is
// three TF32 passes at 495 TFLOP/s). For bf16 inputs small is 0 (a bf16
// value is a TF32 value), and one pass is taken.
//  - Only the upper triangle: the output is cut into strips of 64 features
//    (wgmma's M) and strip s into column chunks of N = 32, 64 or 128 over
//    [64s, F). A block owns one (strip, chunk) item and one split of the
//    rows; the epilogue writes each entry and its mirror. (bf16 operands
//    divided by an N that is not a power of two round apart, and the plain
//    statistic is then not symmetric: such a launch takes chunks over
//    [0, F) and mirrors nothing.)
//  - TF32 wgmma takes only K-major operands, and the contraction runs over
//    the rows, so the split values are stored transposed: feature-major,
//    32 rows a core-matrix row (the no-swizzle layout of csrc/hopper.cuh).
//    A lane holds four channels of one row and stores them into four
//    feature rows; each lane rotates the order of its four stores so that
//    one warp's stores hit 32 distinct banks.
//  - Two producer warpgroups gather the im2col rows (bounds-checked taps,
//    zero outside the border) with cp.async into a ring of raw tiles two
//    tiles ahead, each lane into slots of its own, so that no register
//    waits on a load; then scale them (x / spatial, / N for the right
//    operand, each rounded to the input dtype as the plain version rounds
//    it), split them and store them into a ring of split tiles, which a
//    consumer warpgroup multiplies, handed over by mbarriers. The gather
//    and split, not the products, take most of a tile's time, hence two
//    producers to one consumer. TMA cannot gather im2col rows into a
//    K-major layout.
//  - With power-of-two divisors (the ResNet's) u / N is exact, so the
//    diagonal chunk, which holds the strip's 64 features, is staged once,
//    unscaled, for both operands, and the result is scaled by 1 / N.
//  - Each 32-row tile is summed by the tensor cores into a zeroed
//    accumulator and then added into a running fp32 sum in registers: the
//    tensor cores' own fp32 accumulation drops low bits at every step, and
//    over 131072 rows that would build up.
//  - The rows are split across blocks so that the items fill the 132 SMs,
//    about one block an SM, each item's share of the splits in proportion
//    to its work a row (its chunk's width, plus 64 off the diagonal), so
//    that the blocks take about the same time (ops/capture_kernels.py
//    _k1_plan). Each split writes its partial [64, N] region, and a second
//    small kernel sums each entry's partials in split order and applies the
//    EMA (a region is up to 8192 entries, too many for one block to sum
//    after the others); an item with one split writes the EMA'd result
//    itself. No float atomics: a result has the same bits on every run.
//
// K2. At its shapes it is bound by bytes and launches, not by operations:
// ResNet's conv G has d <= 64 features (at most ~16 operations a byte on
// the symmetric half, under the fp32 ridge of 20) and the LM's factors have
// R = 4 rows (no contraction depth for a tensor-core tile). So it stays on
// the fp32 FMA units, and its design cuts launches and latency: one launch a
// call with the split reduce and the EMA fused into it, only the upper
// triangle computed (both, in the bf16 case above). Every divisor that is a
// power of two is taken as a multiply in a kernel built for that case, as
// K1's are: chosen at run time the two get if-converted, and every value
// then pays for the correction of the other divisors (Divisor).
//  - Tall and narrow (F <= 88: conv G, the FC layer): a block owns every
//    output, 4 x 4 a thread over the upper-triangle tiles (thread sets
//    share the rows when the tiles are fewer than the threads), and streams
//    its split of the rows through shared memory in chunks of 4096
//    elements, loading the next chunk into registers (16-byte loads) while
//    it multiplies this one. The launch is cooperative, up to one block an
//    SM, so the splits are resident together: each writes its partials
//    entry-major, and behind a grid-wide barrier (a counter that the last
//    block to leave clears) the splits share the reduce, a lane group
//    summing one entry's partials in a fixed lane order and shuffle tree.
//  - Short and wide (F > 88: the LM's dense layers, R = 4): a 256-thread
//    block per 64 x 64 output tile, 4 x 4 a thread, rows staged 16 at a
//    time. At a few rows it computes both triangles: the products cost less
//    than a mirror's scattered stores (and reads of the EMA's current
//    values); with more rows, upper-triangle tiles mirrored. No split at the
//    LM's shapes, so the EMA'd result is written directly, the EMA's
//    current values read first so that their latency passes while the rows
//    load, rows of four read and written as 16-byte accesses (else the last
//    block of a tile to arrive, by an arrival counter after __threadfence
//    that it resets, sums the splits). Each round's 16 products go into a
//    fresh sum, which is added into the running one with Kahan's
//    compensation: at ResNet-50's conv G shapes (thousands of rows a
//    split) a plain running fp32 sum drifts by ~1e-5 of an entry, ten
//    times the capture tolerance; the compensated one stays at fp32
//    rounding (four adds an output a round against 16 FMAs).
//
// Numerics follow ops/factors.py op for op: every elementwise scaling is
// rounded to the input dtype (fp32 or bf16) in the reference's order
// (x / spatial, then / N for conv A; x mult0, then x mult1, then the ones
// column, then / denom for K2); products accumulate in fp32; the EMA
// epilogue `cur * (1 - alpha) + stat * alpha` uses __fmul_rn/__fadd_rn,
// the rounding sequence of the plain PyTorch version.
//
// K3 is elementwise, 14 bytes per element (two fp32 reads, one bf16 and
// one fp32 write) and three flops, so it is bound by bytes. One flat
// grid-stride pass: 16-byte loads of x and r, the wire stored as 8 bytes
// (bf16 x 4) and r' as a float4, a scalar tail for the elements past the
// last multiple of 4 (and the whole pass when a pointer is not 16-byte
// aligned). `__fadd_rn`/`__fsub_rn` and `__float2bfloat16_rn` round as the
// plain version's three torch ops do, so the two agree bit for bit on every
// non-NaN input (NaN payloads may differ).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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

// Four consecutive elements of global memory as one vector load (the
// caller guarantees the alignment), widened to fp32.
template <typename T, int TM>
__device__ __forceinline__ void ldv(float (&v)[TM], const T* p) {
  static_assert(TM == 4, "the kernels load four features at a time");
  if constexpr (std::is_same<T, float>::value) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = hi.x;
    v[3] = hi.y;
  }
}

// x / d as the reference rounds it, the IEEE quotient: a multiply by the
// reciprocal when d is a power of two (then exact and identical); else the
// product q = x * inv, within two ulps of x / d, corrected once, q +
// (x - q d) inv with both steps fused, which lands within 2^-22 ulp of x / d
// (inv is the correctly rounded 1 / d). That rounds as x / d does unless x / d
// lies nearer a rounding midpoint, and it lies at least ulp / (2 D) from every
// midpoint, D the odd part of d. So the result is the IEEE quotient whenever
// D < 2^21 and |x / d| >= 2^-100: the divisors here are counts of rows and
// output positions, whose odd parts are small (ResNet-50's: 1, 7 and 49).
// Past those bounds it may round one ulp off the quotient. x = +-inf gives
// NaN (IEEE: +-inf), NaN stays NaN. Three flops: the division routine it
// replaces made K1 six times slower a row at ResNet-50's spatial sizes
// (3136, 784, ...) than at powers of two, measured on one H100.
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
  // kPow2 is the launch's compile-time copy of `pow2`: chosen at run time
  // the two get if-converted, and every value pays for the correction
  template <bool kPow2>
  __device__ __forceinline__ float div(float x) const {
    const float q = __fmul_rn(x, inv);
    return kPow2 ? q : fmaf(fmaf(-q, d, x), inv, q);
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
  int R;  // N * OH * OW
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
  // The raw values of TM consecutive features one at a time (1 for the
  // ones column, 0 outside the padded border and past F), unscaled: the
  // groups that are not TM aligned channels of one tap (which K1 copies
  // with cp.async).
  template <int TM>
  __device__ void fetch(float (&v)[TM], const Row& rw, const Group& g) const {
    Col cl = g.c0;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      v[i] = raw(rw, cl);
      next_col(cl, g.f0 + i);
    }
  }
  __device__ float raw(const Row& rw, const Col& cl) const {
    if (cl.kind == 2) return 0.f;
    if (cl.kind == 1) return 1.f;
    const int iy = rw.iy0 + cl.ki;
    const int ix = rw.ix0 + cl.kj;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) return 0.f;
    return load_f<T>(x + rw.base + ((long long)iy * W + ix) * C + cl.c);
  }
  // a fetched value as the operand: / spatial, rounded to the input dtype
  template <bool kPow2>
  __device__ float scale(float v) const {
    return round_to<T>(spatial.template div<kPow2>(v));
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

// ---------------------------------------------------------------------------
// The fused epilogue of K1 and K2: the EMA, the mirrored store, and the
// fixed-order reduce of a split's partials by the last block to arrive.
// ---------------------------------------------------------------------------

// `cur * (1 - alpha) + stat * alpha` without FMA contraction (the
// complement taken in fp32, as update_running_avg does), or the statistic.
struct Ema {
  const float* cur;
  float alpha, comp;
  int on;
  __device__ __forceinline__ float apply(float v, long long e) const {
    return on ? __fadd_rn(__fmul_rn(__ldg(cur + e), comp), __fmul_rn(v, alpha))
              : v;
  }
};

// Entry (i, j) of the upper triangle and its mirror (j, i) of [F, F]; with
// `full`, entry (i, j) alone, wherever it lies (a launch that computes both
// triangles: bf16 operands divided by a denominator that is not a power of
// two round apart, and the statistic is then not symmetric).
__device__ __forceinline__ void emit(float v, int i, int j, int F,
                                     const Ema& ema, float* out,
                                     bool full = false) {
  if (i >= F || j >= F || (!full && j < i)) return;
  const long long e = (long long)i * F + j;
  out[e] = ema.apply(v, e);
  if (!full && i != j) {
    const long long m = (long long)j * F + i;
    out[m] = ema.apply(v, m);
  }
}

// Whether this block is the last of the S splits of output item `item` to
// arrive, for every thread of the block (all must call it, after writing
// their partials). The last block resets the counter for the next launch,
// so the counters need no clearing between calls.
__device__ __forceinline__ bool last_to_arrive(int* cnt, int item, int S) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(cnt + item, 1) == S - 1;
    if (last) cnt[item] = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// A grid-wide barrier for a cooperative launch of S blocks (all resident):
// counter cnt[0] counts arrivals. grid_depart counts the blocks that are
// done in cnt[1]; the last one clears both for the next launch, when every
// block is past the barrier.
__device__ __forceinline__ void grid_arrive(int* cnt, int S) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(cnt, 1);
    while (*reinterpret_cast<volatile int*>(cnt) < S) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}
__device__ __forceinline__ void grid_depart(int* cnt, int S) {
  if (threadIdx.x == 0 && atomicAdd(cnt + 1, 1) == S - 1) {
    cnt[0] = 0;
    cnt[1] = 0;
  }
}

// Sum of the S partials [S, F, F] of entry e, in split order.
__device__ __forceinline__ float split_sum(const float* part, int S,
                                          long long FF, long long e) {
  float acc = __ldcg(part + e);
#pragma unroll 8
  for (int s = 1; s < S; ++s) acc = __fadd_rn(acc, __ldcg(part + s * FF + e));
  return acc;
}

// Rows [i0, i0 + ti) x columns [j0, j0 + tj) of the output from the S
// partials [S, F, F], the EMA applied, mirrored; one entry a thread.
__device__ void reduce_region(const float* part, int S, int F, int i0, int ti,
                              int j0, int tj, const Ema& ema, float* out,
                              bool full) {
  const long long FF = (long long)F * F;
  for (int e = threadIdx.x; e < ti * tj; e += blockDim.x) {
    const int i = i0 + e / tj, j = j0 + e % tj;
    if (i >= F || j >= F || (!full && j < i)) continue;
    emit(split_sum(part, S, FF, (long long)i * F + j), i, j, F, ema, out,
         full);
  }
}

// ---------------------------------------------------------------------------
// K1: conv factor A on the tensor cores (see the note at the top).
// ---------------------------------------------------------------------------

constexpr int kRT = 32;          // rows of one staged tile: four k8 steps
constexpr int kStages = 3;       // split tiles in the ring to the consumer
constexpr int kRawStages = 3;    // gathered tiles in flight (cp.async)
constexpr int kStrip = 64;       // features of a strip: wgmma's M
constexpr int kK1Threads = 384;  // two producer warpgroups and a consumer
constexpr int kK1Producers = 256;
constexpr int kK1Head = 128;     // bytes before the ring: the mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Floats of one ring stage for chunks of up to nmax columns: the strip's
// split pair [64 features, kRT rows] and the chunk's [nmax, kRT]; and of one
// stage of gathered raw values, a 16-byte slot per four features and row.
__host__ __device__ constexpr int k1_stage_floats(int nmax) {
  return 2 * (kStrip + nmax) * kRT;
}
__host__ __device__ constexpr int k1_raw_floats(int nmax) {
  return (kStrip + nmax) * kRT;
}

// An asynchronous copy of kBytes (8 or 16) through L1, where neighbouring
// rows' taps find the same pixels; zeros when !ok.
template <int kBytes>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            bool ok) {
  const uint32_t d = smem_u32(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(kBytes), "r"(ok ? kBytes : 0)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows of the big plane of a diagonal chunk staged once for both operands:
// the chunk's N, at least the strip's 64 (rows past the chunk hold stale
// values that reach only output rows past F); the small plane follows.
__host__ __device__ constexpr int k1_shared_rows(int n) {
  return n > kStrip ? n : kStrip;
}

// Producers (warpgroups 0 and 1, 256 threads): row tiles [t0, t1) of the
// block's split into the ring. Lane (fg, rr) of producer warp w (0..7)
// gathers features 4fg..4fg+3 of each 32-feature block of the strip
// (blocks 0, 1) and of the chunk (blocks 2..), for row 4w + rr of the
// tile. The gather runs kRawStages - 1 tiles ahead through cp.async into
// slots of its own (zero-filled outside the padded border and past R), so
// no register waits on a load; a slot is read back by the thread that
// filled it, and its index is swizzled so that a warp's 16-byte accesses
// fall on distinct banks. Groups that are not four aligned channels of one
// tap (C % 4 != 0, the ones column) are loaded and stored by hand.
template <typename T, int N, bool kPow2>
__device__ void k1_produce(const ConvRows<T>& rows, const Divisor& denom,
                           int R, int t0, int t1, int i0, int j0,
                           float* ring, int stage_floats, float* raw,
                           int raw_floats, uint64_t* full, uint64_t* empty) {
  constexpr int kBlk = (kStrip + N) / 32;
  constexpr bool kSplit = std::is_same<T, float>::value;
  const int lane = threadIdx.x % 32;
  const int fg = lane >> 2, rot = fg >> 1;
  const int row = 4 * (threadIdx.x / 32) + (lane & 3);
  const int swz = fg ^ ((row & 3) << 1);
  // the diagonal chunk holds the strip's features: with power-of-two
  // divisors u / N is exact, so the chunk is staged unscaled, serves as
  // both operands, and the result is scaled by 1 / N at the end
  const bool shared = kPow2 && j0 == i0;
  typename ConvRows<T>::Group grp[kBlk];
#pragma unroll
  for (int b = 0; b < kBlk; ++b)
    grp[b] = rows.template group<4>(
        (b < 2 ? i0 + 32 * b : j0 + 32 * (b - 2)) + 4 * fg);
  auto slot = [&](int t, int b) {
    return raw + ((t - t0) % kRawStages) * raw_floats +
           ((row * kBlk + b) * 8 + swz) * 4;
  };
  // the row of the next tile to gather, stepped a tile at a time
  auto rw = rows.row(t0 * kRT + row);
  int r_next = t0 * kRT + row;

  auto gather = [&](int t) {
    if (t < t1) {
      const bool ok = r_next < R;
#pragma unroll
      for (int b = 0; b < kBlk; ++b) {
        if (shared && b < 2) continue;
        float* dst = slot(t, b);
        const auto& g = grp[b];
        if (g.vec) {
          const int iy = rw.iy0 + g.c0.ki, ix = rw.ix0 + g.c0.kj;
          const bool in = ok && iy >= 0 && iy < rows.H && ix >= 0 &&
                          ix < rows.W;
          const T* src = in ? rows.x + rw.base +
                                  ((long long)iy * rows.W + ix) * rows.C +
                                  g.c0.c
                            : rows.x;
          cp_async_ca<4 * sizeof(T)>(dst, src, in);
        } else {
          float v[4] = {0.f, 0.f, 0.f, 0.f};
          if (ok) rows.template fetch<4>(v, rw, g);
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
      rows.advance(rw, kRT);
      r_next += kRT;
    }
    cp_async_commit();
  };

  for (int t = t0; t < t0 + kRawStages - 1; ++t) gather(t);
  for (int t = t0; t < t1; ++t) {
    gather(t + kRawStages - 1);
    cp_async_wait<kRawStages - 1>();
    const int k = t - t0, s = k % kStages;
    if (k >= kStages) mbar_wait(empty + s, (k / kStages - 1) & 1);
    float* stage = ring + s * stage_floats;
#pragma unroll
    for (int b = 0; b < kBlk; ++b) {
      if (shared && b < 2) continue;
      const float* src = slot(t, b);
      float raw4[4];
      if (!kSplit && grp[b].vec) {
        const uint2 q = *reinterpret_cast<const uint2*>(src);
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&q.x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&q.y));
        raw4[0] = lo.x;
        raw4[1] = lo.y;
        raw4[2] = hi.x;
        raw4[3] = hi.y;
      } else {
        const float4 q = *reinterpret_cast<const float4*>(src);
        raw4[0] = q.x;
        raw4[1] = q.y;
        raw4[2] = q.z;
        raw4[3] = q.w;
      }
      uint32_t big[4], small[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float v = rows.template scale<kPow2>(raw4[u]);
        if (b >= 2 && !shared) v = round_to<T>(denom.template div<kPow2>(v));
        split_tf32(v, big[u], small[u]);
      }
      float* pb = shared ? stage : b < 2 ? stage : stage + 2 * kStrip * kRT;
      float* ps = pb + (shared ? k1_shared_rows(N) : b < 2 ? kStrip : N) * kRT;
      const int f = 32 * (b < 2 ? b : b - 2) + 4 * fg;
#pragma unroll
      for (int step = 0; step < 4; ++step) {
        const int u = (step + rot) & 3;
        const int o = core_off<kRT>(f + u, row);
        pb[o] = __uint_as_float(pick4(big, u));
        if (kSplit) ps[o] = __uint_as_float(pick4(small, u));
      }
    }
    fence_async_proxy();
    mbar_arrive(full + s);
  }
  cp_async_wait<0>();
}

// Consumer (warpgroup 2): every tile of the block, each summed in a zeroed
// accumulator, then added into `sum`.
template <int N, bool kSplit>
__device__ void k1_consume(int ntiles, bool shared, const float* ring,
                           int stage_floats, uint64_t* full, uint64_t* empty,
                           float (&sum)[N / 2]) {
  float acc[N / 2];
  for (int k = 0; k < ntiles; ++k) {
    const int s = k % kStages;
    mbar_wait(full + s, (k / kStages) & 1);
    const float* stage = ring + s * stage_floats;
    const uint64_t ab = plane_desc(stage, kRT);
    const uint64_t as =
        plane_desc(stage + (shared ? k1_shared_rows(N) : kStrip) * kRT, kRT);
    const uint64_t bb = shared ? ab : plane_desc(stage + 2 * kStrip * kRT, kRT);
    const uint64_t bs =
        shared ? as : plane_desc(stage + (2 * kStrip + N) * kRT, kRT);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kRT / 8; ++ks) {
      if (kSplit) {
        wgmma_ss(acc, slice(as, ks), slice(bb, ks), ks > 0);
        wgmma_ss(acc, slice(ab, ks), slice(bs, ks), 1);
        wgmma_ss(acc, slice(ab, ks), slice(bb, ks), 1);
      } else {
        wgmma_ss(acc, slice(ab, ks), slice(bb, ks), ks > 0);
      }
    }
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
    mbar_arrive(empty + s);
    add_to(sum, acc);
  }
}

// Row (feature of the strip) and column (of the chunk) of accumulator
// entry i of thread lt (0..127) of the consumer warpgroup.
__device__ __forceinline__ int k1_row(int lt, int i) {
  return 16 * (lt / 32) + (lt % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int k1_col(int lt, int i) {
  return 8 * (i >> 2) + 2 * (lt % 4) + (i & 1);
}

template <typename T, int N, bool kPow2>
__device__ void k1_block(const ConvRows<T>& rows, const Divisor& denom,
                         int R, int t0, int t1, int z, int S, int i0, int j0,
                         bool all, const Ema& ema, float* part, float* out,
                         float* ring, int stage_floats, float* raw,
                         int raw_floats, uint64_t* full, uint64_t* empty) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  const int F = rows.F;
  if (threadIdx.x < kK1Producers) {
    k1_produce<T, N, kPow2>(rows, denom, R, t0, t1, i0, j0, ring,
                            stage_floats, raw, raw_floats, full, empty);
    return;
  }
  const int lt = threadIdx.x - kK1Producers;
  float sum[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum[i] = 0.f;
  const bool shared = kPow2 && j0 == i0;
  k1_consume<N, kSplit>(max(0, t1 - t0), shared, ring, stage_floats, full,
                        empty, sum);
  if (shared) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sum[i] *= denom.inv;
  }
  float* dst = S > 1 ? part + (long long)z * F * F : nullptr;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = i0 + k1_row(lt, i), c = j0 + k1_col(lt, i);
    if (S == 1)
      emit(sum[i], r, c, F, ema, out, all);
    else if (r < F && c < F)
      dst[(long long)r * F + c] = sum[i];
  }
}

// K1's second kernel when rows are split: each entry of an item whose rows
// were split (its (i0, j0, N, S) row of `items`) summed over its S partials
// [S, F, F] in split order, the EMA applied, mirrored.
__global__ void __launch_bounds__(kThreads)
    split_reduce_kernel(const float* __restrict__ part,
                        const int* __restrict__ items, int nitems, int F,
                        int all, Ema ema, float* __restrict__ out) {
  const long long FF = (long long)F * F;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= FF) return;
  const int i = (int)(e / F), j = (int)(e % F);
  if (!all && j < i) return;
  for (int k = 0; k < nitems; ++k) {
    const int* it = items + 4 * k;
    if (i >= it[0] && i < it[0] + kStrip && j >= it[1] && j < it[1] + it[2]) {
      if (it[3] > 1) emit(split_sum(part, it[3], FF, e), i, j, F, ema, out, all);
      return;
    }
  }
}

// One block a row of the `blocks` table: (strip row i0, chunk column j0,
// chunk width N, row tiles [t0, t1), split z of the item's S). Items whose
// work is larger (wider, or with a strip of their own to gather) take more
// splits, so that the blocks take about the same time.
template <typename T, bool kPow2>
__global__ void __launch_bounds__(kK1Threads, 1)
    conv_a_kernel(ConvRows<T> rows, Divisor denom,
                  const int* __restrict__ blocks, int nmax, int all, Ema ema,
                  float* __restrict__ part, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char k1_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(k1_smem);
  uint64_t* empty = full + kStages;
  float* ring = reinterpret_cast<float*>(k1_smem + kK1Head);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, kK1Producers);
      mbar_init(empty + s, kK1Threads - kK1Producers);
    }
  }
  __syncthreads();
  const int* bk = blocks + 7 * blockIdx.x;
  const int i0 = bk[0], j0 = bk[1], n = bk[2], t0 = bk[3], t1 = bk[4];
  const int z = bk[5], S = bk[6];
  const int R = rows.R;
  const int sf = k1_stage_floats(nmax);
  float* raw = ring + kStages * sf;
  const int rf = k1_raw_floats(nmax);
  switch (n) {
    case 32:
      k1_block<T, 32, kPow2>(rows, denom, R, t0, t1, z, S, i0, j0, all, ema,
                             part, out, ring, sf, raw, rf, full, empty);
      break;
    case 64:
      k1_block<T, 64, kPow2>(rows, denom, R, t0, t1, z, S, i0, j0, all, ema,
                             part, out, ring, sf, raw, rf, full, empty);
      break;
    default:
      k1_block<T, 128, kPow2>(rows, denom, R, t0, t1, z, S, i0, j0, all, ema,
                             part, out, ring, sf, raw, rf, full, empty);
  }
}

size_t k1_smem_bytes(int nmax) {
  return kK1Head + sizeof(float) * (kStages * (size_t)k1_stage_floats(nmax) +
                                     kRawStages * (size_t)k1_raw_floats(nmax));
}

// ---------------------------------------------------------------------------
// K2, tall and narrow (F <= 88): one block holds every output of its split.
// ---------------------------------------------------------------------------

constexpr int kChunk = 4096;  // elements of the rows staged per round
constexpr int kPer = kChunk / kThreads;

// Upper-triangle tile `id` of a g x g grid, row by row: (ti, tj), ti <= tj.
__device__ __forceinline__ void tri_tile(int id, int g, int& ti, int& tj) {
  ti = 0;
  while (id >= g - ti) {
    id -= g - ti;
    ++ti;
  }
  tj = ti + id;
}

// Raw values [c0 * d, c0 * d + n * d) of the row matrix into registers:
// thread tid takes elements (or vectors of four) tid + 256 k.
template <typename T>
__device__ __forceinline__ void tall_fetch(const StatRows<T>& rows, long long c0,
                                           int n, float (&buf)[kPer]) {
  const long long base = c0 * rows.d;
  const int count = n * rows.d;
  if (rows.vec_ok) {
#pragma unroll
    for (int k = 0; k < kPer / 4; ++k) {
      const int e = 4 * (threadIdx.x + kThreads * k);
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (e < count) ldv<T, 4>(v, rows.x + base + e);
#pragma unroll
      for (int u = 0; u < 4; ++u) buf[4 * k + u] = v[u];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = threadIdx.x + kThreads * k;
      buf[k] = e < count ? load_f<T>(rows.x + base + e) : 0.f;
    }
  }
}

// ... and from registers into the staged operands u (prepped) and w =
// round(u / denom), [rc][fp] each.
template <bool kPow2, typename T>
__device__ __forceinline__ void tall_store(const StatRows<T>& rows,
                                           const Divisor& denom, int n,
                                           const float (&buf)[kPer], float* us,
                                           float* ws, int fp) {
  const int count = n * rows.d;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = rows.vec_ok ? 4 * (threadIdx.x + kThreads * (k / 4)) + k % 4
                              : threadIdx.x + kThreads * k;
    if (e < count) {
      const int r = e / rows.d, f = e - r * rows.d;
      const float u = rows.prep(buf[k]);
      us[r * fp + f] = u;
      ws[r * fp + f] = round_to<T>(denom.template div<kPow2>(u));
    }
  }
}

template <typename T, bool kPow2>
__global__ void __launch_bounds__(kThreads)
    stat_tall_kernel(StatRows<T> rows, int R, int rows_per_split, int rc,
                     int sets, int full, Divisor denom, Ema ema,
                     float* __restrict__ part, int* __restrict__ cnt,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) float k2_smem[];
  const int F = rows.F, g = (F + 3) / 4, fp = 4 * g;
  const int ntiles = full ? g * g : g * (g + 1) / 2;
  float* us = k2_smem;        // [rc][fp]
  float* ws = us + rc * fp;   // [rc][fp]
  // the ones column and the padding columns stay put over the chunks
  for (int e = threadIdx.x; e < rc * fp; e += kThreads) {
    const int f = e % fp;
    const float one = f == rows.d && F > rows.d ? 1.f : 0.f;
    us[e] = one;
    ws[e] = f == rows.d && F > rows.d
                ? round_to<T>(denom.template div<kPow2>(1.f))
                : 0.f;
  }
  const int set = threadIdx.x / ntiles;
  int ti, tj;
  if (full) {
    ti = threadIdx.x % ntiles / g;
    tj = threadIdx.x % ntiles % g;
  } else {
    tri_tile(threadIdx.x % ntiles, g, ti, tj);
  }
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  const int r_begin = blockIdx.x * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  float buf[kPer];
  if (r_begin < r_end) tall_fetch(rows, r_begin, min(rc, r_end - r_begin), buf);
  for (int c0 = r_begin; c0 < r_end; c0 += rc) {
    const int n = min(rc, r_end - c0);
    __syncthreads();  // the last chunk's readers are done
    tall_store<kPow2>(rows, denom, n, buf, us, ws, fp);
    __syncthreads();
    if (c0 + rc < r_end) tall_fetch(rows, c0 + rc, min(rc, r_end - c0 - rc), buf);
    if (set < sets) {
#pragma unroll 4
      for (int r = set; r < n; r += sets) {
        const float4 a = *reinterpret_cast<const float4*>(us + r * fp + 4 * ti);
        const float4 b = *reinterpret_cast<const float4*>(ws + r * fp + 4 * tj);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
  // the thread sets' sums, in set order
  __syncthreads();
  if (set < sets && set > 0) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      us[((set - 1) * ntiles + threadIdx.x % ntiles) * 16 + e] = acc[e / 4][e % 4];
  }
  __syncthreads();
  const int S = gridDim.x;
  if (set == 0) {
    for (int p = 1; p < sets; ++p)
#pragma unroll
      for (int e = 0; e < 16; ++e)
        acc[e / 4][e % 4] =
            __fadd_rn(acc[e / 4][e % 4], us[((p - 1) * ntiles + threadIdx.x) * 16 + e]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = 4 * ti + a, j = 4 * tj + b;
        if (S == 1)
          emit(acc[a][b], i, j, F, ema, out, full);
        else if (i < F && j < F)
          part[((long long)i * F + j) * S + blockIdx.x] = acc[a][b];
      }
  }
  if (S == 1) return;
  // every split's partial is written: the S blocks (all resident, as the
  // launch is cooperative) then share the reduce, block z taking entries
  // [z * eb, (z + 1) * eb) of the entry-major partials [F * F][S]. Lanes in
  // groups of gs (a power of two >= S, at most 32) sum one entry each, lane
  // k of a group taking splits k, k + gs, ... in order, then a fixed
  // shuffle tree; a warp takes four such entries a group at a time, their
  // loads in flight together.
  grid_arrive(cnt, S);
  const int FF = F * F, eb = (FF + S - 1) / S;
  const int e0 = blockIdx.x * eb, e1 = min(FF, e0 + eb);
  int gs = 1;
  while (gs < S && gs < 32) gs <<= 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per = 32 / gs, grp = lane / gs, gl = lane % gs;
  for (int base = e0 + warp * 4 * per; base < e1; base += kThreads / 8 * per) {
    float v[4];
    int ei[4], ej[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int o = base + u * per + grp;
      ei[u] = o < e1 ? o / F : F;
      ej[u] = o % F;
      v[u] = 0.f;
      if (ei[u] < F && (full || ej[u] >= ei[u])) {
        const float* src = part + (long long)o * S;
        for (int s = gl; s < S; s += gs) v[u] = __fadd_rn(v[u], __ldcg(src + s));
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      for (int m = gs / 2; m > 0; m >>= 1)
        v[u] = __fadd_rn(v[u], __shfl_xor_sync(0xffffffffu, v[u], m));
      if (gl == 0) emit(v[u], ei[u], ej[u], F, ema, out, full);
    }
  }
  grid_depart(cnt, S);
}

// ---------------------------------------------------------------------------
// K2, short and wide (F > 88): one block per upper-triangle 64 x 64 tile.
// ---------------------------------------------------------------------------

constexpr int kTM = 4;              // outputs a thread, each way
constexpr int kTile = 16 * kTM;     // a block's output tile

// TM consecutive floats of shared memory as one vector access.
__device__ __forceinline__ void lds4(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// Block (tile blockIdx.x of the upper triangle, split blockIdx.y). Each
// round stages kBK rows of both operands: thread t loads four consecutive
// features of row t / 16 for each (a vector load where the layout allows).
// The next round's loads are issued before this round's FMAs, into
// registers, and shared memory is double-buffered. Thread (tx, ty) owns
// outputs i = ty*4 + a, j = tx*4 + b of the tile.
template <typename T, bool kPow2>
__global__ void __launch_bounds__(kThreads)
    stat_wide_kernel(StatRows<T> rows, int R, int rows_per_split, int full,
                     int vec_out, Divisor denom, Ema ema,
                     float* __restrict__ part, int* __restrict__ cnt,
                     float* __restrict__ out) {
  static_assert(kThreads / 16 == kBK, "one staged row per 16 threads");
  __shared__ __align__(16) float As[2][kBK][kTile];
  __shared__ __align__(16) float Bs[2][kBK][kTile];
  const int F = rows.F, S = gridDim.y, tid = threadIdx.x;
  const int g = (F + kTile - 1) / kTile;
  int bi, bj;
  if (full) {
    bi = blockIdx.x / g;
    bj = blockIdx.x % g;
  } else {
    tri_tile(blockIdx.x, g, bi, bj);
  }
  const int i0 = bi * kTile, j0 = bj * kTile;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);

  const int lr = tid / 16, lf = (tid % 16) * kTM;
  const auto ga = rows.template group<kTM>(i0 + lf);
  const auto gb = rows.template group<kTM>(j0 + lf);
  auto rw = rows.row(r_begin + lr);
  float va[kTM], vb[kTM];
  auto stage = [&](int r0) {
    if (r0 + lr < r_end) {
      rows.template load<kTM>(va, rw, ga);
      rows.template load<kTM>(vb, rw, gb);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        vb[i] = round_to<T>(denom.template div<kPow2>(vb[i]));
    } else {
#pragma unroll
      for (int i = 0; i < kTM; ++i) va[i] = vb[i] = 0.f;
    }
    rows.advance(rw, kBK);
  };

  const int tx = tid % 16, ty = tid / 16;
  // the running sum and its Kahan compensation (what the last add lost)
  float acc[kTM][kTM], lost[kTM][kTM];
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int b = 0; b < kTM; ++b) acc[a][b] = lost[a][b] = 0.f;

  // a tile written whole (both triangles, one split): the EMA's current
  // values are read now, so that their latency passes while the rows load
  // and multiply, and a row of four is read and written as one 16-byte
  // access where the layout allows (vec_out: F % 4 == 0, aligned)
  const bool direct = full && S == 1;
  const bool row4 = direct && vec_out && j0 + tx * kTM + kTM <= F;
  float c[kTM][kTM];
  if (direct && ema.on) {
#pragma unroll
    for (int a = 0; a < kTM; ++a) {
      const int i = min(i0 + ty * kTM + a, F - 1);
      const long long o = (long long)i * F + j0 + tx * kTM;
      if (row4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(ema.cur + o));
        c[a][0] = q.x;
        c[a][1] = q.y;
        c[a][2] = q.z;
        c[a][3] = q.w;
      } else {
#pragma unroll
        for (int b = 0; b < kTM; ++b)
          c[a][b] = j0 + tx * kTM + b < F ? __ldg(ema.cur + o + b) : 0.f;
      }
    }
  }

  stage(r_begin);
  int buf = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += kBK) {
    *reinterpret_cast<float4*>(&As[buf][lr][lf]) =
        make_float4(va[0], va[1], va[2], va[3]);
    *reinterpret_cast<float4*>(&Bs[buf][lr][lf]) =
        make_float4(vb[0], vb[1], vb[2], vb[3]);
    __syncthreads();
    if (r0 + kBK < r_end) stage(r0 + kBK);
    float rnd[kTM][kTM];
#pragma unroll
    for (int a = 0; a < kTM; ++a)
#pragma unroll
      for (int b = 0; b < kTM; ++b) rnd[a][b] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[kTM];
      lds4(av, &As[buf][kk][ty * kTM]);
      lds4(bv, &Bs[buf][kk][tx * kTM]);
#pragma unroll
      for (int a = 0; a < kTM; ++a)
#pragma unroll
        for (int b = 0; b < kTM; ++b) rnd[a][b] = fmaf(av[a], bv[b], rnd[a][b]);
    }
#pragma unroll
    for (int a = 0; a < kTM; ++a)
#pragma unroll
      for (int b = 0; b < kTM; ++b) {
        const float y = __fsub_rn(rnd[a][b], lost[a][b]);
        const float t = __fadd_rn(acc[a][b], y);
        lost[a][b] = __fsub_rn(__fsub_rn(t, acc[a][b]), y);
        acc[a][b] = t;
      }
    buf ^= 1;
  }

  if (direct) {
#pragma unroll
    for (int a = 0; a < kTM; ++a) {
      const int i = i0 + ty * kTM + a;
      if (i >= F) continue;
      float v[kTM];
#pragma unroll
      for (int b = 0; b < kTM; ++b)
        v[b] = ema.on ? __fadd_rn(__fmul_rn(c[a][b], ema.comp),
                                  __fmul_rn(acc[a][b], ema.alpha))
                      : acc[a][b];
      float* o = out + (long long)i * F + j0 + tx * kTM;
      if (row4) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int b = 0; b < kTM; ++b)
          if (j0 + tx * kTM + b < F) o[b] = v[b];
      }
    }
    return;
  }
  float* dst = part + (long long)blockIdx.y * F * F;
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int b = 0; b < kTM; ++b) {
      const int i = i0 + ty * kTM + a, j = j0 + tx * kTM + b;
      if (S == 1)
        emit(acc[a][b], i, j, F, ema, out, full);
      else if (i < F && j < F)
        dst[(long long)i * F + j] = acc[a][b];
    }
  if (S > 1 && last_to_arrive(cnt, blockIdx.x, S))
    reduce_region(part, S, F, i0, kTile, j0, kTile, ema, out, full);
}

// ---------------------------------------------------------------------------
// Host side of K1 and K2.
// ---------------------------------------------------------------------------

Ema make_ema(const float* cur, float alpha, int has_ema) {
  Ema e;
  e.cur = cur;
  e.alpha = alpha;
  e.comp = 1.0f - alpha;  // in fp32, as update_running_avg takes it
  e.on = has_ema;
  return e;
}

template <typename T>
int conv_a(const void* x, int N, int H, int W, int C, int kh, int kw, int sh,
           int sw, int pt, int pl, int OH, int OW, int use_bias,
           const int* table, int nblocks, int nitems, int nmax, int smax,
           int full, const float* cur, float alpha, int has_ema, float* part,
           float* out, cudaStream_t stream) {
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
  rows.R = N * OH * OW;
  rows.spatial = Divisor::make((float)(OH * OW));
  rows.vec_ok = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const Ema ema = make_ema(cur, alpha, has_ema);
  const Divisor dn = Divisor::make((float)N);
  const int err = launch<kK1Threads>(
      rows.spatial.pow2 && dn.pow2 ? conv_a_kernel<T, true>
                                   : conv_a_kernel<T, false>,
      dim3(nblocks), k1_smem_bytes(nmax), stream, rows, dn, table, nmax, full,
      ema, part, out);
  if (err != 0 || smax == 1) return err;
  const long long FF = (long long)rows.F * rows.F;
  return launch<kThreads>(split_reduce_kernel,
                          dim3((unsigned)((FF + kThreads - 1) / kThreads)), 0,
                          stream, part, table + 7 * nblocks, nitems, rows.F,
                          full, ema, out);
}

template <typename T>
int stat_rows(const void* x, int R, int d, int append_ones, int nmult,
              float mult0, float mult1, float denom, int wide, int full,
              int S, int rows_per_split, int rc, int sets, const float* cur,
              float alpha, int has_ema, float* part, int* cnt, float* out,
              cudaStream_t stream) {
  StatRows<T> rows;
  rows.x = static_cast<const T*>(x);
  rows.d = d;
  rows.F = d + (append_ones ? 1 : 0);
  rows.nmult = nmult;
  rows.mult0 = mult0;
  rows.mult1 = mult1;
  rows.vec_ok = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const Ema ema = make_ema(cur, alpha, has_ema);
  const Divisor dv = Divisor::make(denom);
  if (wide) {
    const int g = (rows.F + kTile - 1) / kTile;
    const int vec_out =
        rows.F % 4 == 0 &&
        ((reinterpret_cast<uintptr_t>(out) |
          (has_ema ? reinterpret_cast<uintptr_t>(cur) : 0)) % 16) == 0;
    return launch<kThreads>(
        dv.pow2 ? stat_wide_kernel<T, true> : stat_wide_kernel<T, false>,
        dim3(full ? g * g : g * (g + 1) / 2, S), 0, stream, rows, R,
        rows_per_split, full, vec_out, dv, ema, part, cnt, out);
  }
  // cooperative, so that the S blocks are resident together and can share
  // the reduce behind a grid-wide barrier
  const int fp = 4 * ((rows.F + 3) / 4);
  void* args[] = {&rows, &R,   &rows_per_split, &rc,  &sets, &full,
                  (void*)&dv, (void*)&ema, &part, &cnt, &out};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      dv.pow2 ? (const void*)stat_tall_kernel<T, true>
              : (const void*)stat_tall_kernel<T, false>,
      dim3(S), dim3(kThreads), args, sizeof(float) * 2 * (size_t)rc * fp,
      stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One element of K3: the sum, its bf16 wire value and the new residual.
__device__ __forceinline__ float ef_one(float x, float r, __nv_bfloat16* w) {
  const float xc = __fadd_rn(x, r);
  *w = __float2bfloat16_rn(xc);
  return __fsub_rn(xc, __bfloat162float(*w));
}

// K3: `nvec` groups of four elements through vector accesses (when `vec`),
// then the rest one by one, both grid-stride.
__global__ void ef_quantize_kernel(const float* __restrict__ x,
                                   const float* __restrict__ r,
                                   __nv_bfloat16* __restrict__ wire,
                                   float* __restrict__ nr, long long n,
                                   int vec) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long nvec = vec ? n / 4 : 0;
  for (long long i = tid; i < nvec; i += stride) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(x) + i);
    const float4 b = __ldg(reinterpret_cast<const float4*>(r) + i);
    __align__(8) __nv_bfloat16 w[4];
    float4 o;
    o.x = ef_one(a.x, b.x, &w[0]);
    o.y = ef_one(a.y, b.y, &w[1]);
    o.z = ef_one(a.z, b.z, &w[2]);
    o.w = ef_one(a.w, b.w, &w[3]);
    reinterpret_cast<uint2*>(wire)[i] = *reinterpret_cast<const uint2*>(w);
    reinterpret_cast<float4*>(nr)[i] = o;
  }
  for (long long i = nvec * 4 + tid; i < n; i += stride) {
    __nv_bfloat16 w;
    nr[i] = ef_one(x[i], r[i], &w);
    wire[i] = w;
  }
}

}  // namespace

extern "C" {

// K1. dtype: 0 fp32, 1 bf16. table: the launch plan on the device, nblocks
// rows (strip row, chunk column, chunk width, first and end row tile of 32
// rows, split, the item's splits) and then nitems rows (strip row, chunk
// column, chunk width, splits); nmax the widest chunk, smax the most
// splits; full: the items cover both triangles and nothing is mirrored.
// part: [smax, F, F] fp32 scratch, summed by a second kernel when smax > 1;
// out: [F, F] fp32; cur: [F, F] fp32 (read only when has_ema). Returns a
// cudaError_t code.
int kfac_conv_a(const void* x, int dtype, int N, int H, int W, int C, int kh,
                int kw, int sh, int sw, int pt, int pl, int OH, int OW,
                int use_bias, const int* table, int nblocks, int nitems,
                int nmax, int smax, int full, const float* cur, float alpha,
                int has_ema, float* part, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return conv_a<float>(x, N, H, W, C, kh, kw, sh, sw, pt, pl, OH, OW,
                         use_bias, table, nblocks, nitems, nmax, smax, full,
                         cur, alpha, has_ema, part, out, st);
  if (dtype == 1)
    return conv_a<__nv_bfloat16>(x, N, H, W, C, kh, kw, sh, sw, pt, pl, OH,
                                 OW, use_bias, table, nblocks, nitems, nmax,
                                 smax, full, cur, alpha, has_ema, part, out,
                                 st);
  return (int)cudaErrorInvalidValue;
}

// K1's dynamic shared memory in bytes for chunks up to nmax wide, and its
// blocks resident on one SM (the power-of-two divisors' kernel, the main
// path's).
int kfac_conv_a_occupancy(int dtype, int nmax, int* smem_bytes, int* blocks) {
  const size_t smem = k1_smem_bytes(nmax);
  *smem_bytes = (int)smem;
  cudaError_t e;
  if (dtype == 0) {
    e = opt_in(conv_a_kernel<float, true>, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, conv_a_kernel<float, true>, kK1Threads, smem);
  } else {
    e = opt_in(conv_a_kernel<__nv_bfloat16, true>, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, conv_a_kernel<__nv_bfloat16, true>, kK1Threads, smem);
  }
  return (int)e;
}

// K2. wide: 0 the tall kernel (rc rows a chunk, `sets` thread sets over the
// rows), 1 the wide one; full: both triangles computed, nothing mirrored;
// splits x rows_per_split rows. part:
// [splits, F, F] fp32 scratch (splits > 1); cnt: zeroed arrival counters
// (left zeroed), one per 64 x 64 output tile (wide) or two (tall).
int kfac_stat_rows(const void* x, int dtype, int R, int d, int append_ones,
                   int nmult, float mult0, float mult1, float denom, int wide,
                   int full, int splits, int rows_per_split, int rc, int sets,
                   const float* cur, float alpha, int has_ema, float* part,
                   int* cnt, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return stat_rows<float>(x, R, d, append_ones, nmult, mult0, mult1, denom,
                            wide, full, splits, rows_per_split, rc, sets, cur,
                            alpha, has_ema, part, cnt, out, st);
  if (dtype == 1)
    return stat_rows<__nv_bfloat16>(x, R, d, append_ones, nmult, mult0, mult1,
                                    denom, wide, full, splits, rows_per_split,
                                    rc, sets, cur, alpha, has_ema, part, cnt,
                                    out, st);
  return (int)cudaErrorInvalidValue;
}

// K3. x, r, nr: n fp32 values; wire: n bf16 values. `blocks` blocks of 256
// threads. Returns a cudaError_t code.
int kfac_ef_quantize(const float* x, const float* r, void* wire, float* nr,
                     long long n, int blocks, void* stream) {
  const uintptr_t any16 = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(r) |
                          reinterpret_cast<uintptr_t>(nr);
  const int vec =
      any16 % 16 == 0 && reinterpret_cast<uintptr_t>(wire) % 8 == 0;
  ef_quantize_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, r, static_cast<__nv_bfloat16*>(wire), nr, n, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
