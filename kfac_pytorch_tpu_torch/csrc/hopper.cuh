// Building blocks of the split-TF32 tensor-core kernels (wgmma, sm_90a),
// shared by csrc/attention.cu (K4, K5a, K5b) and csrc/capture.cu (K1): the
// no-swizzle K-major operand layout and its descriptors, the TF32 split,
// cp.async, the wgmma fences, SS products of 64 rows by 32, 64 or 128
// columns, and the split stores.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Offset (in floats) of element (r, c) of a K-major operand plane of
// 64 (or D) rows and C columns along the contraction: the wgmma
// no-swizzle layout of 8-row x 16-byte core matrices, each 128 bytes
// contiguous, the core matrices of one 8-row group laid along the
// contraction (leading byte offset 128) and the groups 32*C bytes apart
// (stride byte offset).
template <int C>
__device__ __forceinline__ int core_off(int r, int c) {
  return (r >> 3) * (8 * C) + (c >> 2) * 32 + (r & 7) * 4 + (c & 3);
}

// Column of the contraction index e (0..63) in a transposed plane: in
// each group of 8, the even indices fill columns 0-3 and the odd ones 4-7.
// The accumulator a thread feeds as the A operand holds the pair (2t, 2t+1)
// of every 8 columns, where the k8 A fragment wants (t, t+4); this order
// of B's rows makes the two agree without moving the accumulator.
__device__ __forceinline__ int perm_col(int e) {
  const int w = e & 7;
  return (e & ~7) | ((w & 1) ? 4 + (w >> 1) : (w >> 1));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to within 2^-22 |x|: big and small are TF32 values.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// wgmma descriptor of k8 slice 0 of a plane laid out by core_off<C>: no
// swizzle, start address >> 4, leading byte offset 128 (the next core
// matrix along the contraction), stride byte offset 32*C (the next 8 rows).
__device__ __forceinline__ uint64_t plane_desc(const float* plane, int C) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(plane));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((32 * C) >> 4) << 32);
}
// ... and of slice ks: 64 floats (256 bytes) further on
__device__ __forceinline__ uint64_t slice(uint64_t desc, int ks) {
  return desc + (uint64_t)(16 * ks);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory become visible to wgmma
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator registers across wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma m64n64k8, TF32 inputs, fp32 accumulator d, both operands from
// shared memory (descriptors da, db); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same product for N = 32 and 128 (d holds N/2 values a thread).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&a)[4], int u) {
  return (u & 2) ? ((u & 1) ? a[3] : a[2]) : ((u & 1) ? a[1] : a[0]);
}

// Split four consecutive values (r, c..c+3) of a [kTC, D] tile into the
// big and small planes (unless !kPlain) and, with kTrans, into the
// transposed pair (rows c..c+3 of a [D, kTC] plane, column perm_col(r)).
template <int D, bool kTrans, bool kPlain = true, int kTC = 64>
__device__ __forceinline__ void store_split(float4 x, int r, int c,
                                            float* big, float* small,
                                            float* tbig, float* tsmall) {
  const float xs[4] = {x.x, x.y, x.z, x.w};
  uint32_t b[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(xs[i], b[i], s[i]);
  if (kPlain) {
    const int o = core_off<D>(r, c);
    *reinterpret_cast<uint4*>(big + o) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(small + o) =
        make_uint4(s[0], s[1], s[2], s[3]);
  }
  if (kTrans) {
    // the transposed stores of one warp fall on four banks per column c
    // unless its lanes take the four values in different orders: rotated
    // by r's parity and by c / 8 (core_pos: lanes 16-31 are 8 columns on)
    const int pc = perm_col(r);
    const int rot = (r & 1) + ((c >> 2) & 2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = (i + rot) & 3;
      const int ot = core_off<kTC>(c + u, pc);
      tbig[ot] = __uint_as_float(pick4(b, u));
      tsmall[ot] = __uint_as_float(pick4(s, u));
    }
  }
}

// sum += part, elementwise
template <int N>
__device__ __forceinline__ void add_to(float (&sum)[N],
                                       const float (&part)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) sum[i] += part[i];
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launch a kernel of `Threads` threads a block after opting it in.
template <int Threads, typename K, typename... Args>
int launch(K kernel, dim3 grid, size_t smem, cudaStream_t st, Args... args) {
  const cudaError_t e = opt_in(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, Threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
