// The tensor-core product code shared by the block kernels: K1 and K3
// (block_mma.cuh) and the chained blocks K4 and K5 (block_chain.cuh).
//
// * 3xTF32: mma.sync m16n8k8 in TF32 with a float32 accumulator, each
//   float32 operand a split into big = tf32(a) (rounded to nearest) plus
//   small = tf32(a - big), and the products small*big + big*small +
//   big*big summed: about 2^-21 of each product, where one TF32 pass keeps
//   2^-11.  A bfloat16 value is exact in TF32, so its small part is zero
//   and its pass is skipped.
// * cp.async copies of weight chunks into shared memory (stage).
// * Row strides padded against bank conflicts (ld_a, ld_b): an A fragment
//   reads rows g and columns t (g = lane / 4, t = lane % 4), which a stride
//   of 4 mod 8 spreads over the 32 banks; a B fragment reads rows t and
//   columns g, which a stride of 8 mod 16 spreads.
// * The activation combinations fixed at compile time, and act_t.

#pragma once

#include "block_fused.cuh"

namespace ffcnn_block {

// The activation combinations fixed at compile time: {act1, act2, act3,
// res_act} (res_act is not read where a block has no residual).
#define FFCNN_BLOCK_ACT_INSTANCES(X)                                     \
  X(2, 2, 0, 0) /* yolo-fastest-xl: leaky, leaky, linear; linear res */ \
  X(1, 2, 0, 2) /* ffcnn-micro: relu, leaky, linear; leaky res */

namespace mma {

constexpr int kChunk = 32;              // expand channels per chunk
constexpr int kLdH = kChunk + 8;        // expand output row stride
constexpr int kVec = 13 * kChunk;       // a chunk's s1, b1, s2, b2, kdw (x9)

// Row strides in floats: A-fragment arrays take 4 mod 8, B-fragment arrays
// 8 mod 16 (see the header).
__host__ __device__ constexpr int ld_a(int k) { return (k + 3) / 8 * 8 + 4; }
__host__ __device__ constexpr int ld_b(int n) { return (n + 7) / 16 * 16 + 8; }
constexpr int kLdA2 = ld_a(kChunk);     // the depthwise output
constexpr int kLdW1 = ld_b(kChunk);     // the expand weight chunk

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small to about 2^-22 of v
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(v);
  small = tf32(v - __uint_as_float(big));
}

// tf32(v) by integer rounding of the magnitude, half away from zero: the
// value cvt.rna gives for finite v, with two full-rate integer operations.
__device__ __forceinline__ uint32_t tf32_int(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// split (I false) or the same split by integer rounding (I true)
template <bool I>
__device__ __forceinline__ void split_t(float v, uint32_t& big,
                                        uint32_t& small) {
  if constexpr (I) {
    big = tf32_int(v);
    small = tf32_int(v - __uint_as_float(big));
  } else {
    split(v, big, small);
  }
}

// d += a @ b, one m16n8k8 TF32 product with a float32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[j] += (a_big + a_small) @ (b_big[j] + b_small[j]) for the n8 tiles
// j < N that are live, without the small*small term; a_small is skipped
// where it is zero (a bfloat16 input).  b[j] holds the raw B fragment
// {B[t][g], B[t + 4][g]}.  Each of the three passes runs over every tile
// before the next starts, so that no mma waits on the one issued just
// before it (they share no accumulator).
template <int N, bool I = false>
__device__ __forceinline__ void mma_3x(float (&d)[N][4],
                                       const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4], bool a_exact,
                                       const float (&b)[N][2],
                                       const bool (&live)[N]) {
  uint32_t bb[N][2], bs[N][2];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    split_t<I>(b[j][0], bb[j][0], bs[j][0]);
    split_t<I>(b[j][1], bb[j][1], bs[j][1]);
  }
  if (!a_exact) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (live[j]) mma_tf32(d[j], as, bb[j][0], bb[j][1]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (live[j]) mma_tf32(d[j], ab, bs[j][0], bs[j][1]);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (live[j]) mma_tf32(d[j], ab, bb[j][0], bb[j][1]);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Start copying a rows x cols block of floats (row stride sld) into shared
// memory (row stride dld), zero-filled out to rpad x cpad, by a CTA of NT
// threads.  vec: 16-byte copies (cols, cpad, sld and dld multiples of 4,
// src 16-byte aligned).
template <int NT = kThreads>
__device__ __forceinline__ void stage(float* dst, int dld, const float* src,
                                      int sld, int rows, int cols, int rpad,
                                      int cpad, bool vec) {
  if (vec) {
    const int nv = cpad >> 2;
    for (int i = threadIdx.x; i < rpad * nv; i += NT) {
      const int r = i / nv, c = (i - r * nv) << 2;
      const bool ok = r < rows && c < cols;
      cp_async16(dst + r * dld + c, ok ? src + (size_t)r * sld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rpad * cpad; i += NT) {
      const int r = i / cpad, c = i - r * cpad;
      const bool ok = r < rows && c < cols;
      cp_async4(dst + r * dld + c, ok ? src + (size_t)r * sld + c : src, ok);
    }
  }
}

// act with the id fixed at compile time, or (A < 0) read at run time
template <int A>
__device__ __forceinline__ float act_t(float v, int runtime_id) {
  return act(v, A < 0 ? runtime_id : A);
}

}  // namespace mma
}  // namespace ffcnn_block
