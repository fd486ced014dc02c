// The int8 convolution of an int8 plan, NHWC: int8 activations times int8
// weights, int32 accumulation, one fused float32 epilogue
//
//   y = act(acc * eff[f] + bias[f])        eff = w_scale * x_scale
//
// stored as float32, bfloat16, or int8 codes clip(rint(y * inv), -127, 127)
// at a scalar or per-channel inv = 1 / out_scale; or (the check's raw mode)
// the int32 accumulators themselves.
//
// A uint8 mode (the dense path) runs conv-1 straight off the raw pixels,
// the port of ffcnn_tpu/ops/conv.py::conv0_int8_from_u8: each pixel is
// shifted to a code by x ^ 0x80 (x - 128) as the A tile is gathered, a
// tap outside the image reads code 0 in the shifted domain (JAX pads the
// shifted input with zeros), and the epilogue adds back the shift exactly,
//
//   y = act((acc + m128[pixel, f]) * eff[f] + bias[f])
//
// where m128 = 128 * conv(ones, wq) counts each output pixel's in-bounds
// taps (made once a Net and geometry by the wrapper).  Every term of
// acc + m128 is an integer below 27 * 127 * 255 < 2^24, so the sum is
// exact in float32 and the kernel equals its plain version bit for bit.
//
// Replaces the XLA convolution with int8 operands of
// ffcnn_tpu/ops/conv.py::conv2d_int8 (lax.conv_general_dilated with
// preferred_element_type=int32, which an int8 plan runs for every conv on
// an int8 blob outside the fused runs).  PyTorch has no int8 convolution on
// the card.
//
// Two paths, one epilogue:
//
// * dense (groups == 1, any k x k, stride, pad): an implicit GEMM, rows =
//   output pixels, columns = filters, K = k*k*C in (ky, kx, c) order,
//   padded with zero weights to a multiple of 32 (the wrapper repacks the
//   weights once, when the plan is installed, to (F, Kp)).  A CTA of four
//   warps owns 64 rows x 64 filters and walks K in steps of 32 bytes; each
//   step's A tile (gathered from the NHWC input, taps outside the image
//   read as code 0, which is 0.0 in a symmetric scheme, as XLA's zero pad)
//   and B tile go to shared memory in two buffers, by 16-byte cp.async
//   where C is a multiple of 16 (one tap a 16 bytes) and by 4- or 1-byte
//   loads otherwise, the next step's tiles on their way while this one
//   computes.  A warp holds 32 x 32 of the output in int32 fragments and
//   runs mma.sync.m16n8k32.s8.s8.s32 on the int8 tensor cores.  Rows of
//   the tiles are 48 bytes apart, so the fragment loads (rows g, words t)
//   fall in 32 distinct banks.
// * grouped and depthwise: int32 multiply-adds on the CUDA cores, a thread
//   a (pixel, filter); depthwise (one input channel a filter) with C a
//   multiple of 4 takes four channels a thread by char4 loads, and a
//   grouped conv with a multiple of 4 input channels a group sums four
//   products a __dp4a.
//
// Bound on this card: xl's int8 convs are 1x1 convs of 48-384 channels and
// 3x3 depthwise convs, a few operations a byte, so the bytes bound them (the
// input read and the output written once: int8 in, int8 or bf16 out); the
// int8 tensor cores' 1,979 TOP/s are far away.  This first version aims to
// be right: a later one takes wgmma and TMA.
//
// The epilogue rounds as the plain version does: the product and the sum
// are separate roundings (__fmul_rn, __fadd_rn: no FMA contraction), and
// the requantize rounds half to even (__float2int_rn, as torch.round and
// jnp.round).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_fused.cuh"

namespace {

constexpr int kThreads = 128;  // the dense CTA: four warps
constexpr int kBM = 64;        // output pixels a dense CTA
constexpr int kBN = 64;        // filters a dense CTA
constexpr int kBK = 32;        // K bytes a step (one m16n8k32)
constexpr int kLd = 48;        // bytes between tile rows in shared memory
constexpr int kEwThreads = 256;

enum OutKind { kF32 = 0, kBf16 = 1, kI8 = 2, kI32 = 3 };

struct ConvArgs {
  const int8_t* x;
  const int8_t* wp;
  const float* eff;
  const float* bias;
  const float* inv;
  const float* m128;  // uint8 mode: (oh * ow, f), else null
  void* y;
  int n, h, w, c, f, k, stride, pad, groups, oh, ow, kp, ktot, act;
  int out_kind, inv_vec, x_u8;
};

// Output (m, o), m the pixel (image, oy, ox) in row-major order.
__device__ __forceinline__ void emit(const ConvArgs& a, size_t m, int o,
                                     int acc) {
  const size_t at = m * a.f + o;
  if (a.out_kind == kI32) {
    static_cast<int*>(a.y)[at] = acc;
    return;
  }
  float s = (float)acc;
  if (a.m128 != nullptr)  // the uint8 mode's shift, per pixel (exact)
    s = __fadd_rn(s, a.m128[(m % ((size_t)a.oh * a.ow)) * a.f + o]);
  float v = __fadd_rn(__fmul_rn(s, a.eff[o]), a.bias[o]);
  v = ffcnn_block::act(v, a.act);
  if (a.out_kind == kI8)
    ffcnn_block::store_q(static_cast<int8_t*>(a.y) + at, v,
                         a.inv[a.inv_vec ? o : 0]);
  else if (a.out_kind == kBf16)
    static_cast<__nv_bfloat16*>(a.y)[at] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(a.y)[at] = v;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

// The dense path.  mode: how the A tile is gathered, 0 one 16-byte
// cp.async a thread (C % 16 == 0, x 16-byte aligned, int8 x), 1 four
// 4-byte loads (C % 4 == 0), 2 sixteen byte loads.  Modes 1 and 2 shift
// uint8 pixels to codes (x ^ 0x80) as they load them.
__global__ void __launch_bounds__(kThreads)
    conv_int8_dense_kernel(const __grid_constant__ ConvArgs a, int mode) {
  __shared__ __align__(16) int8_t as[2][kBM * kLd];
  __shared__ __align__(16) int8_t bs[2][kBN * kLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long npix = (long long)a.oh * a.ow;
  const long long rows = (long long)a.n * npix;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int f0 = blockIdx.y * kBN;
  // the tile row this thread loads (A: a pixel, B: a filter), and which
  // half of the step's 32 bytes
  const int row = tid >> 1, half = tid & 1;
  const long long m = m0 + row;
  const bool mrow = m < rows;
  int iy0 = 0, ix0 = 0;
  const int8_t* ximg = a.x;
  if (mrow) {
    const long long img = m / npix;
    const int rem = (int)(m - img * npix), oy = rem / a.ow;
    iy0 = oy * a.stride - a.pad;
    ix0 = (rem - oy * a.ow) * a.stride - a.pad;
    ximg = a.x + (size_t)img * a.h * a.w * a.c;
  }
  const bool frow = f0 + row < a.f;
  const int8_t* wrow =
      a.wp + (size_t)(frow ? f0 + row : 0) * a.kp + half * 16;

  // the step at k0 into buffer st
  auto load = [&](int st, int k0) {
    cp_async16(&bs[st][row * kLd + half * 16], wrow + k0, frow);
    int8_t* dst = &as[st][row * kLd + half * 16];
    const int kk0 = k0 + half * 16;
    if (mode == 0) {
      const int tap = kk0 / a.c, ci = kk0 - tap * a.c;
      const int ky = tap / a.k, iy = iy0 + ky, ix = ix0 + tap - ky * a.k;
      const bool ok = mrow && kk0 < a.ktot && iy >= 0 && iy < a.h &&
                      ix >= 0 && ix < a.w;
      cp_async16(dst, ok ? ximg + ((size_t)iy * a.w + ix) * a.c + ci : a.x,
                 ok);
    } else {
      const int step = mode == 1 ? 4 : 1;
      for (int j = 0; j < 16; j += step) {
        const int kk = kk0 + j;
        const int tap = kk / a.c, ci = kk - tap * a.c;
        const int ky = tap / a.k, iy = iy0 + ky, ix = ix0 + tap - ky * a.k;
        const bool ok = mrow && kk < a.ktot && iy >= 0 && iy < a.h &&
                        ix >= 0 && ix < a.w;
        const int8_t* src = ximg + ((size_t)iy * a.w + ix) * a.c + ci;
        if (step == 4)
          *reinterpret_cast<uint32_t*>(dst + j) =
              ok ? *reinterpret_cast<const uint32_t*>(src) ^
                       (a.x_u8 ? 0x80808080u : 0u)
                 : 0u;
        else
          dst[j] = ok ? (int8_t)(*src ^ (a.x_u8 ? 0x80 : 0)) : (int8_t)0;
      }
    }
    cp_commit();
  };

  const int wm = warp & 1, wn = warp >> 1;  // the warp's 32 x 32
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][j][u] = 0;

  const int nk = a.kp / kBK;
  load(0, 0);
  for (int ks = 0; ks < nk; ++ks) {
    const int st = ks & 1;
    if (ks + 1 < nk) {
      load(st ^ 1, (ks + 1) * kBK);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // step ks's tiles are in
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* p = &as[st][(wm * 32 + i * 16 + g) * kLd + 4 * t];
      af[i][0] = *reinterpret_cast<const uint32_t*>(p);
      af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd);
      af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* p = &bs[st][(wn * 32 + j * 8 + g) * kLd + 4 * t];
      bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
      bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    __syncthreads();  // done with buffer st before step ks + 2 refills it
  }

  // fragment (row g + 8h, columns 2t + u) of each 16 x 8 tile
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long mm = m0 + wm * 32 + i * 16 + g + 8 * h;
      if (mm >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int o = f0 + wn * 32 + j * 8 + 2 * t + u;
          if (o < a.f) emit(a, (size_t)mm, o, acc[i][j][2 * h + u]);
        }
    }
}

// Depthwise, C % 4 == 0: a thread a (pixel, four channels), char4 loads of
// the input and of the (k, k, F) weights.
__global__ void __launch_bounds__(kEwThreads)
    conv_int8_dw4_kernel(const __grid_constant__ ConvArgs a) {
  const int nq = a.f >> 2;
  const long long npix = (long long)a.oh * a.ow;
  const long long i = (long long)blockIdx.x * kEwThreads + threadIdx.x;
  if (i >= a.n * npix * nq) return;
  const int q = (int)(i % nq);
  const long long m = i / nq, img = m / npix;
  const int rem = (int)(m - img * npix), oy = rem / a.ow, ox = rem - oy * a.ow;
  const int8_t* ximg = a.x + (size_t)img * a.h * a.w * a.c + 4 * q;
  int s[4] = {0, 0, 0, 0};
  for (int ky = 0; ky < a.k; ++ky) {
    const int iy = oy * a.stride - a.pad + ky;
    if (iy < 0 || iy >= a.h) continue;
    for (int kx = 0; kx < a.k; ++kx) {
      const int ix = ox * a.stride - a.pad + kx;
      if (ix < 0 || ix >= a.w) continue;
      const char4 xv =
          *reinterpret_cast<const char4*>(ximg + ((size_t)iy * a.w + ix) * a.c);
      const char4 wv = *reinterpret_cast<const char4*>(
          a.wp + (size_t)(ky * a.k + kx) * a.f + 4 * q);
      s[0] += (int)xv.x * wv.x;
      s[1] += (int)xv.y * wv.y;
      s[2] += (int)xv.z * wv.z;
      s[3] += (int)xv.w * wv.w;
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) emit(a, (size_t)m, 4 * q + u, s[u]);
}

// Any grouped conv: a thread a (pixel, filter), the (F, k, k, C/groups)
// weights; vec: C/groups and C multiples of 4, four products a __dp4a.
__global__ void __launch_bounds__(kEwThreads)
    conv_int8_grouped_kernel(const __grid_constant__ ConvArgs a, int vec) {
  const long long npix = (long long)a.oh * a.ow;
  const long long i = (long long)blockIdx.x * kEwThreads + threadIdx.x;
  if (i >= a.n * npix * a.f) return;
  const int o = (int)(i % a.f);
  const long long m = i / a.f, img = m / npix;
  const int rem = (int)(m - img * npix), oy = rem / a.ow, ox = rem - oy * a.ow;
  const int icg = a.c / a.groups, grp = o / (a.f / a.groups);
  const int8_t* ximg = a.x + (size_t)img * a.h * a.w * a.c + grp * icg;
  int s = 0;
  for (int ky = 0; ky < a.k; ++ky) {
    const int iy = oy * a.stride - a.pad + ky;
    if (iy < 0 || iy >= a.h) continue;
    for (int kx = 0; kx < a.k; ++kx) {
      const int ix = ox * a.stride - a.pad + kx;
      if (ix < 0 || ix >= a.w) continue;
      const int8_t* xp = ximg + ((size_t)iy * a.w + ix) * a.c;
      const int8_t* wq = a.wp + ((size_t)(o * a.k + ky) * a.k + kx) * icg;
      if (vec) {
        for (int ci = 0; ci < icg; ci += 4)
          s = __dp4a(*reinterpret_cast<const int*>(xp + ci),
                     *reinterpret_cast<const int*>(wq + ci), s);
      } else {
        for (int ci = 0; ci < icg; ++ci) s += (int)xp[ci] * wq[ci];
      }
    }
  }
  emit(a, (size_t)m, o, s);
}

}  // namespace

extern "C" {

// x (n, h, w, c) int8, contiguous; with x_u8, uint8 pixels (groups == 1
// only) and m128 (oh * ow, f) float32, the uint8 mode.  wp: the packed int8 weights: groups ==
// 1 (F, kp), K in (ky, kx, c) order, zero past k*k*c, kp a multiple of 32,
// 16-byte aligned; depthwise (c == groups == f) with c % 4 == 0 (k, k, f),
// x and wp 4-byte aligned; any other grouped conv (f, k, k, c / groups).  eff, bias: (f,) float32;
// inv: (f,) float32 where inv_vec, else (1,), read for out_kind 2 only.  y
// (n, oh, ow, f): float32 (out_kind 0), bfloat16 (1), int8 (2) or the int32
// accumulators (3).  Returns cudaErrorInvalidValue for arguments it cannot
// take, else cudaGetLastError().
int ffcnn_conv_int8(const void* x, const void* wp, const void* eff,
                    const void* bias, const void* inv, int inv_vec,
                    const void* m128, int x_u8, void* y, int out_kind, int n,
                    int h, int w, int c, int f, int k, int stride, int pad,
                    int groups, int oh, int ow, int kp, int act,
                    void* stream) {
  if (groups < 1 || c < 1 || f < 1 || k < 1 || stride < 1 || pad < 0 ||
      c % groups || f % groups || out_kind < 0 || out_kind > 3 ||
      (out_kind == 2 && inv == nullptr) || n < 0 || oh < 0 || ow < 0 ||
      (x_u8 && (groups != 1 || m128 == nullptr)))
    return (int)cudaErrorInvalidValue;
  ConvArgs a{(const int8_t*)x, (const int8_t*)wp, (const float*)eff,
             (const float*)bias, (const float*)inv, (const float*)m128, y,
             n, h, w, c, f, k, stride, pad, groups, oh, ow, kp, k * k * c,
             act, out_kind, inv_vec, x_u8 ? 1 : 0};
  const long long rows = (long long)n * oh * ow;
  if (rows == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (groups == 1) {
    if (kp % kBK || kp < k * k * c || (uintptr_t)wp % 16 ||
        (rows + kBM - 1) / kBM > 0x7fffffffLL || (f + kBN - 1) / kBN > 65535)
      return (int)cudaErrorInvalidValue;
    const int mode = !x_u8 && c % 16 == 0 && (uintptr_t)x % 16 == 0 ? 0
                     : c % 4 == 0 && (uintptr_t)x % 4 == 0 ? 1
                                                            : 2;
    const dim3 grid((unsigned)((rows + kBM - 1) / kBM), (f + kBN - 1) / kBN);
    conv_int8_dense_kernel<<<grid, kThreads, 0, s>>>(a, mode);
    return (int)cudaGetLastError();
  }
  const bool dw4 = c == groups && f == groups && c % 4 == 0;
  if (dw4 && ((uintptr_t)x % 4 || (uintptr_t)wp % 4))
    return (int)cudaErrorInvalidValue;
  const long long items = rows * (dw4 ? f / 4 : f);
  const long long blocks = (items + kEwThreads - 1) / kEwThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dw4) {
    conv_int8_dw4_kernel<<<(unsigned)blocks, kEwThreads, 0, s>>>(a);
  } else {
    const int icg = c / groups;
    const int vec = icg % 4 == 0 && c % 4 == 0 && (uintptr_t)x % 4 == 0 &&
                    (uintptr_t)wp % 4 == 0;
    conv_int8_grouped_kernel<<<(unsigned)blocks, kEwThreads, 0, s>>>(a, vec);
  }
  return (int)cudaGetLastError();
}

const char* ffcnn_conv_int8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
