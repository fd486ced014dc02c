// The int8 convolution of an int8 plan, NHWC: int8 activations times int8
// weights, int32 accumulation, one fused float32 epilogue
//
//   y = act(acc * eff[f] + bias[f])        eff = w_scale * x_scale
//
// stored as float32, bfloat16, or int8 codes clip(rint(y * inv), -127, 127)
// at a scalar or per-channel inv = 1 / out_scale; or (the check's raw mode)
// the int32 accumulators themselves.
//
// A uint8 mode (the u8 path) runs conv-1 straight off the raw pixels, the
// port of ffcnn_tpu/ops/conv.py::conv0_int8_from_u8.  JAX shifts each pixel
// to a code x - 128 and adds the shift back in the epilogue, (acc + 128 M);
// both sides of that equal the one integer
//
//   S[pixel, f] = sum over the pixel's in-bounds taps of wq * x
//
// which the card computes directly: its integer mma takes unsigned A with
// signed B (m16n8k32 .u8.s8), so the pixels go in as they are and a tap
// outside the image is byte 0.  Every S is below 27 * 127 * 255 < 2^24,
// exact in float32, so y = act(S * eff[f] + bias[f]) equals the plain
// version's act((acc + m128) * eff + bias) bit for bit.  No shift and no
// m128 on the card; only the raw mode (the checks' int32 accumulators,
// JAX's acc of the shifted codes) subtracts 128 T, T the sum of the codes
// of the pixel's in-bounds taps.
//
// Replaces the XLA convolution with int8 operands of
// ffcnn_tpu/ops/conv.py::conv2d_int8 (lax.conv_general_dilated with
// preferred_element_type=int32, which an int8 plan runs for every conv on
// an int8 blob outside the fused runs).  PyTorch has no int8 convolution on
// the card.
//
// Bound on this card: xl's int8 convs are 1x1 convs of 32-384 channels and
// 3x3 and 5x5 depthwise convs, a few operations a byte, so the bytes bound
// them (the input read and the output written once: int8 in, int8 or bf16
// out); the int8 tensor cores' 1,979 TOP/s are far away.  What held the
// first version back was latency and instructions, not bytes: dead filter
// columns, two barriers a 32-byte K step, a depthwise tap's two global
// loads, and an epilogue that switched on the activation and the output
// kind for every output.  ffcnn_conv_int8 routes each call by its shape,
// dtype and alignment alone (route_of), one path a call:
//
// * gemm (groups == 1, int8 codes in, C a multiple of 16, x, wp and y
//   16-byte aligned): an implicit GEMM, rows = output pixels, columns =
//   filters, K = k*k*C in (ky, kx, c) order padded with zero weights to
//   Kp, a multiple of 32 (the wrapper packs the weights once, when the
//   plan is installed, to (F, Kp)).  The CTA's filter tile BN follows F
//   (16, 32 or 64; F past 64 takes tiles of 64, which measured faster
//   than 128 on every shape of xl and v8n), so no warp computes a dead
//   column at F 16, and n8 steps past F are skipped: four warps, 4 x 1 of
//   32 x 16 at BN 16 (128 pixels), else 2 x 2 of 32 x BN / 2 (64 pixels).
//   The (BN, Kp) slice of the weights stays in shared memory where it
//   fits kGemmWres, else it streams beside A.  Persistent CTAs walk the
//   pixel tiles; A (gathered from the NHWC input by 16-byte cp.async, a
//   tap outside the image read as code 0, XLA's zero pad) streams in
//   64-byte K steps through a ring of kGemmStages with one barrier a step,
//   the next tile's steps loading while this one finishes.
//   mma.sync.m16n8k32.s8.s8.s32 on the int8 tensor cores.  The epilogue
//   holds eff, bias and inv of a thread's fragment columns in registers,
//   fixes the activation and output kind once a tile (with_epilogue),
//   packs the outputs into a shared stage and writes 16-byte runs of each
//   pixel's row (at F 16 an int8 row is one run).
// * dw (depthwise, c == groups == f, C a multiple of 16, 3x3 or 5x5,
//   stride 1 or 2, aligned as gemm): a CTA owns a 16-channel slice and
//   walks tiles of output rows x columns; each tile's input window with
//   its halo, (th - 1) * s + k rows, comes into shared memory once by
//   16-byte cp.async (stride 2: even and odd columns in two planes, so a
//   warp's reads fall in distinct banks), double-buffered across the
//   CTA's tiles.  A thread computes four channels of kDwRows outputs down
//   a column (half as many where the output is under 2 kDwRows high),
//   loads each input row's words once for every output row they feed and
//   sums four taps a __dp4a (one channel's bytes gathered by __byte_perm,
//   the weights packed likewise once a CTA); the epilogue, from registers
//   with the activation and kind fixed, packs the outputs into a stage
//   written out 16 bytes a thread.
// * u8 (the uint8 mode, any shape): bands of R output rows x up to 512
//   columns of one image, walked by persistent CTAs of four warps; a
//   band's (R - 1) * s + k input rows come into shared memory once, the
//   pad row and columns as zero bytes, by 16-byte cp.async where a row is
//   a multiple of 16 bytes (and x aligned), else by 4-byte words shifted
//   into place, into one of two buffers while the CTA computes the other
//   (conv0_fused.cu's staging).  A warp tile is 16 pixels of one output
//   row by all F filters (F / 8 n8 tiles: no dead column at F 8 or 16).
//   The stems of the repo's models (k 3, C 3, pad 1, stride 1 or 2, F 8,
//   16 or 32) take an instance with F and the stride fixed: K = 27 is one
//   k-step in an order chosen for the gather (lanes t < 3 take row t's
//   bytes 0..3 and 4..7, lane 3 the three rows' byte 8), so a pixel's A
//   words are three aligned shared-memory words and three __byte_perm a
//   lane, with selectors fixed for the launch (a tile starts on a 16-pixel
//   boundary); the B fragments, permuted to match, sit in registers for
//   the launch.  Any other uint8-mode shape takes the generic instance:
//   K walked in steps of 32 in (ky, kx, c) order, each lane's taps
//   decoded once a step, F in passes of four n8 tiles, masked.  The
//   epilogue as gemm's (activation and kind fixed once a tile; 16-byte
//   runs of each pixel's row out of a staged tile where F bytes allow).
// * dense (groups == 1 and C not a multiple of 16, int8 codes): the first
//   version.  A CTA of four warps owns 64 rows x 64 filters and walks K in
//   32-byte steps through two buffers, the A tile gathered by 4- or 1-byte
//   loads; epilogue element by element.
// * dw4 (depthwise with C % 4 == 0 that dw does not take) and grouped (any
//   other grouped conv): int32 multiply-adds on the CUDA cores, a thread a
//   (pixel, four channels) by char4 loads, or a (pixel, filter) with four
//   products a __dp4a where C/groups is a multiple of 4.
//
// The epilogue rounds as the plain version does: the product and the sum
// are separate roundings (__fmul_rn, __fadd_rn: no FMA contraction), and
// the requantize rounds half to even (__float2int_rn, as torch.round and
// jnp.round).  The int32 sums are exact in any order, so every path equals
// the plain version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <type_traits>
#include <vector>

#include "block_fused.cuh"

namespace {

constexpr int kThreads = 128;  // the dense CTA: four warps
constexpr int kBM = 64;        // output pixels a dense CTA
constexpr int kBN = 64;        // filters a dense CTA
constexpr int kBK = 32;        // K bytes a step (one m16n8k32)
constexpr int kLd = 48;        // bytes between tile rows in shared memory
constexpr int kEwThreads = 256;
// the gemm path: threads a CTA, K bytes a ring stage (two m16n8k32
// steps), ring stages, bytes between A rows (an odd multiple of 16: the
// fragment loads of rows g, words t fall in 32 distinct banks), and the
// largest (BN, Kp + 16) weight slice kept in shared memory
constexpr int kGemmThreads = 128;
constexpr int kGemmSK = 64;
constexpr int kGemmStages = 3;
constexpr int kGemmALd = kGemmSK + 16;
constexpr int kGemmWres = 16 * 1024;
// the dw path: threads a CTA, channels a slice (16 bytes a pixel), output
// rows a thread (half of them where the output is under twice as high),
// the widest tile
constexpr int kDwThreads = 256;
constexpr int kDwSlice = 16;
constexpr int kDwRows = 8;
constexpr int kDwMaxTw = 32;
// the u8 path: threads a CTA, output columns a band at most, n8 tiles a
// pass of its generic instance
constexpr int kU8Threads = 128;
constexpr int kU8Warps = kU8Threads / 32;
constexpr int kU8MaxCols = 512;
constexpr int kU8Nt = 4;
constexpr int kSmemMax = 232448;  // the most a CTA can take on sm_90

enum OutKind { kF32 = 0, kBf16 = 1, kI8 = 2, kI32 = 3 };

struct ConvArgs {
  const int8_t* x;
  const int8_t* wp;
  const float* eff;
  const float* bias;
  const float* inv;
  void* y;
  int n, h, w, c, f, k, stride, pad, groups, oh, ow, kp, ktot, act;
  int out_kind, inv_vec, x_u8;  // x_u8: x holds uint8 pixels (the u8 path)
};

// Output (m, o), m the pixel (image, oy, ox) in row-major order.
__device__ __forceinline__ void emit(const ConvArgs& a, size_t m, int o,
                                     int acc) {
  const size_t at = m * a.f + o;
  if (a.out_kind == kI32) {
    static_cast<int*>(a.y)[at] = acc;
    return;
  }
  float v = __fadd_rn(__fmul_rn((float)acc, a.eff[o]), a.bias[o]);
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

// unsigned A (the uint8 mode's raw pixels) times signed B
__device__ __forceinline__ void mma_u8s8(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
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

// The dense path.  mode: how the A tile is gathered, 1 four 4-byte loads
// (C % 4 == 0), 2 sixteen byte loads.
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
            ok ? *reinterpret_cast<const uint32_t*>(src) : 0u;
      else
        dst[j] = ok ? *src : (int8_t)0;
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

// ------------------------------------------------ the epilogue of dw, gemm

template <int V>
using IntC = std::integral_constant<int, V>;

// f(IntC<act>, IntC<kind>): the epilogue's activation and output kind fixed
// at compile time, chosen once a tile (a switch per output would keep the
// outputs of a thread apart; this way they interleave).
template <typename F>
__device__ __forceinline__ void with_epilogue(int act, int kind, F&& f) {
  if (kind == kI32) return f(IntC<0>{}, IntC<kI32>{});
  auto by_kind = [&](auto A) {
    if (kind == kI8) f(A, IntC<kI8>{});
    else if (kind == kBf16) f(A, IntC<kBf16>{});
    else f(A, IntC<kF32>{});
  };
  switch (act) {
    case 1: return by_kind(IntC<1>{});
    case 2: return by_kind(IntC<2>{});
    case 3: return by_kind(IntC<3>{});
    case 4: return by_kind(IntC<4>{});
    case 5: return by_kind(IntC<5>{});
    case 6: return by_kind(IntC<6>{});
    default: return by_kind(IntC<0>{});
  }
}

// N outputs (2 or 4) of consecutive channels from their sums, packed into
// N es bytes at dst (aligned to them): the raw sums, or act(acc * eff +
// bias) (the product and the sum rounded apart) as float32, bfloat16 or
// int8 codes (store_q's arithmetic).
template <int ACT, int KIND, int N>
__device__ __forceinline__ void put_outputs(int8_t* dst, const int (&acc)[N],
                                            const float (&e)[N],
                                            const float (&b)[N],
                                            const float (&q)[N]) {
  uint32_t w[N];
  if constexpr (KIND == kI32) {
#pragma unroll
    for (int n = 0; n < N; ++n) w[n] = (uint32_t)acc[n];
  } else {
    float v[N];
#pragma unroll
    for (int n = 0; n < N; ++n)
      v[n] = ffcnn_block::act(
          __fadd_rn(__fmul_rn((float)acc[n], e[n]), b[n]), ACT);
    if constexpr (KIND == kI8) {
      uint32_t p = 0;
#pragma unroll
      for (int n = 0; n < N; ++n)
        p |= (uint32_t)(uint8_t)ffcnn_block::quant(v[n], q[n]) << (8 * n);
      if constexpr (N == 4)
        *reinterpret_cast<uint32_t*>(dst) = p;
      else
        *reinterpret_cast<uint16_t*>(dst) = (uint16_t)p;
      return;
    } else if constexpr (KIND == kBf16) {
#pragma unroll
      for (int n = 0; n < N; n += 2)
        w[n / 2] = __bfloat16_as_ushort(__float2bfloat16_rn(v[n])) |
                   (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(
                       v[n + 1])) << 16;
      if constexpr (N == 4)
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<uint32_t*>(dst) = w[0];
      return;
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) w[n] = __float_as_uint(v[n]);
    }
  }
  if constexpr (N == 4)
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
}

__host__ __device__ inline int out_bytes(int kind) {
  return kind == kI8 ? 1 : kind == kBf16 ? 2 : 4;
}

// ------------------------------------------------------------- the gemm path

// A gemm CTA: four warps over BM pixels x BN filters, 4 x 1 warps of 32 x
// 16 at BN 16, else 2 x 2 warps of 32 x BN / 2.
__host__ __device__ constexpr int gemm_bm(int bn) {
  return bn == 16 ? 128 : 64;
}

// The gemm path's shared memory, byte offsets: the A ring, the weights
// (resident (BN, Kp + 16) or a ring like A's), the output stage (BM rows
// of BN outputs of up to 4 bytes, 16 bytes apart more).
struct GemmSmem {
  int b, o, total;
};

__host__ __device__ inline GemmSmem gemm_smem(int bn, bool wres, int kp) {
  GemmSmem s;
  s.b = kGemmStages * gemm_bm(bn) * kGemmALd;
  s.o = s.b + (wres ? bn * (kp + 16) : kGemmStages * bn * kGemmALd);
  s.total = s.o + gemm_bm(bn) * (bn * 4 + 16);
  return s;
}

__host__ inline int gemm_bn(int f) { return f <= 16 ? 16 : f <= 32 ? 32 : 64; }

__host__ inline bool gemm_wres(int bn, int kp) {
  return bn * (kp + 16) <= kGemmWres;
}

// The gemm path: CTA (blockIdx.x, blockIdx.y) owns filters [BN y, BN y +
// BN) and walks pixel tiles x, x + gridDim.x, ... of mtiles.
template <int BN, bool WRES>
__global__ void __launch_bounds__(kGemmThreads)
    conv_int8_gemm_kernel(const __grid_constant__ ConvArgs a, int mtiles) {
  constexpr int BM = gemm_bm(BN), WMW = BM / 32, WN = BN / (4 / WMW);
  constexpr int NJ = WN / 8, AR = BM / 32;
  extern __shared__ __align__(16) int8_t sm[];
  const GemmSmem L = gemm_smem(BN, WRES, a.kp);
  int8_t* const as = sm;
  int8_t* const bs = sm + L.b;
  int8_t* const os = sm + L.o;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WMW, wn = warp / WMW;
  const int f0 = blockIdx.y * BN, live = min(BN, a.f - f0);
  // rows < 2^31 (route_of), so the pixel arithmetic is 32-bit
  const int npix = a.oh * a.ow, rows = a.n * npix;
  const int nks = (a.kp + kGemmSK - 1) / kGemmSK;
  const int mine = mtiles > (int)blockIdx.x
                       ? (mtiles - 1 - (int)blockIdx.x) / gridDim.x + 1
                       : 0;
  const int total = mine * nks;

  // eff, bias, inv of this thread's fragment columns (wn WN + 8 j + 2 t +
  // u; past F, the last filter's)
  float pe[NJ][2], pb[NJ][2], pq[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int o = min(f0 + wn * WN + j * 8 + 2 * t + u, a.f - 1);
      pe[j][u] = a.eff[o];
      pb[j][u] = a.bias[o];
      pq[j][u] = a.out_kind == kI8 ? a.inv[a.inv_vec ? o : 0] : 0.f;
    }
  if (WRES) {
    const int cpr = a.kp / 16, ld = a.kp + 16;
    for (int i = tid; i < BN * cpr; i += kGemmThreads) {
      const int r = i / cpr, c = i - r * cpr;
      const bool ok = r < live;
      cp_async16(bs + r * ld + c * 16,
                 ok ? a.wp + (size_t)(f0 + r) * a.kp + c * 16 : a.wp, ok);
    }
    cp_commit();
  }

  // the loader: its step (tile, ks) and slot, this thread's A rows (row0
  // + 32 i) of the tile it is loading, their images and first taps
  const int ck = tid & 3, row0 = tid >> 2;
  int ld_tile = 0, ld_ks = 0, ld_slot = 0;
  const int8_t* xrow[AR];
  int iy0[AR], ix0[AR];
  auto load = [&]() {
    const int ks = ld_ks, slot = ld_slot;
    if (ks == 0) {
      const int m0 = (blockIdx.x + ld_tile * gridDim.x) * BM;
#pragma unroll
      for (int i = 0; i < AR; ++i) {
        const int m = m0 + row0 + 32 * i;
        xrow[i] = nullptr;
        iy0[i] = ix0[i] = 0;
        if (m < rows) {
          const int img = m / npix, rem = m - img * npix, oy = rem / a.ow;
          iy0[i] = oy * a.stride - a.pad;
          ix0[i] = (rem - oy * a.ow) * a.stride - a.pad;
          xrow[i] = a.x + (size_t)img * a.h * a.w * a.c;
        }
      }
    }
    const int kk = ks * kGemmSK + ck * 16;
    if (kk < a.kp) {
      const int tap = kk / a.c, ci = kk - tap * a.c;
      const int ky = tap / a.k, kx = tap - ky * a.k;
      const bool kin = kk < a.ktot;
#pragma unroll
      for (int i = 0; i < AR; ++i) {
        const int iy = iy0[i] + ky, ix = ix0[i] + kx;
        const bool ok = xrow[i] != nullptr && kin && iy >= 0 && iy < a.h &&
                        ix >= 0 && ix < a.w;
        cp_async16(as + (slot * BM + row0 + 32 * i) * kGemmALd + ck * 16,
                   ok ? xrow[i] + ((size_t)iy * a.w + ix) * a.c + ci : a.x,
                   ok);
      }
    }
    if (!WRES) {
      for (int i = tid; i < BN * 4; i += kGemmThreads) {
        const int r = i >> 2, kb = ks * kGemmSK + (i & 3) * 16;
        if (kb < a.kp) {
          const bool ok = r < live;
          cp_async16(bs + (slot * BN + r) * kGemmALd + (i & 3) * 16,
                     ok ? a.wp + (size_t)(f0 + r) * a.kp + kb : a.wp, ok);
        }
      }
    }
    ld_slot = ld_slot + 1 == kGemmStages ? 0 : ld_slot + 1;
    if (++ld_ks == nks) {
      ld_ks = 0;
      ++ld_tile;
    }
  };

  int acc[2][NJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][j][u] = 0;

#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < total) load();
    cp_commit();
  }
  int tile = 0, ks = 0, slot = 0;
  for (int it = 0; it < total; ++it) {
    cp_wait<kGemmStages - 2>();
    __syncthreads();  // stage it is in; every thread is done with it - 1
    if (it + kGemmStages - 1 < total) load();
    cp_commit();
    const int steps = min(kGemmSK, a.kp - ks * kGemmSK) / 32;
    const int8_t* at = as + slot * BM * kGemmALd;
    const int8_t* bt = WRES ? bs + ks * kGemmSK : bs + slot * BN * kGemmALd;
    const int bld = WRES ? a.kp + 16 : kGemmALd;
#pragma unroll
    for (int s = 0; s < kGemmSK / 32; ++s) {
      if (s >= steps) break;
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = at + (wm * 32 + i * 16 + g) * kGemmALd + s * 32 +
                          4 * t;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kGemmALd);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kGemmALd + 16);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = wn * WN + j * 8;
        if (col >= live) break;  // warp-uniform: n8 steps past F
        const int8_t* p = bt + (col + g) * bld + s * 32 + 4 * t;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma_s8(acc[i][j], af[i], *reinterpret_cast<const uint32_t*>(p),
                 *reinterpret_cast<const uint32_t*>(p + 16));
      }
    }
    slot = slot + 1 == kGemmStages ? 0 : slot + 1;
    if (++ks < nks) continue;
    ks = 0;

    // the tile's epilogue: each fragment pair's outputs (rows g + 8h,
    // columns 2t, 2t + 1 of each 16 x 8 tile), the activation and kind
    // fixed once a tile, packed into the stage; then 16-byte runs of each
    // pixel's row out
    const int m0 = (blockIdx.x + tile++ * gridDim.x) * BM;
    const int es = out_bytes(a.out_kind), sld = BN * es + 16;
    with_epilogue(a.act, a.out_kind, [&](auto A, auto K) {
      constexpr int ACT = decltype(A)::value, KIND = decltype(K)::value;
      constexpr int kEs = KIND == kI8 ? 1 : KIND == kBf16 ? 2 : 4;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int pair[2] = {acc[i][j][2 * h], acc[i][j][2 * h + 1]};
            put_outputs<ACT, KIND, 2>(
                os + (wm * 32 + i * 16 + g + 8 * h) * sld +
                    (wn * WN + j * 8 + 2 * t) * kEs,
                pair, pe[j], pb[j], pq[j]);
          }
    });
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][j][u] = 0;
    __syncthreads();  // the stage is whole
    const int vrows = min(BM, rows - m0);
    int8_t* y = static_cast<int8_t*>(a.y) + ((size_t)m0 * a.f + f0) * es;
    if ((a.f * es) % 16 == 0 && (uintptr_t)a.y % 16 == 0) {
      const int cpr = live * es / 16;
      for (int i = tid; i < vrows * cpr; i += kGemmThreads) {
        const int r = i / cpr, c = i - r * cpr;
        *reinterpret_cast<uint4*>(y + (size_t)r * a.f * es + c * 16) =
            *reinterpret_cast<const uint4*>(os + r * sld + c * 16);
      }
    } else {
      for (int i = tid; i < vrows * live; i += kGemmThreads) {
        const int r = i / live, c = i - r * live;
        const int8_t* src = os + r * sld + c * es;
        int8_t* dst = y + ((size_t)r * a.f + c) * es;
        if (es == 1)
          *dst = *src;
        else if (es == 2)
          *reinterpret_cast<uint16_t*>(dst) =
              *reinterpret_cast<const uint16_t*>(src);
        else
          *reinterpret_cast<uint32_t*>(dst) =
              *reinterpret_cast<const uint32_t*>(src);
      }
    }
    // the next write of the stage follows at least one ring barrier
  }
  cp_wait<0>();
}

// --------------------------------------------------------------- the dw path

// A dw tile: rows output rows a thread, tw output columns x th output
// rows (th / rows threads' rows), its input window wr x wc pixels (wcp
// columns in shared memory: stride 2 keeps even columns, then odd, each
// plane wcp / 2 wide), and the tiles across and down the output.
struct DwTile {
  int rows, tw, th, wr, wc, wcp, tx, ty;
};

__host__ __device__ inline DwTile dw_tile(int oh, int ow, int k, int s) {
  DwTile d;
  d.rows = oh < 2 * kDwRows ? kDwRows / 2 : kDwRows;
  const int parts = (ow + kDwMaxTw - 1) / kDwMaxTw;
  d.tw = ow <= kDwMaxTw ? ow : ow % 16 == 0 ? 16 : (ow + parts - 1) / parts;
  const int fit = kDwThreads / (4 * d.tw);
  const int down = (oh + d.rows - 1) / d.rows;
  const int tr = fit < 1 ? 1 : fit < down ? fit : down;
  d.th = tr * d.rows;
  d.wr = (d.th - 1) * s + k;
  d.wc = (d.tw - 1) * s + k;
  d.wcp = s == 1 ? d.wc : 2 * ((d.wc + 1) / 2);
  d.tx = (ow + d.tw - 1) / d.tw;
  d.ty = (oh + d.th - 1) / d.th;
  return d;
}

// Two windows and the output stage (16 channels of 4 bytes a pixel, the
// widest output).
__host__ __device__ inline int dw_smem(const DwTile& d) {
  return 2 * d.wr * d.wcp * 16 + d.th * d.tw * kDwSlice * 4;
}

// Byte c (channel c) of pixel words px[0 .. 3], one tap a byte, for
// __dp4a; K 3 has three, its fourth byte is px[0]'s (its weight is 0).
template <int K>
__device__ __forceinline__ uint32_t taps4(const uint32_t (&px)[K], int c) {
  const uint32_t lo = __byte_perm(px[0], px[1], c | (4 + c) << 4);
  if constexpr (K == 3)
    return __byte_perm(lo, px[2], 0x0010 | (4 + c) << 8);
  else
    return __byte_perm(lo, __byte_perm(px[2], px[3], c | (4 + c) << 4),
                       0x5410);
}

// The dw path: CTA (blockIdx.x, blockIdx.y) owns channels [16 y, 16 y +
// 16) and walks tiles x, x + gridDim.x, ... (image, tile row, tile column);
// a thread takes four channels (q = tid & 3) of one output column and R
// (d.rows) rows in each pass over the tile.  Each input row's K pixel words
// are loaded once for every output row they feed; the taps of a row go
// four a __dp4a (the bytes of one channel gathered by __byte_perm, the
// weights packed so once a CTA; K 5's fifth tap a __dp4a of its own).
template <int K, int S, int R>
__global__ void __launch_bounds__(kDwThreads)
    conv_int8_dw_kernel(const __grid_constant__ ConvArgs a) {
  constexpr int NW = K == 3 ? 1 : 2;  // __dp4a words a row of taps
  extern __shared__ __align__(16) int8_t sm[];
  const DwTile d = dw_tile(a.oh, a.ow, K, S);
  const int wbuf = d.wr * d.wcp * 16;
  int8_t* const os = sm + 2 * wbuf;
  const int tid = threadIdx.x, q = tid & 3;
  const int c0 = blockIdx.y * kDwSlice, ch = c0 + 4 * q;
  const int per_img = d.ty * d.tx, ntiles = a.n * per_img;
  const int es = out_bytes(a.out_kind);

  // this thread's weights, (ky, channel): taps kx 0..3 a word, K 5's tap 4
  // in the low byte of a second; and its channels' eff, bias, inv
  uint32_t wk[K][4][NW];
#pragma unroll
  for (int ky = 0; ky < K; ++ky) {
    uint32_t px[K];
#pragma unroll
    for (int kx = 0; kx < K; ++kx)
      px[kx] = *reinterpret_cast<const uint32_t*>(
          a.wp + (size_t)(ky * K + kx) * a.f + ch);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wk[ky][c][0] = taps4(px, c) & (K == 3 ? 0x00ffffffu : 0xffffffffu);
      if constexpr (NW == 2) wk[ky][c][1] = (px[4] >> (8 * c)) & 0xffu;
    }
  }
  float eff[4], bias[4], inv[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    eff[c] = a.eff[ch + c];
    bias[c] = a.bias[ch + c];
    inv[c] = a.out_kind == kI8 ? a.inv[a.inv_vec ? ch + c : 0] : 0.f;
  }

  auto load = [&](int tile, int8_t* buf) {
    const int img = tile / per_img, rem = tile - img * per_img;
    const int ty = rem / d.tx;
    const int iyb = ty * d.th * S - a.pad;
    const int ixb = (rem - ty * d.tx) * d.tw * S - a.pad;
    const int8_t* xi = a.x + (size_t)img * a.h * a.w * a.c + c0;
    for (int i = tid; i < d.wr * d.wc; i += kDwThreads) {
      const int r = i / d.wc, p = i - r * d.wc;
      const int iy = iyb + r, ix = ixb + p;
      const bool ok = iy >= 0 && iy < a.h && ix >= 0 && ix < a.w;
      const int pc = S == 1 ? p : (p & 1) * (d.wcp / 2) + (p >> 1);
      cp_async16(buf + (r * d.wcp + pc) * 16,
                 ok ? xi + ((size_t)iy * a.w + ix) * a.c : a.x, ok);
    }
    cp_commit();
  };

  int tile = blockIdx.x;
  if (tile < ntiles) load(tile, sm);
  for (int b = 0; tile < ntiles; tile += gridDim.x, b ^= 1) {
    const int next = tile + gridDim.x;
    if (next < ntiles) {
      load(next, sm + (b ^ 1) * wbuf);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // this tile's window is in
    const uint32_t* win = reinterpret_cast<const uint32_t*>(sm + b * wbuf);
    const int img = tile / per_img, rem = tile - img * per_img;
    const int ty = rem / d.tx, tx = rem - ty * d.tx;
    const int items = 4 * d.tw * (d.th / R);
    for (int it = tid; it < items; it += kDwThreads) {
      const int x = (it >> 2) % d.tw, tr = (it >> 2) / d.tw;
      int acc[R][4];
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0;
      // input row r of the thread's window feeds output rows j with
      // ky = r - j S in [0, K): its words are loaded once for all of them
      const uint32_t* wrow = win + (tr * R * S * d.wcp) * 4 + q;
#pragma unroll
      for (int r = 0; r < (R - 1) * S + K; ++r) {
        uint32_t px[K];
#pragma unroll
        for (int kx = 0; kx < K; ++kx)
          px[kx] = wrow[(r * d.wcp +
                         (S == 1 ? x + kx
                                 : (kx & 1) * (d.wcp / 2) + x + (kx >> 1))) *
                        4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t t4 = taps4(px, c);
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const int ky = r - j * S;
            if (ky >= 0 && ky < K) {
              acc[j][c] = __dp4a((int)t4, (int)wk[ky][c][0], acc[j][c]);
              if constexpr (NW == 2)
                acc[j][c] = __dp4a((int)(px[K - 1] >> (8 * c)),
                                   (int)wk[ky][c][1], acc[j][c]);
            }
          }
        }
      }
      with_epilogue(a.act, a.out_kind, [&](auto A, auto K_) {
        constexpr int ACT = decltype(A)::value, KIND = decltype(K_)::value;
        constexpr int kEs = KIND == kI8 ? 1 : KIND == kBf16 ? 2 : 4;
#pragma unroll
        for (int j = 0; j < R; ++j)
          put_outputs<ACT, KIND, 4>(
              os + (((tr * R + j) * d.tw + x) * kDwSlice + 4 * q) * kEs,
              acc[j], eff, bias, inv);
      });
    }
    __syncthreads();  // the stage is whole; the window is free to refill
    // 16 bytes a thread: es of them a pixel's slice
    int8_t* y = static_cast<int8_t*>(a.y) + (size_t)c0 * es;
    for (int i = tid; i < d.th * d.tw * es; i += kDwThreads) {
      const int pix = i / es, part = i - pix * es;
      const int ly = pix / d.tw, lx = pix - ly * d.tw;
      const int oy = ty * d.th + ly, ox = tx * d.tw + lx;
      if (oy >= a.oh || ox >= a.ow) continue;
      *reinterpret_cast<uint4*>(
          y + (((size_t)img * a.oh + oy) * a.ow + ox) * a.c * es +
          part * 16) = *reinterpret_cast<const uint4*>(os + i * 16);
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

// --------------------------------------------------------------- the u8 path

// A band's staged row starts p16 = align_up(c * pad, 16) bytes before input
// column s * c0 (16-byte aligned where c * w is), so a pixel's first tap
// lies at lead + c * s * (its column in the band), lead = p16 - c * pad;
// the stems' lead (c 3, pad 1) is 13.
constexpr int kU8Lead = 13;

// A u8 launch as the host plans it: output rows and columns a band (the
// columns a multiple of 16), the staged row stride (48 mod 128 bytes: the
// three rows a gather instruction reads fall in mostly distinct banks),
// the lead and p16, the 16-byte chunks staged a row, the bands down and
// across, the copy path, and in shared memory a band buffer's bytes and
// the byte offsets of the output stages (16 pixels a warp, osld bytes a
// pixel; the stem instances) and of the raw mode's tap-sum table.
struct U8Plan {
  int rows, cols, ld, lead, p16, nchunk, bands_h, bands_w, aligned;
  int sbuf, ostage, osld, tsum;
};

struct U8Band {
  int img, r0, c0, nr, nc;
};

__device__ __forceinline__ U8Band u8_band(const ConvArgs& a,
                                          const U8Plan& p, int i) {
  const int per_img = p.bands_h * p.bands_w;
  U8Band b;
  b.img = i / per_img;
  const int rem = i - b.img * per_img, bh = rem / p.bands_w;
  b.r0 = bh * p.rows;
  b.c0 = (rem - bh * p.bands_w) * p.cols;
  b.nr = min(p.rows, a.oh - b.r0);
  b.nc = min(p.cols, a.ow - b.c0);
  return b;
}

// Bytes [rb, rb + 4) of the input row that starts at byte `row` of x, 0
// outside the row, as one little-endian word (two aligned loads and a
// funnel shift inside x, else byte by byte).
__device__ __forceinline__ uint32_t u8_row_word(const ConvArgs& a,
                                                long long row, long long rb) {
  const long long rbytes = (long long)a.c * a.w;
  const uint8_t* x = reinterpret_cast<const uint8_t*>(a.x);
  const uintptr_t base = (uintptr_t)x;
  const uintptr_t end = base + (uintptr_t)((long long)a.n * a.h * rbytes);
  if (rb >= 0 && rb + 4 <= rbytes) {
    const uintptr_t at = base + (uintptr_t)(row + rb);
    const uintptr_t w0 = at & ~(uintptr_t)3;
    const int sh = (int)(at & 3);
    if (w0 >= base && w0 + 8 <= end) {
      const uint32_t lo = __ldg(reinterpret_cast<const uint32_t*>(w0));
      if (sh == 0) return lo;
      const uint32_t hi = __ldg(reinterpret_cast<const uint32_t*>(w0 + 4));
      return __funnelshift_r(lo, hi, 8 * sh);
    }
  }
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (rb + i >= 0 && rb + i < rbytes)
      v |= (uint32_t)__ldg(x + row + rb + i) << (8 * i);
  return v;
}

// Stage band b's input rows s r0 - pad, ... into buf (row stride p.ld):
// nchunk 16-byte chunks a row from byte c s c0 - p16 of the input row, the
// rows and bytes outside the image as zeros.  The aligned path only starts
// its copies (cp.async; the caller commits), the word path stores before
// it returns.
__device__ __forceinline__ void u8_stage(const ConvArgs& a, const U8Plan& p,
                                         const U8Band& b, uint8_t* buf) {
  const long long rbytes = (long long)a.c * a.w;
  const long long seg0 = (long long)a.c * a.stride * b.c0 - p.p16;
  const int in_rows = (b.nr - 1) * a.stride + a.k;
  const int iy0 = b.r0 * a.stride - a.pad;
  if (p.aligned) {
    for (int i = threadIdx.x; i < in_rows * p.nchunk; i += kU8Threads) {
      const int r = i / p.nchunk, ch = i - r * p.nchunk;
      const int gy = iy0 + r;
      const long long rb = seg0 + 16LL * ch;
      const bool ok = gy >= 0 && gy < a.h && rb >= 0 && rb < rbytes;
      cp_async16(buf + r * p.ld + 16 * ch,
                 ok ? a.x + ((long long)b.img * a.h + gy) * rbytes + rb
                    : a.x,
                 ok);
    }
  } else {
    const int nw = p.nchunk * 4;
    for (int i = threadIdx.x; i < in_rows * nw; i += kU8Threads) {
      const int r = i / nw, q = i - r * nw;
      const int gy = iy0 + r;
      *reinterpret_cast<uint32_t*>(buf + r * p.ld + 4 * q) =
          gy < 0 || gy >= a.h
              ? 0u
              : u8_row_word(a, ((long long)b.img * a.h + gy) * rbytes,
                            seg0 + 4LL * q);
    }
  }
}

// One output from its sum: the raw sum, or act(acc * eff + bias) (the
// product and the sum rounded apart) as float32, bfloat16 or an int8 code.
template <int ACT, int KIND>
__device__ __forceinline__ void put_one(int8_t* dst, int acc, float e,
                                        float b, float q) {
  if constexpr (KIND == kI32) {
    *reinterpret_cast<int*>(dst) = acc;
  } else {
    const float v =
        ffcnn_block::act(__fadd_rn(__fmul_rn((float)acc, e), b), ACT);
    if constexpr (KIND == kI8)
      *dst = ffcnn_block::quant(v, q);
    else if constexpr (KIND == kBf16)
      *reinterpret_cast<__nv_bfloat16*>(dst) = __float2bfloat16_rn(v);
    else
      *reinterpret_cast<float*>(dst) = v;
  }
}

// F > 0: a stem instance (k 3, c 3, pad 1, stride S, F filters); F == 0:
// the generic one (any shape, the stride read from a).  A persistent CTA
// walks the bands blockIdx.x, + gridDim.x, ..., staging the next band into
// its second buffer while it computes this one; its warps take the band's
// tiles (16 pixels of one output row) in turn.
template <int F, int S>
__global__ void __launch_bounds__(kU8Threads)
    conv_int8_u8_kernel(const __grid_constant__ ConvArgs a,
                        const __grid_constant__ U8Plan p) {
  constexpr bool kGen = F == 0;
  constexpr int NT = kGen ? kU8Nt : F / 8;
  extern __shared__ __align__(16) uint8_t su8[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int s = kGen ? a.stride : S;
  const int nbands = a.n * p.bands_h * p.bands_w;
  const int kk = a.k * a.k;
  int8_t* const ost =
      reinterpret_cast<int8_t*>(su8 + p.ostage) + warp * 16 * p.osld;
  int* const tsum = reinterpret_cast<int*>(su8 + p.tsum);
  const bool y16 = (uintptr_t)a.y % 16 == 0;

  // the raw mode's table: (tap, f) filter f's codes of the tap summed over
  // the channels, row kk their total (the first band's barrier publishes
  // it)
  if (a.out_kind == kI32) {
    for (int i = tid; i < (kk + 1) * a.f; i += kU8Threads) {
      const int tap = i / a.f, f = i - tap * a.f;
      const int8_t* wr = a.wp + (size_t)f * a.kp;
      const int j0 = tap < kk ? tap * a.c : 0;
      const int j1 = tap < kk ? j0 + a.c : a.ktot;
      int v = 0;
      for (int j = j0; j < j1; ++j) v += wr[j];
      tsum[i] = v;
    }
  }
  // T[pixel, col], the codes of the pixel's in-bounds taps: the total less
  // the taps that fall outside the image
  auto tap_total = [&](int oy, int ox, int col) {
    int tot = tsum[kk * a.f + col];
    const int iy = oy * s - a.pad, ix = ox * s - a.pad;
    if (iy < 0 || iy + a.k > a.h || ix < 0 || ix + a.k > a.w)
      for (int ky = 0; ky < a.k; ++ky)
        for (int kx = 0; kx < a.k; ++kx)
          if (iy + ky < 0 || iy + ky >= a.h || ix + kx < 0 || ix + kx >= a.w)
            tot -= tsum[(ky * a.k + kx) * a.f + col];
    return tot;
  };

  // The stem instances' K order: lane t < 3 holds bytes 0..3 (A word a0, B
  // word b0) and 4..7 (a2, b1) of the 9-byte run of taps (kx, c) of row ky
  // = t; lane 3 holds byte 8 of rows 0, 1, 2 in a0 / b0, and its a2 meets
  // zero weights in b1.  A pixel's run starts at staged byte o = 3 S (its
  // column in the band) + kU8Lead of each of its rows; the lane reads the
  // three aligned words at (o & ~3) + d0, d1, d2 and picks its bytes with
  // __byte_perm (sel_a, sel_b), whose offset o & 3 depends on g alone
  // (tiles start every 16 pixels, 48 S bytes; pixel g + 8 lies 24 S bytes
  // on).
  uint32_t sel_a = 0, sel_b = 0;
  int d0 = 0, d1 = 0, d2 = 0;
  uint32_t bw[NT][2];
  float pe[NT][2], pb[NT][2], pq[NT][2];
  if constexpr (!kGen) {
    const uint32_t o3 = (uint32_t)(3 * S * g + kU8Lead) & 3u;
    if (t < 3) {
      sel_a = 0x3210u + 0x1111u * o3;
      sel_b = 0x3210u;
      d0 = t * p.ld;
      d1 = d0 + 4;
      d2 = d0 + 8;
    } else {
      sel_a = o3 | (4u + o3) << 4;
      sel_b = 0x0010u | (4u + o3) << 8;
      d0 = 8;
      d1 = p.ld + 8;
      d2 = 2 * p.ld + 8;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int8_t* wr = a.wp + (size_t)(8 * j + g) * a.kp;
      uint32_t w0 = 0, w1 = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k0 = t < 3 ? 9 * t + i : i < 3 ? 9 * i + 8 : -1;
        if (k0 >= 0) w0 |= (uint32_t)(uint8_t)wr[k0] << (8 * i);
        if (t < 3) w1 |= (uint32_t)(uint8_t)wr[9 * t + 4 + i] << (8 * i);
      }
      bw[j][0] = w0;
      bw[j][1] = w1;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int o = 8 * j + 2 * t + u;
        pe[j][u] = a.eff[o];
        pb[j][u] = a.bias[o];
        pq[j][u] = a.out_kind == kI8 ? a.inv[a.inv_vec ? o : 0] : 0.f;
      }
    }
  }

  if ((int)blockIdx.x < nbands)
    u8_stage(a, p, u8_band(a, p, blockIdx.x), su8);
  cp_commit();
  for (int bi = blockIdx.x, buf = 0; bi < nbands;
       bi += gridDim.x, buf ^= 1) {
    if (bi + (int)gridDim.x < nbands)
      u8_stage(a, p, u8_band(a, p, bi + gridDim.x),
               su8 + (buf ^ 1) * p.sbuf);
    cp_commit();
    cp_wait<1>();  // this band's copies
    __syncthreads();
    const U8Band bd = u8_band(a, p, bi);
    const uint8_t* staged = su8 + buf * p.sbuf;
    const int tpr = (bd.nc + 15) >> 4, ntiles = bd.nr * tpr;
    int orow = warp / tpr, cb = warp - orow * tpr;
    for (int tile = warp; tile < ntiles; tile += kU8Warps) {
      const int oc0 = 16 * cb, valid = min(16, bd.nc - oc0);
      const int oy = bd.r0 + orow;
      const size_t px0 = ((size_t)bd.img * a.oh + oy) * a.ow + bd.c0 + oc0;
      // the tile's rows in the band buffer (a pixel past the band's last
      // column reads staged bytes inside the band's width: no clamp)
      const uint8_t* rp = staged + s * orow * p.ld;
      if constexpr (!kGen) {
        uint32_t af[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint8_t* q =
              rp + ((3 * S * (oc0 + g) + kU8Lead) & ~3) + 24 * S * h;
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(q + d0);
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(q + d1);
          const uint32_t w2 = *reinterpret_cast<const uint32_t*>(q + d2);
          af[h] = __byte_perm(__byte_perm(w0, w1, sel_a), w2, sel_b);
          af[2 + h] = __byte_perm(w1, w2, sel_a);
        }
        int acc[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[j][u] = 0;
          mma_u8s8(acc[j], af, bw[j][0], bw[j][1]);
        }
        // the epilogue: each fragment pair (row g + 8h, columns 8j + 2t,
        // + 1) packed into the warp's stage, then the tile's valid pixels
        // out, F outputs each, contiguous in y
        with_epilogue(a.act, a.out_kind, [&](auto A_, auto K_) {
          constexpr int ACT = decltype(A_)::value, KIND = decltype(K_)::value;
          constexpr int kEs = KIND == kI8 ? 1 : KIND == kBf16 ? 2 : 4;
          constexpr int kRow = F * kEs;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              int pair[2] = {acc[j][2 * h], acc[j][2 * h + 1]};
              if constexpr (KIND == kI32) {
                const int ox = bd.c0 + oc0 + g + 8 * h;
#pragma unroll
                for (int u = 0; u < 2; ++u)
                  pair[u] -= 128 * tap_total(oy, ox, 8 * j + 2 * t + u);
              }
              put_outputs<ACT, KIND, 2>(
                  ost + (g + 8 * h) * p.osld + (8 * j + 2 * t) * kEs, pair,
                  pe[j], pb[j], pq[j]);
            }
          __syncwarp();
          int8_t* out = static_cast<int8_t*>(a.y) + px0 * kRow;
          bool done = false;
          if constexpr (kRow % 16 == 0) {
            if (y16) {
              constexpr int V = kRow / 16;
              for (int i = lane; i < valid * V; i += 32)
                *reinterpret_cast<uint4*>(out + 16 * i) =
                    *reinterpret_cast<const uint4*>(ost + (i / V) * p.osld +
                                                    16 * (i % V));
              done = true;
            }
          }
          if (!done)
            for (int i = lane; i < valid * F; i += 32) {
              const int r = i / F, c = i - r * F;
              const int8_t* src = ost + r * p.osld + c * kEs;
              int8_t* dst = out + i * kEs;
              if constexpr (kEs == 1)
                *dst = *src;
              else if constexpr (kEs == 2)
                *reinterpret_cast<uint16_t*>(dst) =
                    *reinterpret_cast<const uint16_t*>(src);
              else
                *reinterpret_cast<uint32_t*>(dst) =
                    *reinterpret_cast<const uint32_t*>(src);
            }
          __syncwarp();  // the stage is free for the next tile
        });
      } else {
        // the generic instance: K in (ky, kx, c) order in steps of 32, this
        // lane's eight taps decoded once a step; F in passes of NT n8 tiles
        const int c = a.c, k = a.k;
        const uint8_t* p0 = rp + c * s * (oc0 + g) + p.lead;
        const uint8_t* p1 = p0 + 8 * c * s;
        const int nks = a.kp / 32;
        for (int f0 = 0; f0 < a.f; f0 += 8 * NT) {
          int acc[NT][4];
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[j][u] = 0;
          for (int ks = 0; ks < nks; ++ks) {
            uint32_t af[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              // slots past k*k*c meet zero weights: read staged byte 0
              const int kq = 32 * ks + (e < 4 ? 4 * t + e : 12 + 4 * t + e);
              int off = 0;
              if (kq < a.ktot) {
                const int tap = kq / c, ci = kq - tap * c, ky = tap / k;
                off = ky * p.ld + c * (tap - ky * k) + ci;
              }
              const int sh = 8 * (e & 3);
              af[e < 4 ? 0 : 2] |= (uint32_t)p0[off] << sh;
              af[e < 4 ? 1 : 3] |= (uint32_t)p1[off] << sh;
            }
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const int col = f0 + 8 * j;
              if (col >= a.f) break;  // warp-uniform: n8 tiles past F
              uint32_t b0 = 0u, b1 = 0u;
              if (col + g < a.f) {
                const int8_t* wr =
                    a.wp + (size_t)(col + g) * a.kp + 32 * ks + 4 * t;
                b0 = __ldg(reinterpret_cast<const uint32_t*>(wr));
                b1 = __ldg(reinterpret_cast<const uint32_t*>(wr + 16));
              }
              mma_u8s8(acc[j], af, b0, b1);
            }
          }
          with_epilogue(a.act, a.out_kind, [&](auto A_, auto K_) {
            constexpr int ACT = decltype(A_)::value,
                          KIND = decltype(K_)::value;
            constexpr int kEs = KIND == kI8 ? 1 : KIND == kBf16 ? 2 : 4;
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                  const int col = f0 + 8 * j + 2 * t + u;
                  const int lx = oc0 + g + 8 * h;
                  if (col >= a.f || lx >= bd.nc) continue;
                  int v = acc[j][2 * h + u];
                  if constexpr (KIND == kI32)
                    v -= 128 * tap_total(oy, bd.c0 + lx, col);
                  put_one<ACT, KIND>(
                      static_cast<int8_t*>(a.y) +
                          ((px0 + g + 8 * h) * a.f + col) * kEs,
                      v, a.eff[col], a.bias[col],
                      KIND == kI8 ? a.inv[a.inv_vec ? col : 0] : 0.f);
                }
          });
        }
      }
      cb += kU8Warps;
      while (cb >= tpr) {
        cb -= tpr;
        ++orow;
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
}

// ------------------------------------------------------------------- host

// The paths, as ffcnn_conv_int8 reports them (kernels/conv_int8.py's
// ROUTES in this order).
enum Route {
  kDense = 0, kGemm = 1, kDw = 2, kDw4 = 3, kGrouped = 4, kU8 = 5
};

// The path a call takes, from its shape, dtype and alignment alone.
int route_of(const ConvArgs& a) {
  // the 16-byte paths: aligned tensors, pixel counts below 2^31
  const bool a16 = (uintptr_t)a.x % 16 == 0 && (uintptr_t)a.wp % 16 == 0 &&
                   (uintptr_t)a.y % 16 == 0 &&
                   (long long)a.n * a.oh * a.ow <= 0x7fffffffLL &&
                   (long long)a.n * a.h * a.w <= 0x7fffffffLL;
  if (a.x_u8) return kU8;
  if (a.groups == 1) return a.c % 16 == 0 && a16 ? kGemm : kDense;
  if (a.c == a.groups && a.f == a.groups) {
    if (a.c % kDwSlice == 0 && (a.k == 3 || a.k == 5) &&
        (a.stride == 1 || a.stride == 2) && a16)
      return kDw;
    if (a.c % 4 == 0) return kDw4;
  }
  return kGrouped;
}

// The CTAs of kernel k the card holds at once (at least one an SM), its
// shared-memory cap raised first where it needs more than it had.  The
// driver is asked once a kernel, device and size (an eager int8 forward
// launches the conv 29 times), and the cap is only ever raised.
template <typename Kernel>
long long resident(Kernel k, int threads, size_t smem) {
  struct Seen {
    Kernel k;
    int dev;
    size_t smem;
    long long fit;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mu);
  size_t cap = 48 * 1024;
  for (const Seen& e : seen) {
    if (e.k != k || e.dev != dev) continue;
    if (e.smem == smem) return e.fit;
    cap = std::max(cap, e.smem);
  }
  if (smem > cap)
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  int sms = 1, occ = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, threads, smem);
  const long long fit = (long long)std::max(occ, 1) * std::max(sms, 1);
  seen.push_back({k, dev, smem, fit});
  return fit;
}

template <int BN, bool WRES>
void launch_gemm(const ConvArgs& a, long long mtiles, int ntiles,
                 size_t smem, cudaStream_t s) {
  auto* k = conv_int8_gemm_kernel<BN, WRES>;
  const long long fit = resident(k, kGemmThreads, smem);
  const long long gx = std::max(1LL, std::min(mtiles, fit / ntiles));
  k<<<dim3((unsigned)gx, ntiles), kGemmThreads, smem, s>>>(a, (int)mtiles);
}

void launch_gemm(const ConvArgs& a, int bn, bool wres, long long mtiles,
                 int ntiles, size_t smem, cudaStream_t s) {
  switch (bn * 2 + wres) {
    case 32: return launch_gemm<16, false>(a, mtiles, ntiles, smem, s);
    case 33: return launch_gemm<16, true>(a, mtiles, ntiles, smem, s);
    case 64: return launch_gemm<32, false>(a, mtiles, ntiles, smem, s);
    case 65: return launch_gemm<32, true>(a, mtiles, ntiles, smem, s);
    case 128: return launch_gemm<64, false>(a, mtiles, ntiles, smem, s);
    default: return launch_gemm<64, true>(a, mtiles, ntiles, smem, s);
  }
}

// The u8 path's plan for stem instance f_inst (0: the generic one): band
// columns the output's width up to kU8MaxCols (halved while a CTA's shared
// memory would pass kSmemMax), rows the first of 4, 2, 1 that gives two
// bands an SM.  Returns the CTA's shared memory, -1 where it cannot fit.
long long plan_u8(const ConvArgs& a, int f_inst, bool raw, int sms,
                  U8Plan* out) {
  U8Plan p{};
  p.p16 = (a.c * a.pad + 15) / 16 * 16;
  p.lead = p.p16 - a.c * a.pad;
  p.aligned = (uintptr_t)a.x % 16 == 0 && ((long long)a.c * a.w) % 16 == 0;
  p.osld = f_inst ? f_inst * 4 + 16 : 0;
  const long long stages = (long long)kU8Warps * 16 * p.osld;
  const long long table = raw ? (long long)(a.k * a.k + 1) * a.f * 4 : 0;
  p.cols = std::min((a.ow + 15) / 16 * 16, kU8MaxCols);
  long long total = 0;
  for (;;) {
    // a pixel's taps end c (s (cols - 1) + k) bytes past the lead; a stem
    // lane's three words read up to 3 bytes further
    const long long need =
        p.lead + (long long)a.c * (a.stride * (p.cols - 1LL) + a.k) + 4;
    const long long ld = (need + 15) / 16 * 16;
    const long long ld48 = ld + ((48 - ld % 128) + 128) % 128;
    p.bands_w = (a.ow + p.cols - 1) / p.cols;
    for (int r : {4, 2, 1}) {
      p.rows = r;
      if ((long long)a.n * ((a.oh + r - 1) / r) * p.bands_w >= 2LL * sms)
        break;
    }
    const long long sbuf = ((p.rows - 1LL) * a.stride + a.k) * ld48;
    total = 2 * sbuf + stages + table;
    if (total <= kSmemMax || p.cols == 16) {
      p.nchunk = (int)((need + 15) / 16);
      p.ld = (int)std::min(ld48, (long long)kSmemMax);
      p.sbuf = (int)std::min(sbuf, (long long)kSmemMax);
      break;
    }
    p.cols = std::max(16, (p.cols / 2 + 15) / 16 * 16);
  }
  p.bands_h = (a.oh + p.rows - 1) / p.rows;
  p.ostage = 2 * p.sbuf;
  p.tsum = p.ostage + (int)stages;
  *out = p;
  return total <= kSmemMax ? total : -1;
}

template <int F, int S>
void launch_u8(const ConvArgs& a, const U8Plan& p, size_t smem,
               long long nbands, cudaStream_t s) {
  auto* k = conv_int8_u8_kernel<F, S>;
  const long long gx =
      std::max(1LL, std::min(nbands, resident(k, kU8Threads, smem)));
  k<<<(unsigned)gx, kU8Threads, smem, s>>>(a, p);
}

template <int K, int S, int R>
void launch_dw(const ConvArgs& a, long long ntiles, size_t smem,
               cudaStream_t s) {
  auto* k = conv_int8_dw_kernel<K, S, R>;
  const int slices = a.c / kDwSlice;
  const long long fit = resident(k, kDwThreads, smem);
  const long long gx = std::max(1LL, std::min(ntiles, fit / slices));
  k<<<dim3((unsigned)gx, slices), kDwThreads, smem, s>>>(a);
}

}  // namespace

extern "C" {

// x (n, h, w, c) int8, contiguous; with x_u8, uint8 pixels (groups == 1
// only), the uint8 mode.  wp: the packed int8 weights: groups == 1 (F,
// kp), K in (ky, kx, c) order, zero past k*k*c, kp a multiple of 32,
// 16-byte aligned; depthwise (c == groups == f) with
// c % 4 == 0 (k, k, f), x and wp 4-byte aligned; any other grouped conv
// (f, k, k, c / groups).  eff, bias: (f,) float32; inv: (f,) float32 where
// inv_vec, else (1,), read for out_kind 2 only.  y (n, oh, ow, f): float32
// (out_kind 0), bfloat16 (1), int8 (2) or the int32 accumulators (3).
// *route: the path launched (Route), -1 where none was.  Returns
// cudaErrorInvalidValue for arguments it cannot take, else
// cudaGetLastError().
int ffcnn_conv_int8(const void* x, const void* wp, const void* eff,
                    const void* bias, const void* inv, int inv_vec,
                    int x_u8, void* y, int out_kind, int n,
                    int h, int w, int c, int f, int k, int stride, int pad,
                    int groups, int oh, int ow, int kp, int act,
                    void* stream, int* route) {
  *route = -1;
  if (groups < 1 || c < 1 || f < 1 || k < 1 || stride < 1 || pad < 0 ||
      c % groups || f % groups || out_kind < 0 || out_kind > 3 ||
      (out_kind == 2 && inv == nullptr) || n < 0 || oh < 0 || ow < 0 ||
      (x_u8 && groups != 1))
    return (int)cudaErrorInvalidValue;
  ConvArgs a{(const int8_t*)x, (const int8_t*)wp, (const float*)eff,
             (const float*)bias, (const float*)inv, y,
             n, h, w, c, f, k, stride, pad, groups, oh, ow, kp, k * k * c,
             act, out_kind, inv_vec, x_u8 ? 1 : 0};
  const long long rows = (long long)n * oh * ow;
  if (rows == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int r = route_of(a);
  if (groups == 1) {
    if (kp % kBK || kp < k * k * c || (uintptr_t)wp % 16)
      return (int)cudaErrorInvalidValue;
    if (r == kU8) {
      int dev = 0, sms = 1;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      // the stems' instances: F and the stride fixed (F 8 at stride 1, which
      // no model has, takes the generic one)
      const bool stem = c == 3 && k == 3 && pad == 1 &&
                        (f == 16 || f == 32 || (f == 8 && stride == 2)) &&
                        (stride == 1 || stride == 2);
      U8Plan p;
      const long long smem =
          plan_u8(a, stem ? f : 0, out_kind == kI32, sms, &p);
      const long long nbands = (long long)n * p.bands_h * p.bands_w;
      if (smem < 0 || nbands > 0x3fffffffLL)
        return (int)cudaErrorInvalidValue;
      switch (stem ? f * 4 + stride : 0) {
        case 8 * 4 + 2: launch_u8<8, 2>(a, p, smem, nbands, s); break;
        case 16 * 4 + 1: launch_u8<16, 1>(a, p, smem, nbands, s); break;
        case 16 * 4 + 2: launch_u8<16, 2>(a, p, smem, nbands, s); break;
        case 32 * 4 + 1: launch_u8<32, 1>(a, p, smem, nbands, s); break;
        case 32 * 4 + 2: launch_u8<32, 2>(a, p, smem, nbands, s); break;
        default: launch_u8<0, 0>(a, p, smem, nbands, s); break;
      }
    } else if (r == kGemm) {
      const int bn = gemm_bn(f);
      const bool wres = gemm_wres(bn, kp);
      const long long mtiles = (rows + gemm_bm(bn) - 1) / gemm_bm(bn);
      const int ntiles = (f + bn - 1) / bn;
      const int smem = gemm_smem(bn, wres, kp).total;
      if (mtiles > 0x7fffffffLL || ntiles > 65535 || smem > kSmemMax)
        return (int)cudaErrorInvalidValue;
      launch_gemm(a, bn, wres, mtiles, ntiles, smem, s);
    } else {
      if ((rows + kBM - 1) / kBM > 0x7fffffffLL ||
          (f + kBN - 1) / kBN > 65535)
        return (int)cudaErrorInvalidValue;
      const int mode = c % 4 == 0 && (uintptr_t)x % 4 == 0 ? 1 : 2;
      const dim3 grid((unsigned)((rows + kBM - 1) / kBM),
                      (f + kBN - 1) / kBN);
      conv_int8_dense_kernel<<<grid, kThreads, 0, s>>>(a, mode);
    }
    *route = r;
    return (int)cudaGetLastError();
  }
  if (r == kDw) {
    const DwTile d = dw_tile(oh, ow, k, stride);
    const long long ntiles = (long long)n * d.ty * d.tx;
    const int smem = dw_smem(d);
    if (ntiles > 0x7fffffffLL || c / kDwSlice > 65535 || smem > kSmemMax)
      return (int)cudaErrorInvalidValue;
    const int rows = d.rows == kDwRows;
    switch ((k == 5) * 4 + (stride == 2) * 2 + rows) {
      case 0: launch_dw<3, 1, kDwRows / 2>(a, ntiles, smem, s); break;
      case 1: launch_dw<3, 1, kDwRows>(a, ntiles, smem, s); break;
      case 2: launch_dw<3, 2, kDwRows / 2>(a, ntiles, smem, s); break;
      case 3: launch_dw<3, 2, kDwRows>(a, ntiles, smem, s); break;
      case 4: launch_dw<5, 1, kDwRows / 2>(a, ntiles, smem, s); break;
      case 5: launch_dw<5, 1, kDwRows>(a, ntiles, smem, s); break;
      case 6: launch_dw<5, 2, kDwRows / 2>(a, ntiles, smem, s); break;
      default: launch_dw<5, 2, kDwRows>(a, ntiles, smem, s); break;
    }
    *route = r;
    return (int)cudaGetLastError();
  }
  if (r == kDw4 && ((uintptr_t)x % 4 || (uintptr_t)wp % 4))
    return (int)cudaErrorInvalidValue;
  const long long items = rows * (r == kDw4 ? f / 4 : f);
  const long long blocks = (items + kEwThreads - 1) / kEwThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (r == kDw4) {
    conv_int8_dw4_kernel<<<(unsigned)blocks, kEwThreads, 0, s>>>(a);
  } else {
    const int icg = c / groups;
    const int vec = icg % 4 == 0 && c % 4 == 0 && (uintptr_t)x % 4 == 0 &&
                    (uintptr_t)wp % 4 == 0;
    conv_int8_grouped_kernel<<<(unsigned)blocks, kEwThreads, 0, s>>>(a, vec);
  }
  *route = r;
  return (int)cudaGetLastError();
}

const char* ffcnn_conv_int8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
