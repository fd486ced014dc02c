// The tensor-core block body with rounding points, NHWC, stride S (1 or
// 2), shared by K8 (mbconv.cu) and P3's pwonly and fullbf16 modes
// (block_variants.cu):
//
//   h1 = R_h1( act1(x @ w1 * s1 + b1) )     (0 outside the image)
//   d  = R_d( leaky(dw3x3_S(h1) * s2 + b2) )        (no depthwise: d = h1)
//   y  = act3(d @ w2 * s3 + b3) + r
//
// r is x at the output pixel, read from the input halo (P3, P = C), or an
// external tensor res (K8; none where res is null).  T is the storage
// type of x, res and y (float32 or bfloat16, chosen at run time); sums are
// float32.  A compile-time policy fixes the rest:
//
// * R_h1, R_d: keep float32, round to T, or round to bf16.  K8 rounds
//   both to T (the TPU kernel keeps them in scratch of x's dtype), P3's
//   fullbf16 both to bf16, pwonly neither.  The expand is rounded after
//   the pixels outside the image are zeroed (round(0) is 0).
// * the depthwise stage run (K8, fullbf16) or skipped (pwonly: the tile's
//   own pixels are expanded, no halo, and the expand feeds the projection).
// * the weights: float32, each split into TF32 big + small (K8, pwonly), or
//   rounded to bf16 (fullbf16).  An operand that is a bf16 value is exact
//   in TF32 and takes one part, so a product takes one mma.sync m16n8k8
//   pass for each pair of parts but small * small: x in bf16 against
//   split weights two passes, float32 x three (3xTF32, about 2^-21 of each
//   product), a bf16 operand against bf16 weights one.  With bf16 storage
//   every operand of fullbf16 is a bf16 value, and its instance runs both
//   products as one mma.sync m16n8k16 bf16 pass with a float32
//   accumulator: the same products, exactly, in half the instructions of
//   the TF32 form at K >= 16 (C and the chunk padded to 16).
// * the residual source: the input halo (P3) or res after act3 (K8).
// * the taps' layout: K1's (E, 9) (P3) or the TPU kernel's (3, 3, E) (K8).
//
// The depthwise activation is leaky, fixed.  act1 and act3 are compile-time
// for the pairs in kK8Acts (the bench's) and read from the arguments in
// the runtime-switch instance.
//
// The scheme is K1's (block_mma.cuh, left as it is so that K1, K3 and P3's
// full mode cannot move): a CTA of kThreads owns a TH x TW tile of output
// pixels (at most kMaxPix, a halo of at most max_halo<S>() pixels:
// block_fused.cuh's tile contract) and kOG output channels, loads the halo
// once as float32, and walks E in 32-channel chunks with the next chunk's
// weights on their way by cp.async into the other of two buffers:
//   1. expand [halo pixels in 16-row slabs] x [C] @ [C] x [32] on the
//      tensor cores, a warp a slab, epilogue act1(. * s1 + b1), zeroing and
//      R_h1;
//   2. depthwise 3x3 (stride S) + leaky on the CUDA cores, a thread a
//      (channel, pixel row), then R_d; the result is stored split (big,
//      small) where the projection needs both parts;
//   3. project [64 output pixels] x [32] @ [32] x [P in n8 tiles], the
//      accumulators in fragments across the chunks (warp w holds pixel
//      slab w % 4 and every other n8 tile).
// Bound on this card: the block moves its input, res and output once and
// the expand never leaves the CTA, so its bytes bound it at the bench's
// narrow shapes; the body is latency-bound as K1 is (barriers between the
// three stages, fragment loads), which a later pass may attack.
//
// Row strides against bank conflicts: TF32 A fragments read rows g and
// columns t (4 mod 8), B fragments rows t and columns g (8 mod 16); the
// bf16 form reads float pairs (2t, 2t + 1) of A rows g (8 mod 16) and
// single floats of B rows 2t (4 mod 8).

#pragma once

#include "tf32_mma.cuh"

namespace ffcnn_block {
namespace rnd {

using mma::act_t;
using mma::cp_commit;
using mma::cp_wait;
using mma::kChunk;
using mma::kLdA2;
using mma::kLdH;
using mma::kLdW1;
using mma::kVec;
using mma::ld_a;
using mma::ld_b;
using mma::mma_tf32;
using mma::split;
using mma::stage;

// The instances built (the CPU tests read these two lines): the n8 tiles
// of the projection a warp holds.  A launch takes the smallest that holds
// half the widest CTA's tiles.  K8: both strides, act1/act3 of kK8Acts;
// any other pair runs the runtime-switch instance at 8.  P3: pwonly,
// fullbf16 in TF32 (float32 storage) and in bf16 (bf16 storage).
constexpr int kK8Nj[] = {1, 2, 4, 8};
constexpr int kP3Nj[] = {1, 2, 8};
// K8's compile-time {act1, act3} (ffcnn_tpu/ops/activations.py ids)
constexpr int kK8Acts[2] = {2, 0};

enum Round { kKeep = 0, kToT = 1, kToBf16 = 2 };

// The policies: kDw the depthwise stage, kRoundH1/kRoundD the rounding
// points, kWBf16 bf16 weights, kResIn the residual from the halo, kTapsTE
// the taps as (3, 3, E), kM16 the bf16 m16n8k16 form (bf16 storage only).
struct Mbconv {
  static constexpr bool kDw = true, kWBf16 = false, kResIn = false,
                        kTapsTE = true, kM16 = false;
  static constexpr int kRoundH1 = kToT, kRoundD = kToT;
};
struct PwOnly {
  static constexpr bool kDw = false, kWBf16 = false, kResIn = true,
                        kTapsTE = false, kM16 = false;
  static constexpr int kRoundH1 = kKeep, kRoundD = kKeep;
};
template <bool M16>
struct FullBf16 {
  static constexpr bool kDw = true, kWBf16 = true, kResIn = true,
                        kTapsTE = false, kM16 = M16;
  static constexpr int kRoundH1 = kToBf16, kRoundD = kToBf16;
};

struct Args {
  const void* x;
  const void* res;  // K8's residual, or null
  void* y;
  const float *w1, *s1, *b1, *kdw, *s2, *b2, *w2, *s3, *b3;
  int n, h, w, c, e, p, ho, wo;
  int act1, act3;
  int th, tw, tiles_w, cp;  // cp: C padded to the K step (8, or 16)
};

// Row strides in floats, and the shared memory of a policy in floats (the
// tests mirror it): the halo [nq16][ldx], the expand output [nq][kLdH]
// (with the depthwise stage), the projection's A operand big and small
// [kMaxPix][ldd], the output pixels' tap offsets, two chunk buffers.
__host__ __device__ constexpr int ld_x(int cpk, bool m16) {
  return m16 ? ld_b(cpk) : ld_a(cpk);
}
__host__ __device__ constexpr int ld_d(bool m16) {
  return m16 ? ld_b(kChunk) : kLdA2;
}
__host__ __device__ constexpr int ld_w1(bool m16) {
  return m16 ? ld_a(kChunk) : kLdW1;
}
__host__ __device__ constexpr int ld_w2(int n, bool m16) {
  return m16 ? ld_a(n) : ld_b(n);
}
__host__ __device__ constexpr int smem_floats(int nq, int cpk, int pn,
                                              bool dw, bool m16) {
  return (nq + 15) / 16 * 16 * ld_x(cpk, m16) + (dw ? nq * kLdH : 0) +
         2 * kMaxPix * ld_d(m16) + kMaxPix +
         2 * (cpk * ld_w1(m16) + kChunk * ld_w2(pn, m16) + kVec);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int R>
__device__ __forceinline__ float round_at(float v, bool t_bf16) {
  if constexpr (R == kToBf16) return round_bf16(v);
  if constexpr (R == kToT) return t_bf16 ? round_bf16(v) : v;
  return v;
}

// a value rounded at R is exact in TF32 (its small part is 0)
template <int R>
__device__ __forceinline__ bool exact_at(bool t_bf16) {
  return R == kToBf16 || (R == kToT && t_bf16);
}

// two floats that are bf16 values as a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a @ b, m16n8k16, bf16 in, float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[j] += (a_big + a_small) @ b[j] for the live n8 tiles j < N, in TF32:
// b split big + small (BX false) or rounded to bf16 (BX true, exact);
// a_small skipped where a is exact.  Each pass runs over every tile before
// the next starts, so no mma waits on the one issued just before it.
template <int N, bool BX>
__device__ __forceinline__ void mma_parts(float (&d)[N][4],
                                          const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4],
                                          bool a_exact, const float (&b)[N][2],
                                          const bool (&live)[N]) {
  uint32_t bb[N][2], bs[N][2];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if constexpr (BX) {
        bb[j][k] = __float_as_uint(round_bf16(b[j][k]));
        bs[j][k] = 0u;
      } else {
        split(b[j][k], bb[j][k], bs[j][k]);
      }
    }
  if (!a_exact) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (live[j]) mma_tf32(d[j], as, bb[j][0], bb[j][1]);
  }
  if constexpr (!BX) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (live[j]) mma_tf32(d[j], ab, bs[j][0], bs[j][1]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (live[j]) mma_tf32(d[j], ab, bb[j][0], bb[j][1]);
}

// The input halo as float32, [nq16][ldx]: zero outside the image, past C
// and in the rows that round nq up to whole 16-row slabs.
template <typename T>
__device__ __forceinline__ void load_halo(float* xs, int ldx, const Args& a,
                                          int nq, int nq16, int hw, int iy0,
                                          int ix0) {
  const T* x = static_cast<const T*>(a.x);
  const int ng = a.cp >> 3;  // groups of 8 channels
  for (int i = threadIdx.x; i < nq16 * ng; i += kThreads) {
    const int q = i / ng, c0 = (i - q * ng) << 3;
    const int gy = iy0 + q / hw, gx = ix0 + q % hw;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q < nq && c0 < a.c && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w) {
      const T* src =
          x + (((size_t)blockIdx.y * a.h + gy) * a.w + gx) * a.c + c0;
      if (a.c % 8 == 0) {
        if constexpr (sizeof(T) == 2) {
          const uint4 u = *reinterpret_cast<const uint4*>(src);
          const __nv_bfloat162* b =
              reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(b[k]);
            v[2 * k] = f.x;
            v[2 * k + 1] = f.y;
          }
        } else {
          const float4 f0 = reinterpret_cast<const float4*>(src)[0];
          const float4 f1 = reinterpret_cast<const float4*>(src)[1];
          v[0] = f0.x; v[1] = f0.y; v[2] = f0.z; v[3] = f0.w;
          v[4] = f1.x; v[5] = f1.y; v[6] = f1.z; v[7] = f1.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (c0 + k < a.c) v[k] = to_f32(src[k]);
      }
    }
    float4* d = reinterpret_cast<float4*>(xs + q * ldx + c0);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// The expand of one 16-row slab of the halo (rows r0..r0+15) for the
// chunk's NT n8 tiles, then act1(. * s1 + b1), 0 outside the image, R_h1:
// into h1s ([q][kLdH]) with the depthwise stage, else (the tile's own
// pixels) into the projection's A operand hb/hs ([q][ldd]).
template <class P, int NT, int A1>
__device__ __forceinline__ void expand_slab(
    const Args& a, const float* xs, int ldx, const float* w1c,
    const float* vc, float* h1s, float* hb, float* hs, int r0, int nq,
    int hw, int iy0, int ix0, bool t_bf16) {
  constexpr int ldw1 = ld_w1(P::kM16), ldd = ld_d(P::kM16);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
  if constexpr (P::kM16) {
    for (int k0 = 0; k0 < a.cp; k0 += 16) {
      const float* xa = xs + (r0 + g) * ldx + k0 + 2 * t;
      const float2 x0 = *reinterpret_cast<const float2*>(xa);
      const float2 x1 = *reinterpret_cast<const float2*>(xa + 8 * ldx);
      const float2 x2 = *reinterpret_cast<const float2*>(xa + 8);
      const float2 x3 = *reinterpret_cast<const float2*>(xa + 8 * ldx + 8);
      const uint32_t av[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                              pack_bf16(x2.x, x2.y), pack_bf16(x3.x, x3.y)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* wb = w1c + (k0 + 2 * t) * ldw1 + j * 8 + g;
        mma_bf16(acc[j], av, pack_bf16(wb[0], wb[ldw1]),
                 pack_bf16(wb[8 * ldw1], wb[9 * ldw1]));
      }
    }
  } else {
    bool live[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) live[j] = true;
    for (int k0 = 0; k0 < a.cp; k0 += 8) {
      const float* xa = xs + (r0 + g) * ldx + k0 + t;
      const float av[4] = {xa[0], xa[8 * ldx], xa[4], xa[8 * ldx + 4]};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (t_bf16) {
          ab[k] = __float_as_uint(av[k]);
          as[k] = 0u;
        } else {
          split(av[k], ab[k], as[k]);
        }
      }
      float b[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* wb = w1c + (k0 + t) * ldw1 + j * 8 + g;
        b[j][0] = wb[0];
        b[j][1] = wb[4 * ldw1];
      }
      mma_parts<NT, P::kWBf16>(acc, ab, as, t_bf16, b, live);
    }
  }
  bool in[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = r0 + g + 8 * h;
    const int gy = iy0 + q / hw, gx = ix0 + q % hw;
    in[h] = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + 2 * t;
    const float s0 = vc[col], s1 = vc[col + 1];
    const float b0 = vc[kChunk + col], b1 = vc[kChunk + col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = r0 + g + 8 * h;
      if (q >= nq) continue;
      float v0 = 0.f, v1 = 0.f;
      if (in[h]) {
        v0 = round_at<P::kRoundH1>(
            act_t<A1>(acc[j][2 * h] * s0 + b0, a.act1), t_bf16);
        v1 = round_at<P::kRoundH1>(
            act_t<A1>(acc[j][2 * h + 1] * s1 + b1, a.act1), t_bf16);
      }
      if constexpr (P::kDw) {
        *reinterpret_cast<float2*>(h1s + q * kLdH + col) = make_float2(v0, v1);
      } else if (exact_at<P::kRoundH1>(t_bf16) || P::kM16) {
        *reinterpret_cast<float2*>(hb + q * ldd + col) = make_float2(v0, v1);
      } else {
        uint32_t g0, l0, g1, l1;
        split(v0, g0, l0);
        split(v1, g1, l1);
        *reinterpret_cast<float2*>(hb + q * ldd + col) =
            make_float2(__uint_as_float(g0), __uint_as_float(g1));
        *reinterpret_cast<float2*>(hs + q * ldd + col) =
            make_float2(__uint_as_float(l0), __uint_as_float(l1));
      }
    }
  }
}

// the expand's n8-tile count as a compile-time constant (1 to 4)
template <class P, int A1>
__device__ __forceinline__ void expand_nt(int ntc, const Args& a,
                                          const float* xs, int ldx,
                                          const float* w1c, const float* vc,
                                          float* h1s, float* hb, float* hs,
                                          int r0, int nq, int hw, int iy0,
                                          int ix0, bool t_bf16) {
  switch (ntc) {
    case 1:
      expand_slab<P, 1, A1>(a, xs, ldx, w1c, vc, h1s, hb, hs, r0, nq, hw,
                            iy0, ix0, t_bf16);
      break;
    case 2:
      expand_slab<P, 2, A1>(a, xs, ldx, w1c, vc, h1s, hb, hs, r0, nq, hw,
                            iy0, ix0, t_bf16);
      break;
    case 3:
      expand_slab<P, 3, A1>(a, xs, ldx, w1c, vc, h1s, hb, hs, r0, nq, hw,
                            iy0, ix0, t_bf16);
      break;
    default:
      expand_slab<P, 4, A1>(a, xs, ldx, w1c, vc, h1s, hb, hs, r0, nq, hw,
                            iy0, ix0, t_bf16);
  }
}

// NJ: n8 tiles of the projection a warp holds (of ceil(P' / 8), P' the
// CTA's outputs, at most kOG, split between two warps a pixel slab).  The
// instances that hold one or two tiles serve the narrow blocks of the
// large maps, which launch many CTAs: they are kept to the registers that
// let four or three CTAs share an SM (the others to two), as K1's are.
template <class P, int S, int NJ, int A1, int A3>
__global__ void __launch_bounds__(kThreads, NJ == 1 ? 4 : NJ == 2 ? 3 : 2)
    round_kernel(Args a, int t_bf16_, int vec_) {
  constexpr bool M16 = P::kM16;
  constexpr int M = P::kDw ? 1 : 0;  // the halo's margin
  constexpr int ldd = ld_d(M16), ldw1 = ld_w1(M16);
  extern __shared__ float4 smem4[];
  const bool t_bf16 = t_bf16_, vec = vec_;
  const int th = a.th, tw = a.tw, npix = th * tw;
  const int hw = P::kDw ? S * tw + 3 - S : tw;
  const int nq = P::kDw ? (S * th + 3 - S) * hw : npix;
  const int nq16 = (nq + 15) & ~15, cpk = a.cp, ldx = ld_x(cpk, M16);
  const int og = blockIdx.z * kOG, np = min(kOG, a.p - og);
  const int nt = (np + 7) >> 3, ldw2 = ld_w2(nt * 8, M16);
  float* xs = reinterpret_cast<float*>(smem4);  // [nq16][ldx] input halo
  float* h1s = xs + nq16 * ldx;                 // [nq][kLdH] expand output
  float* hb = h1s + (P::kDw ? nq * kLdH : 0);   // [kMaxPix][ldd] A big
  float* hs = hb + kMaxPix * ldd;               //                A small
  int* poff = reinterpret_cast<int*>(hs + kMaxPix * ldd);  // [kMaxPix]
  float* bufs = hs + kMaxPix * ldd + kMaxPix;  // two chunk buffers
  const int buf_floats = cpk * ldw1 + kChunk * ldw2 + kVec;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ty0 = (blockIdx.x / a.tiles_w) * th;  // output tile origin
  const int tx0 = (blockIdx.x % a.tiles_w) * tw;
  const int iy0 = S * ty0 - M, ix0 = S * tx0 - M;  // halo origin
  const int nchunks = (a.e + kChunk - 1) / kChunk;
  const bool d_exact = exact_at<P::kDw ? P::kRoundD : P::kRoundH1>(t_bf16);

  // chunk ci's weights into buffer ci % 2: w1[:, e0:e0+32] as
  // [cpk][ldw1], w2[e0:e0+32, og:og+np] as [32][ldw2], then s1 b1 s2 b2
  // and the taps ([32][9] from (E, 9), [9][32] from (3, 3, E))
  auto stage_chunk = [&](int ci) {
    float* w1c = bufs + (ci & 1) * buf_floats;
    float* w2c = w1c + cpk * ldw1;
    float* vc = w2c + kChunk * ldw2;
    const int e0 = ci * kChunk, ec = min(kChunk, a.e - e0);
    stage(w1c, ldw1, a.w1 + e0, a.e, a.c, ec, cpk, kChunk, vec);
    stage(w2c, ldw2, a.w2 + (size_t)e0 * a.p + og, a.p, ec, np, kChunk,
          nt * 8, vec);
    const float* vs[4] = {a.s1, a.b1, a.s2, a.b2};
#pragma unroll
    for (int k = 0; k < (P::kDw ? 4 : 2); ++k)
      stage(vc + k * kChunk, 0, vs[k] + e0, 0, 1, ec, 1, kChunk, vec);
    if constexpr (P::kDw && P::kTapsTE)
      stage(vc + 4 * kChunk, kChunk, a.kdw + e0, a.e, 9, ec, 9, kChunk, vec);
    else if constexpr (P::kDw)
      stage(vc + 4 * kChunk, 0, a.kdw + (size_t)e0 * 9, 0, 1, ec * 9, 1,
            kChunk * 9, vec);
    cp_commit();
  };

  stage_chunk(0);
  if constexpr (P::kDw) {
    // each output pixel's first tap in h1s (no division in the tap loop)
    for (int i = tid; i < kMaxPix; i += kThreads) {
      const int py = i / tw, px = i - py * tw;
      poff[i] = i < npix ? (S * py * hw + S * px) * kLdH : 0;
    }
  }
  if (t_bf16)
    load_halo<__nv_bfloat16>(xs, ldx, a, nq, nq16, hw, iy0, ix0);
  else
    load_halo<float>(xs, ldx, a, nq, nq16, hw, iy0, ix0);

  // the projection: this warp's pixel slab and n8 tiles pj0 + 2j
  const int pm = warp & 3, pj0 = warp >> 2;
  float pacc[NJ][4];
  bool plive[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    plive[j] = pj0 + 2 * j < nt;
#pragma unroll
    for (int k = 0; k < 4; ++k) pacc[j][k] = 0.f;
  }

  for (int ci = 0; ci < nchunks; ++ci) {
    __syncthreads();  // chunk ci-1 is done with h1s, hb/hs and its buffer
    if (ci + 1 < nchunks) {
      stage_chunk(ci + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // chunk ci's buffer (and at ci 0 the halo) is in
    const float* w1c = bufs + (ci & 1) * buf_floats;
    const float* w2c = w1c + cpk * ldw1;
    const float* vc = w2c + kChunk * ldw2;
    const int ec = min(kChunk, a.e - ci * kChunk), ntc = (ec + 7) >> 3;
    // the projection's K: the chunk's channels in n8 tiles, or in k16
    // steps for the bf16 form (its A columns past ec hold zeros)
    const int kd_w = M16 ? (ec + 15) & ~15 : ntc * 8;

    // 1. expand: a warp a 16-row slab, all the chunk's n8 tiles at once
    for (int r0 = warp * 16; r0 < nq16; r0 += kWarps * 16)
      expand_nt<P, A1>(ntc, a, xs, ldx, w1c, vc, h1s, hb, hs, r0, nq, hw,
                          iy0, ix0, t_bf16);
    __syncthreads();

    // 2. depthwise 3x3 (stride S) + leaky, R_d: thread = (channel e of the
    // chunk's kd_w, pixel row), every output pixel row of the 64
    if constexpr (P::kDw) {
      const int rows = kThreads / kd_w;
      const int e = tid % kd_w, p0 = tid / kd_w;
      if (p0 < rows) {
        const bool live = e < ec;
        float kd[9];
#pragma unroll
        for (int k = 0; k < 9; ++k)
          kd[k] = P::kTapsTE ? vc[4 * kChunk + k * kChunk + e]
                             : vc[4 * kChunk + e * 9 + k];
        const float sc = vc[2 * kChunk + e], bi = vc[3 * kChunk + e];
#pragma unroll 4
        for (int pix = p0; pix < kMaxPix; pix += rows) {
          float v = 0.f;
          if (live && pix < npix) {
            const float* hp = h1s + poff[pix] + e;
            float s = 0.f;
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx)
                s = fmaf(hp[(dy * hw + dx) * kLdH], kd[dy * 3 + dx], s);
            v = round_at<P::kRoundD>(act_t<2>(s * sc + bi, 2), t_bf16);
          }
          if (d_exact || M16) {
            hb[pix * ldd + e] = v;
          } else {
            uint32_t big, small;
            split(v, big, small);
            hb[pix * ldd + e] = __uint_as_float(big);
            hs[pix * ldd + e] = __uint_as_float(small);
          }
        }
      }
      __syncthreads();
    }

    // 3. project: pacc += d[slab pm] @ w2c[:, n8 tiles pj0 + 2j]
    if (pj0 < nt) {
      if constexpr (M16) {
        for (int k0 = 0; k0 < kd_w; k0 += 16) {
          const float* ha = hb + (pm * 16 + g) * ldd + k0 + 2 * t;
          const float2 x0 = *reinterpret_cast<const float2*>(ha);
          const float2 x1 = *reinterpret_cast<const float2*>(ha + 8 * ldd);
          const float2 x2 = *reinterpret_cast<const float2*>(ha + 8);
          const float2 x3 =
              *reinterpret_cast<const float2*>(ha + 8 * ldd + 8);
          const uint32_t av[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                                  pack_bf16(x2.x, x2.y),
                                  pack_bf16(x3.x, x3.y)};
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            if (!plive[j]) continue;
            const float* wb =
                w2c + (k0 + 2 * t) * ldw2 + (pj0 + 2 * j) * 8 + g;
            mma_bf16(pacc[j], av, pack_bf16(wb[0], wb[ldw2]),
                     pack_bf16(wb[8 * ldw2], wb[9 * ldw2]));
          }
        }
      } else {
        for (int k0 = 0; k0 < kd_w; k0 += 8) {
          const int r = (pm * 16 + g) * ldd + k0 + t;
          const uint32_t ab[4] = {
              __float_as_uint(hb[r]), __float_as_uint(hb[r + 8 * ldd]),
              __float_as_uint(hb[r + 4]),
              __float_as_uint(hb[r + 8 * ldd + 4])};
          uint32_t as[4] = {0u, 0u, 0u, 0u};
          if (!d_exact) {
            as[0] = __float_as_uint(hs[r]);
            as[1] = __float_as_uint(hs[r + 8 * ldd]);
            as[2] = __float_as_uint(hs[r + 4]);
            as[3] = __float_as_uint(hs[r + 8 * ldd + 4]);
          }
          float b[NJ][2];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float* wb = w2c + (k0 + t) * ldw2 + (pj0 + 2 * j) * 8 + g;
            b[j][0] = plive[j] ? wb[0] : 0.f;
            b[j][1] = plive[j] ? wb[4 * ldw2] : 0.f;
          }
          mma_parts<NJ, P::kWBf16>(pacc, ab, as, d_exact, b, plive);
        }
      }
    }
  }

  // epilogue: act3(acc * s3 + b3), then the residual, then the store
  const int img = blockIdx.y;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pix = pm * 16 + g + 8 * h;
    if (pix >= npix) continue;
    const int py = pix / tw, px = pix - py * tw;
    const int gy = ty0 + py, gx = tx0 + px;
    if (gy >= a.ho || gx >= a.wo) continue;
    const size_t at = (((size_t)img * a.ho + gy) * a.wo + gx) * a.p;
    const float* rin = xs + ((py + M) * hw + px + M) * ldx;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (!plive[j]) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int o = og + (pj0 + 2 * j) * 8 + 2 * t + u;
        if (o >= a.p) continue;
        float v = act_t<A3>(pacc[j][2 * h + u] * a.s3[o] + a.b3[o], a.act3);
        if constexpr (P::kResIn) {
          v += rin[o];
        } else if (a.res) {
          v += t_bf16
                   ? to_f32(static_cast<const __nv_bfloat16*>(a.res)[at + o])
                   : static_cast<const float*>(a.res)[at + o];
        }
        if (t_bf16)
          store(static_cast<__nv_bfloat16*>(a.y) + at + o, v);
        else
          store(static_cast<float*>(a.y) + at + o, v);
      }
    }
  }
}

// What a launch needs (plan() below): the grid, the shared memory, the
// 16-byte staging flag and the n8 tiles a warp must hold; empty: nothing
// to launch.
struct Plan {
  dim3 grid;
  size_t smem;
  bool vec, empty;
  int need;
};

// Internal linkage: each library that includes this header raises the
// shared-memory cap of its own copy of every instance (see block_mma.cuh).
namespace {

template <class P, int S, int NJ, int A1, int A3>
void launch(const Args& a, bool t_bf16, const Plan& pl, cudaStream_t stream) {
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit) &&
      cudaFuncSetAttribute(round_kernel<P, S, NJ, A1, A3>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem) == cudaSuccess)
    raised.fetch_or(bit, std::memory_order_relaxed);
  round_kernel<P, S, NJ, A1, A3><<<pl.grid, kThreads, pl.smem, stream>>>(
      a, (int)t_bf16, (int)pl.vec);
}

}  // namespace

// Plans a launch of policy P at stride S from a's sizes and tile: fills
// ho, wo, tiles_w and cp, and returns cudaErrorInvalidValue for what the
// kernel cannot take (a tile, a stride, odd sizes at stride 2, a batch >
// 65535, a channel count beyond shared memory), else cudaSuccess.
template <class P, int S>
int plan(Args& a, Plan& pl) {
  const int th = a.th, tw = a.tw;
  const int hw = P::kDw ? S * tw + 3 - S : tw;
  const int nq = P::kDw ? (S * th + 3 - S) * hw : th * tw;
  pl.empty = false;
  if (th < 1 || tw < 1 || th * tw > kMaxPix ||
      (P::kDw && nq > max_halo<S>()) || a.h % S || a.w % S)
    return (int)cudaErrorInvalidValue;
  if (a.n == 0 || a.h == 0 || a.w == 0 || a.p == 0) {
    pl.empty = true;
    return (int)cudaSuccess;
  }
  const int kstep = P::kM16 ? 16 : 8;
  a.ho = a.h / S;
  a.wo = a.w / S;
  a.tiles_w = (a.wo + tw - 1) / tw;
  a.cp = (a.c + kstep - 1) / kstep * kstep;
  const int pn = ((a.p < kOG ? a.p : kOG) + 7) / 8 * 8;  // the widest CTA's
  pl.smem = sizeof(float) * smem_floats(nq, a.cp, pn, P::kDw, P::kM16);
  if (pl.smem > kMaxSmem || a.n > 65535 || a.c < 1 || a.e < 1)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies of what stage_chunk stages (the depthwise's last three)
  const void* staged[] = {a.w1, a.w2, a.s1, a.b1, a.s2, a.b2, a.kdw};
  pl.vec = a.e % 4 == 0 && a.p % 4 == 0;
  for (int i = 0; i < (P::kDw ? 7 : 4); ++i)
    pl.vec = pl.vec && (uintptr_t)staged[i] % 16 == 0;
  pl.grid =
      dim3(((a.ho + th - 1) / th) * a.tiles_w, a.n, (a.p + kOG - 1) / kOG);
  pl.need = (pn / 8 + 1) / 2;
  return (int)cudaSuccess;
}

}  // namespace rnd
}  // namespace ffcnn_block
