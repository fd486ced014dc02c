// P3: K1's stride-1 block cut into the variants of the small-C bisection,
// NHWC, P = C, with the bisection's fixed activations (leaky expand, leaky
// depthwise, linear project, linear residual); T is the storage type:
//
//   copy      y = x, the input halo streamed through shared memory
//   dwonly    y = T(leaky(sum_taps xpad * kdw[:C][dy*3+dx])), float32 rows
//   dwmixed   the same sums, with the rows staged in shared memory in T
//   dwbf16    rows staged in T, taps kdw rounded to bf16; with T = bf16
//             every product and every sum rounds to bf16 (__hmul_rn and
//             __hadd_rn, which nvcc never contracts into an FMA) and the
//             leaky slope is bf16(0.1); with T = float32 the sums are float32
//   pwonly    y = T((leaky(x @ w1 * s1 + b1) @ w2) * s3 + b3 + x), no halo
//   full      K1 itself: block_mma.cuh's run_block<1>, the tensor-core
//             template and C-entry body that block_fused.cu launches
//   fullbf16  full with w1 and w2 rounded to bf16, the expand rounded to
//             bf16 after the halo is zeroed, and the depthwise output
//             rounded to bf16 before the projection
//
// Zero padding: pixels outside the image are 0 in the raw rows (tap modes)
// and in the expand output (full modes, after the epilogue, as in K1).
//
// Replaces tools/bisect_smallc.py::make_variant_kernel (launched by
// variant_step), which worked on the TPU's (H, C, W*N) layout; this kernel
// works in NHWC like K1, so the split it reports is the split of the port's
// K1, and the wrapper converts the layout before and after.  Every mode
// takes K1's arguments (ffcnn_block::Args, kdw as K1's (E, 9)) and K1's
// activation ids; `full` launches K1's own template, and pwonly and
// fullbf16 are the float32-FMA body K1 had before its tensor-core redesign
// (block_kernel below, at S = 1) with only their mode's changes, so the
// split they give is that of the earlier K1.
//
// Bound on this card: every variant moves the block's input and output
// once (copy and the tap modes are bound by those bytes), and the full
// modes add the pointwise multiply-adds, which the CUDA cores run in
// float32 as in K1.  The variants exist to attribute K1's time, not to
// beat it: the copy mode measures the tile's streaming, the tap modes the
// depthwise stage, pwonly the two products, and full the whole block.

#include <type_traits>

#include "block_mma.cuh"

namespace p3 {

using ffcnn_block::act;
using ffcnn_block::Args;
using ffcnn_block::kEC;
using ffcnn_block::kHaloPass;
using ffcnn_block::kMaxPix;
using ffcnn_block::kMaxSmem;
using ffcnn_block::kOG;
using ffcnn_block::kPPT;
using ffcnn_block::kQPT;
using ffcnn_block::kThreads;
using ffcnn_block::kWarps;
using ffcnn_block::max_halo;
using ffcnn_block::store;
using ffcnn_block::to_f32;

enum Mode { kCopy, kDwOnly, kDwMixed, kDwBf16, kPwOnly, kFull, kFullBf16 };

// the bisection's activations, as K1's ids (ffcnn_tpu/ops/activations.py)
constexpr int kLeaky = 2, kLinear = 0;
constexpr float kSlopeBf16 = 0.10009765625f;  // bf16(0.1)

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// copy and the three tap modes: the halo tile in shared memory, then each
// output pixel from it (lane = channel, warps stride the pixels, as K1).
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) tap_kernel(Args a) {
  constexpr bool kRaw = MODE == kDwMixed || MODE == kDwBf16;
  constexpr bool kHalf =
      MODE == kDwBf16 && std::is_same<T, __nv_bfloat16>::value;
  using S = typename std::conditional<kRaw, T, float>::type;
  extern __shared__ float4 smem4[];
  S* xs = reinterpret_cast<S*>(smem4);  // [nq][c] input halo
  const int th = a.th, tw = a.tw, hw = tw + 2, nq = (th + 2) * hw;
  const int npix = th * tw, c = a.c;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty0 = (blockIdx.x / a.tiles_w) * th;
  const int tx0 = (blockIdx.x % a.tiles_w) * tw;
  const int img = blockIdx.y;
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);

  for (int i = tid; i < nq * c; i += kThreads) {
    const int q = i / c, ch = i - q * c;
    const int gy = ty0 - 1 + q / hw, gx = tx0 - 1 + q % hw;
    const bool in = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
    const size_t at = (((size_t)img * a.h + gy) * a.w + gx) * c + ch;
    if constexpr (kRaw)
      xs[i] = in ? x[at] : from_f32<T>(0.f);
    else
      xs[i] = in ? to_f32(x[at]) : 0.f;
  }
  __syncthreads();

  for (int c0 = 0; c0 < c; c0 += 32) {
    const int ch = c0 + lane;
    const bool live = ch < c;
    float kd[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      kd[t] = (MODE != kCopy && live) ? a.kdw[(size_t)ch * 9 + t] : 0.f;
      if (MODE == kDwBf16) kd[t] = round_bf16(kd[t]);
    }
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      const int pix = warp + k * kWarps;
      if (pix >= npix || !live) continue;
      const int py = pix / tw, px = pix - py * tw;
      const int gy = ty0 + py, gx = tx0 + px;
      if (gy >= a.h || gx >= a.w) continue;
      T* out = y + (((size_t)img * a.h + gy) * a.w + gx) * c + ch;
      if constexpr (MODE == kCopy) {
        store(out, xs[((py + 1) * hw + px + 1) * c + ch]);
      } else if constexpr (kHalf) {
        __nv_bfloat16 s = __float2bfloat16_rn(0.f);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            s = __hadd_rn(s, __hmul_rn(xs[((py + dy) * hw + px + dx) * c + ch],
                                       __float2bfloat16_rn(kd[dy * 3 + dx])));
        const float v = __bfloat162float(s);
        store(out, v > 0.f ? v : v * kSlopeBf16);
      } else {
        float s = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            s = fmaf(to_f32(xs[((py + dy) * hw + px + dx) * c + ch]),
                     kd[dy * 3 + dx], s);
        store(out, act(s, a.act2));
      }
    }
  }
}

// pwonly and fullbf16: the float32-FMA block_kernel K1 had before its
// tensor-core redesign, at S = 1, Tin = Tout = T, with only the mode's
// changes, each marked "mode:" below.
template <typename T, int MODE, int PJ>
__global__ void __launch_bounds__(kThreads) block_kernel(Args a) {
  constexpr bool kBf = MODE == kFullBf16;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);     // [nq][cp] input halo
  const int th = a.th, tw = a.tw;
  const int hw = tw + 2, nq = (th + 2) * hw;
  const int cp = a.cp, npix = th * tw;
  float* w1s = xs + nq * cp;                        // [cp][kEC]
  float* h1s = w1s + cp * kEC;                      // [nq][kEC]
  float* h2s = h1s + nq * kEC;                      // [kMaxPix][kEC]
  float* w2s = h2s + kMaxPix * kEC;                 // [kEC][kOG]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty0 = (blockIdx.x / a.tiles_w) * th;
  const int tx0 = (blockIdx.x % a.tiles_w) * tw;
  const int iy0 = ty0 - 1, ix0 = tx0 - 1;
  const int img = blockIdx.y, og = blockIdx.z * kOG;
  const T* x = static_cast<const T*>(a.x);

  for (int i = tid; i < nq * cp; i += kThreads) {
    const int q = i / cp, c = i - q * cp;
    const int gy = iy0 + q / hw, gx = ix0 + q % hw;
    float v = 0.f;
    if (c < a.c && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w)
      v = to_f32(x[(((size_t)img * a.h + gy) * a.w + gx) * a.c + c]);
    xs[i] = v;
  }

  float acc[kPPT][PJ];
#pragma unroll
  for (int k = 0; k < kPPT; ++k)
#pragma unroll
    for (int j = 0; j < PJ; ++j) acc[k][j] = 0.f;

  for (int e0 = 0; e0 < a.e; e0 += kEC) {
    const int ec = min(kEC, a.e - e0);
    const bool live = lane < ec;
    __syncthreads();  // the previous chunk is done with the chunk buffers
    for (int i = tid; i < cp * kEC; i += kThreads) {
      const int c = i / kEC, e = i - c * kEC;
      const float v =
          (c < a.c && e < ec) ? a.w1[(size_t)c * a.e + e0 + e] : 0.f;
      w1s[i] = kBf ? round_bf16(v) : v;  // mode: bf16 operands
    }
    for (int i = tid; i < kEC * kOG; i += kThreads) {
      const int e = i / kOG, o = i - e * kOG;
      const float v = (e < ec && og + o < a.p)
                          ? a.w2[(size_t)(e0 + e) * a.p + og + o] : 0.f;
      w2s[i] = kBf ? round_bf16(v) : v;  // mode: bf16 operands
    }
    __syncthreads();

    const float sc1 = live ? a.s1[e0 + lane] : 0.f;
    const float bi1 = live ? a.b1[e0 + lane] : 0.f;
    if constexpr (MODE == kPwOnly) {
      // mode: expand the tile's own pixels straight into the projection's
      // input; no halo, no taps
      int qk[kPPT];
      float ex[kPPT];
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const int pix = min(warp + k * kWarps, npix - 1);
        const int py = pix / tw, px = pix - py * tw;
        qk[k] = (py + 1) * hw + px + 1;
        ex[k] = 0.f;
      }
      for (int c = 0; c < cp; c += 4) {
        const float wa = w1s[c * kEC + lane];
        const float wb = w1s[(c + 1) * kEC + lane];
        const float wc = w1s[(c + 2) * kEC + lane];
        const float wd = w1s[(c + 3) * kEC + lane];
#pragma unroll
        for (int k = 0; k < kPPT; ++k) {
          const float4 v =
              *reinterpret_cast<const float4*>(xs + qk[k] * cp + c);
          ex[k] = fmaf(v.x, wa, ex[k]);
          ex[k] = fmaf(v.y, wb, ex[k]);
          ex[k] = fmaf(v.z, wc, ex[k]);
          ex[k] = fmaf(v.w, wd, ex[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const int pix = warp + k * kWarps;
        if (pix < npix)
          h2s[pix * kEC + lane] = live ? act(ex[k] * sc1 + bi1, a.act1) : 0.f;
      }
    } else {
      // 1. expand the halo: lane = chunk channel, warps stride the pixels
      for (int q0 = 0; q0 < nq; q0 += kHaloPass) {
        float ex[kQPT];
#pragma unroll
        for (int k = 0; k < kQPT; ++k) ex[k] = 0.f;
        for (int c = 0; c < cp; c += 4) {
          const float wa = w1s[c * kEC + lane];
          const float wb = w1s[(c + 1) * kEC + lane];
          const float wc = w1s[(c + 2) * kEC + lane];
          const float wd = w1s[(c + 3) * kEC + lane];
#pragma unroll
          for (int k = 0; k < kQPT; ++k) {
            const int q = min(q0 + warp + k * kWarps, nq - 1);
            const float4 v =
                *reinterpret_cast<const float4*>(xs + q * cp + c);
            ex[k] = fmaf(v.x, wa, ex[k]);
            ex[k] = fmaf(v.y, wb, ex[k]);
            ex[k] = fmaf(v.z, wc, ex[k]);
            ex[k] = fmaf(v.w, wd, ex[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < kQPT; ++k) {
          const int q = q0 + warp + k * kWarps;
          if (q < nq) {
            const int gy = iy0 + q / hw, gx = ix0 + q % hw;
            const bool in = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
            const float v = (in && live) ? act(ex[k] * sc1 + bi1, a.act1)
                                         : 0.f;
            h1s[q * kEC + lane] = kBf ? round_bf16(v) : v;  // mode: bf16 rows
          }
        }
      }
      __syncthreads();

      // 2. depthwise 3x3 over the tile's output pixels
      float kd[9];
#pragma unroll
      for (int t = 0; t < 9; ++t)
        kd[t] = live ? a.kdw[(size_t)(e0 + lane) * 9 + t] : 0.f;
      const float sc2 = live ? a.s2[e0 + lane] : 0.f;
      const float bi2 = live ? a.b2[e0 + lane] : 0.f;
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const int pix = warp + k * kWarps;
        if (pix < npix) {
          const int py = pix / tw, px = pix - py * tw;
          float s = 0.f;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
              s = fmaf(h1s[((py + dy) * hw + px + dx) * kEC + lane],
                       kd[dy * 3 + dx], s);
          const float v = live ? act(s * sc2 + bi2, a.act2) : 0.f;
          h2s[pix * kEC + lane] = kBf ? round_bf16(v) : v;  // mode: bf16 mids
        }
      }
    }
    __syncthreads();

    // 3. project: this chunk's share of y[pixel][og + lane + 32j]
    for (int e = 0; e < ec; ++e) {
      float wv[PJ];
#pragma unroll
      for (int j = 0; j < PJ; ++j) wv[j] = w2s[e * kOG + lane + 32 * j];
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const float hv = h2s[(warp + k * kWarps) * kEC + e];
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[k][j] = fmaf(hv, wv[j], acc[k][j]);
      }
    }
  }

  T* y = static_cast<T*>(a.y);
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const int pix = warp + k * kWarps;
    if (pix >= npix) continue;
    const int py = pix / tw, px = pix - py * tw;
    const int gy = ty0 + py, gx = tx0 + px;
    if (gy >= a.ho || gx >= a.wo) continue;
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      const int o = og + lane + 32 * j;
      if (o >= a.p) continue;
      float v = act(acc[k][j] * a.s3[o] + a.b3[o], a.act3);
      if (a.residual)
        v = act(v + xs[((py + 1) * hw + px + 1) * cp + o], a.res_act);
      store(y + (((size_t)img * a.ho + gy) * a.wo + gx) * a.p + o, v);
    }
  }
}

// Raise a kernel's shared-memory cap once per device, as K1's launch does;
// ``raised`` is the instance's own record of the devices done.
inline void raise_smem(std::atomic<uint64_t>& raised, const void* kernel) {
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit) &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem) == cudaSuccess)
    raised.fetch_or(bit, std::memory_order_relaxed);
}

template <typename T, int MODE>
void launch_tap(const Args& a, dim3 grid, size_t smem, cudaStream_t s) {
  static std::atomic<uint64_t> raised{0};
  raise_smem(raised, (const void*)tap_kernel<T, MODE>);
  tap_kernel<T, MODE><<<grid, kThreads, smem, s>>>(a);
}

template <typename T, int MODE, int PJ>
void launch_block(const Args& a, dim3 grid, size_t smem, cudaStream_t s) {
  static std::atomic<uint64_t> raised{0};
  raise_smem(raised, (const void*)block_kernel<T, MODE, PJ>);
  block_kernel<T, MODE, PJ><<<grid, kThreads, smem, s>>>(a);
}

template <typename T, int MODE>
void launch_block_pj(const Args& a, dim3 grid, size_t smem, cudaStream_t s) {
  if (a.p <= 32)
    launch_block<T, MODE, 1>(a, grid, smem, s);
  else if (a.p <= 64)
    launch_block<T, MODE, 2>(a, grid, smem, s);
  else
    launch_block<T, MODE, 4>(a, grid, smem, s);
}

template <typename T>
void dispatch(const Args& a, int mode, dim3 grid, size_t smem,
              cudaStream_t s) {
  switch (mode) {
    case kCopy: launch_tap<T, kCopy>(a, grid, smem, s); break;
    case kDwOnly: launch_tap<T, kDwOnly>(a, grid, smem, s); break;
    case kDwMixed: launch_tap<T, kDwMixed>(a, grid, smem, s); break;
    case kDwBf16: launch_tap<T, kDwBf16>(a, grid, smem, s); break;
    case kPwOnly: launch_block_pj<T, kPwOnly>(a, grid, smem, s); break;
    default: launch_block_pj<T, kFullBf16>(a, grid, smem, s); break;
  }
}

}  // namespace p3

extern "C" {

// x and y (n, h, w, c), contiguous, bfloat16 where bf16 is 1, else float32.
// mode: 0 copy, 1 dwonly, 2 dwmixed, 3 dwbf16, 4 pwonly, 5 full,
// 6 fullbf16.  w1 (c, e), s1/b1 (e), kdw (e, 9) as K1's, s2/b2 (e), w2
// (e, c), s3/b3 (c): float32, contiguous.  (th, tw): output tile, th*tw <=
// 64, (th+2)*(tw+2) <= 104.  c <= 128, and c <= e for the tap modes (their
// taps are kdw[:c]).  Returns cudaErrorInvalidValue for what the kernel
// cannot take, else cudaGetLastError().
int ffcnn_block_variant(const void* x, void* y, int bf16, int mode,
                        const void* w1, const void* s1, const void* b1,
                        const void* kdw, const void* s2, const void* b2,
                        const void* w2, const void* s3, const void* b3, int n,
                        int h, int w, int c, int e, int th, int tw,
                        void* stream) {
  using namespace p3;
  const int nq = (th + 2) * (tw + 2);
  if (mode < kCopy || mode > kFullBf16 || th < 1 || tw < 1 ||
      th * tw > kMaxPix || nq > max_halo<1>() || c < 1 || c > kOG || e < 1 ||
      (mode <= kDwBf16 && c > e) || n > 65535)
    return (int)cudaErrorInvalidValue;
  if (mode == kFull)
    return ffcnn_block::run_block<1>(x, y, bf16, bf16, w1, s1, b1, kdw, s2,
                                     b2, w2, s3, b3, n, h, w, c, e, c, kLeaky,
                                     kLeaky, kLinear, 1, kLinear, th, tw,
                                     stream);
  if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  Args a{x, y,
         (const float*)w1, (const float*)s1, (const float*)b1,
         (const float*)kdw, (const float*)s2, (const float*)b2,
         (const float*)w2, (const float*)s3, (const float*)b3,
         n, h, w, c, e, c, h, w, kLeaky, kLeaky, kLinear, 1, kLinear,
         th, tw, (w + tw - 1) / tw, (c + 3) / 4 * 4};
  const bool raw = mode == kDwMixed || mode == kDwBf16;
  const size_t smem =
      mode <= kDwBf16
          ? (size_t)nq * c * (raw && bf16 ? 2 : 4)
          : sizeof(float) * ((size_t)nq * a.cp + a.cp * kEC + nq * kEC +
                             kMaxPix * kEC + kEC * kOG);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid(((h + th - 1) / th) * a.tiles_w, n, 1);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    dispatch<__nv_bfloat16>(a, mode, grid, smem, s);
  else
    dispatch<float>(a, mode, grid, smem, s);
  return (int)cudaGetLastError();
}

const char* ffcnn_variant_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
