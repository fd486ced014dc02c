// P3: K1's stride-1 block cut into the variants of the small-C bisection,
// NHWC, P = C, with the bisection's fixed activations (leaky expand, leaky
// depthwise, linear project, linear residual); T is the storage type:
//
//   copy      y = x, streamed through shared memory
//   dwonly    y = T(leaky(sum_taps xpad * kdw[:C][dy*3+dx])), float32 rows
//   dwmixed   the same sums, with the rows held in shared memory in T
//   dwbf16    rows held in T, taps kdw rounded to bf16; with T = bf16
//             every product and every sum rounds to bf16 (__hmul2_rn and
//             __hadd2_rn, which nvcc never contracts into an FMA) and the
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
// takes K1's arguments (kdw as K1's (E, 9)).  `full` launches K1's own
// template; pwonly and fullbf16 run the tensor-core body with rounding
// points (block_round_mma.cuh) under their policies: pwonly without the
// depthwise stage, float32 kept; fullbf16 with bf16 weights and both
// rounding points at bf16, its products one bf16 m16n8k16 pass with bf16
// storage.  So the split the probe reports is that of K1's own scheme.
//
// Bound on this card: every variant moves the block's input and output
// once.  The tap modes are bound by those bytes; their kernel is written
// for them: a CTA owns a band of whole rows of one image (rows chosen by
// the wrapper, kernels/block_variants.py::tap_band), stages the band and
// its two halo rows by cp.async in 16-byte pieces (a row of an NHWC image
// is contiguous, so the band is one run of bytes; rows outside the image
// are zero-filled), and each thread computes whole 8-channel vectors of
// pixels (C a multiple of 8), its vector's 72 taps in registers, storing
// 16 bytes at a time; neighbouring threads take neighbouring vectors, so
// the stores are contiguous.  The full modes add the pointwise
// multiply-adds on the tensor cores.

#include <type_traits>

#include "block_mma.cuh"
#include "block_round_mma.cuh"

namespace p3 {

using ffcnn_block::act;
using ffcnn_block::kMaxSmem;
using ffcnn_block::kOG;
using ffcnn_block::kThreads;
using ffcnn_block::mma::cp_commit;
using ffcnn_block::mma::cp_wait;
namespace rnd = ffcnn_block::rnd;

enum Mode { kCopy, kDwOnly, kDwMixed, kDwBf16, kPwOnly, kFull, kFullBf16 };

// the bisection's activations, as K1's ids (ffcnn_tpu/ops/activations.py)
constexpr int kLeaky = 2, kLinear = 0;
constexpr float kSlopeBf16 = 0.10009765625f;  // bf16(0.1)

// The tap modes' shared memory for a band of `rows` output rows: the rows
// and their halo rows in T, and (dwonly with bf16 storage) the same rows
// as float32.  The tests mirror it (kernels/block_variants.py::tap_smem).
inline size_t tap_smem(int rows, int w, int c, int isz, int mode) {
  const int halo = mode == kCopy ? 0 : 2;
  const size_t row = (size_t)w * c;
  return (size_t)(rows + halo) * row *
         (isz + (mode == kDwOnly && isz == 2 ? 4 : 0));
}

struct Band {
  const void* x;
  void* y;
  const float* kdw;
  int h, w, c, rows;  // rows: output rows a CTA (the last band may hold fewer)
};

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

// 8 channels held in shared memory, as float32
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(b[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// 8 channels to device memory, 16 bytes a store
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    b[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// copy and the three tap modes on a band of whole rows (see the header)
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) tap_kernel(Band a) {
  constexpr int halo = MODE == kCopy ? 0 : 1;
  constexpr bool kF32Rows = MODE == kDwOnly && sizeof(T) == 2;
  constexpr bool kHalf = MODE == kDwBf16 && sizeof(T) == 2;
  using R = typename std::conditional<kF32Rows, float, T>::type;
  extern __shared__ float4 smem4[];
  char* band = reinterpret_cast<char*>(smem4);  // [rows + 2 halo][w][c] T
  const int w = a.w, c = a.c;
  const int r0 = blockIdx.x * a.rows, rows = min(a.rows, a.h - r0);
  const int nrows = rows + 2 * halo;
  const size_t row_bytes = (size_t)w * c * sizeof(T);
  const int ppr = (int)(row_bytes >> 4);  // 16-byte pieces a row
  const char* xi =
      static_cast<const char*>(a.x) + (size_t)blockIdx.y * a.h * row_bytes;
  T* yi = static_cast<T*>(a.y) + ((size_t)blockIdx.y * a.h + r0) * w * c;

  // the band: input rows r0 - halo .. r0 + rows - 1 + halo, one run of bytes
  for (int i = threadIdx.x; i < nrows * ppr; i += kThreads) {
    const int r = i / ppr, gy = r0 - halo + r;
    const bool ok = gy >= 0 && gy < a.h;
    cp16(band + (size_t)i * 16,
         ok ? xi + (size_t)gy * row_bytes + (size_t)(i - r * ppr) * 16 : xi,
         ok);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  if constexpr (MODE == kCopy) {
    const uint4* src = reinterpret_cast<const uint4*>(band);
    uint4* dst = reinterpret_cast<uint4*>(yi);
    for (int i = threadIdx.x; i < rows * ppr; i += kThreads) dst[i] = src[i];
    return;
  } else {
    const R* rs = reinterpret_cast<const R*>(band);
    if constexpr (kF32Rows) {  // dwonly: the rows upcast to float32
      float* fb = reinterpret_cast<float*>(band + (size_t)(a.rows + 2) *
                                                      row_bytes);
      const __nv_bfloat16* tb = reinterpret_cast<const __nv_bfloat16*>(band);
      for (int i = threadIdx.x; i < nrows * w * c / 8; i += kThreads) {
        float v[8];
        load8(tb + 8 * i, v);
        store8(fb + 8 * i, v);
      }
      __syncthreads();
      rs = fb;
    }

    // thread = (pixel, 8-channel vector v): neighbouring threads take
    // neighbouring vectors, so v is fixed for a thread and its taps stay in
    // registers
    const int nv = c >> 3, per = kThreads / nv;
    if (threadIdx.x >= per * nv) return;
    const int c0 = (threadIdx.x % nv) << 3;
    float kd[9][8];
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        kd[t][k] = a.kdw[(size_t)(c0 + k) * 9 + t];
        if (MODE == kDwBf16) kd[t][k] = rnd::round_bf16(kd[t][k]);
      }
    __nv_bfloat162 k2[9][4];  // kHalf: the taps as bf16 pairs
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        k2[t][k] = __floats2bfloat162_rn(kd[t][2 * k], kd[t][2 * k + 1]);
    for (int pix = threadIdx.x / nv; pix < rows * w; pix += per) {
      const int py = pix / w, px = pix - py * w;
      float v[8];
      if constexpr (kHalf) {
        // the plain version's order: acc = acc + row * tap, in bf16
        __nv_bfloat162 s[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) s[k] = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int gx = px + dx - 1;
            if (gx < 0 || gx >= w) continue;  // a zero tap adds 0 exactly
            const uint4 u = *reinterpret_cast<const uint4*>(
                rs + ((size_t)(py + dy) * w + gx) * c + c0);
            const __nv_bfloat162* r2 =
                reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              s[k] = __hadd2_rn(s[k], __hmul2_rn(r2[k], k2[dy * 3 + dx][k]));
          }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(s[k]);
          v[2 * k] = f.x > 0.f ? f.x : f.x * kSlopeBf16;
          v[2 * k + 1] = f.y > 0.f ? f.y : f.y * kSlopeBf16;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int gx = px + dx - 1;
            if (gx < 0 || gx >= w) continue;
            float r[8];
            load8(rs + ((size_t)(py + dy) * w + gx) * c + c0, r);
#pragma unroll
            for (int k = 0; k < 8; ++k)
              v[k] = fmaf(r[k], kd[dy * 3 + dx][k], v[k]);
          }
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = act(v[k], kLeaky);
      }
      store8(yi + (size_t)pix * c + c0, v);
    }
  }
}

template <typename T, int MODE>
void launch_tap(const Band& b, dim3 grid, size_t smem, cudaStream_t s) {
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit) &&
      cudaFuncSetAttribute(tap_kernel<T, MODE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem) == cudaSuccess)
    raised.fetch_or(bit, std::memory_order_relaxed);
  tap_kernel<T, MODE><<<grid, kThreads, smem, s>>>(b);
}

template <typename T>
void dispatch_tap(const Band& b, int mode, dim3 grid, size_t smem,
                  cudaStream_t s) {
  switch (mode) {
    case kCopy: launch_tap<T, kCopy>(b, grid, smem, s); break;
    case kDwOnly: launch_tap<T, kDwOnly>(b, grid, smem, s); break;
    case kDwMixed: launch_tap<T, kDwMixed>(b, grid, smem, s); break;
    default: launch_tap<T, kDwBf16>(b, grid, smem, s); break;
  }
}

// pwonly and fullbf16 on the body, at the smallest instance of kP3Nj that
// holds the tiles a warp needs
template <class P>
int run_body(rnd::Args& a, bool bf16, cudaStream_t s) {
  rnd::Plan pl;
  const int err = rnd::plan<P, 1>(a, pl);
  if (err || pl.empty) return err ? err : (int)cudaGetLastError();
  if (pl.need <= rnd::kP3Nj[0])
    rnd::launch<P, 1, rnd::kP3Nj[0], kLeaky, kLinear>(a, bf16, pl, s);
  else if (pl.need <= rnd::kP3Nj[1])
    rnd::launch<P, 1, rnd::kP3Nj[1], kLeaky, kLinear>(a, bf16, pl, s);
  else
    rnd::launch<P, 1, rnd::kP3Nj[2], kLeaky, kLinear>(a, bf16, pl, s);
  return (int)cudaGetLastError();
}

}  // namespace p3

extern "C" {

// x and y (n, h, w, c), contiguous, bfloat16 where bf16 is 1, else float32.
// mode: 0 copy, 1 dwonly, 2 dwmixed, 3 dwbf16, 4 pwonly, 5 full,
// 6 fullbf16.  w1 (c, e), s1/b1 (e), kdw (e, 9) as K1's, s2/b2 (e), w2
// (e, c), s3/b3 (c): float32, contiguous.  c <= 128.  (th, tw): for pwonly,
// full and fullbf16 the output tile, th*tw <= 64, (th+2)*(tw+2) <= 104;
// for the tap modes (c a multiple of 8, c <= e: their taps are kdw[:c]; x
// and y 16-byte aligned) the band, th output rows of the whole width, tw =
// w, th <= h, its rows fitting shared memory (tap_smem).  Returns
// cudaErrorInvalidValue for what the kernel cannot take, else
// cudaGetLastError().
int ffcnn_block_variant(const void* x, void* y, int bf16, int mode,
                        const void* w1, const void* s1, const void* b1,
                        const void* kdw, const void* s2, const void* b2,
                        const void* w2, const void* s3, const void* b3, int n,
                        int h, int w, int c, int e, int th, int tw,
                        void* stream) {
  using namespace p3;
  if (mode < kCopy || mode > kFullBf16 || c < 1 || c > kOG || e < 1 ||
      n > 65535)
    return (int)cudaErrorInvalidValue;
  if (mode == kFull)
    return ffcnn_block::run_block<1>(x, y, bf16, bf16, w1, s1, b1, kdw, s2,
                                     b2, w2, s3, b3, n, h, w, c, e, c, kLeaky,
                                     kLeaky, kLinear, 1, kLinear, th, tw,
                                     stream);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode <= kDwBf16) {
    const size_t smem = tap_smem(th, w, c, bf16 ? 2 : 4, mode);
    if (c % 8 || c > e || tw != w || th < 1 || (h > 0 && th > h) ||
        smem > kMaxSmem || (uintptr_t)x % 16 || (uintptr_t)y % 16)
      return (int)cudaErrorInvalidValue;
    if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
    const Band b{x, y, (const float*)kdw, h, w, c, th};
    const dim3 grid((h + th - 1) / th, n, 1);
    if (bf16)
      dispatch_tap<__nv_bfloat16>(b, mode, grid, smem, s);
    else
      dispatch_tap<float>(b, mode, grid, smem, s);
    return (int)cudaGetLastError();
  }
  rnd::Args a{x, nullptr, y,
              (const float*)w1, (const float*)s1, (const float*)b1,
              (const float*)kdw, (const float*)s2, (const float*)b2,
              (const float*)w2, (const float*)s3, (const float*)b3,
              n, h, w, c, e, c, 0, 0, kLeaky, kLinear, th, tw, 0, 0};
  if (mode == kPwOnly) return run_body<rnd::PwOnly>(a, bf16 != 0, s);
  return bf16 ? run_body<rnd::FullBf16<true>>(a, true, s)
              : run_body<rnd::FullBf16<false>>(a, false, s);
}

const char* ffcnn_variant_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
