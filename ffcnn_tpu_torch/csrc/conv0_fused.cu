// K6: the 3x3 / stride-2 / pad-1 stem straight off uint8 pixels, NHWC:
//
//   y[n, r, c, f] = act( s[f] * sum_{dy, dx, ch} x[n, 2r-1+dy, 2c-1+dx, ch]
//                                               * wm[(dy*3 + dx)*3 + ch, f]
//                        + b[f] )
//
// Replaces ffcnn_tpu/kernels/conv0_fused.py::_make_kernel (launched by
// conv0_cs).  wm is the folded conv-1 (BGR swap and normalisation folded
// into the weights) kept in float32, its 27 rows in HWIO order (dy, dx, ch);
// pixels outside the image are 0 (the conv's zero pad on the raw bytes).
//
// Bound on this card: device memory.  Per output pixel the stem reads 12
// new input bytes (its 27 taps overlap its neighbours', served by L1) and
// writes F values (16 bf16 = 32 bytes on yolo-fastest-xl), against 27*F
// FMAs: about 10 FMAs per byte moved, far below the card's float32 rate
// per byte.  So the design moves each byte once: one thread per output
// pixel holds its 27 taps in registers, the weights sit in shared memory
// (broadcast reads), and each thread stores its pixel's F outputs as
// 16-byte vectors where F allows.  The TPU kernel's
// in-kernel batch-to-lanes transpose and (H, C, W*N) output layout do not
// apply: the port stays NHWC, and the stem's output feeds the region run
// that starts at layer 1 as it is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 27;      // 3 x 3 x 3 channels
constexpr int kFC = 16;        // output channels per register pass
constexpr int kMaxF = 256;     // shared weights: 27 x 256 float32 = 27 KB

__device__ __forceinline__ float act(float v, int a) {
  switch (a) {
    case 1: return fmaxf(v, 0.f);
    case 2: return v > 0.f ? v : v * 0.1f;
    case 3:
    case 5: return 1.f / (1.f + expf(-v));
    case 4: return v * tanhf(log1pf(expf(v)));
    case 6: return v * (1.f / (1.f + expf(-v)));
    default: return v;
  }
}

__device__ __forceinline__ void put(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void put(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = __floats2bfloat162_rn(v[2 * i],
                                                           v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(q);
}
__device__ __forceinline__ void put1(float* p, float v) { *p = v; }
__device__ __forceinline__ void put1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv0_kernel(const uint8_t* __restrict__ x, T* __restrict__ y,
             const float* __restrict__ wm, const float* __restrict__ sc,
             const float* __restrict__ bi, int n, int h, int w, int f,
             int actid) {
  __shared__ float ws[kTaps * kMaxF];
  for (int i = threadIdx.x; i < kTaps * f; i += kThreads) ws[i] = wm[i];
  __syncthreads();

  const int ho = h / 2, wo = w / 2;
  const long long pix = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (pix >= (long long)n * ho * wo) return;
  const int img = (int)(pix / ((long long)ho * wo));
  const int rem = (int)(pix - (long long)img * ho * wo);
  const int oy = rem / wo, ox = rem - oy * wo;

  float v[kTaps];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int gy = 2 * oy - 1 + dy;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int gx = 2 * ox - 1 + dx;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
      const size_t at = in ? (((size_t)img * h + gy) * w + gx) * 3 : 0;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        v[(dy * 3 + dx) * 3 + ch] = in ? (float)__ldg(x + at + ch) : 0.f;
    }
  }

  T* out = y + (size_t)pix * f;
  const int vec = 16 / (int)sizeof(T);        // outputs per 16-byte store
  for (int f0 = 0; f0 < f; f0 += kFC) {
    float acc[kFC];
#pragma unroll
    for (int j = 0; j < kFC; ++j) acc[j] = 0.f;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
#pragma unroll
      for (int j = 0; j < kFC; ++j)
        if (f0 + j < f) acc[j] = fmaf(v[t], ws[t * f + f0 + j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kFC; ++j)
      if (f0 + j < f) acc[j] = act(acc[j] * sc[f0 + j] + bi[f0 + j], actid);
    if (f % vec == 0 && f0 + kFC <= f) {
#pragma unroll
      for (int j = 0; j < kFC; j += vec)
        put(out + f0 + j, acc + j);
    } else {
      for (int j = 0; j < kFC && f0 + j < f; ++j) put1(out + f0 + j, acc[j]);
    }
  }
}

}  // namespace

extern "C" {

// x (n, h, w, 3) uint8, contiguous, h and w even; y (n, h/2, w/2, f)
// float32 (bf16 == 0) or bfloat16, contiguous; wm (27, f), s/b (f)
// float32.  Returns cudaErrorInvalidValue for a size it cannot take, else
// cudaGetLastError().
int ffcnn_conv0(const void* x, void* y, int bf16, const void* wm,
                const void* s, const void* b, int n, int h, int w, int f,
                int actid, void* stream) {
  if (h % 2 || w % 2 || f < 1 || f > kMaxF) return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * (h / 2) * (w / 2);
  if (total == 0) return (int)cudaGetLastError();
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    conv0_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const uint8_t*)x, (__nv_bfloat16*)y, (const float*)wm,
        (const float*)s, (const float*)b, n, h, w, f, actid);
  else
    conv0_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const uint8_t*)x, (float*)y, (const float*)wm, (const float*)s,
        (const float*)b, n, h, w, f, actid);
  return (int)cudaGetLastError();
}

const char* ffcnn_conv0_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
