// Fused stride-1 inverted-residual block, NHWC:
//
//   y = act_r( act3( (act2( dw3x3( zpad( act1(x @ w1 * s1 + b1) ) ) * s2 + b2 )
//                     @ w2) * s3 + b3 ) + x )          (residual optional)
//
// Replaces ffcnn_tpu/kernels/block_fused.py::_make_kernel (launched once per
// block by _cs_block).  The dw zero padding applies to the expand OUTPUT:
// halo pixels outside the image are set to 0 after the expand epilogue (pw
// of a zero pixel is act1(b1), not 0).  Math is float32 throughout; the
// input is upcast on load and the output cast once at the store.
//
// Bound on this card: the unfused chain moves the E-wide expand tensor
// (E/C = 6x the block input on yolo-fastest-xl) through device memory twice,
// so the chain is bandwidth bound.  Here the expand never leaves the CTA:
// a CTA owns a TH x TW tile of output pixels of one image and 128 output
// channels, loads the (TH+2) x (TW+2) input halo once into shared memory as
// float32, then walks E in chunks of 32 channels (one per lane):
//   1. expand the halo for the chunk (float4 broadcast reads of x, one
//      channel per lane), apply act1, zero the pixels outside the image;
//   2. depthwise 3x3 + act2 for the tile's pixels;
//   3. add the chunk's share of the projection into float32 accumulators
//      held in registers (8 pixels x 32*PJ channels per thread).
// What remains is device-memory traffic of the block's input and output
// only, and float32 FMAs on the CUDA cores, which now bound the kernel
// (the halo recomputes (TH+2)(TW+2)/(TH*TW) of the expand).  Tensor-core
// (wgmma) expand/project is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEC = 32;                  // expand channels per chunk
constexpr int kMaxPix = 64;              // output pixels per tile
constexpr int kMaxHalo = 104;            // halo pixels per tile
constexpr int kQPT = kMaxHalo / kWarps;  // halo pixels per thread (13)
constexpr int kPPT = kMaxPix / kWarps;   // output pixels per thread (8)
constexpr int kOG = 128;                 // output channels per CTA
constexpr size_t kMaxSmem = 232448;      // a CTA's shared memory on sm_90

struct Args {
  const void* x;
  void* y;
  const float *w1, *s1, *b1, *kdw, *s2, *b2, *w2, *s3, *b3;
  int n, h, w, c, e, p;
  int act1, act2, act3, residual, res_act;
  int th, tw, tiles_w, cp;
};

// ffcnn_tpu/ops/activations.py ids: 1 relu, 2 leaky, 3/5 logistic,
// 4 mish, 6 swish, anything else linear.
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int PJ>
__global__ void __launch_bounds__(kThreads) block_s1_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);     // [nq][cp] input halo
  const int th = a.th, tw = a.tw, hw = tw + 2, nq = (th + 2) * hw;
  const int cp = a.cp, npix = th * tw;
  float* w1s = xs + nq * cp;                        // [cp][kEC]
  float* h1s = w1s + cp * kEC;                      // [nq][kEC]
  float* h2s = h1s + nq * kEC;                      // [kMaxPix][kEC]
  float* w2s = h2s + kMaxPix * kEC;                 // [kEC][kOG]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty0 = (blockIdx.x / a.tiles_w) * th;
  const int tx0 = (blockIdx.x % a.tiles_w) * tw;
  const int img = blockIdx.y, og = blockIdx.z * kOG;
  const T* x = static_cast<const T*>(a.x);

  for (int i = tid; i < nq * cp; i += kThreads) {
    const int q = i / cp, c = i - q * cp;
    const int gy = ty0 - 1 + q / hw, gx = tx0 - 1 + q % hw;
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
      w1s[i] = (c < a.c && e < ec) ? a.w1[(size_t)c * a.e + e0 + e] : 0.f;
    }
    for (int i = tid; i < kEC * kOG; i += kThreads) {
      const int e = i / kOG, o = i - e * kOG;
      w2s[i] = (e < ec && og + o < a.p)
                   ? a.w2[(size_t)(e0 + e) * a.p + og + o] : 0.f;
    }
    __syncthreads();

    // 1. expand the halo: lane = chunk channel, warps stride the pixels
    {
      float ex[kQPT];
#pragma unroll
      for (int k = 0; k < kQPT; ++k) ex[k] = 0.f;
      for (int c = 0; c < cp; c += 4) {
        const float wa = w1s[c * kEC + lane], wb = w1s[(c + 1) * kEC + lane];
        const float wc = w1s[(c + 2) * kEC + lane];
        const float wd = w1s[(c + 3) * kEC + lane];
#pragma unroll
        for (int k = 0; k < kQPT; ++k) {
          const int q = min(warp + k * kWarps, nq - 1);
          const float4 v = *reinterpret_cast<const float4*>(xs + q * cp + c);
          ex[k] = fmaf(v.x, wa, ex[k]);
          ex[k] = fmaf(v.y, wb, ex[k]);
          ex[k] = fmaf(v.z, wc, ex[k]);
          ex[k] = fmaf(v.w, wd, ex[k]);
        }
      }
      const float sc = live ? a.s1[e0 + lane] : 0.f;
      const float bi = live ? a.b1[e0 + lane] : 0.f;
#pragma unroll
      for (int k = 0; k < kQPT; ++k) {
        const int q = warp + k * kWarps;
        if (q < nq) {
          const int gy = ty0 - 1 + q / hw, gx = tx0 - 1 + q % hw;
          const bool in = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
          h1s[q * kEC + lane] = (in && live) ? act(ex[k] * sc + bi, a.act1)
                                             : 0.f;
        }
      }
    }
    __syncthreads();

    // 2. depthwise 3x3 over the tile's output pixels
    {
      float kd[9];
#pragma unroll
      for (int t = 0; t < 9; ++t)
        kd[t] = live ? a.kdw[(size_t)(e0 + lane) * 9 + t] : 0.f;
      const float sc = live ? a.s2[e0 + lane] : 0.f;
      const float bi = live ? a.b2[e0 + lane] : 0.f;
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
          h2s[pix * kEC + lane] = live ? act(s * sc + bi, a.act2) : 0.f;
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
    if (gy >= a.h || gx >= a.w) continue;
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      const int o = og + lane + 32 * j;
      if (o >= a.p) continue;
      float v = act(acc[k][j] * a.s3[o] + a.b3[o], a.act3);
      if (a.residual)
        v = act(v + xs[((py + 1) * hw + px + 1) * cp + o], a.res_act);
      store(y + (((size_t)img * a.h + gy) * a.w + gx) * a.p + o, v);
    }
  }
}

template <typename T, int PJ>
void launch(const Args& a, dim3 grid, size_t smem, cudaStream_t stream) {
  // The shared-memory cap is a per-device attribute of the instance: raise
  // it to the card's maximum once per device, not on every launch.
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit) &&
      cudaFuncSetAttribute(block_s1_kernel<T, PJ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem) == cudaSuccess)
    raised.fetch_or(bit, std::memory_order_relaxed);
  block_s1_kernel<T, PJ><<<grid, kThreads, smem, stream>>>(a);
}

template <typename T>
void launch_pj(const Args& a, int pj, dim3 grid, size_t smem,
               cudaStream_t stream) {
  switch (pj) {
    case 1: launch<T, 1>(a, grid, smem, stream); break;
    case 2: launch<T, 2>(a, grid, smem, stream); break;
    case 3: launch<T, 3>(a, grid, smem, stream); break;
    default: launch<T, 4>(a, grid, smem, stream); break;
  }
}

}  // namespace

extern "C" {

// x (n, h, w, c) and y (n, h, w, p): float32 (bf16 == 0) or bfloat16,
// contiguous.  w1 (c, e), s1/b1 (e), kdw (e, 9), s2/b2 (e), w2 (e, p),
// s3/b3 (p): float32, contiguous.  (th, tw): output tile, th*tw <= 64 and
// (th+2)*(tw+2) <= 104.  Returns cudaErrorInvalidValue for a tile, a batch
// (> 65535) or a channel count (shared memory) it cannot take, else
// cudaGetLastError().
int ffcnn_block_s1(const void* x, void* y, int bf16, const void* w1,
                   const void* s1, const void* b1, const void* kdw,
                   const void* s2, const void* b2, const void* w2,
                   const void* s3, const void* b3, int n, int h, int w, int c,
                   int e, int p, int act1, int act2, int act3, int residual,
                   int res_act, int th, int tw, void* stream) {
  if (th < 1 || tw < 1 || th * tw > kMaxPix ||
      (th + 2) * (tw + 2) > kMaxHalo)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || w == 0 || p == 0) return (int)cudaGetLastError();
  Args a{x, y,
         (const float*)w1, (const float*)s1, (const float*)b1,
         (const float*)kdw, (const float*)s2, (const float*)b2,
         (const float*)w2, (const float*)s3, (const float*)b3,
         n, h, w, c, e, p, act1, act2, act3, residual, res_act,
         th, tw, (w + tw - 1) / tw, (c + 3) / 4 * 4};
  const int nq = (th + 2) * (tw + 2);
  const size_t smem = sizeof(float) * ((size_t)nq * a.cp + a.cp * kEC +
                                       nq * kEC + kMaxPix * kEC + kEC * kOG);
  if (smem > kMaxSmem || n > 65535) return (int)cudaErrorInvalidValue;
  const int tiles = ((h + th - 1) / th) * a.tiles_w;
  const dim3 grid(tiles, n, (p + kOG - 1) / kOG);
  const int pj = p >= kOG ? 4 : (p + 31) / 32;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    launch_pj<__nv_bfloat16>(a, pj, grid, smem, s);
  else
    launch_pj<float>(a, pj, grid, smem, s);
  return (int)cudaGetLastError();
}

const char* ffcnn_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
