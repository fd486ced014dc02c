// Fused inverted-residual block, NHWC, stride S (1 or 2):
//
//   y = act_r( act3( (act2( dw3x3_S( zpad( act1(x @ w1 * s1 + b1) ) ) * s2
//                      + b2 ) @ w2) * s3 + b3 ) + x )   (residual: S == 1)
//
// The template shared by block_fused.cu (S = 1, K1) and block_down.cu
// (S = 2, K3); each .cu is its own library with its own extern "C" entry,
// so the two compile in parallel.  The dw zero padding applies to the
// expand OUTPUT: halo pixels outside the image are set to 0 after the
// expand epilogue (pw of a zero pixel is act1(b1), not 0).  Math is float32
// throughout; the input is upcast on load and the output cast once at the
// store (input and output types are separate, float32 or bfloat16, so a run
// can keep its boundaries in float32).  block_chain.cuh builds the chained
// kernels (K4, K5) from the helpers here.
//
// Bound on this card: the unfused chain moves the E-wide expand tensor
// (E/C = 3-6x the block input on yolo-fastest-xl) through device memory
// twice, so the chain is bandwidth bound.  Here the expand never leaves the
// CTA: a CTA owns a TH x TW tile of output pixels of one image and 128
// output channels, loads the input halo once into shared memory as float32
// ((TH+2) x (TW+2) pixels at S = 1, (2TH+1) x (2TW+1) at S = 2: output
// pixel (r, c) reads input rows S*r-1 .. S*r+1 and likewise columns), then
// walks E in chunks of 32 channels (one per lane):
//   1. expand the halo for the chunk (float4 broadcast reads of x, one
//      channel per lane; kHaloPass pixels per pass, so the stride-2 halo
//      takes two passes with the registers of one), apply act1, zero the
//      pixels outside the image;
//   2. depthwise 3x3 (stride S) + act2 for the tile's pixels;
//   3. add the chunk's share of the projection into float32 accumulators
//      held in registers (8 pixels x 32*PJ channels per thread).
// What remains is device-memory traffic of the block's input and output
// only, and float32 FMAs on the CUDA cores, which now bound the kernel
// (the halo recomputes halo/(S*S*TH*TW) of the expand).  Tensor-core
// (wgmma) expand/project is the next step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace ffcnn_block {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEC = 32;                   // expand channels per chunk
constexpr int kMaxPix = 64;               // output pixels per tile
constexpr int kHaloPass = 104;            // halo pixels expanded per pass
constexpr int kQPT = kHaloPass / kWarps;  // halo pixels per thread (13)
constexpr int kPPT = kMaxPix / kWarps;    // output pixels per thread (8)
constexpr int kOG = 128;                  // output channels per CTA
constexpr size_t kMaxSmem = 232448;       // a CTA's shared memory on sm_90

// Halo pixels a tile may take: one expand pass at S = 1 (as before the
// stride-2 variant existed), two at S = 2.
template <int S>
constexpr int max_halo() { return S == 1 ? 104 : 160; }

struct Args {
  const void* x;
  void* y;
  const float *w1, *s1, *b1, *kdw, *s2, *b2, *w2, *s3, *b3;
  int n, h, w, c, e, p, ho, wo;
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

template <typename Tin, typename Tout, int PJ, int S>
__global__ void __launch_bounds__(kThreads) block_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);     // [nq][cp] input halo
  const int th = a.th, tw = a.tw;
  const int hw = S * tw + 3 - S, nq = (S * th + 3 - S) * hw;
  const int cp = a.cp, npix = th * tw;
  float* w1s = xs + nq * cp;                        // [cp][kEC]
  float* h1s = w1s + cp * kEC;                      // [nq][kEC]
  float* h2s = h1s + nq * kEC;                      // [kMaxPix][kEC]
  float* w2s = h2s + kMaxPix * kEC;                 // [kEC][kOG]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty0 = (blockIdx.x / a.tiles_w) * th;   // output tile origin
  const int tx0 = (blockIdx.x % a.tiles_w) * tw;
  const int iy0 = S * ty0 - 1, ix0 = S * tx0 - 1;  // input halo origin
  const int img = blockIdx.y, og = blockIdx.z * kOG;
  const Tin* x = static_cast<const Tin*>(a.x);

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
      const float sc = live ? a.s1[e0 + lane] : 0.f;
      const float bi = live ? a.b1[e0 + lane] : 0.f;
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
            h1s[q * kEC + lane] = (in && live)
                                      ? act(ex[k] * sc + bi, a.act1) : 0.f;
          }
        }
      }
    }
    __syncthreads();

    // 2. depthwise 3x3 (stride S) over the tile's output pixels
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
              s = fmaf(h1s[((S * py + dy) * hw + S * px + dx) * kEC + lane],
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

  Tout* y = static_cast<Tout*>(a.y);
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
      if (S == 1 && a.residual)
        v = act(v + xs[((py + 1) * hw + px + 1) * cp + o], a.res_act);
      store(y + (((size_t)img * a.ho + gy) * a.wo + gx) * a.p + o, v);
    }
  }
}

template <typename Tin, typename Tout, int PJ, int S>
void launch(const Args& a, dim3 grid, size_t smem, cudaStream_t stream) {
  // The shared-memory cap is a per-device attribute of the instance: raise
  // it to the card's maximum once per device, not on every launch.
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit) &&
      cudaFuncSetAttribute(block_kernel<Tin, Tout, PJ, S>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem) == cudaSuccess)
    raised.fetch_or(bit, std::memory_order_relaxed);
  block_kernel<Tin, Tout, PJ, S><<<grid, kThreads, smem, stream>>>(a);
}

template <typename Tin, typename Tout, int S>
void launch_pj(const Args& a, int pj, dim3 grid, size_t smem,
               cudaStream_t stream) {
  switch (pj) {
    case 1: launch<Tin, Tout, 1, S>(a, grid, smem, stream); break;
    case 2: launch<Tin, Tout, 2, S>(a, grid, smem, stream); break;
    case 3: launch<Tin, Tout, 3, S>(a, grid, smem, stream); break;
    default: launch<Tin, Tout, 4, S>(a, grid, smem, stream); break;
  }
}

// The C entries' body: checks what the kernel cannot take, then launches.
// (th, tw) is the OUTPUT tile; the output is (h/S) x (w/S).  in_bf16 and
// out_bf16 pick bfloat16 (1) or float32 (0) for x and y.
template <int S>
int run_block(const void* x, void* y, int in_bf16, int out_bf16,
              const void* w1, const void* s1, const void* b1, const void* kdw,
              const void* s2, const void* b2, const void* w2, const void* s3,
              const void* b3, int n, int h, int w, int c, int e, int p,
              int act1, int act2, int act3, int residual, int res_act, int th,
              int tw, void* stream) {
  const int hw = S * tw + 3 - S, nq = (S * th + 3 - S) * hw;
  if (th < 1 || tw < 1 || th * tw > kMaxPix || nq > max_halo<S>() ||
      h % S || w % S || (S != 1 && residual))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || w == 0 || p == 0) return (int)cudaGetLastError();
  const int ho = h / S, wo = w / S;
  Args a{x, y,
         (const float*)w1, (const float*)s1, (const float*)b1,
         (const float*)kdw, (const float*)s2, (const float*)b2,
         (const float*)w2, (const float*)s3, (const float*)b3,
         n, h, w, c, e, p, ho, wo, act1, act2, act3, residual, res_act,
         th, tw, (wo + tw - 1) / tw, (c + 3) / 4 * 4};
  const size_t smem = sizeof(float) * ((size_t)nq * a.cp + a.cp * kEC +
                                       nq * kEC + kMaxPix * kEC + kEC * kOG);
  if (smem > kMaxSmem || n > 65535) return (int)cudaErrorInvalidValue;
  const int tiles = ((ho + th - 1) / th) * a.tiles_w;
  const dim3 grid(tiles, n, (p + kOG - 1) / kOG);
  const int pj = p >= kOG ? 4 : (p + 31) / 32;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16 && out_bf16)
    launch_pj<__nv_bfloat16, __nv_bfloat16, S>(a, pj, grid, smem, s);
  else if (in_bf16)
    launch_pj<__nv_bfloat16, float, S>(a, pj, grid, smem, s);
  else if (out_bf16)
    launch_pj<float, __nv_bfloat16, S>(a, pj, grid, smem, s);
  else
    launch_pj<float, float, S>(a, pj, grid, smem, s);
  return (int)cudaGetLastError();
}

}  // namespace ffcnn_block
