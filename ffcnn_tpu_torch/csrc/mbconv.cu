// K8: the NHWC inverted-residual block of the block A/B bench, stride S
// (1 or 2), with the TPU kernel's own rounding points (T = x's dtype):
//
//   h1 = round_T( act_mid(x @ w1 * s1 + b1) )          (zero padded)
//   d  = round_T( leaky(dw3x3_S(h1) * sd + bd) )
//   y  = round_T( act_out(d @ w2 * s2 + b2) + res )    (res: optional)
//
// Replaces ffcnn_tpu/kernels/block_pallas.py::_block_kernel (launched by
// fused_mbconv).  The TPU kernel keeps a batch tile's whole block in VMEM:
// expand into a zero-padded scratch of x's dtype, nine shifted FMAs, project.
// Weights stay float32; products and sums are float32.
//
// Bound on this card: at the bench's shapes the block's boundary tensors
// (x, res, y) are few channels wide (4-48) against an expand of 8-224, so
// the unfused chain is bound by moving the expand tensor through device
// memory, and a fused block by its boundary bytes or, at wide expands, by
// the multiply-adds.  The design keeps the expand out of device memory with
// K1's chunk scheme (block_fused.cuh, included read-only for its constants
// and helpers): a CTA owns a TH x TW tile of output pixels of one image and
// 128 output channels, loads the input halo once into shared memory as
// float32, then walks the expand in chunks of 32 channels (one per lane):
// expand the halo (zeroed outside the image, rounded to T), depthwise 3x3 at
// stride S (rounded to T), and add the chunk's share of the projection to
// float32 accumulators in registers.  Expand and project are float32 FMAs
// on the CUDA cores; narrow channel counts leave most lanes idle, so this
// first design is bound by issue, not by the card's bytes or peak rate.

#include "block_fused.cuh"

namespace k8 {

using ffcnn_block::act;
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

template <typename T>
__device__ __forceinline__ float round_as(float v) { return v; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Args {
  const void* x;
  const void* res;  // null: no residual add
  void* y;
  const float *w1, *s1, *b1, *wd, *sd, *bd, *w2, *s2, *b2;
  int n, h, w, c, e, p, ho, wo;
  int act_mid, act_out;  // activation ids: 2 leaky, 0 linear
  int th, tw, tiles_w, cp;
};

template <typename T, int PJ, int S>
__global__ void __launch_bounds__(kThreads) mbconv_kernel(Args a) {
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
      w1s[i] = (c < a.c && e < ec) ? a.w1[(size_t)c * a.e + e0 + e] : 0.f;
    }
    for (int i = tid; i < kEC * kOG; i += kThreads) {
      const int e = i / kOG, o = i - e * kOG;
      w2s[i] = (e < ec && og + o < a.p)
                   ? a.w2[(size_t)(e0 + e) * a.p + og + o] : 0.f;
    }
    __syncthreads();

    // 1. expand the halo, rounded to T; zero outside the image
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
          const float wdd = w1s[(c + 3) * kEC + lane];
#pragma unroll
          for (int k = 0; k < kQPT; ++k) {
            const int q = min(q0 + warp + k * kWarps, nq - 1);
            const float4 v =
                *reinterpret_cast<const float4*>(xs + q * cp + c);
            ex[k] = fmaf(v.x, wa, ex[k]);
            ex[k] = fmaf(v.y, wb, ex[k]);
            ex[k] = fmaf(v.z, wc, ex[k]);
            ex[k] = fmaf(v.w, wdd, ex[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < kQPT; ++k) {
          const int q = q0 + warp + k * kWarps;
          if (q < nq) {
            const int gy = iy0 + q / hw, gx = ix0 + q % hw;
            const bool in = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
            h1s[q * kEC + lane] =
                (in && live) ? round_as<T>(act(ex[k] * sc + bi, a.act_mid))
                             : 0.f;
          }
        }
      }
    }
    __syncthreads();

    // 2. depthwise 3x3 (stride S), leaky, rounded to T
    {
      float kd[9];
#pragma unroll
      for (int t = 0; t < 9; ++t)
        kd[t] = live ? a.wd[(size_t)t * a.e + e0 + lane] : 0.f;
      const float sc = live ? a.sd[e0 + lane] : 0.f;
      const float bi = live ? a.bd[e0 + lane] : 0.f;
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
          h2s[pix * kEC + lane] =
              live ? round_as<T>(act(s * sc + bi, 2)) : 0.f;
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

  const T* res = static_cast<const T*>(a.res);
  T* y = static_cast<T*>(a.y);
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const int pix = warp + k * kWarps;
    if (pix >= npix) continue;
    const int py = pix / tw, px = pix - py * tw;
    const int gy = ty0 + py, gx = tx0 + px;
    if (gy >= a.ho || gx >= a.wo) continue;
    const size_t at = (((size_t)img * a.ho + gy) * a.wo + gx) * a.p;
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      const int o = og + lane + 32 * j;
      if (o >= a.p) continue;
      float v = act(acc[k][j] * a.s2[o] + a.b2[o], a.act_out);
      if (res) v += to_f32(res[at + o]);
      store(y + at + o, v);
    }
  }
}

template <typename T, int PJ, int S>
void launch(const Args& a, dim3 grid, size_t smem, cudaStream_t stream) {
  // raise the shared-memory cap once per device for this instance
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit) &&
      cudaFuncSetAttribute(mbconv_kernel<T, PJ, S>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem) == cudaSuccess)
    raised.fetch_or(bit, std::memory_order_relaxed);
  mbconv_kernel<T, PJ, S><<<grid, kThreads, smem, stream>>>(a);
}

template <typename T, int S>
void launch_pj(const Args& a, int pj, dim3 grid, size_t smem,
               cudaStream_t stream) {
  switch (pj) {
    case 1: launch<T, 1, S>(a, grid, smem, stream); break;
    case 2: launch<T, 2, S>(a, grid, smem, stream); break;
    case 3: launch<T, 3, S>(a, grid, smem, stream); break;
    default: launch<T, 4, S>(a, grid, smem, stream); break;
  }
}

}  // namespace k8

extern "C" {

// x (n, h, w, c), res (n, h/s, w/s, p) or null, y (n, h/s, w/s, p),
// contiguous, bfloat16 where bf16 is 1, else float32.  w1 (c, e), s1/b1 (e),
// wd (3, 3, e), sd/bd (e), w2 (e, p), s2/b2 (p): float32, contiguous.
// act_mid/act_out: 1 leaky, 0 linear.  (th, tw): output tile, th*tw <= 64,
// halo (s*th+3-s)*(s*tw+3-s) <= 104 at stride 1 and <= 160 at stride 2.
// Returns cudaErrorInvalidValue for what the kernel cannot take (a tile, a
// stride, odd sizes at stride 2, a batch > 65535, a channel count beyond
// shared memory), else cudaGetLastError().
int ffcnn_mbconv(const void* x, const void* res, void* y, int bf16,
                 const void* w1, const void* s1, const void* b1,
                 const void* wd, const void* sd, const void* bd,
                 const void* w2, const void* s2, const void* b2, int n, int h,
                 int w, int c, int e, int p, int stride, int act_mid,
                 int act_out, int th, int tw, void* stream) {
  using namespace k8;
  const int S = stride;
  if (S != 1 && S != 2) return (int)cudaErrorInvalidValue;
  const int hw = S * tw + 3 - S, nq = (S * th + 3 - S) * hw;
  if (th < 1 || tw < 1 || th * tw > kMaxPix ||
      nq > (S == 1 ? max_halo<1>() : max_halo<2>()) || h % S || w % S)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || w == 0 || p == 0) return (int)cudaGetLastError();
  const int ho = h / S, wo = w / S;
  Args a{x, res, y,
         (const float*)w1, (const float*)s1, (const float*)b1,
         (const float*)wd, (const float*)sd, (const float*)bd,
         (const float*)w2, (const float*)s2, (const float*)b2,
         n, h, w, c, e, p, ho, wo, act_mid ? 2 : 0, act_out ? 2 : 0,
         th, tw, (wo + tw - 1) / tw, (c + 3) / 4 * 4};
  const size_t smem = sizeof(float) * ((size_t)nq * a.cp + a.cp * kEC +
                                       nq * kEC + kMaxPix * kEC + kEC * kOG);
  if (smem > kMaxSmem || n > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(((ho + th - 1) / th) * a.tiles_w, n, (p + kOG - 1) / kOG);
  const int pj = p >= kOG ? 4 : (p + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16 && S == 1)
    launch_pj<__nv_bfloat16, 1>(a, pj, grid, smem, st);
  else if (bf16)
    launch_pj<__nv_bfloat16, 2>(a, pj, grid, smem, st);
  else if (S == 1)
    launch_pj<float, 1>(a, pj, grid, smem, st);
  else
    launch_pj<float, 2>(a, pj, grid, smem, st);
  return (int)cudaGetLastError();
}

const char* ffcnn_mbconv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
