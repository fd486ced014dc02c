// K9: the channels-first inverted-residual block of the block A/B bench,
// stride 1, on (C, S) tensors with S = N*H*W, with the TPU kernel's own
// rounding points (T = x's dtype):
//
//   mid = act_mid(w1 @ x * s1 + b1)                  (float32, zero padded)
//   d   = round_T( act_dw(dw3x3(mid) * sd + bd) )
//   y   = round_T( act_out(w2 @ d * s2 + b2) + res )  (res: optional)
//
// w1 and w2 come in T (the wrapper rounds them, as the JAX wrapper does);
// the taps, scales and biases are float32.
//
// Replaces ffcnn_tpu/kernels/csblock_pallas.py::_cs_kernel (launched by
// fused_mbconv_cs).  The TPU kernel puts S on the 128-wide lanes and reaches
// a depthwise tap by a lane roll of the whole f32 mid tensor by dy*W+dx,
// with iota row and column masks for the image edges.  Here no roll is
// needed: a tap is an index offset of dy*W+dx along S into the tile's halo
// in shared memory, and the edge masks are the zeroed halo pixels outside
// the image.
//
// Bound on this card: as K8 (mbconv.cu), the expand tensor (8-224 channels)
// is what the unfused chain moves through device memory; the fused block is
// bound by its boundary bytes at narrow widths and by its multiply-adds at
// wide ones.  The design is K1's chunk scheme (block_fused.cuh, included
// read-only for its constants and helpers): a CTA owns a TH x TW tile of one
// image and 128 output channels, loads its input halo once, walks the expand
// in chunks of 32 channels (expand the halo, depthwise, add the chunk's
// share of the projection to registers).  Channels-first, neighbouring S
// are neighbouring addresses: the halo is loaded with neighbouring threads
// on neighbouring S, and the output tile is staged through shared memory so
// that its stores, and the residual's loads, are made the same way.  Expand
// and project are float32 FMAs on the CUDA cores.

#include "block_fused.cuh"

namespace k9 {

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
  const void* x;    // (c, s)
  const void* res;  // (p, s) or null
  void* y;          // (p, s)
  const void *w1, *w2;                  // (e, c), (p, e) in T
  const float *s1, *b1, *wd, *sd, *bd, *s2, *b2;
  size_t s;
  int n, h, w, c, e, p;
  int act_mid, act_dw, act_out;  // activation ids: 2 leaky, 0 linear
  int th, tw, tiles_w, cp;
};

template <typename T, int PJ>
__global__ void __launch_bounds__(kThreads) mbconv_cs_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);     // [nq][cp] input halo
  const int th = a.th, tw = a.tw;
  const int hw = tw + 2, nq = (th + 2) * hw;
  const int cp = a.cp, npix = th * tw;
  float* w1s = xs + nq * cp;                        // [cp][kEC]
  float* h1s = w1s + cp * kEC;                      // [nq][kEC]
  float* h2s = h1s + nq * kEC;                      // [kMaxPix][kEC]
  float* w2s = h2s + kMaxPix * kEC;                 // [kEC][kOG]
  float* ys = w1s;  // after the chunks: [32*PJ][npix+1] output tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty0 = (blockIdx.x / a.tiles_w) * th;   // output tile origin
  const int tx0 = (blockIdx.x % a.tiles_w) * tw;
  const int img = blockIdx.y, og = blockIdx.z * kOG;
  const size_t base = (size_t)img * a.h * a.w;     // the image's first s
  const T* x = static_cast<const T*>(a.x);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2);

  // the halo, pixel-fastest: neighbouring threads read neighbouring s
  for (int i = tid; i < nq * cp; i += kThreads) {
    const int c = i / nq, q = i - c * nq;
    const int gy = ty0 - 1 + q / hw, gx = tx0 - 1 + q % hw;
    float v = 0.f;
    if (c < a.c && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w)
      v = to_f32(x[(size_t)c * a.s + base + (size_t)gy * a.w + gx]);
    xs[q * cp + c] = v;
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
      w1s[i] = (c < a.c && e < ec) ? to_f32(w1[(size_t)(e0 + e) * a.c + c])
                                   : 0.f;
    }
    for (int i = tid; i < kEC * kOG; i += kThreads) {
      const int e = i / kOG, o = i - e * kOG;
      w2s[i] = (e < ec && og + o < a.p)
                   ? to_f32(w2[(size_t)(og + o) * a.e + e0 + e]) : 0.f;
    }
    __syncthreads();

    // 1. expand the halo (float32); zero outside the image
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
            const int gy = ty0 - 1 + q / hw, gx = tx0 - 1 + q % hw;
            const bool in = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
            h1s[q * kEC + lane] =
                (in && live) ? act(ex[k] * sc + bi, a.act_mid) : 0.f;
          }
        }
      }
    }
    __syncthreads();

    // 2. depthwise 3x3: tap (dy, dx) is the halo offset dy*hw + dx
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
              s = fmaf(h1s[((py + dy) * hw + px + dx) * kEC + lane],
                       kd[dy * 3 + dx], s);
          h2s[pix * kEC + lane] =
              live ? round_as<T>(act(s * sc + bi, a.act_dw)) : 0.f;
        }
      }
    }
    __syncthreads();

    // 3. project: this chunk's share of y[og + lane + 32j][pixel]
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

  // stage the tile channel-major, then store pixel-fastest
  const int ys_stride = npix + 1;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const int pix = warp + k * kWarps;
    if (pix >= npix) continue;
#pragma unroll
    for (int j = 0; j < PJ; ++j)
      ys[(lane + 32 * j) * ys_stride + pix] = acc[k][j];
  }
  __syncthreads();
  const T* res = static_cast<const T*>(a.res);
  T* y = static_cast<T*>(a.y);
  const int oc = min(32 * PJ, a.p - og);
  for (int i = tid; i < oc * npix; i += kThreads) {
    const int ol = i / npix, pix = i - ol * npix;
    const int py = pix / tw, px = pix - py * tw;
    const int gy = ty0 + py, gx = tx0 + px;
    if (gy >= a.h || gx >= a.w) continue;
    const int o = og + ol;
    const size_t at = (size_t)o * a.s + base + (size_t)gy * a.w + gx;
    float v = act(ys[ol * ys_stride + pix] * a.s2[o] + a.b2[o], a.act_out);
    if (res) v += to_f32(res[at]);
    store(y + at, v);
  }
}

template <typename T, int PJ>
void launch(const Args& a, dim3 grid, size_t smem, cudaStream_t stream) {
  // raise the shared-memory cap once per device for this instance
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit) &&
      cudaFuncSetAttribute(mbconv_cs_kernel<T, PJ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem) == cudaSuccess)
    raised.fetch_or(bit, std::memory_order_relaxed);
  mbconv_cs_kernel<T, PJ><<<grid, kThreads, smem, stream>>>(a);
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

}  // namespace k9

extern "C" {

// x (c, n*h*w), res (p, n*h*w) or null, y (p, n*h*w), w1 (e, c), w2 (p, e),
// contiguous, bfloat16 where bf16 is 1, else float32.  s1/b1 (e), wd
// (3, 3, e), sd/bd (e), s2/b2 (p): float32, contiguous.  act_*: activation
// ids (2 leaky, anything else linear).  (th, tw): output tile, th*tw <= 64
// and (th+2)*(tw+2) <= 104.  Returns cudaErrorInvalidValue for what the
// kernel cannot take (a tile, a batch > 65535, a channel count beyond shared
// memory), else cudaGetLastError().
int ffcnn_mbconv_cs(const void* x, const void* res, void* y, int bf16,
                    const void* w1, const void* s1, const void* b1,
                    const void* wd, const void* sd, const void* bd,
                    const void* w2, const void* s2, const void* b2, int n,
                    int h, int w, int c, int e, int p, int act_mid,
                    int act_dw, int act_out, int th, int tw, void* stream) {
  using namespace k9;
  const int npix = th * tw, nq = (th + 2) * (tw + 2);
  if (th < 1 || tw < 1 || npix > kMaxPix || nq > max_halo<1>())
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || w == 0 || p == 0) return (int)cudaGetLastError();
  Args a{x, res, y, w1, w2,
         (const float*)s1, (const float*)b1, (const float*)wd,
         (const float*)sd, (const float*)bd, (const float*)s2,
         (const float*)b2, (size_t)n * h * w,
         n, h, w, c, e, p, act_mid, act_dw, act_out,
         th, tw, (w + tw - 1) / tw, (c + 3) / 4 * 4};
  // the chunk buffers, or the staged output tile where that is larger
  const size_t chunks = (size_t)a.cp * kEC + nq * kEC + kMaxPix * kEC +
                        kEC * kOG;
  const size_t staged = (size_t)kOG * (npix + 1);
  const size_t smem = sizeof(float) * ((size_t)nq * a.cp +
                                       (chunks > staged ? chunks : staged));
  if (smem > kMaxSmem || n > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(((h + th - 1) / th) * a.tiles_w, n, (p + kOG - 1) / kOG);
  const int pj = p >= kOG ? 4 : (p + 31) / 32;
  if (bf16)
    launch_pj<__nv_bfloat16>(a, pj, grid, smem, (cudaStream_t)stream);
  else
    launch_pj<float>(a, pj, grid, smem, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

const char* ffcnn_mbconv_cs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
