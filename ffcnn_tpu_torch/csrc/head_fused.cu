// K7: a chain of stride-1 convs feeding a yolo head, NHWC, in one launch:
// depthwise (fs 3 or 5, pad fs/2) and pointwise stages, each
// y = act(conv(x) * s + b), float32 inside with float32 weights, one cast
// at the store.
//
// Replaces ffcnn_tpu/kernels/head_fused.py::_make_kernel (launched by
// apply_head_run).  On yolo-fastest-xl the chain is layers 116-120 at 10x10:
// dw5x5 C192, pw 192, dw5x5, pw 192, pw 255.
//
// Bound on this card: the unfused chain writes and reads every stage's map
// through device memory and pays one launch (plus epilogue and cast passes)
// per stage, on maps of only 100 pixels.  Here one CTA owns one image's whole
// chain: the input and each interior map live in two float32 stage buffers
// in shared memory (10x10x192 = 76.8 KB each), so only the chain's input and
// the head's output touch device memory.  Where the two buffers do not fit
// a CTA (xl at 416x416: 13x13x192, 292 KB with the weight chunk), they live
// in a per-image scratch buffer in device memory that the wrapper allocates
// (260 KB an image, 16.6 MB at batch 64, so it stays in the 50 MB L2) and
// shared memory holds the weight chunk alone.  The pointwise weights (192x255
// float32 = 196 KB) do not fit beside the buffers, so they stream through
// shared memory in chunks of 32 input channels.  A pointwise stage gives each
// thread 16 pixels x up to 4 output channels of float32 accumulators in
// registers (the warp reads the same pixel's input: broadcast; consecutive
// lanes read consecutive weights); a depthwise stage gives each thread one
// (pixel, channel) at a time, with bounds checks for the zero pad.  The math
// is float32 FMAs on the CUDA cores, and one CTA per image leaves SMs idle at
// small batches: both are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxStages = 8;
constexpr int kOL = 64;                  // output-channel lanes per pixel group
constexpr int kGroups = kThreads / kOL;  // pixel groups (8)
constexpr int kPP = 16;                  // pixels per thread per pass
constexpr int kKC = 32;                  // pw input channels per weight chunk
constexpr int kMaxOJ = 4;                // pw output channels <= 4 * kOL
constexpr size_t kMaxSmem = 232448;      // a CTA's shared memory on sm_90

struct Stage {
  int kind;  // 0 pointwise, 1 depthwise
  int fs, act, cin, cout;
  const float *w, *s, *b;  // pw w (cin, cout); dw w (cin, fs*fs)
};

struct Args {
  const void* x;
  void* y;
  float* scratch;  // 2 * h * w * cbuf floats an image, or null: in smem
  int h, w, ns, cbuf;
  Stage st[kMaxStages];
};

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

// Pointwise stage: out[p][o] = act(s[o] * sum_c in[p][c] w[c][o] + b[o]).
// Thread (group g, lane l) owns pixels g + kGroups*k and channels l + kOL*j.
// The result goes to shared memory (out) or, for the last stage, to y.
template <typename T, int OJ>
__device__ void pw_stage(const Stage& st, const float* in, float* out, T* y,
                         float* wbuf, int npix) {
  const int tid = threadIdx.x, g = tid / kOL, l = tid % kOL;
  const int cin = st.cin, cout = st.cout;
  for (int p0 = 0; p0 < npix; p0 += kGroups * kPP) {
    float acc[kPP][OJ];
#pragma unroll
    for (int k = 0; k < kPP; ++k)
#pragma unroll
      for (int j = 0; j < OJ; ++j) acc[k][j] = 0.f;
    for (int c0 = 0; c0 < cin; c0 += kKC) {
      const int kc = min(kKC, cin - c0);
      __syncthreads();  // everyone is done with the previous chunk
      for (int i = tid; i < kc * cout; i += kThreads)
        wbuf[i] = st.w[(size_t)c0 * cout + i];
      __syncthreads();
      for (int c = 0; c < kc; ++c) {
        float wv[OJ];
#pragma unroll
        for (int j = 0; j < OJ; ++j) {
          const int o = l + kOL * j;
          wv[j] = o < cout ? wbuf[c * cout + o] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kPP; ++k) {
          const int p = p0 + g + kGroups * k;
          const float v = p < npix ? in[p * cin + c0 + c] : 0.f;
#pragma unroll
          for (int j = 0; j < OJ; ++j) acc[k][j] = fmaf(v, wv[j], acc[k][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < OJ; ++j) {
      const int o = l + kOL * j;
      if (o >= cout) continue;
      const float sc = st.s[o], bi = st.b[o];
#pragma unroll
      for (int k = 0; k < kPP; ++k) {
        const int p = p0 + g + kGroups * k;
        if (p >= npix) continue;
        const float v = act(acc[k][j] * sc + bi, st.act);
        if (y)
          store(y + (size_t)p * cout + o, v);
        else
          out[p * cout + o] = v;
      }
    }
  }
}

// Depthwise stage (fs x fs, pad fs/2, stride 1), one (pixel, channel) per
// thread step; the taps sit in wbuf as (c, fs*fs).
template <typename T>
__device__ void dw_stage(const Stage& st, const float* in, float* out, T* y,
                         float* wbuf, int h, int w) {
  const int c = st.cin, fs = st.fs, r = fs / 2, taps = fs * fs;
  __syncthreads();  // everyone is done with wbuf
  for (int i = threadIdx.x; i < c * taps; i += kThreads) wbuf[i] = st.w[i];
  __syncthreads();
  for (int i = threadIdx.x; i < h * w * c; i += kThreads) {
    const int p = i / c, ch = i - p * c;
    const int py = p / w, px = p - py * w;
    const float* k = wbuf + ch * taps;
    float acc = 0.f;
    for (int dy = 0; dy < fs; ++dy) {
      const int yy = py + dy - r;
      if (yy < 0 || yy >= h) continue;
      for (int dx = 0; dx < fs; ++dx) {
        const int xx = px + dx - r;
        if (xx < 0 || xx >= w) continue;
        acc = fmaf(in[(yy * w + xx) * c + ch], k[dy * fs + dx], acc);
      }
    }
    const float v = act(acc * st.s[ch] + st.b[ch], st.act);
    if (y)
      store(y + (size_t)p * c + ch, v);
    else
      out[p * c + ch] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) head_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int npix = a.h * a.w, img = blockIdx.x;
  float* smem = reinterpret_cast<float*>(smem4);
  float* buf0 = a.scratch ? a.scratch + (size_t)img * 2 * npix * a.cbuf : smem;
  float* buf[2] = {buf0, buf0 + (size_t)npix * a.cbuf};
  float* wbuf = a.scratch ? smem : buf[1] + (size_t)npix * a.cbuf;
  const int c0 = a.st[0].cin;
  const T* x = static_cast<const T*>(a.x) + (size_t)img * npix * c0;
  for (int i = threadIdx.x; i < npix * c0; i += kThreads)
    buf[0][i] = to_f32(x[i]);
  __syncthreads();
  const int cl = a.st[a.ns - 1].cout;
  T* yimg = static_cast<T*>(a.y) + (size_t)img * npix * cl;
  int cur = 0;
  for (int s = 0; s < a.ns; ++s) {
    const Stage& st = a.st[s];
    T* y = s == a.ns - 1 ? yimg : nullptr;
    if (st.kind == 1) {
      dw_stage<T>(st, buf[cur], buf[cur ^ 1], y, wbuf, a.h, a.w);
    } else {
      switch ((st.cout + kOL - 1) / kOL) {
        case 1: pw_stage<T, 1>(st, buf[cur], buf[cur ^ 1], y, wbuf, npix);
                break;
        case 2: pw_stage<T, 2>(st, buf[cur], buf[cur ^ 1], y, wbuf, npix);
                break;
        case 3: pw_stage<T, 3>(st, buf[cur], buf[cur ^ 1], y, wbuf, npix);
                break;
        default: pw_stage<T, 4>(st, buf[cur], buf[cur ^ 1], y, wbuf, npix);
                 break;
      }
    }
    __syncthreads();  // the stage's output is complete
    cur ^= 1;
  }
}

template <typename T>
void launch(const Args& a, int n, size_t smem, cudaStream_t stream) {
  // Raise the shared-memory cap once per device, not on every launch.
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit) &&
      cudaFuncSetAttribute(head_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem) == cudaSuccess)
    raised.fetch_or(bit, std::memory_order_relaxed);
  head_kernel<T><<<n, kThreads, smem, stream>>>(a);
}

}  // namespace

extern "C" {

// Shared memory the kernel needs to hold a chain's stage buffers and weight
// chunk (meta as for ffcnn_head), or 0 for a chain it cannot take (too many
// stages, a stage kind, kernel size or width it does not take, channels that
// do not chain).  Over 232448 bytes, the buffers go to device memory.
size_t ffcnn_head_smem(int h, int w, int ns, const int* meta) {
  if (ns < 1 || ns > kMaxStages || h < 1 || w < 1) return 0;
  size_t cbuf = meta[3], wmax = 0;
  for (int s = 0; s < ns; ++s) {
    const int* m = meta + 5 * s;
    const int kind = m[0], fs = m[1], cin = m[3], cout = m[4];
    if (s > 0 && cin != meta[5 * (s - 1) + 4]) return 0;
    if (kind == 0) {
      if (cout < 1 || cout > kMaxOJ * kOL || cin < 1) return 0;
      wmax = std::max(wmax, (size_t)kKC * cout);
    } else if (kind == 1) {
      if (fs % 2 == 0 || fs < 1 || cin != cout || cin < 1) return 0;
      wmax = std::max(wmax, (size_t)cin * fs * fs);
    } else {
      return 0;
    }
    if (s < ns - 1) cbuf = std::max(cbuf, (size_t)cout);
  }
  return sizeof(float) * (2 * (size_t)h * w * cbuf + wmax);
}

// x (n, h, w, meta[3]) and y (n, h, w, cout of the last stage): float32
// (bf16 == 0) or bfloat16, contiguous.  meta: 5 ints per stage (kind 0 pw /
// 1 dw, fs, act, cin, cout); w, s, b: per stage, float32 contiguous (pw w
// (cin, cout), dw w (cin, fs*fs), s/b (cout)).  scratch: float32, n * 2 * h
// * w * (widest map's channels), for a chain whose stage buffers do not fit
// shared memory (ffcnn_head_smem over 232448 bytes), else null.  Returns
// cudaErrorInvalidValue for a chain it cannot take, else cudaGetLastError().
int ffcnn_head(const void* x, void* y, void* scratch, int bf16, int n, int h,
               int w, int ns, const int* meta, const void* const* wp,
               const void* const* sp, const void* const* bp, void* stream) {
  size_t smem = ffcnn_head_smem(h, w, ns, meta);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  Args a{};
  a.cbuf = meta[3];  // the widest map a stage buffer holds
  for (int s = 0; s < ns - 1; ++s) a.cbuf = std::max(a.cbuf, meta[5 * s + 4]);
  if (smem > kMaxSmem) {  // the stage buffers go to scratch
    smem -= sizeof(float) * 2 * (size_t)h * w * a.cbuf;
    if (!scratch || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    a.scratch = static_cast<float*>(scratch);
  } else if (scratch) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaGetLastError();
  a.x = x;
  a.y = y;
  a.h = h;
  a.w = w;
  a.ns = ns;
  for (int s = 0; s < ns; ++s) {
    const int* m = meta + 5 * s;
    a.st[s] = Stage{m[0], m[1], m[2], m[3], m[4], (const float*)wp[s],
                    (const float*)sp[s], (const float*)bp[s]};
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    launch<__nv_bfloat16>(a, n, smem, st);
  else
    launch<float>(a, n, smem, st);
  return (int)cudaGetLastError();
}

const char* ffcnn_head_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
