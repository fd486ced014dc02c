// K6: the 3x3 / stride-2 / pad-1 stem straight off uint8 pixels, NHWC:
//
//   y[n, r, c, f] = act( s[f] * sum_{dy, dx, ch} x[n, 2r-1+dy, 2c-1+dx, ch]
//                                               * wm[(dy*3 + dx)*3 + ch, f]
//                        + b[f] )
//
// Replaces ffcnn_tpu/kernels/conv0_fused.py::_make_kernel (launched by
// conv0_cs).  wm is the folded conv-1 (BGR swap and normalisation folded
// into the weights) in float32, its 27 rows in HWIO order (dy, dx, ch);
// pixels outside the image are 0 (the conv's zero pad on the raw bytes).
// The TPU kernel's in-kernel batch-to-lanes transpose and (H, C, W*N)
// output layout do not apply: the port stays NHWC, and the stem's output
// feeds the region run that starts at layer 1 as it is.
//
// Bound on this card: device memory.  At batch 64 and 320x320 the stem
// reads 19.7 MB of bytes and writes 52.4 MB of bf16 (0.0215 ms at 3.35
// TB/s) against 0.7 G multiply-adds.  Fed from shared memory, those
// multiply-adds on the CUDA cores cost as much issue time as the bytes
// take, so the design takes them off the CUDA cores and moves each byte
// once:
//
// * Products on the tensor cores: mma.sync m16n8k8 in TF32, 16 output
//   pixels by 8 output channels, the 27 taps padded to 32 (four k-steps).
//   A uint8 value is exact in TF32, so the pixel operand has no small
//   part, and two passes, one a weight part, give 3xTF32's accuracy
//   (tf32_mma.cuh): the weights come split into TF32 parts by the host
//   (conv0_params, with split_t<true>'s integer rounding), padded to
//   32 x 8*ceil(F/8), and sit in registers for the whole launch.
// * The input staged once: a band is R output rows by up to 512 output
//   columns of one image, and its 2R+1 input rows are copied into shared
//   memory, by 16-byte cp.async where every row starts on a 16-byte
//   boundary (3W a multiple of 16), else by 4-byte words shifted into
//   place (funnel shifts).  The pad row and column come in as zeros.  The
//   A fragments are gathered from there, a byte a value, a pixel's 27 taps
//   at fixed offsets.
// * Copies in flight while the tensor cores work: a few persistent CTAs an
//   SM walk the bands, each copying its next band into a second buffer
//   while it computes the current one.
// * F and the activation fixed at compile time for the repo's stride-2
//   stems (F 8 micro, 16 yolo-fastest-xl, 32 yolov4-tiny; leaky); any
//   other F up to 256 takes a generic instance with masked n8 tiles, the
//   activation read at run time, and scalar stores.
// * Coalesced stores: a warp's 16 x F outputs go through shared memory and
//   out as 16-byte vectors, one full line a warp instruction.
// * Few instructions a pixel (issue, not bytes, held a first build at 2.4x
//   the bound): a tile is 16 pixels of one output row, so no address needs
//   a division, a byte becomes a float by one OR and one add, and leaky is
//   one max.
//
// The band's rows, columns and row stride, the instance, the copy path and
// the number of CTAs are chosen by kernels/conv0_fused.py::plan and passed
// in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using ffcnn_block::mma::act_t;
using ffcnn_block::mma::mma_tf32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTaps = 27;        // 3 x 3 x 3 channels; padded to 32
constexpr int kMaxF = 256;
constexpr int kGenericTiles = 4; // n8 tiles a pass of the generic instance
constexpr size_t kMaxSmem = 232448;

struct Args {
  const uint8_t* x;
  void* y;
  const float* whi;   // (32, fp) TF32 parts, rows 27..31 and cols f.. zero
  const float* wlo;
  const float* sc;    // (f,)
  const float* bi;
  long long xbytes;   // bytes of x
  int n, h, w, f, fp, act;
  int rows, cols, ld; // a band's output rows and columns, smem row stride
  int bands_h, bands_w, aligned, ctas;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(bytes));
}

// Bytes [rb, rb + 4) of the input row at byte `row` of x, 0 outside the
// row, as one little-endian word.
__device__ __forceinline__ uint32_t row_word(const Args& a, long long row,
                                             long long rb) {
  const long long rbytes = 3LL * a.w;
  const uintptr_t base = (uintptr_t)a.x;
  if (rb >= 0 && rb + 4 <= rbytes) {
    const uintptr_t at = base + (uintptr_t)(row + rb);
    const uintptr_t w0 = at & ~(uintptr_t)3;
    const int sh = (int)(at & 3);
    if (w0 >= base && w0 + 8 <= base + (uintptr_t)a.xbytes) {
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
      v |= (uint32_t)__ldg(a.x + row + rb + i) << (8 * i);
  return v;
}

__device__ __forceinline__ uint32_t tap_bits(const uint8_t* p) {
  // an exact float of the byte, by the 2^23 trick: one OR and one add
  return __float_as_uint(__uint_as_float(0x4B000000u | *p) - 8388608.f);
}

// act_t, with leaky as one max: max(v, 0.1 v) is v > 0 ? v : 0.1 v for
// every v (signed zeros and NaN alike)
template <int A>
__device__ __forceinline__ float act_c(float v, int runtime_id) {
  if constexpr (A == 2) return fmaxf(v, v * 0.1f);
  return act_t<A>(v, runtime_id);
}

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void put1(float* p, float v) { *p = v; }
__device__ __forceinline__ void put1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A band: output rows r0 .. r0 + nr - 1, columns c0 .. c0 + nc - 1 of
// image img.
struct Band {
  int img, r0, c0, nr, nc;
};

__device__ __forceinline__ Band band_of(const Args& a, int i) {
  const int per_img = a.bands_h * a.bands_w;
  Band b;
  b.img = i / per_img;
  const int rem = i - b.img * per_img, bh = rem / a.bands_w;
  b.r0 = bh * a.rows;
  b.c0 = (rem - bh * a.bands_w) * a.cols;
  b.nr = min(a.rows, a.h / 2 - b.r0);
  b.nc = min(a.cols, a.w / 2 - b.c0);
  return b;
}

// Stage a band's input rows 2r0-1 .. 2r0+2nr-1, bytes [6c0 - 16, 6c0 +
// 6nc) of each, at row stride a.ld from `buf`: input column 2c0 lands at
// offset 16.  The aligned path only starts its copies (cp.async, one
// commit group a band); the word path stores before it returns.
__device__ __forceinline__ void stage(const Args& a, const Band& b,
                                      uint8_t* buf) {
  const long long rbytes = 3LL * a.w;
  const long long seg0 = 6LL * b.c0 - 16;
  const int nchunk = (16 + 6 * b.nc + 15) >> 4;
  const int in_rows = 2 * b.nr + 1;
  if (a.aligned) {
    for (int i = threadIdx.x; i < in_rows * nchunk; i += kThreads) {
      const int r = i / nchunk, ch = i - r * nchunk;
      const int gy = 2 * b.r0 - 1 + r;
      const long long rb = seg0 + 16LL * ch;
      const int bytes = (gy < 0 || rb < 0 || rb >= rbytes)
                            ? 0 : (int)min(16LL, rbytes - rb);
      const uint8_t* src =
          bytes ? a.x + ((long long)b.img * a.h + gy) * rbytes + rb : a.x;
      cp_async16(buf + r * a.ld + 16 * ch, src, bytes);
    }
  } else {
    const int nw = nchunk * 4;
    for (int i = threadIdx.x; i < in_rows * nw; i += kThreads) {
      const int r = i / nw, q = i - r * nw;
      const int gy = 2 * b.r0 - 1 + r;
      *reinterpret_cast<uint32_t*>(buf + r * a.ld + 4 * q) =
          gy < 0 ? 0u
                 : row_word(a, ((long long)b.img * a.h + gy) * rbytes,
                            seg0 + 4LL * q);
    }
  }
}

// F > 0: F output channels and the activation A fixed; F == 0: the
// generic instance (any f <= kMaxF, A < 0 reads a.act).  A persistent CTA
// walks the bands blockIdx.x, + gridDim.x, ...; the next band's rows are
// copied into the second buffer while this band is computed.
template <int F, int A, typename T>
__global__ void __launch_bounds__(kThreads)
conv0_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int NT = F > 0 ? F / 8 : kGenericTiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nbands = a.n * a.bands_h * a.bands_w;
  const size_t sbuf = (size_t)(2 * a.rows + 1) * a.ld;

  // This lane's taps: k columns t and t + 4 of each k-step s (A fragment
  // a0/a1 and a2/a3), as byte offsets from a pixel's tap (0, 0, 0).
  int toff[8];
  bool tval[8];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      // (taps 27..31 are padding: offset 0, value 0)
      const int kk = 8 * s + t + 4 * h2;
      const int dy = kk / 9, dx = (kk % 9) / 3, ch = kk % 3;
      tval[2 * s + h2] = kk < kTaps;
      toff[2 * s + h2] = kk < kTaps ? dy * a.ld + dx * 3 + ch : 0;
    }

  // The weight fragments {B[t][g], B[t + 4][g]} of k-step s, n8 tile j,
  // both parts; the fixed instances load theirs once.
  uint32_t bhi[NT][4][2], blo[NT][4][2];
  float sv[NT][2], bv[NT][2];
  auto load_b = [&](int f0) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = f0 + 8 * j + g;
      const bool ok = F > 0 || col < a.fp;
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int at = (8 * s + t + 4 * h2) * a.fp + col;
          bhi[j][s][h2] = ok ? __float_as_uint(__ldg(a.whi + at)) : 0u;
          blo[j][s][h2] = ok ? __float_as_uint(__ldg(a.wlo + at)) : 0u;
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = f0 + 8 * j + 2 * t + e;
        const bool cok = F > 0 || c < a.f;
        sv[j][e] = cok ? __ldg(a.sc + c) : 0.f;
        bv[j][e] = cok ? __ldg(a.bi + c) : 0.f;
      }
    }
  };
  if constexpr (F > 0) load_b(0);

  constexpr int kOutLd = F * (int)sizeof(T) + 16;   // staged bytes a pixel
  uint8_t* ostage = smem + 2 * sbuf +
                    (size_t)warp * 16 * (F > 0 ? kOutLd : 0);
  T* y = reinterpret_cast<T*>(a.y);
  const int ho = a.h / 2, wo = a.w / 2;

  if (blockIdx.x < nbands) stage(a, band_of(a, blockIdx.x), smem);
  asm volatile("cp.async.commit_group;" ::);
  for (int bi = blockIdx.x, buf = 0; bi < nbands;
       bi += gridDim.x, buf ^= 1) {
    if (bi + gridDim.x < nbands)
      stage(a, band_of(a, bi + gridDim.x), smem + (buf ^ 1) * sbuf);
    asm volatile("cp.async.commit_group;" ::);
    asm volatile("cp.async.wait_group 1;" ::);  // this band's copies
    __syncthreads();
    const Band bd = band_of(a, bi);
    const int nc = bd.nc;
    const uint8_t* staged = smem + buf * sbuf;
    // a tile: 16 pixels of one output row; tiles a row, and this warp's
    // first tile's row and column block (then stepped without divisions)
    const int tpr = (nc + 15) >> 4;
    const int ntiles = bd.nr * tpr;
    int orow = warp / tpr, cb = warp - orow * tpr;

    for (int tile = warp; tile < ntiles; tile += kWarps) {
      const int oc0 = 16 * cb;
      const int valid = min(16, nc - oc0);
      // the tile's first output pixel
      const size_t px0 =
          ((size_t)bd.img * ho + bd.r0 + orow) * wo + bd.c0 + oc0;
      // the A fragments: pixels g and g + 8 of the tile
      const uint8_t* prow = staged + 2 * orow * a.ld + 13;
      const uint8_t* pb[2] = {prow + 6 * min(oc0 + g, nc - 1),
                              prow + 6 * min(oc0 + g + 8, nc - 1)};
      uint32_t af[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        af[s][0] = tval[2 * s] ? tap_bits(pb[0] + toff[2 * s]) : 0u;
        af[s][1] = tval[2 * s] ? tap_bits(pb[1] + toff[2 * s]) : 0u;
        // k columns 28..31 (s = 3, t + 4) are all padding
        af[s][2] = s < 3 ? tap_bits(pb[0] + toff[2 * s + 1]) : 0u;
        af[s][3] = s < 3 ? tap_bits(pb[1] + toff[2 * s + 1]) : 0u;
      }

      for (int f0 = 0; f0 < (F > 0 ? F : a.fp); f0 += 8 * NT) {
        if constexpr (F == 0) load_b(f0);
        // small parts first, each part in its own accumulator
        float dl[NT][4], dh[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dl[j][e] = dh[j][e] = 0.f;
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (F == 0 && f0 + 8 * j >= a.fp) continue;
            mma_tf32(dl[j], af[s], blo[j][s][0], blo[j][s][1]);
            mma_tf32(dh[j], af[s], bhi[j][s][0], bhi[j][s][1]);
          }
        // epilogue: rows g (e 0, 1) and g + 8 (e 2, 3), channels 2t, 2t + 1
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = act_c<A>((dl[j][e] + dh[j][e]) * sv[j][e & 1] +
                                bv[j][e & 1], a.act);
          const int c = f0 + 8 * j + 2 * t;
          if constexpr (F > 0) {
            put2(reinterpret_cast<T*>(ostage + g * kOutLd) + c, v[0], v[1]);
            put2(reinterpret_cast<T*>(ostage + (g + 8) * kOutLd) + c, v[2],
                 v[3]);
          } else {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              if (g + 8 * hh >= valid) continue;
              T* out = y + (px0 + g + 8 * hh) * a.f;
              if (c < a.f) put1(out + c, v[2 * hh]);
              if (c + 1 < a.f) put1(out + c + 1, v[2 * hh + 1]);
            }
          }
        }
      }
      if constexpr (F > 0) {
        // the tile's valid pixels, F outputs each, contiguous in y: out as
        // 16-byte vectors
        constexpr int V = F * (int)sizeof(T) / 16;
        uint4* out = reinterpret_cast<uint4*>(y + px0 * F);
        __syncwarp();
        for (int i = lane; i < valid * V; i += 32)
          out[i] = *reinterpret_cast<const uint4*>(ostage + (i / V) * kOutLd +
                                                   16 * (i % V));
        __syncwarp();
      }
      cb += kWarps;
      while (cb >= tpr) {
        cb -= tpr;
        ++orow;
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
}

template <int F, int A, typename T>
int launch(const Args& a, size_t smem, cudaStream_t st) {
  auto* k = conv0_kernel<F, A, T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k<<<a.ctas, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int inst_f, int inst_act, size_t smem,
             cudaStream_t st) {
  if (inst_f == 8 && inst_act == 2) return launch<8, 2, T>(a, smem, st);
  if (inst_f == 16 && inst_act == 2) return launch<16, 2, T>(a, smem, st);
  if (inst_f == 32 && inst_act == 2) return launch<32, 2, T>(a, smem, st);
  if (inst_f == 0 && inst_act < 0) return launch<0, -1, T>(a, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (n, h, w, 3) uint8, contiguous, h and w even; y (n, h/2, w/2, f)
// float32 (bf16 == 0) or bfloat16, contiguous; whi/wlo (32, fp) float32
// TF32 parts (fp = 8 * ceil(f / 8)), s/b (f) float32.  inst_f/inst_act:
// the compiled instance (8, 16 or 32 with act 2; 0 and -1 the generic
// one); rows x cols: a band (cols a multiple of 8); ld: the staged row
// stride in bytes (a multiple of 16, at least 16 + 6 cols); aligned: x
// 16-byte aligned and 3w a multiple of 16; ctas: the persistent CTAs
// (each takes every ctas-th band).  Returns cudaErrorInvalidValue
// for arguments it cannot take, else cudaGetLastError().
int ffcnn_conv0(const void* x, void* y, int bf16, const void* whi,
                const void* wlo, const void* s, const void* b, int n, int h,
                int w, int f, int actid, int inst_f, int inst_act, int rows,
                int cols, int ld, int aligned, int ctas, void* stream) {
  if (h % 2 || w % 2 || f < 1 || f > kMaxF || rows < 1 || cols < 8 ||
      ctas < 1 ||
      cols % 8 || ld % 16 || ld < 16 + 6 * cols ||
      (inst_f && inst_f != f) || (inst_act >= 0 && inst_act != actid) ||
      (aligned && (((uintptr_t)x) % 16 || (3 * w) % 16)))
    return (int)cudaErrorInvalidValue;
  const int ho = h / 2, wo = w / 2;
  if ((long long)n * ho * wo == 0) return (int)cudaGetLastError();
  Args a{(const uint8_t*)x, y, (const float*)whi, (const float*)wlo,
         (const float*)s, (const float*)b, (long long)n * h * w * 3,
         n, h, w, f, (f + 7) / 8 * 8, actid, rows, cols, ld,
         (ho + rows - 1) / rows, (wo + cols - 1) / cols, aligned, ctas};
  if ((long long)n * a.bands_h * a.bands_w > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t out = bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const size_t smem = 2 * (size_t)(2 * rows + 1) * ld +
                      (inst_f ? (size_t)kWarps * 16 * (inst_f * out + 16) : 0);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(a, inst_f, inst_act, smem, st)
              : dispatch<float>(a, inst_f, inst_act, smem, st);
}

const char* ffcnn_conv0_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
