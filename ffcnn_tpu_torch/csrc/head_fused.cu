// K7 for Hopper: a chain of stride-1 convs feeding a yolo head, NHWC, in one
// launch: depthwise (fs 3 or 5, pad fs/2) and pointwise stages, each
// y = act(conv(x) * s + b), float32 inside with float32 weights, one cast
// at the store.
//
// Replaces ffcnn_tpu/kernels/head_fused.py::_make_kernel (launched by
// apply_head_run).  On yolo-fastest-xl at 320x320 the chain is layers
// 116-120 at 10x10: dw5x5 C192 leaky, pw 192 linear, dw5x5 leaky, pw 192
// linear, pw 255 linear; 785 M pointwise and 61 M depthwise multiply-adds
// at batch 64.
//
// Bound on this card: bytes.  Only the chain's input and the head's output
// cross device memory (0.0019 ms at batch 64 in bf16); every interior map
// lives in one of two float32 stage buffers in shared memory.  The kernel
// this replaces took 0.54 ms there: one CTA an image, float32 FMAs fed by
// shared loads, serial weight restaging, a run-time activation switch in
// every epilogue and two divisions for every depthwise element.  Here:
//
// 1. The pointwise stages run on the tensor cores, mma.sync m16n8k8 in
//    3xTF32 (tf32_mma.cuh, TF32 parts rounded with integer operations):
//    pixels are M (16-row tiles, the last row clamped and never stored),
//    output channels N (n8 tiles, the last masked), input channels K (k8
//    steps).  A warp holds up to two units of one m16 tile by four n8
//    tiles across the K loop.  The stage buffers take the padded row
//    strides ld_a / ld_b against bank conflicts.
// 2. The weights stream through shared memory in chunks of 32 input
//    channels by cp.async into two buffers: chunk k + 1 loads while chunk
//    k multiplies, one barrier a chunk.  (A ring of four 16-channel
//    chunks ran no faster: the copies' latency is not what bounds it.)
// 3. The activations are template parameters: each stage dispatches once
//    to a body compiled for its activation id (every id that
//    ops/activations.py takes) and, for a depthwise stage, its kernel size.
// 4. While the batch leaves SMs idle (2n <= the card's SMs, h >= 2: the
//    wrapper's plan, as K5's), a cluster of two CTAs takes an image, CTA r
//    owning rows [r * ceil(h / 2), ...) of every map.  Pointwise stages
//    are per pixel and need nothing of the neighbour; a depthwise stage
//    reads the neighbour's boundary rows in place through distributed
//    shared memory, between two cluster barriers.  At 13x13 (416x416) a
//    CTA's own 7 rows fit shared memory; only chains that do not fit at
//    their cluster size (13x13 at one CTA an image, 19x19) keep their
//    stage buffers in a per-image device scratch, where they stay in L2.
// 5. A depthwise thread step is one channel of a band of rows and five
//    columns, walked with the channel fastest by carries (no division
//    inside the stage loop); its taps sit in registers for the whole band,
//    each input value is read once for the five outputs it feeds (a
//    predicated load at the image's side borders, none for the taps), and
//    a row outside the image is skipped whole.

#include <cooperative_groups.h>

#include <algorithm>
#include <climits>
#include <type_traits>

#include "tf32_mma.cuh"

namespace cg = cooperative_groups;
namespace blk = ffcnn_block;
namespace mma = ffcnn_block::mma;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 8;
constexpr int kKC = 32;          // pointwise input channels a weight chunk
constexpr int kRing = 2;         // weight chunks held: one in use, one loading
constexpr int kNJ = 4;           // n8 tiles a pointwise unit
constexpr int kUPW = 2;          // units a warp holds across the K loop
constexpr int kCB = 5;           // depthwise output columns a thread step
constexpr int kMaxPwOut = 256;   // pointwise output channels
constexpr size_t kMaxSmem = 232448;  // a CTA's shared memory on sm_90

__host__ __device__ constexpr int pad8(int c) { return (c + 7) / 8 * 8; }
// Row strides: a stage buffer of c channels (A fragments read it) and a
// pointwise weight chunk of n outputs (B fragments).
__host__ __device__ constexpr int buf_ld(int c) { return mma::ld_a(pad8(c)); }
__host__ __device__ constexpr int w_ld(int n) { return mma::ld_b(pad8(n)); }

struct Stage {
  int kind;  // 0 pointwise, 1 depthwise
  int fs, act, cin, cout;
  const float *w, *s, *b;  // pw w (cin, cout); dw w (cin, fs*fs)
};

struct Args {
  const void* x;
  void* y;
  float* scratch;  // 2 * buf floats an image, or null: buffers in smem
  int h, w, ns;
  int rows;        // rows a CTA owns: ceil(h / cluster)
  int ld;          // a stage buffer's row stride
  size_t buf;      // floats of a stage buffer (a CTA's rows, or the image)
  Stage st[kMaxStages];
};

// The chain's layout at a cluster size, or false for a chain the kernel
// cannot take (kernels/head_fused.py's plan mirrors it).  ld: stage
// buffer row stride; wfl: floats of the weight region (the pointwise
// chunks, or a depthwise stage's taps); smem: bytes of shared memory;
// scratch: the buffers go to device memory.
struct Layout {
  int ld, wfl;
  size_t smem;
  bool scratch;
};

bool layout(int h, int w, int ns, const int* meta, int cluster, Layout& l) {
  if (ns < 1 || ns > kMaxStages || h < 1 || w < 1 || cluster < 1 ||
      cluster > 2 || h < cluster)
    return false;
  int cbuf = meta[3], wfl = 0;
  for (int s = 0; s < ns; ++s) {
    const int* m = meta + 5 * s;
    const int kind = m[0], fs = m[1], cin = m[3], cout = m[4];
    if (cin < 1 || (s > 0 && cin != meta[5 * (s - 1) + 4])) return false;
    if (kind == 0) {
      if (cout < 1 || cout > kMaxPwOut) return false;
      wfl = std::max(wfl, kRing * kKC * w_ld(cout));
    } else if (kind == 1) {
      if ((fs != 3 && fs != 5) || cin != cout) return false;
      wfl = std::max(wfl, cin * fs * fs);
    } else {
      return false;
    }
    if (s < ns - 1) cbuf = std::max(cbuf, cout);
  }
  l.ld = buf_ld(cbuf);
  l.wfl = wfl;
  const int rows = (h + cluster - 1) / cluster;
  const size_t on_chip = sizeof(float) * (2 * (size_t)rows * w * l.ld + wfl);
  l.scratch = on_chip > kMaxSmem;
  l.smem = l.scratch ? sizeof(float) * wfl : on_chip;
  return l.smem <= kMaxSmem;
}

// f(std::integral_constant<int, id>) for the activation ids of
// ops/activations.py (3 and 5 are both the logistic; others linear).
template <typename F>
__device__ __forceinline__ void with_act(int id, F&& f) {
  switch (id) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 3:
    case 5: f(std::integral_constant<int, 3>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 6: f(std::integral_constant<int, 6>{}); break;
    default: f(std::integral_constant<int, 0>{}); break;
  }
}

// The CTA's np pixels of x (c channels, contiguous) into buf as float32,
// row stride ld, zero in the channel padding up to pad8(c).
template <typename T>
__device__ void load_input(float* buf, int ld, const T* x, int np, int c) {
  const int ng = pad8(c) >> 3;  // groups of 8 channels
  for (int i = threadIdx.x; i < np * ng; i += kThreads) {
    const int p = i / ng, c0 = (i - p * ng) << 3;
    const T* src = x + (size_t)p * c + c0;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (c % 8 == 0) {
      if constexpr (sizeof(T) == 2) {
        const uint4 u = *reinterpret_cast<const uint4*>(src);
        const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
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
        if (c0 + k < c) v[k] = blk::to_f32(src[k]);
    }
    float4* d = reinterpret_cast<float4*>(buf + (size_t)p * ld + c0);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// Pointwise stage over the CTA's np pixels: out[p][o] = act(s[o] *
// sum_c in[p][c] w[c][o] + b[o]), to the other stage buffer (zero in the
// channel padding) or, for the last stage, to y.  a_exact: the input
// buffer holds bfloat16 values (exact in TF32, two products a k-step).
template <int A, typename T>
__device__ void pw_stage(const Stage& st, const float* in, float* out, int ld,
                         T* y, float* wb, int np, bool a_exact) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cin = st.cin, cout = st.cout, nt = (cout + 7) >> 3;
  const int ldw = w_ld(cout), k8 = pad8(cin);
  const int mt = (np + 15) >> 4, units = mt * ((nt + kNJ - 1) / kNJ);
  const int nch = (cin + kKC - 1) / kKC;
  const bool vec = (cout & 3) == 0;
  for (int u0 = 0; u0 < units; u0 += kWarps * kUPW) {
    // unit u: m16 tile u % mt, n8 tiles [4 (u / mt), +4)
    const float* ar[kUPW][2];
    int m0[kUPW], n0[kUPW];
    bool on[kUPW], live[kUPW][kNJ];
    float acc[kUPW][kNJ][4];
#pragma unroll
    for (int i = 0; i < kUPW; ++i) {
      const int u = u0 + warp + kWarps * i;
      on[i] = u < units;
      const int q = on[i] ? u / mt : 0;
      m0[i] = on[i] ? (u - q * mt) * 16 : 0;
      n0[i] = q * kNJ;
      ar[i][0] = in + min(m0[i] + g, np - 1) * ld + t;
      ar[i][1] = in + min(m0[i] + g + 8, np - 1) * ld + t;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        live[i][j] = on[i] && n0[i] + j < nt;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
      }
    }
    // chunk k into buffer k % kRing
    auto load = [&](int k) {
      if (k < nch)
        mma::stage<kThreads>(wb + (k % kRing) * kKC * ldw, ldw,
                             st.w + (size_t)k * kKC * cout, cout,
                             min(kKC, cin - k * kKC), cout, kKC, nt * 8, vec);
      mma::cp_commit();
    };
    __syncthreads();  // the weight buffers are free
#pragma unroll
    for (int k = 0; k < kRing - 1; ++k) load(k);
    for (int ch = 0; ch < nch; ++ch) {
      mma::cp_wait<kRing - 2>();
      __syncthreads();  // chunk ch is in; chunk ch - 1's buffer is free
      load(ch + kRing - 1);
      const float* wc = wb + (ch % kRing) * kKC * ldw;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 8) {
        const int k = ch * kKC + kk;
        if (k >= k8) break;
#pragma unroll
        for (int i = 0; i < kUPW; ++i) {
          if (!on[i]) continue;
          const float av[4] = {ar[i][0][k], ar[i][1][k], ar[i][0][k + 4],
                               ar[i][1][k + 4]};
          uint32_t ab[4], as[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (a_exact) {
              ab[e] = __float_as_uint(av[e]);
              as[e] = 0u;
            } else {
              mma::split_t<true>(av[e], ab[e], as[e]);
            }
          }
          float b[kNJ][2];
#pragma unroll
          for (int j = 0; j < kNJ; ++j) {
            const float* wp = wc + (kk + t) * ldw + (n0[i] + j) * 8 + g;
            b[j][0] = live[i][j] ? wp[0] : 0.f;
            b[j][1] = live[i][j] ? wp[4 * ldw] : 0.f;
          }
          mma::mma_3x<kNJ, true>(acc[i], ab, as, a_exact, b, live[i]);
        }
      }
    }
    // epilogue: a lane holds rows g and g + 8, columns 2t and 2t + 1
#pragma unroll
    for (int i = 0; i < kUPW; ++i) {
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        if (!live[i][j]) continue;
        const int o = (n0[i] + j) * 8 + 2 * t;
        float sc[2], bi[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[e] = o + e < cout ? __ldg(st.s + o + e) : 0.f;
          bi[e] = o + e < cout ? __ldg(st.b + o + e) : 0.f;
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = m0[i] + g + 8 * hh;
          if (p >= np) continue;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = o + e < cout
                       ? mma::act_t<A>(acc[i][j][2 * hh + e] * sc[e] + bi[e],
                                       A)
                       : 0.f;
          if (y) {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (o + e < cout) blk::store(y + (size_t)p * cout + o + e, v[e]);
          } else {
            *reinterpret_cast<float2*>(out + (size_t)p * ld + o) =
                make_float2(v[0], v[1]);
          }
        }
      }
    }
  }
}

// Depthwise stage (FS x FS, pad FS/2, stride 1) over the CTA's nrows rows
// (image rows row0...): out = act(dw(in) * s + b), to the other stage
// buffer or, for the last stage, to y.  Rows of the neighbour CTA are read
// where they lie: in its shared memory (cluster of two, buffers on chip)
// or in the image's scratch map.
template <int FS, int A, int CS, bool G, typename T>
__device__ void dw_stage(const Stage& st, const float* in, float* out, int ld,
                         T* y, float* wb, int h, int w, int row0, int nrows,
                         int rows, int rank) {
  constexpr int R = FS / 2, NI = kCB + FS - 1, NT = FS * FS;
  const int c = st.cin;
  mma::stage<kThreads>(wb, 0, st.w, 0, 1, c * NT, 1, c * NT,
                       (c * NT) % 4 == 0);
  mma::cp_commit();
  const long long rowf = (long long)w * ld;  // a row can lie above row0
  const float* other = nullptr;  // the neighbour's buffer, at its row 0
  if constexpr (CS > 1 && !G)
    other = cg::this_cluster().map_shared_rank(const_cast<float*>(in),
                                               rank ^ 1) -
            (rank ^ 1) * rows * rowf;
  // image row yy of the input map, or null outside the image
  auto row_of = [&](int yy) -> const float* {
    if (yy < 0 || yy >= h) return nullptr;
    if constexpr (CS > 1 && !G)
      if (yy < row0 || yy >= row0 + nrows) return other + yy * rowf;
    return in + (yy - row0) * rowf;
  };
  // channels the items walk: padded to 8 in a stage buffer (the padding
  // written 0), exact in y
  const int cw = y ? c : pad8(c);
  const int ncb = (w + kCB - 1) / kCB, band = cw * ncb;
  // rows a step: the fewest rounds of kThreads steps times rows a step
  int rb = 1, best = INT_MAX;
  for (int r = 1; r <= nrows; ++r) {
    const int cost = (band * ((nrows + r - 1) / r) + kThreads - 1) /
                     kThreads * r;
    if (cost <= best) {
      best = cost;
      rb = r;
    }
  }
  const int steps = band * ((nrows + rb - 1) / rb);
  // step i = (row band, column block, channel), the channel fastest: the
  // thread's first by division, then by carries
  int ch = threadIdx.x % cw, xb = threadIdx.x / cw, yb = 0;
  while (xb >= ncb) {
    xb -= ncb;
    ++yb;
  }
  const int dch = kThreads % cw, dxb = kThreads / cw;
  mma::cp_wait<0>();
  __syncthreads();  // the taps are in
  for (int i = threadIdx.x; i < steps; i += kThreads) {
    const int x0 = xb * kCB, y0 = yb * rb, y1 = min(y0 + rb, nrows);
    if (ch < c) {
      float tap[NT];
#pragma unroll
      for (int k = 0; k < NT; ++k) tap[k] = wb[ch * NT + k];
      const float sc = __ldg(st.s + ch), bi = __ldg(st.b + ch);
      for (int yl = y0; yl < y1; ++yl) {
        float acc[kCB];
#pragma unroll
        for (int j = 0; j < kCB; ++j) acc[j] = 0.f;
#pragma unroll
        for (int dy = 0; dy < FS; ++dy) {
          const float* src = row_of(row0 + yl + dy - R);
          if (!src) continue;
          src += ch;
#pragma unroll
          for (int q = 0; q < NI; ++q) {
            const int ix = x0 + q - R;
            const float v = (unsigned)ix < (unsigned)w ? src[ix * ld] : 0.f;
#pragma unroll
            for (int j = 0; j < kCB; ++j)
              if (q - j >= 0 && q - j < FS)
                acc[j] = fmaf(v, tap[dy * FS + q - j], acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kCB; ++j) {
          if (x0 + j >= w) break;
          const float v = mma::act_t<A>(acc[j] * sc + bi, A);
          const int p = yl * w + x0 + j;
          if (y)
            blk::store(y + (size_t)p * c + ch, v);
          else
            out[(size_t)p * ld + ch] = v;
        }
      }
    } else {  // the channel padding of a stage buffer
      for (int yl = y0; yl < y1; ++yl)
        for (int j = 0; j < kCB && x0 + j < w; ++j)
          out[(size_t)(yl * w + x0 + j) * ld + ch] = 0.f;
    }
    ch += dch;
    int carry = dxb;
    if (ch >= cw) {
      ch -= cw;
      ++carry;
    }
    xb += carry;
    while (xb >= ncb) {
      xb -= ncb;
      ++yb;
    }
  }
}

template <typename T, int CS, bool G>
__global__ void __launch_bounds__(kThreads, 1)
    head_kernel(const __grid_constant__ Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int rank = 0;
  if constexpr (CS > 1) rank = (int)cg::this_cluster().block_rank();
  const int img = blockIdx.x / CS, row0 = rank * a.rows;
  const int nrows = min(a.rows, a.h - row0), np = nrows * a.w;
  const size_t own = (size_t)row0 * a.w * a.ld;  // the CTA's first row
  float* buf[2];
  float* wb;
  if constexpr (G) {
    float* base = a.scratch + (size_t)img * 2 * a.buf;
    buf[0] = base + own;
    buf[1] = base + a.buf + own;
    wb = smem;
  } else {
    buf[0] = smem;
    buf[1] = smem + a.buf;
    wb = smem + 2 * a.buf;
  }
  const size_t pix0 = (size_t)img * a.h * a.w + (size_t)row0 * a.w;
  const int c0 = a.st[0].cin, cl = a.st[a.ns - 1].cout;
  load_input<T>(buf[0], a.ld, static_cast<const T*>(a.x) + pix0 * c0, np,
                c0);
  T* yown = static_cast<T*>(a.y) + pix0 * cl;
  int cur = 0;
  for (int s = 0; s < a.ns; ++s) {
    const Stage& st = a.st[s];
    const bool dw = st.kind == 1;
    // the previous stage's output is complete (in the whole cluster where
    // a depthwise stage reads the neighbour's rows, or has just read them
    // from a buffer this stage overwrites)
    if constexpr (CS > 1) {
      if (dw || (s > 0 && a.st[s - 1].kind == 1))
        cg::this_cluster().sync();
      else
        __syncthreads();
    } else {
      __syncthreads();
    }
    T* y = s == a.ns - 1 ? yown : nullptr;
    const float* in = buf[cur];
    float* out = buf[cur ^ 1];
    if (dw) {
      with_act(st.act, [&](auto act) {
        constexpr int Act = decltype(act)::value;
        if (st.fs == 3)
          dw_stage<3, Act, CS, G>(st, in, out, a.ld, y, wb, a.h, a.w, row0,
                                  nrows, a.rows, rank);
        else
          dw_stage<5, Act, CS, G>(st, in, out, a.ld, y, wb, a.h, a.w, row0,
                                  nrows, a.rows, rank);
      });
    } else {
      const bool exact = s == 0 && sizeof(T) == 2;
      with_act(st.act, [&](auto act) {
        pw_stage<decltype(act)::value>(st, in, out, a.ld, y, wb, np, exact);
      });
    }
    cur ^= 1;
  }
  // no CTA leaves while its neighbour may still read its shared memory
  if constexpr (CS > 1) cg::this_cluster().sync();
}

// Internal linkage: the record of devices whose shared-memory cap is
// raised is this library's own.
template <typename T, int CS, bool G>
cudaError_t launch(const Args& a, int n, size_t smem, cudaStream_t stream) {
  // Raise the shared-memory cap once per device, not on every launch.
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit) &&
      cudaFuncSetAttribute(head_kernel<T, CS, G>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem) == cudaSuccess)
    raised.fetch_or(bit, std::memory_order_relaxed);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * CS);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, head_kernel<T, CS, G>, a);
}

template <typename T, int CS>
cudaError_t launch_cs(const Args& a, int n, size_t smem, cudaStream_t s) {
  return a.scratch ? launch<T, CS, true>(a, n, smem, s)
                   : launch<T, CS, false>(a, n, smem, s);
}

}  // namespace

extern "C" {

// x (n, h, w, meta[3]) and y (n, h, w, cout of the last stage): float32
// (bf16 == 0) or bfloat16, contiguous.  meta: 5 ints per stage (kind 0 pw /
// 1 dw, fs, act, cin, cout); w, s, b: per stage, float32 contiguous (pw w
// (cin, cout), dw w (cin, fs*fs), s/b (cout)).  cluster: CTAs an image, 1
// or 2 (at most h).  scratch: float32, n * 2 * h * w * (the stage
// buffers' row stride), for a chain whose stage buffers do not fit shared
// memory at this cluster size, else null.  Returns cudaErrorInvalidValue
// for a chain, cluster or scratch it cannot take, else the launch's
// error.
int ffcnn_head(const void* x, void* y, void* scratch, int bf16, int n, int h,
               int w, int ns, const int* meta, const void* const* wp,
               const void* const* sp, const void* const* bp, int cluster,
               void* stream) {
  Layout l;
  if (!layout(h, w, ns, meta, cluster, l) ||
      l.scratch != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  Args a{};
  a.x = x;
  a.y = y;
  a.scratch = static_cast<float*>(scratch);
  a.h = h;
  a.w = w;
  a.ns = ns;
  a.rows = (h + cluster - 1) / cluster;
  a.ld = l.ld;
  a.buf = (size_t)(l.scratch ? h : a.rows) * w * l.ld;
  for (int s = 0; s < ns; ++s) {
    const int* m = meta + 5 * s;
    a.st[s] = Stage{m[0], m[1], m[2], m[3], m[4], (const float*)wp[s],
                    (const float*)sp[s], (const float*)bp[s]};
  }
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (bf16)
    err = cluster == 2 ? launch_cs<__nv_bfloat16, 2>(a, n, l.smem, st)
                       : launch_cs<__nv_bfloat16, 1>(a, n, l.smem, st);
  else
    err = cluster == 2 ? launch_cs<float, 2>(a, n, l.smem, st)
                       : launch_cs<float, 1>(a, n, l.smem, st);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

const char* ffcnn_head_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
