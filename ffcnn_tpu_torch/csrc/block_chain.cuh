// Chained fused blocks: the device code shared by the halo cascade (K4,
// block_cascade.cu) and the whole-run kernel (K5, block_mega.cu), on the
// tensor-core product code of K1 (tf32_mma.cuh).
//
// Both run several stride-1 blocks inside one CTA and keep every boundary
// between them in shared memory as float32, never rounded: only the chain's
// input and its last output touch device memory.  A block is applied to a
// "window": an oh x ow rectangle of output pixels whose input halo,
// (oh+2) x (ow+2) pixels, lies in a float32 map in shared memory (row
// stride map_ld(c): C padded to 8 with zeros, plus 4 against bank
// conflicts).  As in K1, E is walked in chunks of 32 channels, with the next
// chunk's weights on their way by cp.async into the other of two buffers
// (the next chunk may be the next window's or the next block's first):
//   1. expand: [halo pixels, in 16-row slabs] x [C] @ [C] x [32] on the
//      tensor cores in 3xTF32 (two products a k-step where the map holds a
//      bfloat16 input, block 0 only; the TF32 parts rounded with integer
//      operations, which K4 and K5 ran 17-25% faster with than with
//      cvt.rna, the same values), a warp a slab and all of the chunk's
//      n8 tiles; rows past the halo are computed from a clamped row and
//      never stored; epilogue act1(. * s1 + b1), 0 for the pixels outside
//      the image (the dw zero padding applies to the expand OUTPUT);
//   2. depthwise 3x3 + act2 in float32 on the CUDA cores, a thread a
//      (channel, run of 4 pixels of a row), stored as float32 (split into
//      TF32 parts when the project loads it, which keeps this buffer at one
//      float a value);
//   3. project: [window pixels, 16-row slabs] x [32] @ [32] x [P in n8
//      tiles], a warp a (slab, group of n8 tiles).  A window may hold
//      hundreds of pixels (a cascade's first blocks cover the tile and its
//      halo rings), more than registers can keep across the chunks, so the
//      accumulators live in the window's float32 output map: loaded into C
//      fragments before a chunk's k-steps and stored after them (12 mma a
//      tile per load and store at a full chunk).  The last chunk applies
//      scale, bias, act3 and the residual (read from the float32 input map,
//      exact) and stores to the map (zeroing its channel padding) or, for
//      the chain's last block, to device memory.
// The activations are template parameters for the combinations of
// FFCNN_BLOCK_ACT_INSTANCES, chosen block by block; any other block runs
// the instance that reads them from its arguments.

#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "tf32_mma.cuh"

namespace ffcnn_block {

constexpr int kMaxChain = 16;  // blocks per launch
// A CTA of the chained kernels: 512 threads at up to 128 registers, an
// SM's register file, so that the phases of a chunk have 16 warps to hide
// their latency (K5 sets 384; ffcnn_tpu_torch/bench_chain.py builds other
// sizes to compare).
#ifndef FFCNN_CHAIN_THREADS
#define FFCNN_CHAIN_THREADS 512
#endif
constexpr int kCThreads = FFCNN_CHAIN_THREADS;
constexpr int kCWarps = kCThreads / 32;

enum ChainFlags { kChainInBf16 = 1, kChainOutBf16 = 2, kChainVecW = 4,
                  kChainVecX = 8, kChainInI8 = 16, kChainOutI8 = 32 };

#define FFCNN_ACT_ROW(A1, A2, A3, AR) {A1, A2, A3, AR},
constexpr int kActInstances[][4] = {FFCNN_BLOCK_ACT_INSTANCES(FFCNN_ACT_ROW)};
#undef FFCNN_ACT_ROW
constexpr int kNumActInstances =
    sizeof(kActInstances) / sizeof(kActInstances[0]);

// One block of a chain: its weights (layouts as in Args), widths, and its
// compile-time activation instance (-1: read at run time).
struct ChainBlock {
  const float *w1, *s1, *b1, *kdw, *s2, *b2, *w2, *s3, *b3;
  int c, e, p, act1, act2, act3, residual, res_act, inst;
};

__host__ __device__ inline int pad8(int c) { return (c + 7) / 8 * 8; }
__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }
// Row stride of a map of c channels (A fragments read it).
__host__ __device__ inline int map_ld(int c) { return mma::ld_a(pad8(c)); }
// Floats of one chunk buffer for a block: expand weights [pad8(c)][kLdW1],
// project weights [kChunk][ld_b(pad8(p))], then s1 b1 s2 b2 kdw.
__host__ __device__ inline int chunk_floats(int c, int p) {
  return pad8(c) * mma::kLdW1 + mma::kChunk * mma::ld_b(pad8(p)) + mma::kVec;
}

// A launch's shared memory in floats (kernels/block_fused.py mirrors it):
// two maps, the expanded halo [nq][kLdH], the depthwise output
// [npix16][kLdA2], an int table [npix16] (each window pixel's pixel in the
// output map) and two chunk buffers.
struct ChainSmem {
  int map0, map1, h1, h2, tab, buf;
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * ((size_t)map0 + map1 + h1 + h2 + tab + 2 * buf);
  }
};

struct ChainArgs {
  const void* x;
  void* y;
  int h, w, nb, th, tw, flags;
  int rows;  // K5: image rows a CTA owns
  // K4's int8 boundaries: the input code times in_scale on load, the
  // output clip(rint(y * out_inv), -127, 127) at the store
  float in_scale, out_inv;
  ChainSmem sm;
  ChainBlock b[kMaxChain];
};

// in: the input map, inw pixels a row, row stride ldi; the window's halo
// starts at its pixel (iy, ix); in's pixel (0, 0) is image pixel (gy0,
// gx0).  out: the output map, outw pixels a row, row stride ldo; the
// window's pixel (0, 0) is out's pixel (oy, ox).
struct Window {
  const float* in;
  int inw, ldi, iy, ix, gy0, gx0;
  float* out;
  int outw, ldo, oy, ox, oh, ow;
};

struct Scratch {
  float *h1, *h2, *bufs;
  int* opix;  // each window pixel's pixel in the output map
  int buf;    // floats of one chunk buffer
};

__device__ inline Scratch scratch_of(float* base, const ChainSmem& sm) {
  Scratch s;
  s.h1 = base + sm.map0 + sm.map1;
  s.h2 = s.h1 + sm.h1;
  s.opix = reinterpret_cast<int*>(s.h2 + sm.h2);
  s.bufs = s.h2 + sm.h2 + sm.tab;
  s.buf = sm.buf;
  return s;
}

// Start copying block b's chunk ci into dst (see chunk_floats).
__device__ inline void stage_chunk(const ChainBlock& b, int ci, float* dst,
                                   bool vec) {
  using namespace mma;
  const int cp8 = pad8(b.c), pn = pad8(b.p), e0 = ci * kChunk;
  const int ec = min(kChunk, b.e - e0), ldw2 = ld_b(pn);
  float* w2c = dst + cp8 * kLdW1;
  float* vc = w2c + kChunk * ldw2;
  stage<kCThreads>(dst, kLdW1, b.w1 + e0, b.e, b.c, ec, cp8, kChunk, vec);
  stage<kCThreads>(w2c, ldw2, b.w2 + (size_t)e0 * b.p, b.p, ec, b.p, kChunk, pn, vec);
  const float* vs[4] = {b.s1, b.b1, b.s2, b.b2};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    stage<kCThreads>(vc + k * kChunk, 0, vs[k] + e0, 0, 1, ec, 1, kChunk, vec);
  stage<kCThreads>(vc + 4 * kChunk, 0, b.kdw + (size_t)e0 * 9, 0, 1, ec * 9, 1,
        kChunk * 9, vec);
  cp_commit();
}

// Load rows x cols pixels of image img's NHWC input (c channels) into a
// float32 map of row stride ld, starting at image pixel (gy0, gx0): 0
// outside the image and in the channel padding up to pad8(c).  int8 codes
// are dequantized (code * scale).
template <typename T>
__device__ inline void load_map(float* map, int ld, const void* xv, int img,
                                int h, int w, int c, int rows, int cols,
                                int gy0, int gx0, bool vec,
                                float scale = 1.f) {
  const T* x = static_cast<const T*>(xv) + (size_t)img * h * w * c;
  const int ng = pad8(c) >> 3;  // groups of 8 channels
  for (int i = threadIdx.x; i < rows * cols * ng; i += kCThreads) {
    const int q = i / ng, c0 = (i - q * ng) << 3;
    const int my = q / cols, mx = q - my * cols;
    const int gy = gy0 + my, gx = gx0 + mx;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const T* src = x + ((size_t)gy * w + gx) * c + c0;
      if constexpr (sizeof(T) == 1) {
        if (vec) {
          const uint2 u = *reinterpret_cast<const uint2*>(src);
          const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = dequant(b[k], scale);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (c0 + k < c) v[k] = dequant(src[k], scale);
        }
      } else if (vec) {
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
          if (c0 + k < c) v[k] = to_f32(src[k]);
      }
    }
    float4* d = reinterpret_cast<float4*>(map + q * ld + c0);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// 1. The expand of the halo's 16-row slab r0 for the chunk's ntc n8 tiles,
// into h1 (rows < nq), 0 for the pixels outside the (h, w) image.
template <int A1>
__device__ __forceinline__ void expand_slab(const ChainBlock& b,
                                            const Window& wd, const float* w1c,
                                            const float* vc, float* h1,
                                            int r0, int nq, int hw, int ntc,
                                            bool exact, int h, int w) {
  using namespace mma;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* xa[2];
  bool in[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int q = min(r0 + g + 8 * u, nq - 1);
    const int qy = q / hw, qx = q - qy * hw;
    xa[u] = wd.in + ((wd.iy + qy) * wd.inw + wd.ix + qx) * wd.ldi + t;
    const int gy = wd.gy0 + wd.iy + qy, gx = wd.gx0 + wd.ix + qx;
    in[u] = gy >= 0 && gy < h && gx >= 0 && gx < w;
  }
  float acc[4][4];
  bool live[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    live[j] = j < ntc;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
  }
  const int cp8 = pad8(b.c);
  for (int k0 = 0; k0 < cp8; k0 += 8) {
    const float av[4] = {xa[0][k0], xa[1][k0], xa[0][k0 + 4], xa[1][k0 + 4]};
    uint32_t ab[4], as[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (exact) {
        ab[k] = __float_as_uint(av[k]);
        as[k] = 0u;
      } else {
        split_t<true>(av[k], ab[k], as[k]);
      }
    }
    float bf[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* wb = w1c + (k0 + t) * kLdW1 + j * 8 + g;
      bf[j][0] = wb[0];
      bf[j][1] = wb[4 * kLdW1];
    }
    mma_3x<4, true>(acc, ab, as, exact, bf, live);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (!live[j]) continue;
    const int col = j * 8 + 2 * t;
    const float s0 = vc[col], s1 = vc[col + 1];
    const float b0 = vc[kChunk + col], b1 = vc[kChunk + col + 1];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q = r0 + g + 8 * u;
      if (q >= nq) continue;
      const float v0 = in[u] ? act_t<A1>(acc[j][2 * u] * s0 + b0, b.act1)
                             : 0.f;
      const float v1 =
          in[u] ? act_t<A1>(acc[j][2 * u + 1] * s1 + b1, b.act1) : 0.f;
      *reinterpret_cast<float2*>(h1 + q * kLdH + col) = make_float2(v0, v1);
    }
  }
}

// 2. The depthwise 3x3 + act2 of the chunk's ec channels over the window's
// oh x ow pixels (zeros in the rows up to npix16 and the channels up to
// ntc * 8), in float32 on the CUDA cores: a thread a (channel, run of 4
// pixels of a row), each step loading one new column of 3 taps and keeping
// the last two.
template <int A2>
__device__ __forceinline__ void dw_chunk(const ChainBlock& b, const Scratch& s,
                                         const float* vc, int oh, int ow,
                                         int hw, int ec, int ntc) {
  using namespace mma;
  constexpr int kSeg = 4;
  const int ecw = ntc * 8, rows = kCThreads / ecw;
  const int e = threadIdx.x % ecw, r = threadIdx.x / ecw;
  if (r >= rows) return;
  const bool live = e < ec;
  float kd[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) kd[k] = vc[4 * kChunk + e * 9 + k];
  const float sc = vc[2 * kChunk + e], bi = vc[3 * kChunk + e];
  const int nseg = (ow + kSeg - 1) / kSeg, npix = oh * ow;
  for (int item = r; item < oh * nseg; item += rows) {
    const int py = item / nseg, px0 = (item - py * nseg) * kSeg;
    const float* hp = s.h1 + (py * hw + px0) * kLdH + e;
    float c0[3], c1[3];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      c0[dy] = hp[dy * hw * kLdH];
      c1[dy] = hp[(dy * hw + 1) * kLdH];
    }
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
      if (px0 + k >= ow) break;
      float c2[3], acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) c2[dy] = hp[(dy * hw + k + 2) * kLdH];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        acc = fmaf(c0[dy], kd[dy * 3], acc);
        acc = fmaf(c1[dy], kd[dy * 3 + 1], acc);
        acc = fmaf(c2[dy], kd[dy * 3 + 2], acc);
        c0[dy] = c1[dy];
        c1[dy] = c2[dy];
      }
      s.h2[(py * ow + px0 + k) * kLdA2 + e] =
          live ? act_t<A2>(acc * sc + bi, b.act2) : 0.f;
    }
  }
  for (int pix = npix + r; pix < round16(npix); pix += rows)
    s.h2[pix * kLdA2 + e] = 0.f;
}

// The n8 tiles of P a warp item of the projection takes over a window of
// nslab 16-row slabs: the group size (at most 4) whose rounds of kCWarps
// items cost the least, an item costing its A fragments (about 3 tiles'
// worth of loads and splits) plus 2 a tile.
__device__ __forceinline__ int project_group(int nslab, int nt) {
  int best = 0, gs = 1;
  for (int cand = 1; cand <= min(nt, 4); ++cand) {
    const int items = nslab * ((nt + cand - 1) / cand);
    const int cost = (items + kCWarps - 1) / kCWarps * (3 + 2 * cand);
    if (best == 0 || cost < best) {
      best = cost;
      gs = cand;
    }
  }
  return gs;
}

// 3. The chunk's share of the projection, gs <= NJ n8 tiles a warp item.
// The first chunk starts from 0, the others from the output map; the last
// applies the epilogue and stores to the map or, where y is set (the
// chain's last block), to image img's output in device memory, as float32
// (out_kind 0), bfloat16 (1) or int8 codes (2, at out_inv).
template <int NJ, int A3, int AR>
__device__ __forceinline__ void project_chunk(
    const ChainBlock& b, const Window& wd, const Scratch& s, const float* w2c,
    int npix, int ntc, int gs, bool first, bool last, void* y, int out_kind,
    float out_inv, int img, int h, int w) {
  using namespace mma;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nt = pad8(b.p) >> 3, ldw2 = ld_b(nt * 8);
  const int ngrp = (nt + gs - 1) / gs, nslab = round16(npix) >> 4;
  for (int item = warp; item < nslab * ngrp; item += kCWarps) {
    const int slab = item / ngrp, j0 = (item - slab * ngrp) * gs;
    int pr[2];
    float* op[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      pr[u] = slab * 16 + g + 8 * u;
      op[u] = pr[u] < npix ? wd.out + s.opix[pr[u]] * wd.ldo + 2 * t
                           : nullptr;
    }
    float acc[NJ][4];
    bool live[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      live[j] = j < gs && j0 + j < nt;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float2 c = make_float2(0.f, 0.f);
        if (!first && live[j] && op[u])
          c = *reinterpret_cast<const float2*>(op[u] + (j0 + j) * 8);
        acc[j][2 * u] = c.x;
        acc[j][2 * u + 1] = c.y;
      }
    }
    for (int k0 = 0; k0 < ntc * 8; k0 += 8) {
      const float* ha = s.h2 + (slab * 16 + g) * kLdA2 + k0 + t;
      const float av[4] = {ha[0], ha[8 * kLdA2], ha[4], ha[8 * kLdA2 + 4]};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) split_t<true>(av[k], ab[k], as[k]);
      float bf[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* wb = w2c + (k0 + t) * ldw2 + (j0 + j) * 8 + g;
        bf[j][0] = live[j] ? wb[0] : 0.f;
        bf[j][1] = live[j] ? wb[4 * ldw2] : 0.f;
      }
      mma_3x<NJ, true>(acc, ab, as, false, bf, live);
    }
    if (!last) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (live[j] && op[u])
            *reinterpret_cast<float2*>(op[u] + (j0 + j) * 8) =
                make_float2(acc[j][2 * u], acc[j][2 * u + 1]);
      continue;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (!op[u]) continue;
      const int py = pr[u] / wd.ow, px = pr[u] - py * wd.ow;
      const float* res =
          wd.in + ((wd.iy + py + 1) * wd.inw + wd.ix + px + 1) * wd.ldi;
      const int gy = wd.gy0 + wd.iy + 1 + py, gx = wd.gx0 + wd.ix + 1 + px;
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
      const size_t at = (((size_t)img * h + gy) * w + gx) * b.p;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (!live[j]) continue;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int o = (j0 + j) * 8 + 2 * t + k;
          if (o >= b.p) {  // the next block's channel padding
            if (!y) op[u][(j0 + j) * 8 + k] = 0.f;
            continue;
          }
          float v = act_t<A3>(acc[j][2 * u + k] * b.s3[o] + b.b3[o], b.act3);
          if (b.residual) v = act_t<AR>(v + res[o], b.res_act);
          if (!y)
            op[u][(j0 + j) * 8 + k] = v;
          else if (inside && out_kind == 2)
            store_q(static_cast<int8_t*>(y) + at + o, v, out_inv);
          else if (inside && out_kind == 1)
            store(static_cast<__nv_bfloat16*>(y) + at + o, v);
          else if (inside)
            store(static_cast<float*>(y) + at + o, v);
        }
      }
    }
  }
}

// The state of the weight pipeline across a launch: steps taken, each step
// one chunk in the buffer step % 2, the next step's chunk on its way.
struct Pipe {
  int step;
  bool vec;
};

// Block b over window wd, every chunk; next: the block whose chunk 0 the
// next window runs (null for none), staged during this window's last
// chunk.  y: the image's output (the chain's last block) or null, stored
// as out_kind (see project_chunk).
template <int A1, int A2, int A3, int AR>
__device__ void run_window_t(const ChainBlock& b, const Window& wd,
                             const Scratch& s, const ChainBlock* next,
                             Pipe& pipe, bool exact, void* y, int out_kind,
                             int img, int h, int w, float out_inv) {
  using namespace mma;
  const int warp = threadIdx.x >> 5;
  const int hw = wd.ow + 2, nq = (wd.oh + 2) * hw, npix = wd.oh * wd.ow;
  const int nchunks = (b.e + kChunk - 1) / kChunk, nt = pad8(b.p) >> 3;
  const int gs = project_group(round16(npix) >> 4, nt);
  for (int ci = 0; ci < nchunks; ++ci, ++pipe.step) {
    __syncthreads();  // the last chunk is done with h1, h2, the table and
                      // its buffer, and the map it wrote is complete
    if (ci == 0) {
      for (int i = threadIdx.x; i < round16(npix); i += kCThreads) {
        const int py = i < npix ? i / wd.ow : 0;
        const int px = i < npix ? i - py * wd.ow : 0;
        s.opix[i] = (wd.oy + py) * wd.outw + wd.ox + px;
      }
    }
    const ChainBlock* nb = ci + 1 < nchunks ? &b : next;
    if (nb) {
      stage_chunk(*nb, ci + 1 < nchunks ? ci + 1 : 0,
                  s.bufs + ((pipe.step + 1) & 1) * s.buf, pipe.vec);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // this chunk's weights, the table and the map are in
    const float* w1c = s.bufs + (pipe.step & 1) * s.buf;
    const float* w2c = w1c + pad8(b.c) * kLdW1;
    const float* vc = w2c + kChunk * ld_b(nt * 8);
    const int ec = min(kChunk, b.e - ci * kChunk), ntc = (ec + 7) >> 3;
    for (int r0 = warp * 16; r0 < nq; r0 += kCWarps * 16)
      expand_slab<A1>(b, wd, w1c, vc, s.h1, r0, nq, hw, ntc, exact, h, w);
    __syncthreads();
    dw_chunk<A2>(b, s, vc, wd.oh, wd.ow, hw, ec, ntc);
    __syncthreads();
    const bool first = ci == 0, last = ci + 1 == nchunks;
    if (gs == 1)
      project_chunk<1, A3, AR>(b, wd, s, w2c, npix, ntc, gs, first, last, y,
                               out_kind, out_inv, img, h, w);
    else if (gs == 2)
      project_chunk<2, A3, AR>(b, wd, s, w2c, npix, ntc, gs, first, last, y,
                               out_kind, out_inv, img, h, w);
    else
      project_chunk<4, A3, AR>(b, wd, s, w2c, npix, ntc, gs, first, last, y,
                               out_kind, out_inv, img, h, w);
  }
}

// run_window_t at block b's compile-time instance (I and on), else the
// runtime one.
template <int I = 0>
__device__ void run_window(const ChainBlock& b, const Window& wd,
                           const Scratch& s, const ChainBlock* next,
                           Pipe& pipe, bool exact, void* y, int out_kind,
                           int img, int h, int w, float out_inv = 1.f) {
  if constexpr (I < kNumActInstances) {
    if (b.inst == I)
      return run_window_t<kActInstances[I][0], kActInstances[I][1],
                          kActInstances[I][2], kActInstances[I][3]>(
          b, wd, s, next, pipe, exact, y, out_kind, img, h, w, out_inv);
    return run_window<I + 1>(b, wd, s, next, pipe, exact, y, out_kind, img,
                             h, w, out_inv);
  } else {
    run_window_t<-1, -1, -1, -1>(b, wd, s, next, pipe, exact, y, out_kind,
                                 img, h, w, out_inv);
  }
}

// Host side: read the C entries' block descriptions (meta: 8 ints a block,
// c e p act1 act2 act3 residual res_act; ptrs: 9 a block, w1 s1 b1 kdw s2
// b2 w2 s3 b3) into args, with each block's activation instance and the
// flags (in_kind and out_kind: float32 0, bfloat16 1, int8 2); false for a
// chain the kernels cannot take.
inline bool read_chain(ChainArgs& a, int nb, const int* meta,
                       const void* const* ptrs, int in_kind, int out_kind,
                       const void* x) {
  if (in_kind < 0 || in_kind > 2 || out_kind < 0 || out_kind > 2)
    return false;
  if (nb < 1 || nb > kMaxChain) return false;
  bool vec = true;
  for (int j = 0; j < nb; ++j) {
    const int* m = meta + 8 * j;
    const void* const* p = ptrs + 9 * j;
    ChainBlock& b = a.b[j];
    b = ChainBlock{(const float*)p[0], (const float*)p[1],
                   (const float*)p[2], (const float*)p[3],
                   (const float*)p[4], (const float*)p[5],
                   (const float*)p[6], (const float*)p[7],
                   (const float*)p[8], m[0], m[1], m[2], m[3], m[4],
                   m[5], m[6], m[7], -1};
    if (b.c < 1 || b.e < 1 || b.p < 1 || (b.residual && b.p != b.c) ||
        (j > 0 && b.c != a.b[j - 1].p))
      return false;
    for (int i = kNumActInstances - 1; i >= 0; --i)
      if (b.act1 == kActInstances[i][0] && b.act2 == kActInstances[i][1] &&
          b.act3 == kActInstances[i][2] &&
          (!b.residual || b.res_act == kActInstances[i][3]))
        b.inst = i;
    vec = vec && b.e % 4 == 0 && b.p % 4 == 0;
    for (int k = 0; k < 9; ++k) vec = vec && (uintptr_t)p[k] % 16 == 0;
  }
  a.nb = nb;
  a.flags = (in_kind == 1 ? kChainInBf16 : 0) |
            (in_kind == 2 ? kChainInI8 : 0) |
            (out_kind == 1 ? kChainOutBf16 : 0) |
            (out_kind == 2 ? kChainOutI8 : 0) | (vec ? kChainVecW : 0) |
            (a.b[0].c % 8 == 0 && (uintptr_t)x % 16 == 0 ? kChainVecX : 0);
  return true;
}

// The chunk buffer, the widest map stride and the largest block-0 window
// terms every layout shares.
inline int chain_buf(const ChainArgs& a) {
  int buf = 0;
  for (int j = 0; j < a.nb; ++j)
    buf = std::max(buf, chunk_floats(a.b[j].c, a.b[j].p));
  return buf;
}

// The halo, depthwise and table terms for a largest window of oh x ow.
inline void window_smem(ChainSmem& s, int oh, int ow) {
  const int npix16 = round16(oh * ow);
  s.h1 = (oh + 2) * (ow + 2) * mma::kLdH;
  s.h2 = npix16 * mma::kLdA2;
  s.tab = npix16;
}

// K4's layout for an output tile th x tw: block j reads a map of
// (th + 2(nb-j)) x (tw + 2(nb-j)) pixels from map[j % 2] and writes one
// ring smaller into map[(j+1) % 2] (the last block accumulates there too).
inline ChainSmem cascade_smem(const ChainArgs& a, int th, int tw) {
  ChainSmem s{0, 0, 0, 0, 0, 0};
  for (int j = 0; j <= a.nb; ++j) {
    const int r = a.nb - j, pix = (th + 2 * r) * (tw + 2 * r);
    const int c = j < a.nb ? a.b[j].c : a.b[a.nb - 1].p;
    int& m = (j & 1) ? s.map1 : s.map0;
    m = std::max(m, pix * map_ld(c));
  }
  window_smem(s, th + 2 * a.nb - 2, tw + 2 * a.nb - 2);
  s.buf = chain_buf(a);
  return s;
}

// K5's layout: a CTA's rows image rows and one halo row above and below,
// each w + 2 pixels wide (the zero border), twice, at the widest stride of
// the chain; the window terms of one output tile th x tw.
inline ChainSmem mega_smem(const ChainArgs& a, int rows, int th, int tw) {
  ChainSmem s{0, 0, 0, 0, 0, 0};
  int ld = map_ld(a.b[a.nb - 1].p);
  for (int j = 0; j < a.nb; ++j) ld = std::max(ld, map_ld(a.b[j].c));
  s.map0 = s.map1 = (rows + 2) * (a.w + 2) * ld;
  window_smem(s, th, tw);
  s.buf = chain_buf(a);
  return s;
}

}  // namespace ffcnn_block
