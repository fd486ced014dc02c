// Chained fused blocks: the device code shared by the halo cascade (K4,
// block_cascade.cu) and the whole-run kernel (K5, block_mega.cu), built from
// the block template's helpers and constants (block_fused.cuh).
//
// Both run several stride-1 blocks inside one CTA and keep every boundary
// between them in shared memory as float32, never rounded: only the chain's
// input and its last output touch device memory.  A block is applied to a
// "window": an oh x ow rectangle of output pixels whose input halo,
// (oh+2) x (ow+2) pixels, lies in a float32 map in shared memory.  As in K1,
// E is walked in chunks of 32 channels (one per lane): expand the halo for
// the chunk (pixels outside the image are zeroed after the expand epilogue:
// the dw zero padding applies to the expand OUTPUT), depthwise 3x3, then the
// chunk's share of the projection.  K1 keeps that sum in registers for its
// <= 64 pixels; a window here may hold hundreds (a cascade's first blocks
// cover the tile and its halo rings), so the sum is kept in the window's
// float32 output map in shared memory, read and written once per chunk, and
// the last chunk applies the epilogue (scale, bias, act3, residual) and
// stores to that map, or, for the chain's last block, to device memory.

#pragma once

#include <algorithm>

#include "block_fused.cuh"

namespace ffcnn_block {

constexpr int kMaxChain = 16;  // blocks per launch

// One block of a chain: its weights (layouts as in Args) and widths.
struct ChainBlock {
  const float *w1, *s1, *b1, *kdw, *s2, *b2, *w2, *s3, *b3;
  int c, e, p, act1, act2, act3, residual, res_act;
};

// A launch's shared memory, in floats: two maps, then the chunk buffers.
struct ChainSmem {
  int buf0, buf1, w1s, h1s, h2s, w2s;
  __host__ __device__ size_t bytes() const {
    return sizeof(float) *
           ((size_t)buf0 + buf1 + w1s + h1s + h2s + w2s);
  }
};

struct ChainArgs {
  const void* x;
  void* y;
  int h, w, nb, th, tw, tiles_w;
  ChainSmem sm;
  ChainBlock b[kMaxChain];
};

__host__ __device__ inline int pad4(int c) { return (c + 3) / 4 * 4; }
__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
// Output channels of one projection pass: 32 * proj_pj(p), at most 128.
__host__ __device__ inline int proj_pj(int p) {
  return p >= kOG ? 4 : (p + 31) / 32;
}
// Row stride of the projection's weight chunk: p rounded up to whole passes.
__host__ __device__ inline int proj_stride(int p) {
  return round_up(p, 32 * proj_pj(p));
}

// in: the input map, inw pixels a row, channel stride pad4(c); the window's
// halo starts at its pixel (iy, ix); in's pixel (0, 0) is image pixel
// (gy0, gx0).  out: the output map, outw pixels a row, channel stride
// pad4(p); the window's pixel (0, 0) is out's pixel (oy, ox).
struct Window {
  const float* in;
  int inw, iy, ix, gy0, gx0;
  float* out;
  int outw, oy, ox, oh, ow;
};

// The chunk buffers: w1s [cp][kEC], h1s [halo][kEC], h2s [pix][kEC],
// w2s [kEC][ps].
struct Scratch {
  float *w1s, *h1s, *h2s, *w2s;
};

__device__ inline void load_chunk_weights(const ChainBlock& b,
                                          const Scratch& s, int e0, int ec) {
  const int cp = pad4(b.c), ps = proj_stride(b.p);
  for (int i = threadIdx.x; i < cp * kEC; i += kThreads) {
    const int c = i / kEC, e = i - c * kEC;
    s.w1s[i] = (c < b.c && e < ec) ? b.w1[(size_t)c * b.e + e0 + e] : 0.f;
  }
  for (int i = threadIdx.x; i < kEC * ps; i += kThreads) {
    const int e = i / ps, o = i - e * ps;
    s.w2s[i] = (e < ec && o < b.p) ? b.w2[(size_t)(e0 + e) * b.p + o] : 0.f;
  }
}

// h1s[q][lane] = act1(in[q] . w1[:, e0 + lane] * s1 + b1) over the window's
// halo, 0 at pixels outside the image; kHaloPass pixels per pass.
__device__ inline void expand_chunk(const ChainBlock& b, const Window& wd,
                                    const Scratch& s, int e0, int ec, int h,
                                    int w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hw = wd.ow + 2, nq = (wd.oh + 2) * hw, cp = pad4(b.c);
  const bool live = lane < ec;
  const float sc = live ? b.s1[e0 + lane] : 0.f;
  const float bi = live ? b.b1[e0 + lane] : 0.f;
  for (int q0 = 0; q0 < nq; q0 += kHaloPass) {
    int off[kQPT];
    float ex[kQPT];
#pragma unroll
    for (int k = 0; k < kQPT; ++k) {
      const int q = min(q0 + warp + k * kWarps, nq - 1);
      const int qy = q / hw;
      off[k] = ((wd.iy + qy) * wd.inw + wd.ix + q - qy * hw) * cp;
      ex[k] = 0.f;
    }
    for (int c = 0; c < cp; c += 4) {
      const float wa = s.w1s[c * kEC + lane];
      const float wb = s.w1s[(c + 1) * kEC + lane];
      const float wc = s.w1s[(c + 2) * kEC + lane];
      const float wdd = s.w1s[(c + 3) * kEC + lane];
#pragma unroll
      for (int k = 0; k < kQPT; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(wd.in + off[k] + c);
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
        const int qy = q / hw;
        const int gy = wd.gy0 + wd.iy + qy, gx = wd.gx0 + wd.ix + q - qy * hw;
        const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
        s.h1s[q * kEC + lane] =
            (in && live) ? act(ex[k] * sc + bi, b.act1) : 0.f;
      }
    }
  }
}

// h2s[pix][lane] = act2(dw3x3(h1s) * s2 + b2) over the window's pixels.
__device__ inline void dw_chunk(const ChainBlock& b, const Window& wd,
                                const Scratch& s, int e0, int ec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hw = wd.ow + 2, npix = wd.oh * wd.ow;
  const bool live = lane < ec;
  float kd[9];
#pragma unroll
  for (int t = 0; t < 9; ++t)
    kd[t] = live ? b.kdw[(size_t)(e0 + lane) * 9 + t] : 0.f;
  const float sc = live ? b.s2[e0 + lane] : 0.f;
  const float bi = live ? b.b2[e0 + lane] : 0.f;
  for (int pix = warp; pix < npix; pix += kWarps) {
    const int py = pix / wd.ow, px = pix - py * wd.ow;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        acc = fmaf(s.h1s[((py + dy) * hw + px + dx) * kEC + lane],
                   kd[dy * 3 + dx], acc);
    s.h2s[pix * kEC + lane] = live ? act(acc * sc + bi, b.act2) : 0.f;
  }
}

// The chunk's share of the projection, out[pix][o] += h2s[pix][:ec] .
// w2s[:ec][o]: thread (warp, lane) owns pixels p0 + warp + kWarps*k of each
// pass of kMaxPix and channels og + lane + 32j.  The first chunk starts
// from 0; the last applies the epilogue and stores to out (zeroing its
// channel padding) or, where y is set, to the image's output in device
// memory (h x w x p).
template <int PJ, typename Tout>
__device__ void project_chunk(const ChainBlock& b, const Window& wd,
                              const Scratch& s, int ec, bool first, bool last,
                              Tout* y, int h, int w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int npix = wd.oh * wd.ow, cpi = pad4(b.c), cpo = pad4(b.p);
  const int ps = proj_stride(b.p);
  for (int og = 0; og < b.p; og += 32 * PJ) {
    for (int p0 = 0; p0 < npix; p0 += kMaxPix) {
      float acc[kPPT][PJ];
      int off[kPPT];  // the pixel's index in out, -1 past the window
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const int pix = p0 + warp + k * kWarps;
        const int py = pix / wd.ow, px = pix - py * wd.ow;
        off[k] = pix < npix ? (wd.oy + py) * wd.outw + wd.ox + px : -1;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int o = og + lane + 32 * j;
          acc[k][j] = (!first && off[k] >= 0 && o < b.p)
                          ? wd.out[off[k] * cpo + o] : 0.f;
        }
      }
      for (int e = 0; e < ec; ++e) {
        float wv[PJ];
#pragma unroll
        for (int j = 0; j < PJ; ++j) wv[j] = s.w2s[e * ps + og + lane + 32 * j];
#pragma unroll
        for (int k = 0; k < kPPT; ++k) {
          const float hv = s.h2s[(p0 + warp + k * kWarps) * kEC + e];
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[k][j] = fmaf(hv, wv[j], acc[k][j]);
        }
      }
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        if (off[k] < 0) continue;
        const int pix = p0 + warp + k * kWarps;
        const int py = pix / wd.ow, px = pix - py * wd.ow;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int o = og + lane + 32 * j;
          float* dst = wd.out + off[k] * cpo + o;
          if (!last) {
            if (o < b.p) *dst = acc[k][j];
            continue;
          }
          if (o >= b.p) {
            if (!y && o < cpo) *dst = 0.f;  // the next block's channel pad
            continue;
          }
          float v = act(acc[k][j] * b.s3[o] + b.b3[o], b.act3);
          if (b.residual)
            v = act(v + wd.in[((wd.iy + py + 1) * wd.inw + wd.ix + px + 1) *
                                  cpi + o],
                    b.res_act);
          if (!y) {
            *dst = v;
            continue;
          }
          const int gy = wd.gy0 + wd.iy + 1 + py;
          const int gx = wd.gx0 + wd.ix + 1 + px;
          if (gy >= 0 && gy < h && gx >= 0 && gx < w)
            store(y + ((size_t)gy * w + gx) * b.p + o, v);
        }
      }
    }
  }
}

template <int PJ, typename Tout>
__device__ void run_window_pj(const ChainBlock& b, const Window& wd,
                              const Scratch& s, Tout* y, int h, int w) {
  for (int e0 = 0; e0 < b.e; e0 += kEC) {
    const int ec = min(kEC, b.e - e0);
    __syncthreads();  // the previous chunk, window or load is done
    load_chunk_weights(b, s, e0, ec);
    __syncthreads();
    expand_chunk(b, wd, s, e0, ec, h, w);
    __syncthreads();
    dw_chunk(b, wd, s, e0, ec);
    __syncthreads();
    project_chunk<PJ, Tout>(b, wd, s, ec, e0 == 0, e0 + kEC >= b.e, y, h, w);
  }
}

// Block b over window wd; y: the image's output for the chain's last block,
// else null.
template <typename Tout>
__device__ void run_window(const ChainBlock& b, const Window& wd,
                           const Scratch& s, Tout* y, int h, int w) {
  switch (proj_pj(b.p)) {
    case 1: run_window_pj<1, Tout>(b, wd, s, y, h, w); break;
    case 2: run_window_pj<2, Tout>(b, wd, s, y, h, w); break;
    case 3: run_window_pj<3, Tout>(b, wd, s, y, h, w); break;
    default: run_window_pj<4, Tout>(b, wd, s, y, h, w); break;
  }
}

__device__ inline Scratch scratch_of(float* base, const ChainSmem& sm) {
  Scratch s;
  s.w1s = base + sm.buf0 + sm.buf1;
  s.h1s = s.w1s + sm.w1s;
  s.h2s = s.h1s + sm.h1s;
  s.w2s = s.h2s + sm.h2s;
  return s;
}

// Host side: read the C entries' block descriptions (meta: 8 ints a block,
// c e p act1 act2 act3 residual res_act; ptrs: 9 a block, w1 s1 b1 kdw s2
// b2 w2 s3 b3) into args; false for a chain the kernels cannot take.
inline bool read_chain(ChainArgs& a, int nb, const int* meta,
                       const void* const* ptrs) {
  if (nb < 1 || nb > kMaxChain) return false;
  for (int j = 0; j < nb; ++j) {
    const int* m = meta + 8 * j;
    const void* const* p = ptrs + 9 * j;
    a.b[j] = ChainBlock{(const float*)p[0], (const float*)p[1],
                        (const float*)p[2], (const float*)p[3],
                        (const float*)p[4], (const float*)p[5],
                        (const float*)p[6], (const float*)p[7],
                        (const float*)p[8], m[0], m[1], m[2], m[3], m[4],
                        m[5], m[6], m[7]};
    const ChainBlock& b = a.b[j];
    if (b.c < 1 || b.e < 1 || b.p < 1 || (b.residual && b.p != b.c) ||
        (j > 0 && b.c != a.b[j - 1].p))
      return false;
  }
  a.nb = nb;
  return true;
}

// The largest input and projection widths of a chain.
inline void chain_widths(const ChainArgs& a, int& cpin, int& psmax) {
  cpin = psmax = 0;
  for (int j = 0; j < a.nb; ++j) {
    cpin = std::max(cpin, pad4(a.b[j].c));
    psmax = std::max(psmax, proj_stride(a.b[j].p));
  }
}

// K4's layout for an output tile th x tw: block j reads a map of
// (th + 2(nb-j)) x (tw + 2(nb-j)) pixels from buf[j % 2] and writes one ring
// smaller into buf[(j+1) % 2] (the last block accumulates there too).
inline ChainSmem cascade_smem(const ChainArgs& a, int th, int tw) {
  ChainSmem s{0, 0, 0, 0, 0, 0};
  int cpin, psmax;
  chain_widths(a, cpin, psmax);
  for (int j = 0; j <= a.nb; ++j) {
    const int r = a.nb - j, pix = (th + 2 * r) * (tw + 2 * r);
    const int cp = pad4(j < a.nb ? a.b[j].c : a.b[a.nb - 1].p);
    int& buf = (j & 1) ? s.buf1 : s.buf0;
    buf = std::max(buf, pix * cp);
  }
  s.w1s = kEC * cpin;
  s.w2s = kEC * psmax;
  s.h1s = kEC * (th + 2 * a.nb) * (tw + 2 * a.nb);
  s.h2s = kEC * round_up((th + 2 * a.nb - 2) * (tw + 2 * a.nb - 2), kMaxPix);
  return s;
}

// K5's layout: the (h+2) x (w+2) map with its zero border, twice, and the
// chunk buffers of one output tile th x tw.
inline ChainSmem mega_smem(const ChainArgs& a, int th, int tw) {
  ChainSmem s{0, 0, 0, 0, 0, 0};
  int cpin, psmax;
  chain_widths(a, cpin, psmax);
  const int cpm = std::max(cpin, pad4(a.b[a.nb - 1].p));
  s.buf0 = s.buf1 = (a.h + 2) * (a.w + 2) * cpm;
  s.w1s = kEC * cpin;
  s.w2s = kEC * psmax;
  s.h1s = kEC * (th + 2) * (tw + 2);
  s.h2s = kEC * round_up(th * tw, kMaxPix);
  return s;
}

}  // namespace ffcnn_block
