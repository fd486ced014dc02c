// K1 and K3 for Hopper: the fused inverted-residual block, NHWC, stride S
// (1 or 2), with both pointwise products on the tensor cores:
//
//   y = act_r( act3( (act2( dw3x3_S( zpad( act1(x @ w1 * s1 + b1) ) ) * s2
//                      + b2 ) @ w2) * s3 + b3 ) + x )   (residual: S == 1)
//
// Replaces ffcnn_tpu/kernels/block_fused.py::_make_kernel (S = 1, K1,
// block_fused.cu) and ::_make_down_kernel (S = 2, K3, block_down.cu).
// The math is float32, as there: the input is upcast on load, the output
// cast once at the store (float32, bfloat16 or int8 each, chosen at run
// time).  An int8 input is dequantized on load (code * in_scale) and an
// int8 output requantized at the store (clip(rint(y * out_inv), -127,
// 127)), as the TPU kernels' in_scale/out_scale boundaries of an int8
// plan do; the residual adds the dequantized input.
//
// Bound on this card: the block moves its input and output once (the
// expand never leaves the CTA), so its bytes bound it at some 0.1 ms for
// xl's region blocks at batch 64; what took the time in the float32-FMA
// kernel this replaces was the instructions around the two pointwise
// products (9 shared loads for 8 FMAs in the project at P <= 32, lanes
// multiplying zero columns, half the lanes idle at E = 16, a runtime
// activation switch in every epilogue).  Here:
//
// * Both products run on the tensor cores, mma.sync m16n8k8 in TF32, split
//   three ways (3xTF32): each float32 operand a is big = tf32(a) (rounded
//   to nearest) plus small = tf32(a - big), and the accumulator sums
//   small*big + big*small + big*big in float32.  That keeps about 2^-21
//   of each product, where one TF32 pass keeps 2^-11 and misses the float32
//   tolerance the kernel is held to.  A bfloat16 input is exact in TF32,
//   so its small part is zero and the expand takes two products, not three.
// * A CTA owns a TH x TW tile of output pixels of one image (at most 64,
//   an input halo of at most 104 pixels at S = 1 and 160 at S = 2:
//   block_fused.cuh's tile contract) and 128 output channels, loads the
//   halo once as float32, and walks E in chunks of 32 channels.  For each
//   chunk, with the next chunk's weights already on their way
//   (cp.async into the other of two buffers):
//     1. expand: [halo pixels, in 16-row slabs] x [C] @ [C] x [32] on the
//        tensor cores, a warp a slab and all of the chunk's n8 tiles,
//        epilogue act1(. * s1 + b1), then the pixels outside the image are
//        set to 0 (the pointwise conv of a zero pixel is act1(b1), not 0);
//     2. depthwise 3x3 (stride S) + act2 on the CUDA cores in float32, a
//        thread a (channel, pixel row) so that no lane idles at E = 16; the
//        result is stored split (big, small) for the project;
//     3. project: [64 output pixels] x [32] @ [32] x [P in n8 tiles], the
//        accumulators kept in fragments across the chunks (warp w holds
//        pixel slab w % 4 and every other n8 tile), so no lane multiplies a
//        zero column beyond the last n8 tile.
//   The epilogue applies s3, b3, act3, the residual from the float32 halo
//   (exact) and res_act, and stores.  In both products each of the three
//   passes runs over all of a warp's n8 tiles before the next pass, so the
//   mma that share an accumulator are never back to back; the instances
//   for P <= 32 (the large maps, many CTAs) are held to the registers that
//   let four or three CTAs share an SM.
// * The activations are template parameters for the combinations that
//   plan_runs yields on models/*.cfg (FFCNN_BLOCK_ACT_INSTANCES; the
//   tests check that every block of those cfgs has one); any other
//   combination runs the instance that reads them from the arguments.
// * Row strides are padded so that the fragment loads hit distinct banks:
//   an A fragment reads rows g and columns t (g = lane / 4, t = lane % 4),
//   which a stride of 4 mod 8 spreads over the 32 banks; a B fragment reads
//   rows t and columns g, which a stride of 8 mod 16 spreads.
// * Widths need not be multiples of 8: C is padded to 8 and E and P to n8
//   tiles with zeros in shared memory, and the stores skip the padding.
// The product helpers (3xTF32, cp.async, the padded strides, the activation
// instances) live in tf32_mma.cuh, which the chained kernels K4 and K5 share.

#pragma once

#include "tf32_mma.cuh"

namespace ffcnn_block {
namespace mma {

// Shared memory in floats for a halo of nq pixels, C padded to cp8 and a
// CTA's outputs padded to pn (the tests mirror it to check the cfgs' blocks):
// the halo, the expand output, the depthwise output (big and small), the
// output pixels' tap offsets, and two chunk buffers (expand weights,
// project weights, vectors).
__host__ __device__ constexpr int smem_floats(int nq, int cp8, int pn) {
  return (nq + 15) / 16 * 16 * ld_a(cp8) + nq * kLdH + 2 * kMaxPix * kLdA2 +
         kMaxPix + 2 * (cp8 * kLdW1 + kChunk * ld_b(pn) + kVec);
}

enum Flags { kInBf16 = 1, kOutBf16 = 2, kVec16 = 4, kInI8 = 8, kOutI8 = 16 };

// The input halo as float32, [nq16][ldx]: zero outside the image, past C
// and in the rows that round nq up to whole 16-row slabs.
template <typename T>
__device__ __forceinline__ void load_halo(float* xs, int ldx, const Args& a,
                                          int nq, int nq16, int hw, int iy0,
                                          int ix0) {
  const T* x = static_cast<const T*>(a.x);
  const int ng = a.cp >> 3;  // groups of 8 channels
  for (int i = threadIdx.x; i < nq16 * ng; i += kThreads) {
    const int q = i / ng, c0 = (i - q * ng) << 3;
    const int gy = iy0 + q / hw, gx = ix0 + q % hw;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q < nq && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w) {
      const T* src = x + (((size_t)blockIdx.y * a.h + gy) * a.w + gx) * a.c + c0;
      if constexpr (sizeof(T) == 1) {  // int8 codes, dequantized
        if (a.c % 8 == 0) {
          const uint2 u = *reinterpret_cast<const uint2*>(src);
          const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = dequant(b[k], a.in_scale);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (c0 + k < a.c) v[k] = dequant(src[k], a.in_scale);
        }
      } else if (a.c % 8 == 0) {
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
          if (c0 + k < a.c) v[k] = to_f32(src[k]);
      }
    }
    float4* d = reinterpret_cast<float4*>(xs + q * ldx + c0);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// The expand of one 16-row slab of the halo (rows r0..r0+15) for the
// chunk's NT n8 tiles: [16 x cp8] @ w1c[cp8 x 8 NT] on the tensor cores,
// then act1(. * s1 + b1) into h1s, 0 for the pixels outside the image.
template <int NT, int A1>
__device__ __forceinline__ void expand_slab(const Args& a, const float* xs,
                                            int ldx, const float* w1c,
                                            const float* vc, float* h1s,
                                            int r0, int nq, int hw, int iy0,
                                            int ix0, bool in_bf16) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[NT][4];
  bool live[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    live[j] = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
  }
  for (int k0 = 0; k0 < a.cp; k0 += 8) {
    const float* xa = xs + (r0 + g) * ldx + k0 + t;
    const float av[4] = {xa[0], xa[8 * ldx], xa[4], xa[8 * ldx + 4]};
    uint32_t ab[4], as[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (in_bf16) {
        ab[k] = __float_as_uint(av[k]);
        as[k] = 0u;
      } else {
        split(av[k], ab[k], as[k]);
      }
    }
    float b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* wb = w1c + (k0 + t) * kLdW1 + j * 8 + g;
      b[j][0] = wb[0];
      b[j][1] = wb[4 * kLdW1];
    }
    mma_3x<NT>(acc, ab, as, in_bf16, b, live);
  }
  bool in[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = r0 + g + 8 * h;
    const int gy = iy0 + q / hw, gx = ix0 + q % hw;
    in[h] = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + 2 * t;
    const float s0 = vc[col], s1 = vc[col + 1];
    const float b0 = vc[kChunk + col], b1 = vc[kChunk + col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = r0 + g + 8 * h;
      if (q >= nq) continue;
      const float v0 = in[h] ? act_t<A1>(acc[j][2 * h] * s0 + b0, a.act1)
                             : 0.f;
      const float v1 =
          in[h] ? act_t<A1>(acc[j][2 * h + 1] * s1 + b1, a.act1) : 0.f;
      *reinterpret_cast<float2*>(h1s + q * kLdH + col) = make_float2(v0, v1);
    }
  }
}

// NJ: n8 tiles of the projection a warp holds (of ceil(P' / 8), P' the
// CTA's outputs, at most kOG, split between two warps a pixel slab).
// a.cp is C padded to 8 here.  The instances that hold one or two tiles
// serve the small-P blocks of the large maps, which launch many CTAs: they
// are kept to the registers that let four or three CTAs share an SM (the
// others to two).
template <int S, int NJ, int A1, int A2, int A3, int AR>
__global__ void __launch_bounds__(kThreads, NJ == 1 ? 4 : NJ == 2 ? 3 : 2)
    block_kernel(Args a, int flags) {
  extern __shared__ float4 smem4[];
  const bool in_bf16 = flags & kInBf16, vec = flags & kVec16;
  const int th = a.th, tw = a.tw, npix = th * tw;
  const int hw = S * tw + 3 - S, nq = (S * th + 3 - S) * hw;
  const int nq16 = (nq + 15) & ~15, cp8 = a.cp, ldx = ld_a(cp8);
  const int og = blockIdx.z * kOG, np = min(kOG, a.p - og);
  const int nt = (np + 7) >> 3, ldw2 = ld_b(nt * 8);
  float* xs = reinterpret_cast<float*>(smem4);  // [nq16][ldx] input halo
  float* h1s = xs + nq16 * ldx;                 // [nq][kLdH] expand output
  float* h2b = h1s + nq * kLdH;                 // [kMaxPix][kLdA2] dw big
  float* h2s = h2b + kMaxPix * kLdA2;           //                  dw small
  int* poff = reinterpret_cast<int*>(h2s + kMaxPix * kLdA2);  // [kMaxPix]
  float* bufs = h2s + kMaxPix * kLdA2 + kMaxPix;  // two chunk buffers
  const int buf_floats = cp8 * kLdW1 + kChunk * ldw2 + kVec;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ty0 = (blockIdx.x / a.tiles_w) * th;  // output tile origin
  const int tx0 = (blockIdx.x % a.tiles_w) * tw;
  const int iy0 = S * ty0 - 1, ix0 = S * tx0 - 1;  // input halo origin
  const int nchunks = (a.e + kChunk - 1) / kChunk;

  // chunk ci's weights into buffer ci % 2: w1[:, e0:e0+32] as [cp8][kLdW1],
  // w2[e0:e0+32, og:og+np] as [32][ldw2], then s1 b1 s2 b2 and kdw
  auto stage_chunk = [&](int ci) {
    float* w1c = bufs + (ci & 1) * buf_floats;
    float* w2c = w1c + cp8 * kLdW1;
    float* vc = w2c + kChunk * ldw2;
    const int e0 = ci * kChunk, ec = min(kChunk, a.e - e0);
    stage(w1c, kLdW1, a.w1 + e0, a.e, a.c, ec, cp8, kChunk, vec);
    stage(w2c, ldw2, a.w2 + (size_t)e0 * a.p + og, a.p, ec, np, kChunk,
          nt * 8, vec);
    const float* vs[4] = {a.s1, a.b1, a.s2, a.b2};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      stage(vc + k * kChunk, 0, vs[k] + e0, 0, 1, ec, 1, kChunk, vec);
    stage(vc + 4 * kChunk, 0, a.kdw + (size_t)e0 * 9, 0, 1, ec * 9, 1,
          kChunk * 9, vec);
    cp_commit();
  };

  stage_chunk(0);
  // each output pixel's first tap in h1s (no division in the tap loop)
  for (int i = tid; i < kMaxPix; i += kThreads) {
    const int py = i / tw, px = i - py * tw;
    poff[i] = i < npix ? (S * py * hw + S * px) * kLdH : 0;
  }
  if (in_bf16)
    load_halo<__nv_bfloat16>(xs, ldx, a, nq, nq16, hw, iy0, ix0);
  else if (flags & kInI8)
    load_halo<int8_t>(xs, ldx, a, nq, nq16, hw, iy0, ix0);
  else
    load_halo<float>(xs, ldx, a, nq, nq16, hw, iy0, ix0);

  // the projection: this warp's pixel slab and n8 tiles pj0 + 2j
  const int pm = warp & 3, pj0 = warp >> 2;
  float pacc[NJ][4];
  bool plive[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    plive[j] = pj0 + 2 * j < nt;
#pragma unroll
    for (int k = 0; k < 4; ++k) pacc[j][k] = 0.f;
  }

  for (int ci = 0; ci < nchunks; ++ci) {
    __syncthreads();  // chunk ci-1 is done with h1s, h2 and its buffer
    if (ci + 1 < nchunks) {
      stage_chunk(ci + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // chunk ci's buffer (and at ci 0 the halo) is in
    const float* w1c = bufs + (ci & 1) * buf_floats;
    const float* w2c = w1c + cp8 * kLdW1;
    const float* vc = w2c + kChunk * ldw2;
    const int ec = min(kChunk, a.e - ci * kChunk), ntc = (ec + 7) >> 3;

    // 1. expand: a warp a 16-row slab, all the chunk's n8 tiles at once
    for (int r0 = warp * 16; r0 < nq16; r0 += kWarps * 16) {
      switch (ntc) {
        case 1:
          expand_slab<1, A1>(a, xs, ldx, w1c, vc, h1s, r0, nq, hw, iy0, ix0,
                             in_bf16);
          break;
        case 2:
          expand_slab<2, A1>(a, xs, ldx, w1c, vc, h1s, r0, nq, hw, iy0, ix0,
                             in_bf16);
          break;
        case 3:
          expand_slab<3, A1>(a, xs, ldx, w1c, vc, h1s, r0, nq, hw, iy0, ix0,
                             in_bf16);
          break;
        default:
          expand_slab<4, A1>(a, xs, ldx, w1c, vc, h1s, r0, nq, hw, iy0, ix0,
                             in_bf16);
      }
    }
    __syncthreads();

    // 2. depthwise 3x3 (stride S) + act2: thread = (channel e of the
    // chunk's ntc * 8, pixel row), every output pixel row of the 64
    {
      const int ecw = ntc * 8, rows = kThreads / ecw;
      const int e = tid % ecw, p0 = tid / ecw;
      if (p0 < rows) {
        const bool live = e < ec;
        float kd[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) kd[k] = vc[4 * kChunk + e * 9 + k];
        const float sc = vc[2 * kChunk + e], bi = vc[3 * kChunk + e];
#pragma unroll 4
        for (int pix = p0; pix < kMaxPix; pix += rows) {
          float v = 0.f;
          if (live && pix < npix) {
            const float* hp = h1s + poff[pix] + e;
            float s = 0.f;
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx)
                s = fmaf(hp[(dy * hw + dx) * kLdH], kd[dy * 3 + dx], s);
            v = act_t<A2>(s * sc + bi, a.act2);
          }
          uint32_t big, small;
          split(v, big, small);
          h2b[pix * kLdA2 + e] = __uint_as_float(big);
          h2s[pix * kLdA2 + e] = __uint_as_float(small);
        }
      }
    }
    __syncthreads();

    // 3. project: pacc += h2[slab pm] @ w2c[:, n8 tiles pj0 + 2j]
    if (pj0 < nt) {
      for (int k0 = 0; k0 < ntc * 8; k0 += 8) {
        const int r = (pm * 16 + g) * kLdA2 + k0 + t;
        const uint32_t ab[4] = {
            __float_as_uint(h2b[r]), __float_as_uint(h2b[r + 8 * kLdA2]),
            __float_as_uint(h2b[r + 4]),
            __float_as_uint(h2b[r + 8 * kLdA2 + 4])};
        const uint32_t as[4] = {
            __float_as_uint(h2s[r]), __float_as_uint(h2s[r + 8 * kLdA2]),
            __float_as_uint(h2s[r + 4]),
            __float_as_uint(h2s[r + 8 * kLdA2 + 4])};
        float b[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float* wb = w2c + (k0 + t) * ldw2 + (pj0 + 2 * j) * 8 + g;
          b[j][0] = plive[j] ? wb[0] : 0.f;
          b[j][1] = plive[j] ? wb[4 * ldw2] : 0.f;
        }
        mma_3x<NJ>(pacc, ab, as, false, b, plive);
      }
    }
  }

  // epilogue: act3(acc * s3 + b3), then the residual, then the store
  const int img = blockIdx.y;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pix = pm * 16 + g + 8 * h;
    if (pix >= npix) continue;
    const int py = pix / tw, px = pix - py * tw;
    const int gy = ty0 + py, gx = tx0 + px;
    if (gy >= a.ho || gx >= a.wo) continue;
    const size_t at = (((size_t)img * a.ho + gy) * a.wo + gx) * a.p;
    const float* res = xs + ((py + 1) * hw + px + 1) * ldx;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (!plive[j]) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int o = og + (pj0 + 2 * j) * 8 + 2 * t + u;
        if (o >= a.p) continue;
        float v = act_t<A3>(pacc[j][2 * h + u] * a.s3[o] + a.b3[o], a.act3);
        if (S == 1 && a.residual) v = act_t<AR>(v + res[o], a.res_act);
        if (flags & kOutI8)
          store_q(static_cast<int8_t*>(a.y) + at + o, v, a.out_inv);
        else if (flags & kOutBf16)
          store(static_cast<__nv_bfloat16*>(a.y) + at + o, v);
        else
          store(static_cast<float*>(a.y) + at + o, v);
      }
    }
  }
}

// Internal linkage: each library that includes this header (K1's, K3's,
// P3's) has its own copy of every instance and must raise the cap of its
// own copy, so the record of devices done must not be one symbol that the
// dynamic linker unifies across the libraries, as it does for the static
// locals of an inline template with external linkage.
namespace {

template <int S, int NJ, int A1, int A2, int A3, int AR>
void launch(const Args& a, int flags, dim3 grid, size_t smem,
            cudaStream_t stream) {
  // The shared-memory cap is a per-device attribute of the instance: raise
  // it to the card's maximum once per device, not on every launch.
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit) &&
      cudaFuncSetAttribute(block_kernel<S, NJ, A1, A2, A3, AR>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem) == cudaSuccess)
    raised.fetch_or(bit, std::memory_order_relaxed);
  block_kernel<S, NJ, A1, A2, A3, AR><<<grid, kThreads, smem, stream>>>(a,
                                                                       flags);
}

}  // namespace

template <int S, int NJ>
void launch_acts(const Args& a, int flags, dim3 grid, size_t smem,
                 cudaStream_t stream) {
#define FFCNN_TRY_ACTS(A1, A2, A3, AR)                                \
  if (a.act1 == A1 && a.act2 == A2 && a.act3 == A3 &&                 \
      (!a.residual || a.res_act == AR))                               \
    return launch<S, NJ, A1, A2, A3, AR>(a, flags, grid, smem, stream);
  FFCNN_BLOCK_ACT_INSTANCES(FFCNN_TRY_ACTS)
#undef FFCNN_TRY_ACTS
  launch<S, NJ, -1, -1, -1, -1>(a, flags, grid, smem, stream);
}

}  // namespace mma

// The C entries' body: checks what the kernel cannot take, then launches.
// (th, tw) is the OUTPUT tile; the output is (h/S) x (w/S).  in_kind and
// out_kind pick float32 (0), bfloat16 (1) or int8 (2) for x and y: int8 x
// is dequantized on load (code * in_scale), int8 y requantized at the
// store (clip(rint(y * out_inv), -127, 127)).
template <int S>
int run_block(const void* x, void* y, int in_kind, int out_kind,
              const void* w1, const void* s1, const void* b1, const void* kdw,
              const void* s2, const void* b2, const void* w2, const void* s3,
              const void* b3, int n, int h, int w, int c, int e, int p,
              int act1, int act2, int act3, int residual, int res_act, int th,
              int tw, void* stream, float in_scale = 1.f,
              float out_inv = 1.f) {
  using namespace mma;
  const int hw = S * tw + 3 - S, nq = (S * th + 3 - S) * hw;
  if (th < 1 || tw < 1 || th * tw > kMaxPix || nq > max_halo<S>() ||
      h % S || w % S || (S != 1 && residual) || in_kind < 0 || in_kind > 2 ||
      out_kind < 0 || out_kind > 2)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || w == 0 || p == 0) return (int)cudaGetLastError();
  const int ho = h / S, wo = w / S, cp8 = (c + 7) / 8 * 8;
  Args a{x, y,
         (const float*)w1, (const float*)s1, (const float*)b1,
         (const float*)kdw, (const float*)s2, (const float*)b2,
         (const float*)w2, (const float*)s3, (const float*)b3,
         n, h, w, c, e, p, ho, wo, act1, act2, act3, residual, res_act,
         th, tw, (wo + tw - 1) / tw, cp8, in_scale, out_inv};
  const int pn = ((p < kOG ? p : kOG) + 7) / 8 * 8;  // the widest CTA's
  const size_t smem = sizeof(float) * smem_floats(nq, cp8, pn);
  if (smem > kMaxSmem || n > 65535 || c < 1 || e < 1)
    return (int)cudaErrorInvalidValue;
  const void* weights[] = {w1, s1, b1, kdw, s2, b2, w2};
  bool aligned = e % 4 == 0 && p % 4 == 0;
  for (const void* ptr : weights)
    aligned = aligned && (uintptr_t)ptr % 16 == 0;
  const int flags = (in_kind == 1 ? kInBf16 : 0) |
                    (in_kind == 2 ? kInI8 : 0) |
                    (out_kind == 1 ? kOutBf16 : 0) |
                    (out_kind == 2 ? kOutI8 : 0) | (aligned ? kVec16 : 0);
  const dim3 grid(((ho + th - 1) / th) * a.tiles_w, n, (p + kOG - 1) / kOG);
  // n8 tiles a warp holds: half the widest CTA's, rounded up to 1, 2, 4, 8
  const int need = (pn / 8 + 1) / 2;
  cudaStream_t s = (cudaStream_t)stream;
  if (need <= 1)
    launch_acts<S, 1>(a, flags, grid, smem, s);
  else if (need <= 2)
    launch_acts<S, 2>(a, flags, grid, smem, s);
  else if (need <= 4)
    launch_acts<S, 4>(a, flags, grid, smem, s);
  else
    launch_acts<S, 8>(a, flags, grid, smem, s);
  return (int)cudaGetLastError();
}

}  // namespace ffcnn_block
