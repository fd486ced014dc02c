// The constants and helpers of the fused inverted-residual block kernels,
// NHWC, stride S (1 or 2):
//
//   y = act_r( act3( (act2( dw3x3_S( zpad( act1(x @ w1 * s1 + b1) ) ) * s2
//                      + b2 ) @ w2) * s3 + b3 ) + x )   (residual: S == 1)
//
// Every block kernel runs its pointwise products on the tensor cores:
// K1 and K3 (block_fused.cu, block_down.cu) on block_mma.cuh, the chained
// K4 and K5 on block_chain.cuh, and the block bench's K8 and K9 (mbconv.cu,
// mbconv_cs.cu) with P3's pwonly and fullbf16 (block_variants.cu) on the
// body with rounding points, block_round_mma.cuh; all of them through
// tf32_mma.cuh, which includes this file, as the int8 conv (conv_int8.cu)
// does.  What they share from here: a CTA of kThreads owns a tile of at
// most kMaxPix output pixels (an input halo of at most max_halo<S>()
// pixels) and kOG output channels, within kMaxSmem of shared memory; the
// activations by id (act), the storage conversions and the int8
// boundaries.  The dw zero padding applies to the expand OUTPUT: halo
// pixels outside the image are set to 0 after the expand epilogue (pw of
// a zero pixel is act1(b1), not 0).  kEC, kHaloPass, kQPT and kPPT are the
// constants of the first, float32-FMA chunk scheme (E in 32-channel
// chunks, one a lane, kHaloPass halo pixels a pass), which no kernel
// reads any more.

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
  // int8 boundaries (K1 and K3): the input code times in_scale on load,
  // the output clip(rint(y * out_inv), -127, 127) at the store
  float in_scale, out_inv;
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
// An int8 boundary: dequantize a code on load; requantize at the store as
// ffcnn_tpu/kernels/block_fused.py::_quantize does, clip(round(y * inv),
// -127, 127), rounding half to even, the product rounded first (no FMA).
__device__ __forceinline__ float dequant(int8_t q, float scale) {
  return __fmul_rn((float)q, scale);
}
__device__ __forceinline__ int8_t quant(float v, float inv) {
  const int q = __float2int_rn(__fmul_rn(v, inv));
  return (int8_t)max(-127, min(127, q));
}
__device__ __forceinline__ void store_q(int8_t* p, float v, float inv) {
  *p = quant(v, inv);
}

}  // namespace ffcnn_block
