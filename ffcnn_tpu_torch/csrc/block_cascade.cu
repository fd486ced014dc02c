// K4: the halo cascade, a group of consecutive stride-1 fused blocks in one
// launch, NHWC; every boundary inside the group stays on chip in float32.
//
// Replaces ffcnn_tpu/kernels/block_fused.py::_make_cascade_kernel (launched
// by _cs_cascade).  The TPU kernel takes R output rows plus K halo rows on
// each side and shrinks the valid span by two rows a block; here a CTA owns
// a TH x TW output tile of one image, loads the (TH+2K) x (TW+2K) input halo
// once into shared memory as float32 (vector loads), and applies the K
// blocks in turn, each to the map one pixel ring smaller than its input
// (block_chain.cuh).  The tiles are two-dimensional, so the expand zeroing
// applies at all four edges of the image.  A tile at the map's right or
// bottom edge is cut to the map.  In an int8 plan the group's input and
// output may be int8 codes, dequantized on load and requantized at the
// store as the TPU kernel's in_scale/out_scale do; inside the group every
// boundary stays float32.
//
// Bound on this card: the per-block launches (K1) write each boundary to
// device memory and read it back with a halo; here it never leaves the CTA,
// but the K halo rings are recomputed, (TH+2K)(TW+2K)/(TH*TW) of the first
// block's expand.  Both pointwise products run on the tensor cores in
// 3xTF32 (block_chain.cuh), so what is left on the CUDA cores is the
// depthwise taps, the epilogues and the splits; the wrapper's tile search
// (kernels/block_fused.py pick_cascade_tile) prices those against the halo
// recompute within the shared memory of one 512-thread CTA an SM.

#include "block_chain.cuh"

using namespace ffcnn_block;

namespace {

__global__ void __launch_bounds__(kCThreads, 1)
    cascade_kernel(const __grid_constant__ ChainArgs a) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  float* map[2] = {base, base + a.sm.map0};
  const Scratch s = scratch_of(base, a.sm);
  const int k = a.nb, img = blockIdx.y, tiles_w = (a.w + a.tw - 1) / a.tw;
  const int ty0 = (blockIdx.x / tiles_w) * a.th;
  const int tx0 = (blockIdx.x % tiles_w) * a.tw;
  const int th = min(a.th, a.h - ty0), tw = min(a.tw, a.w - tx0);
  const bool in_bf16 = a.flags & kChainInBf16;
  Pipe pipe{0, (a.flags & kChainVecW) != 0};
  stage_chunk(a.b[0], 0, s.bufs, pipe.vec);
  // the input halo, k pixel rings around the tile
  const int c = a.b[0].c, vec = (a.flags & kChainVecX) != 0;
  if (in_bf16)
    load_map<__nv_bfloat16>(map[0], map_ld(c), a.x, img, a.h, a.w, c,
                            th + 2 * k, tw + 2 * k, ty0 - k, tx0 - k, vec);
  else if (a.flags & kChainInI8)
    load_map<int8_t>(map[0], map_ld(c), a.x, img, a.h, a.w, c, th + 2 * k,
                     tw + 2 * k, ty0 - k, tx0 - k, vec, a.in_scale);
  else
    load_map<float>(map[0], map_ld(c), a.x, img, a.h, a.w, c, th + 2 * k,
                    tw + 2 * k, ty0 - k, tx0 - k, vec);
  const int out_kind = (a.flags & kChainOutI8)     ? 2
                       : (a.flags & kChainOutBf16) ? 1
                                                   : 0;
  for (int j = 0; j < k; ++j) {
    const int r = k - j;  // pixel rings around the tile on block j's input
    const ChainBlock& b = a.b[j];
    const Window wd{map[j & 1], tw + 2 * r, map_ld(b.c), 0, 0, ty0 - r,
                    tx0 - r, map[(j + 1) & 1], tw + 2 * r - 2, map_ld(b.p),
                    0, 0, th + 2 * r - 2, tw + 2 * r - 2};
    run_window(b, wd, s, j + 1 < k ? &a.b[j + 1] : nullptr, pipe,
               j == 0 && in_bf16, j == k - 1 ? a.y : nullptr, out_kind, img,
               a.h, a.w, a.out_inv);
  }
}

// Internal linkage: the record of devices whose shared-memory cap is
// raised is this library's own.
void launch_cascade(const ChainArgs& a, dim3 grid, size_t smem,
                    cudaStream_t stream) {
  // Raise the shared-memory cap once per device, not on every launch.
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit) &&
      cudaFuncSetAttribute(cascade_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem) == cudaSuccess)
    raised.fetch_or(bit, std::memory_order_relaxed);
  cascade_kernel<<<grid, kCThreads, smem, stream>>>(a);
}

}  // namespace

extern "C" {

// x (n, h, w, c of block 0) and y (n, h, w, p of the last block),
// contiguous: float32 (kind 0), bfloat16 (1) or int8 (2) as in_kind (x)
// and out_kind (y) say; int8 x is dequantized on load (code * in_scale),
// int8 y requantized at the store (clip(rint(y * out_inv), -127, 127)).  meta: 8 ints a block (c e p act1 act2 act3 residual res_act;
// block j + 1 reads block j's p channels); ptrs: 9 a block (w1 s1 b1 kdw s2
// b2 w2 s3 b3), float32 contiguous in K1's layouts.  (th, tw): output tile,
// whose shared memory (cascade_smem in block_chain.cuh) must fit 232448
// bytes.  Returns cudaErrorInvalidValue for a chain, tile or batch
// (> 65535) it cannot take, else cudaGetLastError().
int ffcnn_cascade(const void* x, void* y, int in_kind, int out_kind, int n,
                  int h, int w, int nb, const int* meta,
                  const void* const* ptrs, int th, int tw, float in_scale,
                  float out_inv, void* stream) {
  ChainArgs a{};
  if (th < 1 || tw < 1 || n > 65535 ||
      !read_chain(a, nb, meta, ptrs, in_kind, out_kind, x))
    return (int)cudaErrorInvalidValue;
  a.in_scale = in_scale;
  a.out_inv = out_inv;
  a.sm = cascade_smem(a, th, tw);
  const size_t smem = a.sm.bytes();
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  a.x = x;
  a.y = y;
  a.h = h;
  a.w = w;
  a.th = th;
  a.tw = tw;
  const dim3 grid(((h + th - 1) / th) * ((w + tw - 1) / tw), n);
  launch_cascade(a, grid, smem, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

const char* ffcnn_cascade_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
