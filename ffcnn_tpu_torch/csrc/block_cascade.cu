// K4: the halo cascade, a group of consecutive stride-1 fused blocks in one
// launch, NHWC; every boundary inside the group stays on chip in float32.
//
// Replaces ffcnn_tpu/kernels/block_fused.py::_make_cascade_kernel (launched
// by _cs_cascade).  The TPU kernel takes R output rows plus K halo rows on
// each side and shrinks the valid span by two rows a block; here a CTA owns
// a TH x TW output tile of one image, loads the (TH+2K) x (TW+2K) input halo
// once into shared memory as float32, and applies the K blocks in turn, each
// to the map one pixel ring smaller than its input (block_chain.cuh).  The
// tiles are two-dimensional, so the expand zeroing applies at all four edges
// of the image.  A tile at the map's right or bottom edge is cut to the map.
//
// Bound on this card: the per-block launches (K1) write each boundary to
// device memory and read it back with a halo; here it never leaves the CTA,
// but the K halo rings are recomputed, (TH+2K)(TW+2K)/(TH*TW) of the first
// block's expand, and the two float32 maps take most of the shared memory,
// so a CTA has an SM to itself.  The kernel is bound by float32 FMAs on the
// CUDA cores, as K1 is; the wrapper's tile search (kernels/block_fused.py
// pick_cascade_tile) trades the halo recompute against the shared memory.

#include "block_chain.cuh"

using namespace ffcnn_block;

namespace {

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
    cascade_kernel(const __grid_constant__ ChainArgs a) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  float* buf[2] = {base, base + a.sm.buf0};
  const Scratch s = scratch_of(base, a.sm);
  const int k = a.nb, img = blockIdx.y;
  const int ty0 = (blockIdx.x / a.tiles_w) * a.th;
  const int tx0 = (blockIdx.x % a.tiles_w) * a.tw;
  const int th = min(a.th, a.h - ty0), tw = min(a.tw, a.w - tx0);
  {  // the input halo, k pixel rings around the tile
    const int c = a.b[0].c, cp = pad4(c), hw = tw + 2 * k;
    const int nq = (th + 2 * k) * hw;
    const Tin* x = static_cast<const Tin*>(a.x) + (size_t)img * a.h * a.w * c;
    for (int i = threadIdx.x; i < nq * cp; i += kThreads) {
      const int q = i / cp, ch = i - q * cp;
      const int gy = ty0 - k + q / hw, gx = tx0 - k + q % hw;
      float v = 0.f;
      if (ch < c && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w)
        v = to_f32(x[((size_t)gy * a.w + gx) * c + ch]);
      buf[0][i] = v;
    }
  }
  Tout* y = static_cast<Tout*>(a.y) + (size_t)img * a.h * a.w * a.b[k - 1].p;
  for (int j = 0; j < k; ++j) {
    const int r = k - j;  // pixel rings around the tile on block j's input
    const Window wd{buf[j & 1], tw + 2 * r, 0, 0, ty0 - r, tx0 - r,
                    buf[(j + 1) & 1], tw + 2 * r - 2, 0, 0,
                    th + 2 * r - 2, tw + 2 * r - 2};
    run_window<Tout>(a.b[j], wd, s, j == k - 1 ? y : nullptr, a.h, a.w);
  }
}

template <typename Tin, typename Tout>
void launch_cascade(const ChainArgs& a, dim3 grid, size_t smem,
                    cudaStream_t stream) {
  // Raise the shared-memory cap once per device, not on every launch.
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit) &&
      cudaFuncSetAttribute(cascade_kernel<Tin, Tout>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem) == cudaSuccess)
    raised.fetch_or(bit, std::memory_order_relaxed);
  cascade_kernel<Tin, Tout><<<grid, kThreads, smem, stream>>>(a);
}

}  // namespace

extern "C" {

// x (n, h, w, c of block 0) and y (n, h, w, p of the last block),
// contiguous: bfloat16 where in_bf16 (x) or out_bf16 (y) is 1, else
// float32.  meta: 8 ints a block (c e p act1 act2 act3 residual res_act;
// block j + 1 reads block j's p channels); ptrs: 9 a block (w1 s1 b1 kdw s2
// b2 w2 s3 b3), float32 contiguous in K1's layouts.  (th, tw): output tile,
// whose shared memory (cascade_smem in block_chain.cuh) must fit 232448
// bytes.  Returns cudaErrorInvalidValue for a chain, tile or batch
// (> 65535) it cannot take, else cudaGetLastError().
int ffcnn_cascade(const void* x, void* y, int in_bf16, int out_bf16, int n,
                  int h, int w, int nb, const int* meta,
                  const void* const* ptrs, int th, int tw, void* stream) {
  ChainArgs a{};
  if (th < 1 || tw < 1 || n > 65535 || !read_chain(a, nb, meta, ptrs))
    return (int)cudaErrorInvalidValue;
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
  a.tiles_w = (w + tw - 1) / tw;
  const dim3 grid(((h + th - 1) / th) * a.tiles_w, n);
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16 && out_bf16)
    launch_cascade<__nv_bfloat16, __nv_bfloat16>(a, grid, smem, s);
  else if (in_bf16)
    launch_cascade<__nv_bfloat16, float>(a, grid, smem, s);
  else if (out_bf16)
    launch_cascade<float, __nv_bfloat16>(a, grid, smem, s);
  else
    launch_cascade<float, float>(a, grid, smem, s);
  return (int)cudaGetLastError();
}

const char* ffcnn_cascade_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
