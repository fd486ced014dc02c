// K5: a whole run of stride-1 fused blocks in one launch, NHWC, one CTA per
// image with the image's boundary map resident in shared memory as float32.
//
// Replaces ffcnn_tpu/kernels/block_fused.py::_make_mega_kernel (launched by
// _apply_run_mega), which keeps a 128-image batch chunk's whole map in VMEM
// and chains the blocks in-kernel.  Here a CTA loads its image once into a
// float32 map with a one-pixel zero border ((h+2) x (w+2), the dw zero pad),
// and for each block walks TH x TW output tiles of the map (the whole map
// where it fits) with K1's expand-chunk scheme (block_chain.cuh): the halo is
// read from the resident map, not from device memory, and each pixel is
// expanded once per block plus the tiles' shared edges.  The output goes to
// the second map, and the two swap roles; the last block stores to device
// memory in the input's dtype.
//
// Bound on this card: only the run's input and output touch device memory;
// the kernel is bound by float32 FMAs on the CUDA cores.  One CTA per image
// leaves SMs idle below 132 images (68 of 132 at batch 64); spreading an
// image over a cluster is later work.

#include "block_chain.cuh"

using namespace ffcnn_block;

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mega_kernel(const __grid_constant__ ChainArgs a) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  float* buf[2] = {base, base + a.sm.buf0};
  const Scratch s = scratch_of(base, a.sm);
  const int img = blockIdx.x, bw = a.w + 2, bh = a.h + 2;
  {  // the image, with a one-pixel zero border
    const int c = a.b[0].c, cp = pad4(c);
    const T* x = static_cast<const T*>(a.x) + (size_t)img * a.h * a.w * c;
    for (int i = threadIdx.x; i < bh * bw * cp; i += kThreads) {
      const int q = i / cp, ch = i - q * cp;
      const int gy = q / bw - 1, gx = q % bw - 1;
      float v = 0.f;
      if (ch < c && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w)
        v = to_f32(x[((size_t)gy * a.w + gx) * c + ch]);
      buf[0][i] = v;
    }
  }
  T* y = static_cast<T*>(a.y) + (size_t)img * a.h * a.w * a.b[a.nb - 1].p;
  const int tiles = ((a.h + a.th - 1) / a.th) * a.tiles_w;
  for (int j = 0; j < a.nb; ++j) {
    for (int t = 0; t < tiles; ++t) {
      const int oy = (t / a.tiles_w) * a.th, ox = (t % a.tiles_w) * a.tw;
      const Window wd{buf[j & 1], bw, oy, ox, -1, -1,
                      buf[(j + 1) & 1], bw, oy + 1, ox + 1,
                      min(a.th, a.h - oy), min(a.tw, a.w - ox)};
      run_window<T>(a.b[j], wd, s, j == a.nb - 1 ? y : nullptr, a.h, a.w);
    }
  }
}

template <typename T>
void launch_mega(const ChainArgs& a, int n, size_t smem,
                 cudaStream_t stream) {
  // Raise the shared-memory cap once per device, not on every launch.
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit) &&
      cudaFuncSetAttribute(mega_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem) == cudaSuccess)
    raised.fetch_or(bit, std::memory_order_relaxed);
  mega_kernel<T><<<n, kThreads, smem, stream>>>(a);
}

}  // namespace

extern "C" {

// x (n, h, w, c of block 0) and y (n, h, w, p of the last block): float32
// (bf16 == 0) or bfloat16, both, contiguous.  meta: 8 ints a block (c e p
// act1 act2 act3 residual res_act); ptrs: 9 a block (w1 s1 b1 kdw s2 b2 w2
// s3 b3), float32 contiguous in K1's layouts.  (th, tw): the output tile
// walked over the map; the two maps and its chunks (mega_smem in
// block_chain.cuh) must fit 232448 bytes.  Returns cudaErrorInvalidValue for
// a run, tile or batch it cannot take, else cudaGetLastError().
int ffcnn_mega(const void* x, void* y, int bf16, int n, int h, int w, int nb,
               const int* meta, const void* const* ptrs, int th, int tw,
               void* stream) {
  ChainArgs a{};
  if (th < 1 || tw < 1 || th > h || tw > w ||
      !read_chain(a, nb, meta, ptrs))
    return (int)cudaErrorInvalidValue;
  a.h = h;
  a.w = w;
  a.sm = mega_smem(a, th, tw);
  const size_t smem = a.sm.bytes();
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  a.x = x;
  a.y = y;
  a.th = th;
  a.tw = tw;
  a.tiles_w = (w + tw - 1) / tw;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    launch_mega<__nv_bfloat16>(a, n, smem, s);
  else
    launch_mega<float>(a, n, smem, s);
  return (int)cudaGetLastError();
}

const char* ffcnn_mega_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
