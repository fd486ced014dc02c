// K5: a whole run of stride-1 fused blocks in one launch, NHWC, a cluster
// of CS CTAs per image (CS = 1 or 2), each holding its share of the image's
// boundary map resident in shared memory as float32.
//
// Replaces ffcnn_tpu/kernels/block_fused.py::_make_mega_kernel (launched by
// _apply_run_mega), which keeps a 128-image batch chunk's whole map in VMEM
// and chains the blocks in-kernel.  Here CTA r of an image's cluster owns
// image rows [r * rows, (r + 1) * rows) and keeps them in a float32 map
// with one halo row above and below and a one-pixel zero border at the
// sides ((rows + 2) x (w + 2) pixels, the dw zero pad), loaded once from
// device memory with its halo rows.  For each block it walks TH x TW output
// tiles of its rows (all of them where they fit) with the chunk scheme of
// block_chain.cuh, both pointwise products on the tensor cores; the output
// goes to the second map, and the two swap roles.  Between two blocks the
// cluster synchronises and each CTA reads its neighbours' boundary rows of
// the new map through distributed shared memory into its halo rows.  The
// last block stores to device memory in the input's dtype.
//
// Bound on this card: only the run's input and output touch device memory.
// One CTA per image left 68 of the 132 SMs idle at batch 64; a cluster of
// two gives 128 CTAs there, each with half the map to hold and to compute,
// for one cluster barrier and two boundary rows a block.

// 384 threads a CTA: K5's one or two windows a block leave the warps of a
// 512-thread CTA too little work each; 384 ran it about 5% faster, where
// K4's many windows keep 512 (bench_chain.py).
#ifndef FFCNN_CHAIN_THREADS
#define FFCNN_CHAIN_THREADS 384
#endif
#include "block_chain.cuh"

using namespace ffcnn_block;
namespace cg = cooperative_groups;

namespace {

template <typename T, int CS>
__global__ void __launch_bounds__(kCThreads, 1)
    mega_kernel(const __grid_constant__ ChainArgs a) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  float* map[2] = {base, base + a.sm.map0};
  const Scratch s = scratch_of(base, a.sm);
  int rank = 0;
  if constexpr (CS > 1) rank = (int)cg::this_cluster().block_rank();
  const int img = blockIdx.x / CS, bw = a.w + 2;
  const int row0 = rank * a.rows, rows = min(a.rows, a.h - row0);
  const bool bf16 = a.flags & kChainInBf16;
  Pipe pipe{0, (a.flags & kChainVecW) != 0};
  stage_chunk(a.b[0], 0, s.bufs, pipe.vec);
  // the CTA's rows with a halo row above and below, zero outside the image
  const int c = a.b[0].c;
  load_map<T>(map[0], map_ld(c), a.x, img, a.h, a.w, c, rows + 2, bw,
              row0 - 1, -1, (a.flags & kChainVecX) != 0);
  const int tiles_w = (a.w + a.tw - 1) / a.tw;
  const int tiles = ((rows + a.th - 1) / a.th) * tiles_w;
  for (int j = 0; j < a.nb; ++j) {
    const ChainBlock& b = a.b[j];
    for (int t = 0; t < tiles; ++t) {
      const int oy = (t / tiles_w) * a.th, ox = (t % tiles_w) * a.tw;
      const Window wd{map[j & 1], bw, map_ld(b.c), oy, ox, row0 - 1, -1,
                      map[(j + 1) & 1], bw, map_ld(b.p), oy + 1, ox + 1,
                      min(a.th, rows - oy), min(a.tw, a.w - ox)};
      const ChainBlock* next =
          t + 1 < tiles ? &b : j + 1 < a.nb ? &a.b[j + 1] : nullptr;
      run_window(b, wd, s, next, pipe, j == 0 && bf16,
                 j == a.nb - 1 ? a.y : nullptr, bf16, img, a.h, a.w);
    }
    if constexpr (CS > 1) {
      if (j + 1 < a.nb) {
        // block j's output is complete in every CTA of the cluster: copy
        // the neighbours' boundary rows into this CTA's halo rows
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();
        float* out = map[(j + 1) & 1];
        const int n4 = bw * map_ld(b.p) / 4;  // float4s a map row
        float4* top = reinterpret_cast<float4*>(out);
        float4* bottom = reinterpret_cast<float4*>(out) + (rows + 1) * n4;
        const float4* above =
            rank > 0 ? cluster.map_shared_rank(top, rank - 1) + a.rows * n4
                     : nullptr;
        const float4* below =
            rank + 1 < CS ? cluster.map_shared_rank(top, rank + 1) + n4
                          : nullptr;
        for (int i = threadIdx.x; i < n4; i += kCThreads) {
          if (above) top[i] = above[i];
          if (below) bottom[i] = below[i];
        }
      }
    }
  }
  // no CTA leaves while a neighbour may still read its shared memory
  if constexpr (CS > 1) cg::this_cluster().sync();
}

// Internal linkage: the record of devices whose shared-memory cap is
// raised is this library's own.
template <typename T, int CS>
cudaError_t launch_mega(const ChainArgs& a, int n, size_t smem,
                        cudaStream_t stream) {
  // Raise the shared-memory cap once per device, not on every launch.
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit) &&
      cudaFuncSetAttribute(mega_kernel<T, CS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem) == cudaSuccess)
    raised.fetch_or(bit, std::memory_order_relaxed);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * CS);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, mega_kernel<T, CS>, a);
}

}  // namespace

extern "C" {

// x (n, h, w, c of block 0) and y (n, h, w, p of the last block): float32
// (bf16 == 0) or bfloat16, both, contiguous.  meta: 8 ints a block (c e p
// act1 act2 act3 residual res_act); ptrs: 9 a block (w1 s1 b1 kdw s2 b2 w2
// s3 b3), float32 contiguous in K1's layouts.  cluster: CTAs an image (1
// or 2, at most h), each owning ceil(h / cluster) rows; (th, tw): the
// output tile walked over a CTA's rows; the two maps and one tile's
// buffers (mega_smem in block_chain.cuh) must fit 232448 bytes.  Returns
// cudaErrorInvalidValue for a run, tile, cluster or batch it cannot take,
// else the launch's error.
int ffcnn_mega(const void* x, void* y, int bf16, int n, int h, int w, int nb,
               const int* meta, const void* const* ptrs, int th, int tw,
               int cluster, void* stream) {
  ChainArgs a{};
  if (cluster < 1 || cluster > 2 || h < cluster || th < 1 || tw < 1 ||
      tw > w || !read_chain(a, nb, meta, ptrs, bf16, bf16, x))
    return (int)cudaErrorInvalidValue;
  a.h = h;
  a.w = w;
  a.rows = (h + cluster - 1) / cluster;
  if (th > a.rows) return (int)cudaErrorInvalidValue;
  a.sm = mega_smem(a, a.rows, th, tw);
  const size_t smem = a.sm.bytes();
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  a.x = x;
  a.y = y;
  a.th = th;
  a.tw = tw;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (bf16)
    err = cluster == 2 ? launch_mega<__nv_bfloat16, 2>(a, n, smem, s)
                       : launch_mega<__nv_bfloat16, 1>(a, n, smem, s);
  else
    err = cluster == 2 ? launch_mega<float, 2>(a, n, smem, s)
                       : launch_mega<float, 1>(a, n, smem, s);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

const char* ffcnn_mega_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
