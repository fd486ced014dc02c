// Greedy NMS keep mask, one CTA per image, resolved 32 anchors at a time.
//
// Replaces ffcnn_tpu/kernels/nms_pallas.py::_nms_kernel (launched by
// nms_keep_mask).  Per image, over candidates sorted by descending score:
//
//   keep[j] = score[j] > 0  and  no i < j with keep[i], class[i] == class[j]
//             and iou(i, j) > thr
//
// iou is inter / min(a_i, a_j) ("min", the reference's quirk, ffcnn.c:316)
// or inter / (a_i + a_j - inter) ("union"); inter is 0 unless x1<x2 and
// y1<y2; 0/0 is NaN and NaN suppresses nothing.
//
// Bound on this card: latency.  An image moves 28 bytes a candidate (42 KB
// at K = 1,500) and its IoU tests take microseconds of the card's float32
// rate, but the recurrence is serial in i: a step an anchor, each ending in
// a barrier, is up to K - 1 barriers.  The design resolves it a block of 32
// anchors at a time, with 1 + 2 * ceil(K / 32) barriers:
//
// * The block's own masks: bit u of mask[r] says anchor r of the block
//   suppresses anchor u > r of it, were r kept.  They depend on the boxes
//   only, so each warp computes a row of the next block's (one ballot)
//   while the current block suppresses the rest, into a second buffer.
// * Resolve on one warp: the block's anchors still alive (a ballot of the
//   keep flags), then 32 steps of `if (alive has r) alive &= ~mask[r]` on a
//   register bitset, the masks passed by shuffles, with no barrier; the
//   kept anchors are listed in shared memory.
// * Suppress the rest in parallel: the later candidates still kept are
//   tested against the listed anchors only, p lanes a candidate (each
//   taking every p-th anchor, the verdicts OR-ed by shuffles) where fewer
//   candidates than threads are left.
// * A CTA of 1,024 threads, and the candidates (boxes, areas, classes)
//   staged in shared memory up to K = 8,192 (25 bytes a candidate); beyond
//   that they are read from device memory, with only the keep flags (K
//   bytes) in shared memory.  No device-memory scratch.
//
// The mask must equal the plain PyTorch version bit for bit, so this file
// is compiled with -fmad=false (no FMA contraction moves an IoU across the
// threshold) and without --use_fast_math (IEEE division), and `overlaps`
// computes the plain version's comparison: it only skips work whose result
// is known (a NaN area, an intersection of 0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 32;        // anchors resolved at a time: a warp's lanes
constexpr int kMaxStaged = 8192;  // candidates staged in shared memory
constexpr int kThreads = 1024;

__device__ __forceinline__ float area(float4 a) {
  return (a.z - a.x) * (a.w - a.y);
}

// iou(a, b) > thr, a the earlier candidate, as torch computes it
// (kernels/nms.py::_iou): torch.maximum/minimum propagate NaN.
// * A NaN area (a NaN coordinate, or inf - inf) makes the IoU NaN
//   whatever the rest: false.  Otherwise no coordinate is NaN, and
//   fmaxf/fminf give torch.maximum/minimum's values.
// * An intersection of 0 gives 0 / den: +-0 where den is not 0 or NaN,
//   else NaN; so the compare needs no division.
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                         float area_b, float thr,
                                         int union_iou) {
  if (area_a != area_a || area_b != area_b) return false;
  const float x1 = fmaxf(a.x, b.x), y1 = fmaxf(a.y, b.y);
  const float x2 = fminf(a.z, b.z), y2 = fminf(a.w, b.w);
  const float inter = (x1 < x2 && y1 < y2) ? (x2 - x1) * (y2 - y1) : 0.f;
  const float den = union_iou ? (area_a + area_b) - inter
                              : fminf(area_a, area_b);
  if (inter == 0.f) return thr < 0.f && den == den && den != 0.f;
  return inter / den > thr;
}

// An image's candidates: staged in shared memory (S), else read from
// device memory.
template <bool S>
struct Cands {
  const float4* bx;   // device memory
  const int* cl;
  float4* sb;         // shared memory (S)
  float* sa;
  int* sc;
  __device__ __forceinline__ float4 box(int j) const {
    return S ? sb[j] : bx[j];
  }
  __device__ __forceinline__ float ar(int j) const {
    return S ? sa[j] : area(bx[j]);
  }
  __device__ __forceinline__ int cls(int j) const {
    return S ? sc[j] : cl[j];
  }
};

// masks[r] for the block of anchors b0 .. b0 + cnt - 1, rows by warps (a
// ballot a row); rows of anchors with score <= 0 (never kept) stay 0.
template <bool S>
__device__ __forceinline__ void block_masks(const Cands<S>& c,
                                            const float* __restrict__ score,
                                            int b0, int cnt, float thr,
                                            int union_iou, uint32_t* masks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool in = lane < cnt;
  const int u = b0 + (in ? lane : 0);
  const float4 b = c.box(u);
  const float ab = c.ar(u);
  const int cb = c.cls(u);
#pragma unroll
  for (int r = warp; r < kBlock; r += kThreads / 32) {
    const int ra = b0 + min(r, cnt - 1);
    const bool row = r < cnt && score[ra] > 0.f;  // the same in every lane
    const uint32_t m = __ballot_sync(
        0xffffffffu, row && in && lane > r && c.cls(ra) == cb &&
                         overlaps(c.box(ra), c.ar(ra), b, ab, thr, union_iou));
    if (lane == 0) masks[r] = m;
  }
}

template <bool S>
__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ scores,
                const int* __restrict__ classes,
                uint8_t* __restrict__ keep_out, int k, float thr,
                int union_iou) {
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ uint32_t masks[2][kBlock];
  __shared__ float4 kbox[kBlock];   // the block's kept anchors
  __shared__ float karea[kBlock];
  __shared__ int kcls[kBlock];
  __shared__ int nkept;
  const size_t base = (size_t)blockIdx.x * k;
  const float* sc = scores + base;
  const Cands<false> cg{boxes + base, classes + base, nullptr, nullptr,
                        nullptr};
  const Cands<S> c{cg.bx, cg.cl, reinterpret_cast<float4*>(dyn),
                   reinterpret_cast<float*>(dyn + 16 * (size_t)k),
                   reinterpret_cast<int*>(dyn + 20 * (size_t)k)};
  uint8_t* keep = dyn + (S ? 24 * (size_t)k : 0);
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    keep[j] = sc[j] > 0.f;
    if constexpr (S) {
      const float4 b = cg.bx[j];
      c.sb[j] = b;
      c.sa[j] = area(b);
      c.sc[j] = cg.cl[j];
    }
  }
  // block 0's masks from device memory: no barrier before them
  block_masks<false>(cg, sc, 0, min(kBlock, k), thr, union_iou, masks[0]);
  __syncthreads();

  for (int b0 = 0, buf = 0; b0 < k; b0 += kBlock, buf ^= 1) {
    const int cnt = min(kBlock, k - b0);
    // 1. resolve the block on warp 0 (its anchors are final once every
    //    earlier block has suppressed), and list its kept anchors
    if (threadIdx.x < 32) {
      const bool in = lane < cnt;
      uint32_t alive = __ballot_sync(0xffffffffu, in && keep[b0 + lane]);
      const uint32_t m = masks[buf][lane];
#pragma unroll
      for (int r = 0; r < kBlock; ++r) {
        const uint32_t mr = __shfl_sync(0xffffffffu, m, r);
        if ((alive >> r) & 1u) alive &= ~mr;
      }
      if (in) keep[b0 + lane] = (alive >> lane) & 1u;
      if ((alive >> lane) & 1u) {
        const int at = __popc(alive & ((1u << lane) - 1u));
        kbox[at] = c.box(b0 + lane);
        karea[at] = c.ar(b0 + lane);
        kcls[at] = c.cls(b0 + lane);
      }
      if (lane == 0) nkept = __popc(alive);
    }
    __syncthreads();
    // 2. the kept anchors suppress every later candidate still kept;
    //    meanwhile the next block's masks
    const int nk = nkept;
    const int later = k - b0 - kBlock;
    if (nk && later > 0) {
      // p lanes a candidate (a power of two, at most a warp)
      int p = 1;
      while (p < 32 && 2 * p * later <= kThreads) p *= 2;
      const int part = threadIdx.x & (p - 1);
      for (int jb = b0 + kBlock; jb < k; jb += kThreads / p) {
        const int j = jb + threadIdx.x / p;
        bool sup = false;
        if (j < k && keep[j]) {
          const float4 b = c.box(j);
          const float ab = c.ar(j);
          const int cb = c.cls(j);
          for (int q = part; q < nk && !sup; q += 4 * p) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int qq = min(q + u * p, nk - 1);
              sup |= (q + u * p < nk) & (kcls[qq] == cb) &
                     overlaps(kbox[qq], karea[qq], b, ab, thr, union_iou);
            }
          }
        }
        for (int o = 1; o < p; o *= 2)
          sup |= __shfl_xor_sync(0xffffffffu, sup, o);
        if (sup && part == 0) keep[j] = 0;
      }
    }
    if (later > 0)
      block_masks<S>(c, sc, b0 + kBlock, min(kBlock, later), thr, union_iou,
                     masks[buf ^ 1]);
    __syncthreads();
  }
  for (int j = threadIdx.x; j < k; j += kThreads)
    keep_out[base + j] = keep[j];
}

template <bool S>
int launch(const void* boxes, const void* scores, const void* classes,
           void* keep, int n, int k, float thr, int union_iou,
           cudaStream_t st) {
  const size_t smem = (size_t)k * (S ? 25 : 1);
  if (smem > 40 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_keep_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_keep_kernel<S><<<n, kThreads, smem, st>>>(
      (const float4*)boxes, (const float*)scores, (const int*)classes,
      (uint8_t*)keep, k, thr, union_iou);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// boxes (n, k, 4) f32, scores (n, k) f32, classes (n, k) i32, all contiguous
// on the device; keep (n, k) uint8.  Returns cudaGetLastError().
int ffcnn_nms_keep(const void* boxes, const void* scores, const void* classes,
                   void* keep, int n, int k, float thr, int union_iou,
                   void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= kMaxStaged)
    return launch<true>(boxes, scores, classes, keep, n, k, thr, union_iou,
                        st);
  return launch<false>(boxes, scores, classes, keep, n, k, thr, union_iou, st);
}

const char* ffcnn_nms_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
