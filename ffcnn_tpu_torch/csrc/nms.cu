// Greedy NMS keep mask, one CTA per image.
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
// Bound on this card: the greedy recurrence is serial in i, so the kernel
// is latency bound (K steps of one __syncthreads each), not bandwidth or
// FLOP bound: at K = 1,500 an image moves 30 KB.  The design keeps every
// step on chip: the keep flags live in shared memory (K bytes, so any K up
// to the model's candidate count fits; no K x K matrix is built), the boxes
// are read through L1, a step whose anchor is already suppressed is skipped
// by every thread alike with no barrier, and one launch covers the batch.
//
// The mask must equal the plain PyTorch version bit for bit, so this file
// is compiled with -fmad=false (no FMA contraction moves an IoU across the
// threshold) and without --use_fast_math (IEEE division).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// torch.maximum / torch.minimum propagate NaN; fmaxf/fminf do not.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ scores,
                const int* __restrict__ classes,
                uint8_t* __restrict__ keep_out, int k, float thr,
                int union_iou) {
  extern __shared__ uint8_t keep[];
  const size_t base = (size_t)blockIdx.x * k;
  const float4* bx = boxes + base;
  const int* cl = classes + base;
  for (int j = threadIdx.x; j < k; j += kThreads)
    keep[j] = scores[base + j] > 0.f;
  __syncthreads();
  for (int i = 0; i < k - 1; ++i) {
    if (!keep[i]) continue;  // final since step i-1; same value in all threads
    const float4 a = bx[i];
    const int ca = cl[i];
    const float area_a = (a.z - a.x) * (a.w - a.y);
    for (int j = i + 1 + threadIdx.x; j < k; j += kThreads) {
      if (!keep[j] || cl[j] != ca) continue;
      const float4 b = bx[j];
      const float x1 = max_nan(a.x, b.x), y1 = max_nan(a.y, b.y);
      const float x2 = min_nan(a.z, b.z), y2 = min_nan(a.w, b.w);
      const float inter = (x1 < x2 && y1 < y2) ? (x2 - x1) * (y2 - y1) : 0.f;
      const float area_b = (b.z - b.x) * (b.w - b.y);
      const float iou = union_iou ? inter / ((area_a + area_b) - inter)
                                  : inter / min_nan(area_a, area_b);
      if (iou > thr) keep[j] = 0;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < k; j += kThreads)
    keep_out[base + j] = keep[j];
}

}  // namespace

extern "C" {

// boxes (n, k, 4) f32, scores (n, k) f32, classes (n, k) i32, all contiguous
// on the device; keep (n, k) uint8.  Returns cudaGetLastError().
int ffcnn_nms_keep(const void* boxes, const void* scores, const void* classes,
                   void* keep, int n, int k, float thr, int union_iou,
                   void* stream) {
  if (n > 0 && k > 0) {
    size_t smem = (size_t)k;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(nms_keep_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    nms_keep_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
        (const float4*)boxes, (const float*)scores, (const int*)classes,
        (uint8_t*)keep, k, thr, union_iou);
  }
  return (int)cudaGetLastError();
}

const char* ffcnn_nms_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
