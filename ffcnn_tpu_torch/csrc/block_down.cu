// K3: the fused stride-2 (stage-transition) block, NHWC: pw expand -> act
// -> zero pad -> dw3x3 stride 2 -> act -> pw project -> act, no residual.
// The kernel is the tensor-core template in block_mma.cuh, at S = 2.
//
// Replaces ffcnn_tpu/kernels/block_fused.py::_make_down_kernel (launched
// once per stride-2 block by _cs_down_block).  The TPU kernel splits each
// expand row into even and odd column halves to reach the stride-2 taps
// with lane-aligned slices; here each output pixel indexes its taps in the
// shared-memory halo directly (input rows and columns 2r-1, 2r, 2r+1), so
// no split is needed.  A TH x TW output tile expands a (2TH+1) x (2TW+1)
// halo, in two passes of the stride-1 kernel's register budget.

#include "block_mma.cuh"

extern "C" {

// x (n, h, w, c), h and w even, and y (n, h/2, w/2, p), contiguous:
// float32, bfloat16 or int8 by in_kind and out_kind, with in_scale and
// out_inv, as for ffcnn_block_s1.  Weights
// as for ffcnn_block_s1.  (th, tw): output tile, th*tw <= 64 and
// (2th+1)*(2tw+1) <= 160.  Returns cudaErrorInvalidValue for a tile, an odd
// size, a batch (> 65535) or a channel count (shared memory) it cannot
// take, else cudaGetLastError().
int ffcnn_block_s2(const void* x, void* y, int in_kind, int out_kind,
                   const void* w1, const void* s1, const void* b1,
                   const void* kdw, const void* s2, const void* b2,
                   const void* w2, const void* s3, const void* b3, int n,
                   int h, int w, int c, int e, int p, int act1, int act2,
                   int act3, int th, int tw, float in_scale,
                   float out_inv, void* stream) {
  return ffcnn_block::run_block<2>(x, y, in_kind, out_kind, w1, s1, b1, kdw,
                                   s2, b2, w2, s3, b3, n, h, w, c, e, p, act1,
                                   act2, act3, 0, 0, th, tw, stream,
                                   in_scale, out_inv);
}

const char* ffcnn_down_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
