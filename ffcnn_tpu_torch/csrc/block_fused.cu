// K1: the fused stride-1 inverted-residual block, NHWC (the kernel is the
// tensor-core template in block_mma.cuh, at S = 1).
//
// Replaces ffcnn_tpu/kernels/block_fused.py::_make_kernel (launched once per
// block by _cs_block).

#include "block_mma.cuh"

extern "C" {

// x (n, h, w, c) and y (n, h, w, p), contiguous: float32 (kind 0),
// bfloat16 (1) or int8 (2) as in_kind (x) and out_kind (y) say; int8 x is
// dequantized on load (code * in_scale), int8 y requantized at the store
// (clip(rint(y * out_inv), -127, 127)).  w1 (c, e), s1/b1 (e), kdw
// (e, 9), s2/b2 (e), w2 (e, p), s3/b3 (p): float32, contiguous.  (th, tw):
// output tile, th*tw <= 64 and (th+2)*(tw+2) <= 104.  Returns
// cudaErrorInvalidValue for a tile, a batch (> 65535) or a channel count
// (shared memory) it cannot take, else cudaGetLastError().
int ffcnn_block_s1(const void* x, void* y, int in_kind, int out_kind,
                   const void* w1, const void* s1, const void* b1,
                   const void* kdw, const void* s2, const void* b2,
                   const void* w2, const void* s3, const void* b3, int n,
                   int h, int w, int c, int e, int p, int act1, int act2,
                   int act3, int residual, int res_act, int th, int tw,
                   float in_scale, float out_inv, void* stream) {
  return ffcnn_block::run_block<1>(x, y, in_kind, out_kind, w1, s1, b1, kdw,
                                   s2, b2, w2, s3, b3, n, h, w, c, e, p, act1,
                                   act2, act3, residual, res_act, th, tw,
                                   stream, in_scale, out_inv);
}

const char* ffcnn_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
