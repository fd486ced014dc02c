// K8: the NHWC inverted-residual block of the block A/B bench, stride S
// (1 or 2), with the TPU kernel's own rounding points (T = x's dtype):
//
//   h1 = round_T( act_mid(x @ w1 * s1 + b1) )          (zero padded)
//   d  = round_T( leaky(dw3x3_S(h1) * sd + bd) )
//   y  = round_T( act_out(d @ w2 * s2 + b2) + res )    (res: optional)
//
// Replaces ffcnn_tpu/kernels/block_pallas.py::_block_kernel (launched by
// fused_mbconv).  The TPU kernel keeps a batch tile's whole block in VMEM:
// expand into a zero-padded scratch of x's dtype, nine shifted FMAs, project.
// Weights stay float32; products and sums are float32.
//
// Bound on this card: at the bench's shapes the block's boundary tensors
// (x, res, y) are few channels wide (4-96) against an expand of 8-448, so
// the unfused chain is bound by moving the expand tensor through device
// memory, and a fused block by its boundary bytes.  The kernel is the
// tensor-core body of block_round_mma.cuh (K1's scheme) under its Mbconv
// policy: both rounding points at T, float32 weights split into TF32 big +
// small (so a bf16 input takes two mma passes a product, float32 three),
// the taps as (3, 3, E), res added after act_out.  This launcher checks,
// plans and picks the instance.

#include "block_round_mma.cuh"

namespace k8 {

using namespace ffcnn_block::rnd;

template <int S, int A1, int A3>
void launch_nj(const Args& a, const Plan& pl, bool bf16, cudaStream_t st) {
  if (pl.need <= kK8Nj[0])
    launch<Mbconv, S, kK8Nj[0], A1, A3>(a, bf16, pl, st);
  else if (pl.need <= kK8Nj[1])
    launch<Mbconv, S, kK8Nj[1], A1, A3>(a, bf16, pl, st);
  else if (pl.need <= kK8Nj[2])
    launch<Mbconv, S, kK8Nj[2], A1, A3>(a, bf16, pl, st);
  else
    launch<Mbconv, S, kK8Nj[3], A1, A3>(a, bf16, pl, st);
}

template <int S>
int run(Args& a, bool bf16, cudaStream_t st) {
  Plan pl;
  const int err = plan<Mbconv, S>(a, pl);
  if (err || pl.empty) return err ? err : (int)cudaGetLastError();
  if (a.act1 == kK8Acts[0] && a.act3 == kK8Acts[1])
    launch_nj<S, kK8Acts[0], kK8Acts[1]>(a, pl, bf16, st);
  else  // the runtime-switch instance
    launch<Mbconv, S, kK8Nj[3], -1, -1>(a, bf16, pl, st);
  return (int)cudaGetLastError();
}

}  // namespace k8

extern "C" {

// x (n, h, w, c), res (n, h/s, w/s, p) or null, y (n, h/s, w/s, p),
// contiguous, bfloat16 where bf16 is 1, else float32.  w1 (c, e), s1/b1 (e),
// wd (3, 3, e), sd/bd (e), w2 (e, p), s2/b2 (p): float32, contiguous.
// act_mid/act_out: 1 leaky, 0 linear.  (th, tw): output tile, th*tw <= 64,
// halo (s*th+3-s)*(s*tw+3-s) <= 104 at stride 1 and <= 160 at stride 2.
// Returns cudaErrorInvalidValue for what the kernel cannot take (a tile, a
// stride, odd sizes at stride 2, a batch > 65535, a channel count beyond
// shared memory), else cudaGetLastError().
int ffcnn_mbconv(const void* x, const void* res, void* y, int bf16,
                 const void* w1, const void* s1, const void* b1,
                 const void* wd, const void* sd, const void* bd,
                 const void* w2, const void* s2, const void* b2, int n, int h,
                 int w, int c, int e, int p, int stride, int act_mid,
                 int act_out, int th, int tw, void* stream) {
  using namespace ffcnn_block::rnd;
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  Args a{x, res, y,
         (const float*)w1, (const float*)s1, (const float*)b1,
         (const float*)wd, (const float*)sd, (const float*)bd,
         (const float*)w2, (const float*)s2, (const float*)b2,
         n, h, w, c, e, p, 0, 0, act_mid ? 2 : 0, act_out ? 2 : 0,
         th, tw, 0, 0};
  cudaStream_t st = (cudaStream_t)stream;
  return stride == 1 ? k8::run<1>(a, bf16 != 0, st)
                     : k8::run<2>(a, bf16 != 0, st);
}

const char* ffcnn_mbconv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
