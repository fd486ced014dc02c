// K9: the channels-first inverted-residual block of the block A/B bench,
// stride 1, on (C, S) tensors with S = N*H*W, with the TPU kernel's own
// rounding points (T = x's dtype):
//
//   mid = act_mid(w1 @ x * s1 + b1)                  (float32, zero padded)
//   d   = round_T( act_dw(dw3x3(mid) * sd + bd) )
//   y   = round_T( act_out(w2 @ d * s2 + b2) + res )  (res: optional)
//
// w1 and w2 come in T (the wrapper rounds them, as the JAX wrapper does);
// the taps, scales and biases are float32.
//
// Replaces ffcnn_tpu/kernels/csblock_pallas.py::_cs_kernel (launched by
// fused_mbconv_cs).  The TPU kernel puts S on the 128-wide lanes and reaches
// a depthwise tap by a lane roll of the whole f32 mid tensor by dy*W+dx,
// with iota row and column masks for the image edges.  Here no roll is
// needed: a tap is an offset into the tile's halo in shared memory, and
// the edge masks are the zeroed halo pixels outside the image.
//
// Bound on this card: as K8 (mbconv.cu), the expand tensor (8-448 channels)
// is what the unfused chain moves through device memory; the fused block
// moves only its boundary tensors, and at the bench's shapes its bytes
// bound it.  The kernel is the tensor-core body of block_round_mma.cuh
// (K1's scheme, K8's body) under its MbconvCs policy: mid kept float32, d
// rounded to T, the channels-first layout (the halo read pixel-fastest,
// the output tile stored through a channel-major copy in shared memory,
// the weights staged as their (E, C) and (P, E) rows), res added after
// act_out.  Both products run on mma.sync: in bf16 storage every operand
// is a bf16 value, so each is one m16n8k16 bf16 pass (exact products,
// float32 sums); in float32 storage 3xTF32.  This launcher checks, plans
// and picks the instance.

#include "block_round_mma.cuh"

namespace k9 {

using namespace ffcnn_block::rnd;

template <class P>
void launch_nj(const Args& a, const Plan& pl, bool bf16, cudaStream_t st) {
  constexpr int A1 = kK9Acts[0], A3 = kK9Acts[2];
  if (pl.need <= kK9Nj[0])
    launch<P, 1, kK9Nj[0], A1, A3>(a, bf16, pl, st);
  else if (pl.need <= kK9Nj[1])
    launch<P, 1, kK9Nj[1], A1, A3>(a, bf16, pl, st);
  else if (pl.need <= kK9Nj[2])
    launch<P, 1, kK9Nj[2], A1, A3>(a, bf16, pl, st);
  else
    launch<P, 1, kK9Nj[3], A1, A3>(a, bf16, pl, st);
}

template <class P>
int run(Args& a, bool bf16, cudaStream_t st) {
  Plan pl;
  const int err = plan<P, 1>(a, pl);
  if (err || pl.empty) return err ? err : (int)cudaGetLastError();
  if (a.act1 == kK9Acts[0] && a.act2 == kK9Acts[1] &&
      a.act3 == kK9Acts[2] && pl.need <= kK9Nj[3])
    launch_nj<P>(a, pl, bf16, st);
  else  // the runtime-switch instance
    launch<P, 1, kNjMax, -1, -1>(a, bf16, pl, st);
  return (int)cudaGetLastError();
}

}  // namespace k9

extern "C" {

// x (c, n*h*w), res (p, n*h*w) or null, y (p, n*h*w), w1 (e, c), w2 (p, e),
// contiguous, bfloat16 where bf16 is 1, else float32.  s1/b1 (e), wd
// (3, 3, e), sd/bd (e), s2/b2 (p): float32, contiguous.  act_*: activation
// ids (block_fused.cuh's act; the wrapper passes 2 leaky or 0 linear), the
// bench's {2, 2, 0} compiled in.  (th, tw): output tile, th*tw <= 64
// and (th+2)*(tw+2) <= 104.  Returns cudaErrorInvalidValue for what the
// kernel cannot take (a tile, a batch > 65535, no input or expand channel,
// a channel count beyond shared memory), else cudaGetLastError().
int ffcnn_mbconv_cs(const void* x, const void* res, void* y, int bf16,
                    const void* w1, const void* s1, const void* b1,
                    const void* wd, const void* sd, const void* bd,
                    const void* w2, const void* s2, const void* b2, int n,
                    int h, int w, int c, int e, int p, int act_mid,
                    int act_dw, int act_out, int th, int tw, void* stream) {
  using namespace ffcnn_block::rnd;
  Args a{x, res, y,
         (const float*)w1, (const float*)s1, (const float*)b1,
         (const float*)wd, (const float*)sd, (const float*)bd,
         (const float*)w2, (const float*)s2, (const float*)b2,
         n, h, w, c, e, p, 0, 0, act_mid, act_out, th, tw, 0, 0, act_dw};
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? k9::run<MbconvCs<true>>(a, true, st)
              : k9::run<MbconvCs<false>>(a, false, st);
}

const char* ffcnn_mbconv_cs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
