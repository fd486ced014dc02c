// P4 and P5: the two Pallas probes of the backend-bug sweep, as kernels.
//
//   P4  strided_rows:   y = x[::2, :] on bfloat16 rows,
//                       (R, C) -> (ceil(R/2), C)
//   P5  dynslice_carry: acc = x (2*seg, C) float32; `steps` times
//                       s = min(i, seg);
//                       acc = concat(acc[s:s+seg], acc[s:s+seg])
//
// Replaces the two pallas_calls of tools/retest_backend_bugs.py: the probe
// MOSAIC_STRIDED_16 (`kern`, a strided 16-bit load) and MOSAIC_DYNSLICE_CARRY
// (`kern`, a dynamic slice of a loop-carried value, fori_loop(0, 3)).  On the
// TPU they reproduced compiler faults; here each is a plain copy kernel,
// bit-exact by construction.
//
// Bound on this card: bytes (each input byte read once, each output byte
// written once), and at the probes' shapes (16 x 128) the launch itself.
// Both are index-mapped copies, a thread an element (P5: four columns, one
// 16-byte run, where the rows allow), neighbouring threads on neighbouring
// columns, so a row's loads and stores coalesce.  P5 composes its steps
// into one row map: output row r after step i is row min(i, seg) + r % seg
// of the carry before it, so walking the steps backwards from r gives the
// input row it copies.  Steps past seg all start at seg, and that map is
// idempotent, so they fold into one: at most seg + 1 steps a thread, in
// registers, with no shared memory and no barrier.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace probes {

constexpr int kThreads = 128;

__global__ void strided_rows_kernel(const uint16_t* __restrict__ x,
                                    uint16_t* __restrict__ y, int rows_out,
                                    int cols) {
  const size_t total = (size_t)rows_out * cols;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / cols, c = i - r * cols;
    y[i] = x[2 * r * cols + c];
  }
}

// the input row that output row r of P5 copies
__device__ __forceinline__ int dynslice_src(int r, int seg, int steps) {
  if (steps > seg) r = seg + r % seg;
  for (int i = min(steps, seg) - 1; i >= 0; --i) r = i + r % seg;
  return r;
}

// V columns a thread (V = 4: float4 runs, cols a multiple of 4)
template <int V>
__global__ void dynslice_carry_kernel(const float* __restrict__ x,
                                      float* __restrict__ y, int seg,
                                      int cols, int steps) {
  using Vec = std::conditional_t<V == 4, float4, float>;
  const int vcols = cols / V;
  const size_t total = (size_t)2 * seg * vcols;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(i / vcols), c = (int)(i - (size_t)r * vcols);
    const int src = dynslice_src(r, seg, steps);
    reinterpret_cast<Vec*>(y)[i] =
        reinterpret_cast<const Vec*>(x)[(size_t)src * vcols + c];
  }
}

}  // namespace probes

extern "C" {

// x (rows, cols) and y (ceil(rows/2), cols) bfloat16, contiguous.
int ffcnn_strided_rows(const void* x, void* y, int rows, int cols,
                       void* stream) {
  using namespace probes;
  if (rows < 0 || cols < 0) return (int)cudaErrorInvalidValue;
  const int rows_out = (rows + 1) / 2;
  const size_t total = (size_t)rows_out * cols;
  if (total == 0) return (int)cudaGetLastError();
  const size_t want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 4096 ? want : 4096);  // a grid-stride loop
  strided_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint16_t*>(x), static_cast<uint16_t*>(y), rows_out,
      cols);
  return (int)cudaGetLastError();
}

// x and y (2*seg, cols) float32, contiguous; seg >= 1, 2*seg rows within
// an int.
int ffcnn_dynslice_carry(const void* x, void* y, int seg, int cols,
                         int steps, void* stream) {
  using namespace probes;
  if (seg < 1 || seg > (1 << 30) - 1 || cols < 0 || steps < 0)
    return (int)cudaErrorInvalidValue;
  if (cols == 0) return (int)cudaGetLastError();
  const bool v4 = cols % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)y % 16 == 0;
  const size_t total = (size_t)2 * seg * (v4 ? cols / 4 : cols);
  const size_t want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 4096 ? want : 4096);  // a grid-stride loop
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  if (v4)
    dynslice_carry_kernel<4><<<blocks, kThreads, 0, s>>>(xf, yf, seg, cols,
                                                         steps);
  else
    dynslice_carry_kernel<1><<<blocks, kThreads, 0, s>>>(xf, yf, seg, cols,
                                                         steps);
  return (int)cudaGetLastError();
}

const char* ffcnn_probes_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
