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
// P4 moves 16-bit values one a thread, neighbouring threads on
// neighbouring columns, so a row's loads and stores coalesce.  P5 keeps
// each column's carry in shared memory (one thread a column) and moves it
// in place: the first half takes acc[s:s+seg] (reading ahead of what it
// writes, s >= 0), then the second half copies the first.

#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void dynslice_carry_kernel(const float* __restrict__ x,
                                      float* __restrict__ y, int seg,
                                      int cols, int steps) {
  extern __shared__ float buf[];  // [2*seg][kThreads]: this CTA's columns
  const int t = threadIdx.x, c = blockIdx.x * kThreads + t;
  if (c >= cols) return;  // each thread owns its column: no barrier needed
  float* col = buf + t;  // row r of this column at col[r * kThreads]
  for (int r = 0; r < 2 * seg; ++r)
    col[r * kThreads] = x[(size_t)r * cols + c];
  for (int i = 0; i < steps; ++i) {
    const int s = min(i, seg);
    for (int r = 0; r < seg; ++r) col[r * kThreads] = col[(s + r) * kThreads];
    for (int r = 0; r < seg; ++r)
      col[(seg + r) * kThreads] = col[r * kThreads];
  }
  for (int r = 0; r < 2 * seg; ++r)
    y[(size_t)r * cols + c] = col[r * kThreads];
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

// x and y (2*seg, cols) float32, contiguous; 2*seg*128*4 bytes of shared
// memory a CTA, so seg <= 48.
int ffcnn_dynslice_carry(const void* x, void* y, int seg, int cols,
                         int steps, void* stream) {
  using namespace probes;
  if (seg < 1 || seg > 48 || cols < 0 || steps < 0)
    return (int)cudaErrorInvalidValue;
  if (cols == 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(float) * 2 * seg * kThreads;
  dynslice_carry_kernel<<<(cols + kThreads - 1) / kThreads, kThreads, smem,
                          (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y), seg, cols, steps);
  return (int)cudaGetLastError();
}

const char* ffcnn_probes_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
