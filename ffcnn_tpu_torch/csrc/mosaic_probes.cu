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
// Both are index-mapped copies with no shared memory and no barrier.
//
// P4 moves one 16-byte run (8 bf16 columns) a thread where the columns are
// a multiple of 8 and both pointers 16-byte aligned, else one 2-byte
// element a thread with the same map.  A CTA is 128 threads as a 2-D block
// (runs, rows): threadIdx.x the run in a row, threadIdx.y the output row in
// the CTA's band, so neighbouring lanes take neighbouring runs and a row's
// store is one coalesced line of 16 bytes a lane; the row and run come from
// the block indices, with no division.  The grid is sized to the work (the
// probe's 16 x 128 is one CTA, one load and one store a thread) and capped
// at what the card keeps resident (kResident threads an SM), beyond which
// the CTAs stride over the row bands.  kernels/mosaic_probes.py's
// ``strided_plan`` mirrors the choice, and the launcher reports it.
//
// P5 copies four columns a thread (one 16-byte run) where the rows allow,
// neighbouring threads on neighbouring columns.  It composes its steps
// into one row map: output row r after step i is row min(i, seg) + r % seg
// of the carry before it, so walking the steps backwards from r gives the
// input row it copies.  Steps past seg all start at seg, and that map is
// idempotent, so they fold into one: at most seg + 1 steps a thread, in
// registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace probes {

constexpr int kThreads = 128;
constexpr int kResident = 2048;  // threads an SM keeps resident (sm_90)

// y[r, run] = x[2r, run] over (rows_out, runs), T one run: uint4 (8 bf16)
// or uint16_t (one bf16)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    strided_rows_kernel(const T* __restrict__ x, T* __restrict__ y,
                        int rows_out, int runs) {
  const int run = blockIdx.x * blockDim.x + threadIdx.x;
  if (run >= runs) return;
  const size_t pitch = (size_t)runs;
  for (int r = blockIdx.y * blockDim.y + threadIdx.y; r < rows_out;
       r += gridDim.y * blockDim.y)
    y[(size_t)r * pitch + run] = x[(size_t)2 * r * pitch + run];
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

// x (rows, cols) and y (ceil(rows/2), cols) bfloat16, contiguous; sms the
// card's SMs.  plan (5 ints) gets the launch: the columns a thread (8 or
// 1), the block's (x, y) and the grid's (x, y); a grid of 0 launches none.
int ffcnn_strided_rows(const void* x, void* y, int rows, int cols, int sms,
                       int* plan, void* stream) {
  using namespace probes;
  if (rows < 0 || cols < 0 || sms < 1) return (int)cudaErrorInvalidValue;
  const bool v8 = cols % 8 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)y % 16 == 0;
  const int vec = v8 ? 8 : 1, runs = cols / vec;
  const int rows_out = rows / 2 + rows % 2;
  int bx = 1;
  while (bx < runs && bx < kThreads) bx *= 2;
  const int by = kThreads / bx;
  const int gx = runs / bx + (runs % bx != 0);
  const int bands = rows_out / by + (rows_out % by != 0);
  int gy = 0;
  if (gx > 0 && bands > 0) {
    const int resident = sms * (kResident / kThreads) / gx;
    gy = bands < resident ? bands : (resident > 1 ? resident : 1);
  }
  plan[0] = vec, plan[1] = bx, plan[2] = by, plan[3] = gy ? gx : 0,
  plan[4] = gy;
  if (gy == 0) return (int)cudaGetLastError();
  const dim3 grid(gx, gy), block(bx, by);
  cudaStream_t s = (cudaStream_t)stream;
  if (v8)
    strided_rows_kernel<uint4><<<grid, block, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), rows_out, runs);
  else
    strided_rows_kernel<uint16_t><<<grid, block, 0, s>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(y), rows_out,
        runs);
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
