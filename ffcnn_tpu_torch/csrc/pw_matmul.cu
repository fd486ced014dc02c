// P1 and P2: a dense 1x1 product y = x @ w, x (M, K) and w (K, N) bfloat16,
// float32 accumulation, y (M, N) float32.
//
// Replaces the two pallas_calls of tools/bench_pw_kernels.py: `kb` (P1, the
// channels-last product (S, Cin) @ (Cin, Cout), S = 256*80*80, Cin 8,
// Cout 32) and `kc` (P2, the same product on K-packed rows, (S/16, 128) @
// (128, 512), whose weight is block-diagonal).  One kernel serves both: it
// computes the dense product it is given, zeros included, so P2 does 16x
// the multiply-adds of P1 for the same result (the packing was a TPU trick
// for the 128-wide MXU).
//
// Bound on this card: at P1's shapes the 26 MB of x and the 210 MB of y set
// the bound (0.07 ms at 3.35 TB/s); 0.84 GFLOP are nothing.  P2 moves the
// same bytes and does 13.4 GFLOP, which float32 FMAs on the CUDA cores
// cannot finish in under 0.2 ms (67 TFLOP/s).  This first design is simple:
// a CTA owns a 64-row x (32*PJ)-column output tile, stages K in chunks of
// 32 through shared memory as float32 (x one 16-byte uint4 of 8 bf16 per
// thread and step, so a K = 8 row is one load), and each thread keeps 8
// rows x PJ columns of float32 sums in registers: the warp's rows are
// broadcast reads, its columns consecutive, so each row of 32 output floats
// is one coalesced 128-byte store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pw {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRT = 8;               // output rows per thread
constexpr int kBM = kWarps * kRT;    // output rows per CTA (64)
constexpr int kBK = 32;              // depth staged per step

template <int PJ>
__global__ void __launch_bounds__(kThreads)
    pw_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w, float* __restrict__ y,
              int m, int k, int n) {
  constexpr int kBN = 32 * PJ;
  __shared__ __align__(16) float xs[kBM][kBK];
  __shared__ float ws[kBK][kBN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;

  float acc[kRT][PJ];
#pragma unroll
  for (int r = 0; r < kRT; ++r)
#pragma unroll
    for (int j = 0; j < PJ; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    const int kc = min(kBK, k - k0);  // a multiple of 8
    __syncthreads();  // the previous step is done with the tiles
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), q = (i % (kBK / 8)) * 8;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (q < kc && row0 + r < m) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            x + (size_t)(row0 + r) * k + k0 + q);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
        const float2 a = __bfloat1622float2(h[0]);
        const float2 b = __bfloat1622float2(h[1]);
        const float2 c = __bfloat1622float2(h[2]);
        const float2 d = __bfloat1622float2(h[3]);
        lo = make_float4(a.x, a.y, b.x, b.y);
        hi = make_float4(c.x, c.y, d.x, d.y);
      }
      *reinterpret_cast<float4*>(&xs[r][q]) = lo;
      *reinterpret_cast<float4*>(&xs[r][q + 4]) = hi;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, c = i - kk * kBN;
      ws[kk][c] = (kk < kc && col0 + c < n)
                      ? __bfloat162float(w[(size_t)(k0 + kk) * n + col0 + c])
                      : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float wv[PJ];
#pragma unroll
      for (int j = 0; j < PJ; ++j) wv[j] = ws[kk][lane + 32 * j];
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const float xv = xs[warp + kWarps * r][kk];
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[r][j] = fmaf(xv, wv[j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    const int row = row0 + warp + kWarps * r;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      const int col = col0 + lane + 32 * j;
      if (col < n) y[(size_t)row * n + col] = acc[r][j];
    }
  }
}

template <int PJ>
void launch(const __nv_bfloat16* x, const __nv_bfloat16* w, float* y, int m,
            int k, int n, cudaStream_t stream) {
  const dim3 grid((m + kBM - 1) / kBM, (n + 32 * PJ - 1) / (32 * PJ));
  pw_kernel<PJ><<<grid, kThreads, 0, stream>>>(x, w, y, m, k, n);
}

}  // namespace pw

extern "C" {

// x (m, k) and w (k, n) bfloat16, y (m, n) float32, all contiguous; x
// 16-byte aligned and k a multiple of 8 (rows are loaded 8 values at a
// time).  Returns cudaErrorInvalidValue for what the kernel cannot take,
// else cudaGetLastError().
int ffcnn_pw_matmul(const void* x, const void* w, void* y, int m, int k,
                    int n, void* stream) {
  using namespace pw;
  if (m < 0 || k < 0 || n < 0 || k % 8 || (uintptr_t)x % 16 ||
      (n + 127) / 128 > 65535)
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return (int)cudaGetLastError();
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* yf = static_cast<float*>(y);
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 32)
    launch<1>(xb, wb, yf, m, k, n, s);
  else if (n <= 64)
    launch<2>(xb, wb, yf, m, k, n, s);
  else
    launch<4>(xb, wb, yf, m, k, n, s);
  return (int)cudaGetLastError();
}

const char* ffcnn_pw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
