// P1 and P2: the dense 1x1 product y = x @ w, x (M, K) and w (K, N)
// bfloat16, float32 sums, y (M, N) float32, as a stream.
//
// Replaces the two pallas_calls of tools/bench_pw_kernels.py: `kb` (P1, the
// channels-last product (S, 8) @ (8, 32), S = 256*80*80) and `kc` (P2, the
// same product on K-packed rows, (S/16, 128) @ (128, 512), against a
// block-diagonal weight).  K and N are compile-time constants, those two
// shapes only.  The kernel computes the dense product it is given, zeros
// included: P2 does 16x the multiply-adds of P1 for the same result.
//
// Bound on this card: both products move 26 MB of x and 210 MB of float32
// y, 0.0704 ms at 3.35 TB/s; P2's 13.4 GFLOP take 0.014 ms on the bf16
// tensor cores.  So the design keeps the output stream busy and the rest
// out of its way:
//
// * Persistent CTAs (the wrapper's grid: the row tiles, at most a few CTAs
//   an SM) walk the row tiles with a stride.  The weight is loaded once a
//   CTA: P1's 512 B into registers, P2's 128 KB into shared memory, its
//   16-byte chunks swizzled by the row (chunk ^ (k & 7)) so that
//   ldmatrix.trans reads conflict-free.
// * A producer warp keeps x tiles in flight in a shared-memory ring with
//   cp.async.bulk (TMA without a tensor map), guarded by a full and an
//   empty mbarrier a stage: one copy a tile for P1 (16-byte rows); one a
//   row for P2, into rows padded to 272 B so that ldmatrix reads
//   conflict-free.  Eight consumer warps work on the tiles that have
//   arrived: for P1 all eight on each tile, for P2 two groups of four in
//   turn, so that one group's stores overlap the other's products.
// * float32 sums of exact bf16 products, so only the order of the sums
//   differs from x.float() @ w.float().  P2 on the tensor cores: mma.sync
//   m16n8k16, a warp a 32x128 output block, A and B fragments by ldmatrix.
//   P1 (0.42 G multiply-adds) on the CUDA cores: a lane four columns of a
//   row, 32 FMAs, the weight in registers; with these stores it beat
//   mma.sync m16n8k8.
// * The output leaves as 16-byte stores with an evict-first L2 policy, so
//   that x and the weight keep the L2, each warp's store 512 contiguous
//   bytes: P1's lanes hold four rows' 128 bytes; P2's warps trade
//   fragments within quads and pass their block through shared memory
//   first (stores of fragments scattered over 16 rows 2 KB apart held
//   P2's stream below P1's).  These stores also beat staging each tile's
//   output in shared memory for one cp.async.bulk store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kConsumers = 8;                    // consumer warps
constexpr int kThreads = 32 * (kConsumers + 1);  // and the producer warp
constexpr int kBarBytes = 128;                   // the mbarriers, first

template <int K, int N>
struct Shape;

// P1: a tile is 16 rows a consumer warp, one 2 KB bulk copy; every
// consumer warp reads every stage
template <>
struct Shape<8, 32> {
  static constexpr int kRows = 128, kStages = 4, kPerSm = 3, kReaders = 8;
  static constexpr int kPitch = 16;    // bytes of an x row in the ring
  static constexpr int kWBytes = 0;    // the weight lives in registers
  static constexpr int kStgBytes = 0;  // the output leaves from registers
};

// P2: a tile is 32 rows, taken by one of two groups of four consumer
// warps (kReaders), a warp 128 of the 512 columns; an even stage count, so
// that a stage serves one group
template <>
struct Shape<128, 512> {
  static constexpr int kRows = 32, kStages = 4, kPerSm = 1, kReaders = 4;
  static constexpr int kPitch = 256 + 16;
  static constexpr int kWBytes = 128 * 512 * 2;
  // a 16 x 128 output block a consumer warp
  static constexpr int kStgBytes = 2 * 16 * 512 * 4;
};

template <class S>
__host__ __device__ constexpr int ring_bytes() {
  return S::kStages * S::kRows * S::kPitch;
}
template <class S>
__host__ __device__ constexpr int smem_bytes() {
  return kBarBytes + S::kWBytes + ring_bytes<S>() + S::kStgBytes;
}
static_assert(smem_bytes<Shape<128, 512>>() <= 232448, "P2 shared memory");
static_assert(smem_bytes<Shape<8, 32>>() * Shape<8, 32>::kPerSm <= 233472,
              "P1 shared memory");

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p;\n"
        "  mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "  selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// global -> shared, completion counted in bytes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// global -> shared, 16 bytes, waited for by cp.async.wait_all
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// 16 bytes to global memory, past L1, evict-first in L2
__device__ __forceinline__ void st_evict_first(float* dst, float4 v,
                                               uint64_t policy) {
  asm volatile(
      "st.global.L1::no_allocate.L2::cache_hint.v4.f32 [%0], {%1,%2,%3,%4}, "
      "%5;" ::"l"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "l"(policy)
      : "memory");
}

// the consumer warps only (the producer never joins): barrier 1
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(32 * kConsumers) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a @ b, m16n8k16, bf16 in, float32 accumulator
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An accumulator fragment (row g: c0, c1; row g + 8: c2, c3; columns
// 2t, 2t + 1; g = lane / 4, t = lane % 4) as one float4 a lane: lanes
// trade with their neighbour, so that an even t holds row g, columns
// 2t..2t+3, and an odd t row g + 8, columns 2t-2..2t+1 (frag_row,
// frag_col).
__device__ __forceinline__ float4 quad_pack(const float (&c)[4], int lane) {
  const bool odd = lane & 1;
  const float r0 = __shfl_xor_sync(~0u, odd ? c[0] : c[2], 1);
  const float r1 = __shfl_xor_sync(~0u, odd ? c[1] : c[3], 1);
  return odd ? make_float4(r0, r1, c[2], c[3])
             : make_float4(c[0], c[1], r0, r1);
}
__device__ __forceinline__ int frag_row(int lane) {
  return (lane >> 2) + 8 * (lane & 1);
}
__device__ __forceinline__ int frag_col(int lane) {
  return 4 * ((lane & 3) >> 1);
}

// P2's staging of a warp's 16 x 128 output block: row r's 16-byte chunk
// c at chunk c ^ stg_swizzle(r), so that both the fragment writes (rows g
// and g + 8) and the row reads fill the 32 banks
__device__ __forceinline__ int stg_swizzle(int r) {
  return ((r >> 3) << 1) | ((r & 1) << 2);
}

// --------------------------------------------------------- the producer
template <int K, int N>
__device__ void produce(const __nv_bfloat16* __restrict__ x, int m,
                        uint64_t* full, uint64_t* empty,
                        unsigned char* ring) {
  using S = Shape<K, N>;
  const int lane = threadIdx.x & 31, tiles = (m + S::kRows - 1) / S::kRows;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const int s = it % S::kStages;
    // the first round finds every stage free
    mbar_wait(&empty[s], ((it / S::kStages) & 1) ^ 1);
    const int rows = min(S::kRows, m - tile * S::kRows);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        x + (size_t)tile * S::kRows * K);
    unsigned char* dst = ring + s * S::kRows * S::kPitch;
    if (lane == 0) mbar_expect_tx(&full[s], rows * K * 2);
    __syncwarp();
    if constexpr (S::kPitch == K * 2) {
      if (lane == 0) bulk_load(dst, src, rows * K * 2, &full[s]);
    } else {
      for (int r = lane; r < rows; r += 32)
        bulk_load(dst + r * S::kPitch, src + r * K * 2, K * 2, &full[s]);
    }
  }
}

// ---------------------------------------------------------- P1 consumer
// Warp `warp` owns rows 16 warp .. 16 warp + 15 of each tile; lane
// (rq, q) computes columns 4q .. 4q + 3 of rows rq, rq + 4, rq + 8, rq + 12,
// so that each warp store is four rows' 512 contiguous bytes.
__device__ void consume_p1(const __nv_bfloat16* __restrict__ w,
                           float* __restrict__ y, int m, uint64_t* full,
                           uint64_t* empty, const unsigned char* ring) {
  using S = Shape<8, 32>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = (m + S::kRows - 1) / S::kRows;
  const int q = lane & 7, rq = lane >> 3;
  float wf[8][4];  // columns 4q .. 4q + 3 of every k
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int c = 0; c < 4; ++c) wf[k][c] = __bfloat162float(w[k * 32 + 4 * q + c]);
  const uint64_t policy = evict_first();
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const int s = it % S::kStages;
    mbar_wait(&full[s], (it / S::kStages) & 1);
    const unsigned char* xs = ring + s * S::kRows * S::kPitch + warp * 16 * 16;
    const int row0 = tile * S::kRows + 16 * warp;  // this warp's first row
    const int live = min(16, m - row0);            // its rows below m
    uint4 xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xv[i] = *reinterpret_cast<const uint4*>(xs + (rq + 4 * i) * 16);
    float4 out[4];  // rows rq + 4i
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float xk = __uint_as_float(k & 1 ? u[k >> 1] & 0xFFFF0000u
                                               : u[k >> 1] << 16);
#pragma unroll
        for (int c = 0; c < 4; ++c) a[c] = fmaf(xk, wf[k][c], a[c]);
      }
      out[i] = make_float4(a[0], a[1], a[2], a[3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (rq + 4 * i < live)
        st_evict_first(y + (size_t)(row0 + rq + 4 * i) * 32 + 4 * q, out[i],
                       policy);
    // release the stage only once the output has been stored: it depends
    // on every value read from the stage, so those reads are done
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// ---------------------------------------------------------- P2 consumer
// Two groups of four warps take the tiles in turn (group `it & 1` the
// CTA's tile `it`), so that one group's stores overlap the other's
// products.  Warp q of a group owns columns 128 q .. 128 q + 127 of the
// tile's 32 rows: 2 x 16 m16n8 accumulators.
__device__ void consume_p2(float* __restrict__ y, int m, uint64_t* full,
                           uint64_t* empty, const unsigned char* ring,
                           const unsigned char* ws, float* stg) {
  using S = Shape<128, 512>;
  constexpr int kMT = S::kRows / 16;  // m16 tiles a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp / S::kReaders, q = warp % S::kReaders;
  const int tiles = (m + S::kRows - 1) / S::kRows;
  // ldmatrix rows: lanes 8i..8i+7 address matrix i; matrices 1 and 3 are
  // 8 rows (A) or 8 k (B) further, matrices 2 and 3 8 columns further
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lhi = lane >> 4;
  const uint32_t ws_a = smem_u32(ws);
  float* mine = stg + warp * 16 * 128;  // this warp's 16 x 128 block
  const uint64_t policy = evict_first();
  for (int it = grp, tile = blockIdx.x + grp * gridDim.x; tile < tiles;
       it += 2, tile += 2 * gridDim.x) {
    const int s = it % S::kStages;
    mbar_wait(&full[s], (it / S::kStages) & 1);
    const uint32_t xs_a = smem_u32(ring + s * S::kRows * S::kPitch);
    float acc[kMT][16][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldsm_x4(a[i], xs_a + (16 * i + lrow) * S::kPitch + (16 * ks + 8 * lhi) * 2);
      // every B fragment of the step first, then its 32 independent mma
      const int k = 16 * ks + lrow;
      uint32_t b[8][4];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int chunk = 16 * q + 2 * p + lhi;  // 16-byte chunk of row k
        ldsm_x4_t(b[p], ws_a + k * 1024 + ((chunk ^ (k & 7)) << 4));
      }
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          mma16(acc[i][2 * p], a[i], b[p][0], b[p][1]);
          mma16(acc[i][2 * p + 1], a[i], b[p][2], b[p][3]);
        }
    }

    const int row0 = tile * S::kRows;
    const int fr = frag_row(lane);
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      // through the warp's own 16 x 128 block, so that each store is one
      // row's 512 contiguous bytes
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 2 * j + (frag_col(lane) >> 2);  // 16-byte chunk
        *reinterpret_cast<float4*>(mine + fr * 128 +
                                   ((c ^ stg_swizzle(fr)) << 2)) =
            quad_pack(acc[i][j], lane);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(
            mine + r * 128 + ((lane ^ stg_swizzle(r)) << 2));
        const int row = row0 + 16 * i + r;
        if (row < m)
          st_evict_first(y + (size_t)row * 512 + 128 * q + 4 * lane, v,
                         policy);
      }
      __syncwarp();
    }
    // as in P1: the stored output depends on every read of the stage
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// ------------------------------------------------------------ the kernel
template <int K, int N>
__global__ void __launch_bounds__(kThreads, Shape<K, N>::kPerSm)
    pw_stream(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w, float* __restrict__ y,
              int m) {
  using S = Shape<K, N>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S::kStages;
  unsigned char* ws = smem + kBarBytes;
  unsigned char* ring = ws + S::kWBytes;
  float* stg = reinterpret_cast<float*>(ring + ring_bytes<S>());
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], S::kReaders);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 32 * kConsumers) {
    produce<K, N>(x, m, full, empty, ring);  // the first tiles load at once
  } else if constexpr (K == 8) {
    consume_p1(w, y, m, full, empty, ring);
  } else {
    // the weight, row k's 16-byte chunk c at chunk c ^ (k & 7), every
    // copy in flight at once
    constexpr int kChunks = N / 8;
    for (int i = threadIdx.x; i < K * kChunks; i += 32 * kConsumers) {
      const int k = i / kChunks, c = i % kChunks;
      cp_async16(ws + k * N * 2 + ((c ^ (k & 7)) << 4), w + k * N + 8 * c);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    consumers_sync();
    consume_p2(y, m, full, empty, ring, ws, stg);
  }
}

// The shared-memory cap of each instance is raised once per device (a
// record of this library's own: internal linkage).
template <int K, int N>
cudaError_t launch(const void* x, const void* w, void* y, int m, int ctas,
                   cudaStream_t stream) {
  static std::atomic<uint64_t> raised{0};
  constexpr int smem = smem_bytes<Shape<K, N>>();
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        pw_stream<K, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    raised.fetch_or(bit, std::memory_order_relaxed);
  }
  pw_stream<K, N><<<ctas, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(y), m);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (m, k) and w (k, n) bfloat16, y (m, n) float32, all contiguous and
// 16-byte aligned; (k, n) one of the compiled shapes; `ctas` persistent
// CTAs, 1 .. the row tiles.  Returns cudaErrorInvalidValue for what the
// kernel cannot take, else the launch's error.
int ffcnn_pw_matmul(const void* x, const void* w, void* y, int m, int k,
                    int n, int ctas, void* stream) {
  const int rows = k == 8 && n == 32      ? Shape<8, 32>::kRows
                   : k == 128 && n == 512 ? Shape<128, 512>::kRows
                                          : 0;
  if (!rows || m < 1 || (uintptr_t)x % 16 || (uintptr_t)w % 16 ||
      (uintptr_t)y % 16 || ctas < 1 || ctas > (m + rows - 1) / rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(k == 8 ? launch<8, 32>(x, w, y, m, ctas, s)
                      : launch<128, 512>(x, w, y, m, ctas, s));
}

const char* ffcnn_pw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
