// Pairwise-L1 Gram matrix for Hopper (sm_90a), bound to Python through
// ctypes.
//
// Replaces: src/repro/kernels/pairwise_gram.py::pairwise_l1_pallas,
//   gram[i,j] = sum_d |x[i,d] - y[j,d]|  over (M,D) x (N,D) f32 rows, which
//   the TPU kernel computes on the VPU as (TM, TN, TD) broadcast-difference
//   blocks summed into a VMEM accumulator along a sequential D grid axis.
//
// What bounds it on an H100: operations.  L1 has no product to put on the
//   tensor cores; each (i, j, d) costs two FP32 instructions on the CUDA
//   cores (the subtraction, and the add with the |.| operand modifier), so
//   M*N*D*2 lane instructions at 132 SMs * 128 lanes * 1.98 GHz = 33.5e12/s.
//   The bytes (each input read once, the f32 output written once) take far
//   less at the main path's shapes (4096 x 4096 x 652: 0.65 ms of
//   instructions against 26 us of bytes).
//
// Design: SGEMM-style register blocking.  A CTA of 256 threads owns a
//   64 x 64 output tile; each thread holds a 4 x 4 micro-tile
//   of accumulators, strided by 16 rows and 16 columns so that the 16
//   threads of a half-warp read 16 consecutive shared-memory words and
//   write 16 consecutive output floats.  D is walked in chunks of 16: each
//   chunk of x and y rows is staged transposed in shared memory
//   ([d][row], padded by one word), so one shared load feeds 4
//   instructions' worth of operands.  Each chunk is summed into a partial
//   micro-tile first and then added to the accumulators, which keeps the
//   rounding error of a D = 652 sum near that of 16 + 41 additions rather
//   than 652.  Rows past M or N and columns past D load as 0 (|0 - 0| adds
//   nothing), so the host pads nothing.
//
// Small grids: when the 64 x 64 tiles would be fewer than half the H100's
//   132 SMs (fig2's 72 x 72 Gram makes 4), a second layout spreads the same
//   work wider.  A CTA of 128 threads owns a 16 x 16 tile; its 8 groups of
//   16 threads (4 x 4 outputs each) take 8 consecutive D chunks per round,
//   each group one chunk, write the chunk partials to shared memory, and
//   one thread per output adds them to its accumulator in chunk order.
//   Each thread loads its column of the next round's rows into registers
//   while the round computes, so a launch waits on one load latency, not
//   one a round.
//   Both layouts form every chunk partial as 0 + 16 terms in d order and
//   add the partials to 0 in chunk order, so an output's bits depend only
//   on its two rows and D, never on M, N or the layout.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;  // threads along each side of the CTA
constexpr int kChunk = 16;  // D values staged per step
constexpr int TM = 4;  // micro-tile side
constexpr int kTile = kSide * TM;  // CTA tile side, 64
// the small-grid layout: below this many 64 x 64 tiles (half of 132 SMs)
constexpr int kSmallGridTiles = 66;
constexpr int kSmallTile = 16;  // its CTA tile side
constexpr int kGroups = 8;  // chunk groups of 4 x 4 threads, a chunk each
constexpr int kSmallThreads = 16 * kGroups;
constexpr int kRound = kGroups * kChunk;  // D values staged per round

__global__ void __launch_bounds__(kThreads)
pairwise_l1_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ out, int m, int n, int d) {
  __shared__ float xs[kChunk][kTile + 1];
  __shared__ float ys[kChunk][kTile + 1];
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
      const int r = e / kChunk;
      const int c = e - r * kChunk;
      const int k = k0 + c;
      const int gm = m0 + r;
      const int gn = n0 + r;
      xs[c][r] = (gm < m && k < d) ? x[(long long)gm * d + k] : 0.f;
      ys[c][r] = (gn < n && k < d) ? y[(long long)gn * d + k] : 0.f;
    }
    __syncthreads();
    float part[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      float a[TM], b[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[c][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < TM; ++j) b[j] = ys[c][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) part[i][j] += fabsf(a[i] - b[j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + kSide * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int gn = n0 + tx + kSide * j;
      if (gn < n) out[(long long)gm * n + gn] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kSmallThreads)
pairwise_l1_small_kernel(const float* __restrict__ x,
                         const float* __restrict__ y, float* __restrict__ out,
                         int m, int n, int d) {
  __shared__ float xs[kRound][kSmallTile + 1];
  __shared__ float ys[kRound][kSmallTile + 1];
  __shared__ float parts[kGroups][kSmallTile * kSmallTile];
  constexpr int kOut = kSmallTile * kSmallTile / kSmallThreads;  // 2
  const int g = threadIdx.x / 16;  // this thread's chunk in the round
  const int tx = threadIdx.x % 4;
  const int ty = threadIdx.x / 4 % 4;
  const int m0 = blockIdx.y * kSmallTile;
  const int n0 = blockIdx.x * kSmallTile;
  // outputs threadIdx.x + h * kSmallThreads of the tile, row-major
  float acc[kOut];
#pragma unroll
  for (int h = 0; h < kOut; ++h) acc[h] = 0.f;

  // a round's rows, column k0 + threadIdx.x of row i in px[i] and py[i],
  // loaded a round ahead so the loads overlap the previous round's work
  static_assert(kRound == kSmallThreads, "a thread stages one column");
  float px[kSmallTile], py[kSmallTile];
  auto fetch = [&](int k0) {
    const int k = k0 + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kSmallTile; ++i) {
      px[i] = (m0 + i < m && k < d) ? x[(long long)(m0 + i) * d + k] : 0.f;
      py[i] = (n0 + i < n && k < d) ? y[(long long)(n0 + i) * d + k] : 0.f;
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < d; k0 += kRound) {
#pragma unroll
    for (int i = 0; i < kSmallTile; ++i) {
      xs[threadIdx.x][i] = px[i];
      ys[threadIdx.x][i] = py[i];
    }
    __syncthreads();
    if (k0 + kRound < d) fetch(k0 + kRound);
    const int chunks = min(kGroups, (d - k0 + kChunk - 1) / kChunk);
    if (g < chunks) {
      float part[TM][TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) part[i][j] = 0.f;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        float a[TM], b[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[g * kChunk + c][ty + 4 * i];
#pragma unroll
        for (int j = 0; j < TM; ++j) b[j] = ys[g * kChunk + c][tx + 4 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j) part[i][j] += fabsf(a[i] - b[j]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j)
          parts[g][(ty + 4 * i) * kSmallTile + tx + 4 * j] = part[i][j];
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < kOut; ++h)
      for (int q = 0; q < chunks; ++q)
        acc[h] += parts[q][threadIdx.x + h * kSmallThreads];
    // the next round writes parts only after the barrier that ends its
    // staging, which every thread reaches after this sum
  }

#pragma unroll
  for (int h = 0; h < kOut; ++h) {
    const int o = threadIdx.x + h * kSmallThreads;
    const int gm = m0 + o / kSmallTile;
    const int gn = n0 + o % kSmallTile;
    if (gm < m && gn < n) out[(long long)gm * n + gn] = acc[h];
  }
}

bool small_grid(int m, int n) {
  return (long long)((n + kTile - 1) / kTile) * ((m + kTile - 1) / kTile) <
         kSmallGridTiles;
}

}  // namespace

// 1 when an (M, N) launch takes the small-grid layout, else 0.
extern "C" int pairwise_l1_small_grid(int m, int n) {
  return m > 0 && n > 0 && small_grid(m, n);
}

// x (M,D) f32, y (N,D) f32, out (M,N) f32, all contiguous.  Returns
// cudaGetLastError() after the launch.
extern "C" int pairwise_l1_launch(const void* x, const void* y, void* out,
                                  int m, int n, int d, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (small_grid(m, n)) {
    const dim3 grid((n + kSmallTile - 1) / kSmallTile,
                    (m + kSmallTile - 1) / kSmallTile);
    pairwise_l1_small_kernel<<<grid, kSmallThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)y, (float*)out, m, n, d);
    return (int)cudaGetLastError();
  }
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  pairwise_l1_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (float*)out, m, n, d);
  return (int)cudaGetLastError();
}
