// Masked Hamming distances over packed LSH codes for Hopper (sm_90a), bound
// to Python through ctypes.
//
// Replaces: src/repro/kernels/hamming.py::hamming_scan_pallas,
//   dist[i,j] = sum_w popcount((q[i,w] ^ c[j,w]) & m[i,w])  over (Q,W)
//   query codes and masks and (N,W) corpus codes, 32-bit words, which the
//   TPU kernel computes as (TQ, TN, W) broadcast blocks in VMEM reduced over
//   the word axis into an int32 (TQ, TN) tile.
//
// What bounds it on an H100: bytes.  Per (i, j, w) the work is XOR, AND, a
//   popcount and an add; the popcount unit does 16 per SM per clock (4.18e12/s)
//   and the lane instructions run at 33.5e12/s, while the int32 (Q,N) output
//   alone is 4 bytes per (i, j).  At W = 4 the output's bytes (4 B at
//   3.35 TB/s, 1.2 ps) outweigh the 4 popcounts (0.96 ps) and 12 lane
//   instructions (0.36 ps) of one (i, j).  At the index's 256 x 4096 that
//   bound is ~1.3 us, so a launch there costs its launch latency.
//
// Design: one CTA of 128 threads per 16-query x 256-row output tile.  Each
//   thread owns two corpus rows, 128 rows apart, so that a warp writes 32
//   consecutive int32 of an output row per store.  The words are walked in
//   chunks of 4: the 16 query and mask rows of the chunk are staged in shared
//   memory (every thread reads the same word, a broadcast), the thread's two
//   corpus rows are held in registers, and each staged word feeds two
//   popcounts.  Words past W, rows past N and queries past Q load as 0, so
//   the host pads nothing; only in-range outputs are written.  The words are
//   read as unsigned, so a word with bit 31 set (negative as int32) is no
//   different from any other.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 2;                 // corpus rows per thread
constexpr int kTileN = kThreads * kRows;  // corpus rows per CTA, 256
constexpr int kTileQ = 16;               // queries per CTA
constexpr int kChunk = 4;                // words staged per step

__global__ void __launch_bounds__(kThreads)
hamming_scan_kernel(const uint32_t* __restrict__ q,
                    const uint32_t* __restrict__ m,
                    const uint32_t* __restrict__ c, int32_t* __restrict__ out,
                    int nq, int n, int w) {
  __shared__ uint32_t qs[kTileQ][kChunk];
  __shared__ uint32_t ms[kTileQ][kChunk];
  const int q0 = blockIdx.y * kTileQ;
  const long long n0 = (long long)blockIdx.x * kTileN;
  int acc[kRows][kTileQ];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < kTileQ; ++i) acc[r][i] = 0;

  for (int w0 = 0; w0 < w; w0 += kChunk) {
    // stage the chunk of the query and mask rows: 64 words each
    if (threadIdx.x < kTileQ * kChunk) {
      const int i = threadIdx.x / kChunk;
      const int k = threadIdx.x % kChunk;
      const bool in = q0 + i < nq && w0 + k < w;
      const long long at = (long long)(q0 + i) * w + w0 + k;
      qs[i][k] = in ? q[at] : 0u;
      ms[i][k] = in ? m[at] : 0u;
    }
    uint32_t cw[kRows][kChunk];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long j = n0 + threadIdx.x + r * kThreads;
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        cw[r][k] = (j < n && w0 + k < w) ? c[j * w + w0 + k] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTileQ; ++i) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const uint32_t qw = qs[i][k];
        const uint32_t mw = ms[i][k];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r][i] += __popc((qw ^ cw[r][k]) & mw);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long j = n0 + threadIdx.x + r * kThreads;
    if (j >= n) continue;
#pragma unroll
    for (int i = 0; i < kTileQ; ++i)
      if (q0 + i < nq) out[(long long)(q0 + i) * n + j] = acc[r][i];
  }
}

}  // namespace

// q (Q,W) and m (Q,W) int32 bit patterns, c (N,W), out (Q,N) int32, all
// contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int hamming_scan_launch(const void* q, const void* m, const void* c,
                                   void* out, int nq, int n, int w,
                                   void* stream) {
  if (nq <= 0 || n <= 0) return 0;
  const dim3 grid((unsigned)((n + kTileN - 1) / kTileN),
                  (unsigned)((nq + kTileQ - 1) / kTileQ));
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  hamming_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)q, (const uint32_t*)m, (const uint32_t*)c,
      (int32_t*)out, nq, n, w);
  return (int)cudaGetLastError();
}
