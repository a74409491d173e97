// k-core Jacobi peel for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces: src/repro/kernels/kcore_peel.py::kcore_peel_pallas, one peel
//   sweep  deg[u] = sum_w A[u,w] * alive[w];  alive'[u] = alive[u] && deg[u] >= k.
//   The TPU kernel streams f32 adjacency tiles through the MXU once per sweep
//   and leaves the fixpoint loop to lax.while_loop on the host side.
//
// What bounds it on an H100: bytes.  The adjacency is read once as bool
//   (B*N*N bytes at 3.35 TB/s); a sweep is N*ceil(N/32) AND+popcount word ops
//   per graph, far below the CUDA-core rate.
//
// Design: one CTA per graph.  The CTA reads its bool adjacency once and packs
//   it into 32-vertex words with warp ballots, stored transposed
//   (rows[x * N + u] = word x of row u) so the lanes of a warp, which own 32
//   consecutive vertices, read consecutive words.  The packed rows stay in
//   shared memory while they fit (N*ceil(N/32)*4 bytes: 128 KiB at N=1024)
//   and live in a global scratch buffer, L2-resident, otherwise.  The alive
//   mask is a bit vector in shared memory.  `sweeps == 0` loops until the
//   graph's own mask stops changing, inside the launch, so the fixpoint costs
//   no host round trip per sweep; extra sweeps on a converged graph change
//   nothing, so the per-graph fixpoint equals a batch-wide loop bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void kcore_peel_kernel(const uint8_t* __restrict__ adj,
                                  const uint8_t* __restrict__ alive_in,
                                  uint8_t* __restrict__ alive_out,
                                  uint32_t* __restrict__ scratch,
                                  int n, int k, int sweeps, int rows_in_smem) {
  extern __shared__ uint32_t smem[];
  __shared__ int changed;
  const int w_words = (n + 31) >> 5;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const uint8_t* a = adj + (size_t)b * n * n;
  uint32_t* rows = rows_in_smem ? smem : scratch + (size_t)b * n * w_words;
  uint32_t* alive = rows_in_smem ? smem + (size_t)n * w_words : smem;
  uint32_t* next = alive + w_words;

  // pack: warp t handles (row u, word x); lane i reads column 32x+i
  for (int t = warp; t < n * w_words; t += n_warps) {
    const int u = t / w_words;
    const int x = t - u * w_words;
    const int col = (x << 5) + lane;
    const bool bit = col < n && a[(size_t)u * n + col] != 0;
    const uint32_t word = __ballot_sync(kFull, bit);
    if (lane == 0) rows[(size_t)x * n + u] = word;
  }
  for (int x = warp; x < w_words; x += n_warps) {
    const int col = (x << 5) + lane;
    const bool bit = col < n && alive_in[(size_t)b * n + col] != 0;
    const uint32_t word = __ballot_sync(kFull, bit);
    if (lane == 0) alive[x] = word;
  }
  __syncthreads();

  for (int s = 0; sweeps == 0 || s < sweeps; ++s) {
    if (threadIdx.x == 0) changed = 0;
    __syncthreads();
    // warp handles mask word x: its lanes own vertices 32x .. 32x+31
    for (int x = warp; x < w_words; x += n_warps) {
      const int u = (x << 5) + lane;
      const uint32_t old = alive[x];
      bool keep = false;
      if (u < n && ((old >> lane) & 1u)) {
        int deg = 0;
        for (int y = 0; y < w_words; ++y)
          deg += __popc(rows[(size_t)y * n + u] & alive[y]);
        keep = deg >= k;
      }
      const uint32_t word = __ballot_sync(kFull, keep);
      if (lane == 0) {
        next[x] = word;
        if (word != old) changed = 1;
      }
    }
    __syncthreads();
    for (int x = threadIdx.x; x < w_words; x += blockDim.x) alive[x] = next[x];
    const int c = changed;
    __syncthreads();
    if (!c) break;
  }

  for (int u = threadIdx.x; u < n; u += blockDim.x)
    alive_out[(size_t)b * n + u] = (alive[u >> 5] >> (u & 31)) & 1u;
}

}  // namespace

// adj (B,N,N) bool, alive_in/alive_out (B,N) bool, scratch (B,ceil(N/32),N)
// int32 (used only when the packed rows do not fit in shared memory).
// sweeps = 0 runs to each graph's fixpoint.  threads: a multiple of 32,
// at most 1024.  Returns cudaGetLastError() after the launch.
extern "C" int kcore_peel_launch(const void* adj, const void* alive_in,
                                 void* alive_out, void* scratch, int batch,
                                 int n, int k, int sweeps, int threads,
                                 void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const size_t w_words = (size_t)(n + 31) / 32;
  const size_t rows_bytes = (size_t)n * w_words * 4;
  const size_t bits_bytes = 2 * w_words * 4;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t reserve = 64;  // the static `changed` flag and alignment
  const int rows_in_smem = rows_bytes + bits_bytes + reserve <= (size_t)optin;
  const size_t smem = rows_in_smem ? rows_bytes + bits_bytes : bits_bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kcore_peel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kcore_peel_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)adj, (const uint8_t*)alive_in, (uint8_t*)alive_out,
      (uint32_t*)scratch, n, k, sweeps, rows_in_smem);
  return (int)cudaGetLastError();
}
