// Dominated-vertex matrix for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces: src/repro/kernels/domination.py::domination_pallas,
//   dom[b,u,v] = (|N[u] \ N[v]| == 0) && u != v && live(u) && live(v),
//   which the TPU kernel computes as the f32 MXU product viol = Nc . NotNc^T
//   (exact below 2^24) with the comparison fused into the epilogue.
//
// What bounds it on an H100: bytes.  It reads the bool adjacency once and
//   writes the bool (B,N,N) result once; the work is N*N*ceil(N/32)
//   AND-NOT+popcount word ops per graph, which at the main path's widths
//   (N <= 1024, 32 words) stays below the byte time.
//
// Design: two launches behind one entry point.  A pack pass turns each live
//   row into its closed neighborhood Nc[u] = (A[u] | e_u) & mask & mask[u]
//   as 32-vertex words (one warp per row, warp ballots), so the (B,N,N)
//   adjacency is read once.  The tile pass gives a CTA one (graph, 32 u,
//   32 v) tile, stages both row tiles in shared memory 32 words at a time
//   (rows padded to 33 words against bank conflicts) and counts
//   viol[u,v] = popc(Nc[u] & ~Nc[v]) in integers, which is exact.  Nc[u]
//   already holds only live columns, so no separate live mask is needed in
//   the count.  The tensor-core 0/1 form is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;  // blockDim.y of the tile pass

__global__ void pack_closed_nbhd_kernel(const uint8_t* __restrict__ adj,
                                        const uint8_t* __restrict__ mask,
                                        uint32_t* __restrict__ nc,
                                        long long rows, int n, int w_words) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long b = row / n;
  const int u = (int)(row - b * n);
  const uint8_t* m = mask + b * n;
  const uint8_t* a = adj + row * n;
  const bool mu = m[u] != 0;
  for (int x = 0; x < w_words; ++x) {
    const int col = (x << 5) + lane;
    const bool bit =
        mu && col < n && m[col] != 0 && (col == u || a[col] != 0);
    const uint32_t word = __ballot_sync(kFull, bit);
    if (lane == 0) nc[row * w_words + x] = word;
  }
}

__global__ void domination_tile_kernel(const uint32_t* __restrict__ nc,
                                       const uint8_t* __restrict__ mask,
                                       uint8_t* __restrict__ out, int n,
                                       int w_words, int tiles) {
  __shared__ uint32_t su[kTile][kTile + 1];
  __shared__ uint32_t sv[kTile][kTile + 1];
  // grid.x enumerates (graph, u tile, v tile); gridDim.z would cap the
  // batch at 65535
  const long long b = blockIdx.x / (tiles * tiles);
  const int t = (int)(blockIdx.x - b * tiles * tiles);
  const int u0 = (t / tiles) * kTile;
  const int v0 = (t % tiles) * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const uint32_t* g = nc + b * n * (long long)w_words;
  int viol[kTile / kRowsPerPass];
#pragma unroll
  for (int i = 0; i < kTile / kRowsPerPass; ++i) viol[i] = 0;

  for (int w0 = 0; w0 < w_words; w0 += kTile) {
    for (int r = ty; r < kTile; r += kRowsPerPass) {
      const int x = w0 + tx;
      const int u = u0 + r;
      const int v = v0 + r;
      su[r][tx] = (u < n && x < w_words) ? g[(long long)u * w_words + x] : 0u;
      sv[r][tx] = (v < n && x < w_words) ? g[(long long)v * w_words + x] : 0u;
    }
    __syncthreads();
    const int wc = min(kTile, w_words - w0);
    for (int x = 0; x < wc; ++x) {
      const uint32_t not_v = ~sv[tx][x];
#pragma unroll
      for (int i = 0; i < kTile / kRowsPerPass; ++i)
        viol[i] += __popc(su[ty + kRowsPerPass * i][x] & not_v);
    }
    __syncthreads();
  }

  const int v = v0 + tx;
  if (v >= n) return;
  const uint8_t* m = mask + b * n;
  const bool mv = m[v] != 0;
#pragma unroll
  for (int i = 0; i < kTile / kRowsPerPass; ++i) {
    const int u = u0 + ty + kRowsPerPass * i;
    if (u < n)
      out[(b * n + u) * (long long)n + v] =
          viol[i] == 0 && u != v && mv && m[u] != 0;
  }
}

}  // namespace

// adj (B,N,N) bool, mask (B,N) bool, out (B,N,N) bool, scratch
// (B,N,ceil(N/32)) int32 for the packed closed neighborhoods.  Returns
// cudaGetLastError() after the two launches.
extern "C" int domination_launch(const void* adj, const void* mask, void* out,
                                 void* scratch, int batch, int n,
                                 void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int w_words = (n + 31) / 32;
  const long long rows = (long long)batch * n;
  const int warps = 8;
  const long long pack_blocks = (rows + warps - 1) / warps;
  cudaStream_t s = (cudaStream_t)stream;
  pack_closed_nbhd_kernel<<<(unsigned)pack_blocks, warps * 32, 0, s>>>(
      (const uint8_t*)adj, (const uint8_t*)mask, (uint32_t*)scratch, rows, n,
      w_words);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n + kTile - 1) / kTile;
  const long long n_tiles = (long long)batch * tiles * tiles;
  dim3 block(kTile, kRowsPerPass);
  domination_tile_kernel<<<(unsigned)n_tiles, block, 0, s>>>(
      (const uint32_t*)scratch, (const uint8_t*)mask, (uint8_t*)out, n,
      w_words, tiles);
  return (int)cudaGetLastError();
}
