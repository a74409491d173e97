// Common-neighbor counts on edges for Hopper (sm_90a), bound to Python
// through ctypes.
//
// Replaces: src/repro/kernels/common_neighbors.py::common_neighbors_pallas,
//   cn[b,u,v] = A[u,v] * |N(u) ∩ N(v)| = ((A @ A) ⊙ A)[u,v],
//   which the TPU kernel computes as a tiled f32 MXU matmul with the edge
//   mask fused into the epilogue.
//
// What bounds it on an H100: bytes.  It reads the bool adjacency once
//   (B*N*N bytes) and writes the int32 result once (4*B*N*N bytes); the
//   output dominates.  The counting work that the data needs is one
//   AND+popcount+add per (edge, 32-vertex word), far below the byte time on
//   the sparse graphs of the main path.
//
// Design: two launches behind one entry point.  A pack pass turns each row
//   of A into 32-vertex words with warp ballots (one warp per row), so the
//   adjacency is read once.  The tile pass gives a CTA one (graph, 32 u,
//   32 v) output tile; it stages the packed rows of both vertex tiles in
//   shared memory 32 words at a time (rows padded to 33 words against bank
//   conflicts) and counts popc(P[u] & P[v]) in integers, which is exact.
//   Each thread owns one v column and 32/kRows u rows, so a warp writes 32
//   consecutive int32 of one output row: the stores are coalesced.  The
//   edge mask A[u,v] is bit v%32 of word v/32 of u's packed row, taken from
//   shared memory while that word is staged, so the adjacency is read once
//   in all and the epilogue only stores.  The tensor-core 0/1 form is later
//   work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;
constexpr int kRows = 8;  // blockDim.y of the tile pass

__global__ void pack_rows_kernel(const uint8_t* __restrict__ adj,
                                 uint32_t* __restrict__ packed,
                                 long long rows, int n, int w_words) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const uint8_t* a = adj + row * n;
  for (int x = 0; x < w_words; ++x) {
    const int col = (x << 5) + lane;
    const uint32_t word = __ballot_sync(kFull, col < n && a[col] != 0);
    if (lane == 0) packed[row * w_words + x] = word;
  }
}

__global__ void common_neighbors_tile_kernel(const uint32_t* __restrict__ packed,
                                             int32_t* __restrict__ out, int n,
                                             int w_words, int tiles) {
  __shared__ uint32_t su[kTile][kTile + 1];
  __shared__ uint32_t sv[kTile][kTile + 1];
  constexpr int kPer = kTile / kRows;  // u rows per thread
  // grid.x enumerates (graph, u tile, v tile); gridDim.z would cap the
  // batch at 65535
  const long long b = blockIdx.x / ((long long)tiles * tiles);
  const int t = (int)(blockIdx.x - b * tiles * tiles);
  const int u0 = (t / tiles) * kTile;
  const int v0 = (t % tiles) * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const uint32_t* g = packed + b * n * (long long)w_words;
  const int v_word = v0 >> 5;  // the packed word holding every v of the tile
  int cn[kPer];
  uint32_t edges[kPer];  // word v_word of each of this thread's u rows
#pragma unroll
  for (int i = 0; i < kPer; ++i) cn[i] = 0, edges[i] = 0u;

  for (int w0 = 0; w0 < w_words; w0 += kTile) {
    for (int r = ty; r < kTile; r += kRows) {
      const int x = w0 + tx;
      const int u = u0 + r;
      const int v = v0 + r;
      su[r][tx] = (u < n && x < w_words) ? g[(long long)u * w_words + x] : 0u;
      sv[r][tx] = (v < n && x < w_words) ? g[(long long)v * w_words + x] : 0u;
    }
    __syncthreads();
    if (v_word >= w0 && v_word < w0 + kTile) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) edges[i] = su[ty + kRows * i][v_word - w0];
    }
    const int wc = min(kTile, w_words - w0);
    for (int x = 0; x < wc; ++x) {
      const uint32_t pv = sv[tx][x];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        cn[i] += __popc(su[ty + kRows * i][x] & pv);
    }
    __syncthreads();
  }

  const int v = v0 + tx;
  if (v >= n) return;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int u = u0 + ty + kRows * i;
    if (u < n)
      out[(b * n + u) * (long long)n + v] = (edges[i] >> tx) & 1u ? cn[i] : 0;
  }
}

}  // namespace

// adj (B,N,N) bool, out (B,N,N) int32, scratch (B,N,ceil(N/32)) int32 for
// the packed rows.  Returns cudaGetLastError() after the two launches.
extern "C" int common_neighbors_launch(const void* adj, void* out,
                                       void* scratch, int batch, int n,
                                       void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int w_words = (n + 31) / 32;
  const long long rows = (long long)batch * n;
  const int warps = 8;
  cudaStream_t s = (cudaStream_t)stream;
  pack_rows_kernel<<<(unsigned)((rows + warps - 1) / warps), warps * 32, 0,
                     s>>>((const uint8_t*)adj, (uint32_t*)scratch, rows, n,
                          w_words);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n + kTile - 1) / kTile;
  const long long n_tiles = (long long)batch * tiles * tiles;
  common_neighbors_tile_kernel<<<(unsigned)n_tiles, dim3(kTile, kRows), 0,
                                 s>>>((const uint32_t*)scratch, (int32_t*)out,
                                      n, w_words, tiles);
  return (int)cudaGetLastError();
}
