// Bit-packed GF(2) boundary-matrix reduction for Hopper (sm_90a), bound to
// Python through ctypes.
//
// Replaces: src/repro/kernels/gf2_reduce.py::gf2_reduce_pallas (one packed
//   (S,W) matrix in VMEM) and ::gf2_reduce_batch_pallas (one complex per grid
//   step).  For each column j in order: l = low(col); while owner[l] >= 0,
//   col ^= column owner[l] and recompute l; then claim owner[l] = j, or mark
//   the column positive when it reduced to zero.  Returns the reduced matrix,
//   owner[n_rows] and positive[S], bit for bit as
//   repro.core.persistence_jax.reduce_packed.
//
// What bounds it on an H100: bytes, at the main path's blocks.  Each block is
//   read once and written once; the pivot chase does a data-dependent number
//   of W-word XORs, sequential over columns, which is latency rather than
//   throughput: one warp per block, many blocks per SM.
//
// Design: one launch covers every (graph, dimension block) pair of a batch:
//   grid = (graphs, blocks), one warp per CTA.  The pivot chase is sequential
//   over columns and parallel over the W words of a column: lane i owns words
//   i, i+32, ..., finds its highest set bit with __clz, and a warp max
//   (__reduce_max_sync) gives low.  Each lane only ever touches its own words
//   of every column, so the chase needs no barrier; owner[] is written by
//   lane 0 and published with __syncwarp.  The Pallas design keeps the whole
//   matrix in VMEM, which a 227 KB block cannot hold for large complexes, so
//   the per-dimension blocks are kept and a block is staged in shared memory
//   when it fits (S*W*4 + R*4 bytes) and reduced in place in its global output
//   buffer (L2-resident) otherwise; the choice is made here by size.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBlocks = 4;

struct Gf2Params {
  const uint32_t* src[kMaxBlocks];
  uint32_t* dst[kMaxBlocks];
  int* owner[kMaxBlocks];
  uint8_t* positive[kMaxBlocks];
  int s[kMaxBlocks];
  int w[kMaxBlocks];
  int r[kMaxBlocks];
  int in_smem[kMaxBlocks];
};

__global__ void gf2_reduce_kernel(Gf2Params p) {
  extern __shared__ uint32_t smem[];
  const long long g = blockIdx.x;
  const int d = blockIdx.y;
  const int lane = threadIdx.x;
  const int S = p.s[d];
  const int W = p.w[d];
  const int R = p.r[d];
  const long long words = (long long)S * W;
  const uint32_t* src = p.src[d] + g * words;
  uint32_t* dst = p.dst[d] + g * words;
  int* owner_out = p.owner[d] + g * R;
  uint8_t* pos = p.positive[d] + g * S;
  const bool staged = p.in_smem[d] != 0;
  uint32_t* m = staged ? smem : dst;
  int* owner = staged ? reinterpret_cast<int*>(smem + words) : owner_out;

  for (long long i = lane; i < words; i += 32) m[i] = src[i];
  for (int i = lane; i < R; i += 32) owner[i] = -1;
  __syncwarp();

  for (int j = 0; j < S; ++j) {
    uint32_t* col = m + (long long)j * W;
    int claimed = -1;
    while (true) {
      int best = -1;
      for (int x = lane; x < W; x += 32) {
        const uint32_t v = col[x];
        if (v) best = (x << 5) + 31 - __clz((int)v);
      }
      const int low = __reduce_max_sync(kFull, best);
      if (low < 0 || low >= R) break;  // zero column (rows >= R are never set)
      const int piv = owner[low];
      if (piv < 0) {
        claimed = low;
        break;
      }
      const uint32_t* pc = m + (long long)piv * W;
      for (int x = lane; x < W; x += 32) col[x] ^= pc[x];
    }
    if (lane == 0) {
      if (claimed >= 0) owner[claimed] = j;
      pos[j] = claimed < 0;
    }
    __syncwarp();
  }

  if (staged) {
    for (long long i = lane; i < words; i += 32) dst[i] = m[i];
    for (int i = lane; i < R; i += 32) owner_out[i] = owner[i];
  }
}

}  // namespace

// n_blocks (1..4) packed blocks, each (graphs, S_d, W_d) int32 bit patterns
// in src[d]; dst[d] the same shape for the reduced matrix, owner[d]
// (graphs, R_d) int32, positive[d] (graphs, S_d) bool.  Returns
// cudaGetLastError() after the launch.
extern "C" int gf2_reduce_launch(int n_blocks, int graphs,
                                 const void* const* src, void* const* dst,
                                 void* const* owner, void* const* positive,
                                 const int* s, const int* w, const int* r,
                                 void* stream) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks) return (int)cudaErrorInvalidValue;
  if (graphs <= 0) return 0;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  Gf2Params p = {};
  size_t smem = 0;
  for (int d = 0; d < n_blocks; ++d) {
    p.src[d] = (const uint32_t*)src[d];
    p.dst[d] = (uint32_t*)dst[d];
    p.owner[d] = (int*)owner[d];
    p.positive[d] = (uint8_t*)positive[d];
    p.s[d] = s[d];
    p.w[d] = w[d];
    p.r[d] = r[d];
    const size_t bytes = ((size_t)s[d] * w[d] + r[d]) * 4;
    p.in_smem[d] = bytes <= (size_t)optin;
    if (p.in_smem[d] && bytes > smem) smem = bytes;
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gf2_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(graphs, n_blocks);
  gf2_reduce_kernel<<<grid, 32, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
