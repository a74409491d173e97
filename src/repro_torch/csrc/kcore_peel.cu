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
// Design: a thread-block cluster of c CTAs per graph (c = 1, 2, 4 or 8, which
//   the wrapper derives from the batch, N and the SM count: 1 when the batch
//   fills the SMs, up to 8 when a few large graphs would leave them idle).
//   CTA r of a cluster owns the 32-vertex words [r*W/c, (r+1)*W/c) of the
//   graph's W = ceil(N/32) and packs only those rows, reading the bool
//   adjacency with 16-byte loads (16 vertices a lane, 512 bytes a warp load)
//   and joining the halves that two neighbouring lanes read into one word
//   with a shuffle.  The packed rows sit in shared memory at an odd pitch
//   (W or W + 1 words), so the pack's stores (consecutive words of a row)
//   and the sweep's loads (one row per lane) are both free of bank
//   conflicts, while they fit; past that they live in a global scratch
//   buffer, L2-resident, word-major.
//   Rows whose length is not a multiple of 16 bytes, or an adjacency that is
//   not 16-byte aligned, are packed a byte per lane with warp ballots.
//
//   Every CTA keeps the whole alive bit vector, triple-buffered.  Sweep s
//   reads buffer s%3, computes the new words of its own vertices (the words
//   of a row split over warps when the CTA has more warps than words, their
//   partial degrees summed through shared memory), stores each new word into
//   buffer (s+1)%3 of every CTA of the cluster through distributed shared
//   memory, and ends with one cluster barrier (release/acquire; a cluster of
//   one CTA stores locally and uses the CTA's own barrier).  Each CTA
//   then compares its old and new full vectors itself: all hold the same
//   words, so all reach the same stop decision without another exchange.
//   A third buffer lets that comparison read the old vector while a faster
//   peer already stores the next sweep's words: buffer (s+2)%3 was last read
//   before the barrier of sweep s.  No CTA stores into a peer after the last
//   barrier, so none can exit while a peer still writes into its memory.
//   `sweeps == 0` loops until the graph's mask stops changing, inside the
//   launch; extra sweeps on a converged graph change nothing, so the
//   per-graph fixpoint equals a batch-wide loop bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kUnroll = 4;      // 16-byte loads in flight per lane in the pack

// the per-CTA sizes of one launch, on the host and in the kernel
struct Layout {
  int w;          // words per row, ceil(n / 32)
  int pitch;      // words between packed rows in shared memory, odd
  int words_max;  // the most words one CTA of the cluster owns
  int rows_max;   // 32 * words_max
  int warps;      // warps per CTA
};

__host__ __device__ inline Layout layout(int n, int c) {
  Layout l;
  l.w = (n + 31) / 32;
  l.pitch = l.w | 1;
  l.words_max = (l.w + c - 1) / c;
  l.rows_max = 32 * l.words_max;
  // a warp per owned word for the sweep, and about four 16-word warp loads
  // per warp for the pack, at most 32 warps
  const int pack = (l.rows_max * l.w + 63) / 64;
  l.warps = l.words_max > pack ? l.words_max : pack;
  if (l.warps > 32) l.warps = 32;
  return l;
}

// the nonzero bytes of a 32-bit word as 4 bits (byte i -> bit i)
__device__ __forceinline__ uint32_t nibble(uint32_t v) {
  return ((__vcmpne4(v, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__global__ void __launch_bounds__(1024)
kcore_peel_kernel(const uint8_t* __restrict__ adj,
                  const uint8_t* __restrict__ alive_in,
                  uint8_t* __restrict__ alive_out,
                  uint32_t* __restrict__ scratch, int n, int k, int sweeps,
                  int rows_in_smem, int vec) {
  extern __shared__ uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const Layout l = layout(n, c);
  const int w = l.w;
  const int b = blockIdx.x / c;
  const int x0 = rank * w / c;
  const int lw = (rank + 1) * w / c - x0;  // words this CTA owns
  const int u0 = x0 << 5;
  const int nrows = max(min((x0 + lw) << 5, n) - u0, 0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  // packed row ul (of this CTA's rows), word x at rows[ul * su + x * sx]
  uint32_t* rows;
  size_t su, sx;
  if (rows_in_smem) {
    rows = smem;
    su = l.pitch;
    sx = 1;
  } else {
    rows = scratch + (size_t)blockIdx.x * l.rows_max * w;
    su = 1;
    sx = l.rows_max;
  }
  uint32_t* bits = rows_in_smem ? smem + (size_t)l.rows_max * l.pitch : smem;
  int* part = reinterpret_cast<int*>(bits + 3 * w);  // n_warps * 32 degrees

  // pack this CTA's rows: item it = (row ul, word x), ul-major
  const uint8_t* a = adj + ((size_t)b * n + u0) * n;
  const int items = nrows * w;
  if (vec) {
    // lanes 2i and 2i+1 read columns 32x .. 32x+15 and 32x+16 .. 32x+31
    for (int base = warp * 16 * kUnroll; base < items;
         base += n_warps * 16 * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int it = base + j * 16 + (lane >> 1);
        v[j] = make_uint4(0u, 0u, 0u, 0u);
        if (it < items) {
          const int ul = it / w;
          const int col = ((it - ul * w) << 5) + ((lane & 1) << 4);
          if (col < n)
            v[j] = __ldg(reinterpret_cast<const uint4*>(
                a + (size_t)ul * n + col));
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const uint32_t half = nibble(v[j].x) | nibble(v[j].y) << 4 |
                              nibble(v[j].z) << 8 | nibble(v[j].w) << 12;
        const uint32_t hi = __shfl_down_sync(kFull, half, 1);
        const int it = base + j * 16 + (lane >> 1);
        if (!(lane & 1) && it < items) {
          const int ul = it / w;
          rows[ul * su + (it - ul * w) * sx] = half | hi << 16;
        }
      }
    }
  } else {
    // a byte per lane, a warp ballot per word
    for (int it = warp; it < items; it += n_warps) {
      const int ul = it / w;
      const int x = it - ul * w;
      const int col = (x << 5) + lane;
      const bool bit = col < n && a[(size_t)ul * n + col] != 0;
      const uint32_t word = __ballot_sync(kFull, bit);
      if (lane == 0) rows[ul * su + x * sx] = word;
    }
  }
  // the whole alive vector into buffer 0, in every CTA
  for (int x = warp; x < w; x += n_warps) {
    const int col = (x << 5) + lane;
    const bool bit = col < n && alive_in[(size_t)b * n + col] != 0;
    const uint32_t word = __ballot_sync(kFull, bit);
    if (lane == 0) bits[x] = word;
  }
  // a cluster barrier, or the CTA's own where the cluster is one CTA
  auto sync = [&] {
    if (c > 1)
      cluster.sync();
    else
      __syncthreads();
  };
  // rows and buffer 0 ready; every peer has started before any remote store
  sync();

  // warp t of the sweep takes owned word t % lw and the word slice t / lw of
  // its row; with groups == 1 it also publishes the word
  const int groups = lw > 0 ? max(1, min(n_warps / lw, w)) : 1;
  int cur = 0;
  for (int s = 0; sweeps == 0 || s < sweeps; ++s) {
    const uint32_t* alive = bits + cur * w;
    const int nxt = cur == 2 ? 0 : cur + 1;
    uint32_t* next = bits + nxt * w;
    auto publish = [&](int xl, int deg) {
      const uint32_t old = alive[x0 + xl];
      const uint32_t word = __ballot_sync(kFull, ((old >> lane) & 1u) &&
                                                     deg >= k);
      if (c == 1) {
        if (lane == 0) next[x0 + xl] = word;
      } else if (lane < c) {
        cluster.map_shared_rank(next, lane)[x0 + xl] = word;
      }
    };
    for (int t = warp; t < lw * groups; t += n_warps) {
      const int xl = t % lw;
      const int p = t / lw;
      const int ul = (xl << 5) + lane;
      int deg = 0;
      if (ul < nrows && ((alive[x0 + xl] >> lane) & 1u)) {
        const int y1 = (p + 1) * w / groups;
        for (int y = p * w / groups; y < y1; ++y)
          deg += __popc(rows[ul * su + y * sx] & alive[y]);
      }
      if (groups == 1)
        publish(xl, deg);
      else
        part[t * 32 + lane] = deg;
    }
    if (groups > 1) {
      __syncthreads();
      for (int xl = warp; xl < lw; xl += n_warps) {
        int deg = 0;
        for (int p = 0; p < groups; ++p) deg += part[(p * lw + xl) * 32 + lane];
        publish(xl, deg);
      }
    }
    sync();
    bool changed = false;
    for (int x = lane; x < w; x += 32) changed |= alive[x] != next[x];
    cur = nxt;
    if (!__any_sync(kFull, changed)) break;
  }

  const uint32_t* fin = bits + cur * w;
  for (int ul = threadIdx.x; ul < nrows; ul += blockDim.x) {
    const int u = u0 + ul;
    alive_out[(size_t)b * n + u] = (fin[u >> 5] >> (u & 31)) & 1u;
  }
}

// shared memory of one CTA: packed rows (when in shared memory), the three
// alive buffers and the partial degrees
size_t smem_bytes(const Layout& l, bool with_rows) {
  return (with_rows ? (size_t)l.rows_max * l.pitch * 4 : 0) +
         (size_t)3 * l.w * 4 + (size_t)l.warps * 32 * 4;
}

bool rows_fit(const Layout& l) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return smem_bytes(l, true) <= (size_t)optin;
}

bool valid_cluster(int c) {
  return c >= 1 && c <= kMaxCluster && (c & (c - 1)) == 0;
}

}  // namespace

// int32 words of global scratch the launch needs: 0 when every CTA's packed
// rows fit in shared memory, else batch * cluster * rows_max * W.
extern "C" long long kcore_peel_scratch_words(int batch, int n, int cluster) {
  if (batch <= 0 || n <= 0 || !valid_cluster(cluster)) return 0;
  const Layout l = layout(n, cluster);
  if (rows_fit(l)) return 0;
  return (long long)batch * cluster * l.rows_max * l.w;
}

// adj (B,N,N) bool, alive_in/alive_out (B,N) bool; scratch holds
// kcore_peel_scratch_words(B, N, cluster) int32 words (may be null when that
// is 0).  sweeps = 0 runs to each graph's fixpoint.  cluster: CTAs per graph,
// 1, 2, 4 or 8.  Returns the launch's error, or cudaGetLastError() after it.
extern "C" int kcore_peel_launch(const void* adj, const void* alive_in,
                                 void* alive_out, void* scratch, int batch,
                                 int n, int k, int sweeps, int cluster,
                                 void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (!valid_cluster(cluster)) return (int)cudaErrorInvalidValue;
  const Layout l = layout(n, cluster);
  const int rows_in_smem = rows_fit(l);
  if (!rows_in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int vec = n % 16 == 0 && ((uintptr_t)adj & 15) == 0;
  const size_t smem = smem_bytes(l, rows_in_smem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kcore_peel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)batch * cluster);
  cfg.blockDim = dim3(32 * l.warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kcore_peel_kernel, (const uint8_t*)adj, (const uint8_t*)alive_in,
      (uint8_t*)alive_out, (uint32_t*)scratch, n, k, sweeps, rows_in_smem,
      vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
