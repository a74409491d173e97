// Common-neighbor counts on edges, and the clustering coefficients' row
// sums fused into the same launch, for Hopper (sm_90a), bound to Python
// through ctypes.
//
// Replaces: src/repro/kernels/common_neighbors.py::common_neighbors_pallas,
//   cn[b,u,v] = A[u,v] * |N(u) ∩ N(v)| = ((A @ A) ⊙ A)[u,v],
//   which the TPU kernel computes as a tiled f32 MXU matmul with the edge
//   mask fused into the epilogue, and the sums that
//   repro/kernels/ops.py::clustering_coefficients takes of it.
//
// The algebra: both operands are rows of A (A is taken to be symmetric), so
//   G[u,v] = sum_w A[u,w] A[v,w] and cn[u,v] = A[u,v] G[u,v].  With the
//   live mask m, the clustering path restricts A to live vertices first;
//   m[w] enters one operand only (m[w]^2 = m[w]) and m[u] m[v] factor out:
//     tri2[u] = sum_v A[u,v] m[u] m[v] G'[u,v],
//     G'[u,v] = sum_w (A[u,w] m[w]) A[v,w],
//     deg[u]  = m[u] sum_w A[u,w] m[w].
//   The sums of 0/1 bytes are an int8 tensor-core product with int32 sums:
//   exact.  Bool bytes are 0 or 1, so the staged adjacency is the int8
//   operand as it is.
//
// What bounds it on an H100: the bytes, 3.35 TB/s.  The cn epilogue reads
//   adj once (B*N^2 bytes) and writes the int32 counts once (4*B*N^2); the
//   fused epilogue reads adj and the mask and writes two (B, N) int32
//   vectors.  A count is needed on edges only, one inner product of N
//   products per unordered edge: far below the bytes' time.  The dense
//   Gram the kernel issues, B*N^2*(N+1) int8 operations (G is symmetric;
//   1,979e12/s), takes less than the bytes at every size of the main path
//   but the fused form at Table 1's 16x1024x1024 (1.7x their time).
//
// Design: one launch, no scratch, 8 warps a CTA, two CTAs an SM, the work
//   mappings of csrc/domination.cu (kernels/common_neighbors.py::layout
//   takes kernels/domination.py::layout's).  Rows of adj go straight to
//   shared memory with 16-byte cp.async copies (a byte path where N is not
//   a multiple of 16), rows padded by 16 bytes so that ldmatrix's 8 row
//   addresses hit 8 distinct 16-byte bank groups; ragged u, v and K edges
//   stage as zero bytes.  Each warp computes a 32 x 64 tile of G with
//   mma.sync.m16n8k32.s8 fed by ldmatrix: both operands are rows of adj,
//   which is what .row.col wants, so nothing is transposed.  The edge bit
//   A[u,v] of each accumulator is read from the staged u rows.  Two
//   epilogues behind one kernel template:
//   * cn: the counts where the edge bit is set go to an int32 tile in
//     shared memory, stored 16 bytes a thread, coalesced;
//   * sums: the mask is ANDed into the A fragments in registers and deg[u]
//     is one more mma of them against ones; each warp reduces its tile's
//     rows (and, for a mirrored tile pair, its columns) by shuffles into
//     shared-memory sums, and no (B, N, N) tensor is written.
//   Two work mappings:
//   * graph (padded N <= 128, one tile a graph): persistent CTAs stage
//     groups of whole graphs (4 at n64) once, the next group's copies in
//     flight meanwhile; a warp computes one 32 x 64 tile of one graph, and
//     the CTA stores the group's counts or sums;
//   * tile (above 128): a CTA takes one unordered (graph, u tile, v tile)
//     pair of 128 x 128 and streams K through a 3-stage ring of 128-byte
//     chunks; the edge bits are taken while chunk iv (the v tile's
//     columns) is staged.  G is symmetric, so it computes each unordered
//     tile pair once and writes both halves: cn[u,v] and cn[v,u] (the
//     mirrored block staged in turn in the freed ring), or the row sums of
//     the u tile and the column sums of the v tile, added into the zeroed
//     tri2 with int32 atomicAdd (integer sums are order-free: the result is
//     deterministic).  deg comes from the diagonal pair of each tile.
//   What holds it back: mma.sync runs at about half the tensor cores' rate
//   (wgmma is the next step), and the staging, epilogue and barrier phases
//   of a CTA's 8 warps do not overlap its mma.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 128;        // rows of a u or v tile (tile mapping)
constexpr int kGraphMaxNp = 128;  // the graph mapping's largest padded N
constexpr int kChunk = 128;  // K bytes a ring stage holds (tile mapping)
constexpr int kStages = 3;
constexpr int kPad = 16;  // bytes past every staged row
// int32 past every staged output row: a pitch of 8 mod 32 words lets a
// warp's 64-bit fragment stores hit distinct banks, one of 4 mod 32 its
// transposed 32-bit stores (the mirrored block)
constexpr int kOutPad = 8;
constexpr int kOutPadT = 4;
constexpr int kSmemMax = 232448;  // 227 KB, a block's limit on sm_90
constexpr uint32_t kOnes = 0x01010101u;  // four int8 ones
constexpr unsigned kFull = 0xffffffffu;
static_assert(kChunk == kTile, "chunk iv holds the v tile's columns");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16 mask bytes of graph b at columns c0..c0+15, zeros past N and for
// a graph past the batch (!graph_ok).
template <bool kVec>
__device__ __forceinline__ uint4 mask16(const uint8_t* __restrict__ mask,
                                        long long b, bool graph_ok, int c0,
                                        int n) {
  if (!graph_ok || c0 >= n) return make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kVec)
    return __ldg(reinterpret_cast<const uint4*>(mask + b * n + c0));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (c0 + j < n && mask[b * n + c0 + j] != 0)
      w[j >> 2] |= 1u << ((j & 3) * 8);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Threads laid over rows of `pieces` 16-byte pieces: 2^lg lanes a row (the
// least power of two >= pieces), `pass` rows at a time; the thread takes
// piece `piece` of row `row` of each pass (none where piece >= pieces).
// Shifts only: no division.
struct RowMap {
  int lg, pass, row, piece;
};

__device__ __forceinline__ RowMap row_map(int pieces) {
  int lg = 0;
  while ((1 << lg) < pieces) ++lg;
  return {lg, kThreads >> lg, (int)threadIdx.x >> lg,
          (int)threadIdx.x & ((1 << lg) - 1)};
}

// Stages the 16 bytes of row u (graph-local) of graph b at columns
// c0..c0+15 to dst: a cp.async copy of the raw bytes (kVec) or byte loads;
// zeros past N and for a graph past the batch.
template <bool kVec>
__device__ __forceinline__ void stage_piece(uint8_t* dst,
                                            const uint8_t* __restrict__ adj,
                                            long long b, bool graph_ok, int u,
                                            int c0, int n) {
  const bool valid = graph_ok && u < n && c0 < n;
  if constexpr (kVec) {
    if (valid)
      cp_async16(dst, adj + ((b * n + u) * (long long)n + c0));
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (valid) {
      const uint8_t* row = adj + (b * n + u) * (long long)n;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (c0 + j < n && row[c0 + j] != 0) w[j >> 2] |= 1u << ((j & 3) * 8);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One warp over ksteps * 32 staged columns: acc += A . B^T for its 32 u
// rows and 32 or 64 v rows; with kSums the A fragments are masked and du
// += their row sums (deg, an mma against ones).  a, b point at each set's
// first staged row, rows `pitch` apart; smask at the mask byte of the
// range's first column (kSums).
template <bool kSums>
__device__ __forceinline__ void warp_gram(int (&acc)[2][8][4],
                                          int (&du)[2][4], const uint8_t* a,
                                          const uint8_t* b, int pitch,
                                          const uint8_t* smask, int ksteps,
                                          bool two, int lane) {
  // 32-bit shared addresses of this lane's rows (ldmatrix's layout)
  const uint32_t pa = smem_addr(a + (lane & 15) * pitch + (lane >> 4) * 16);
  const uint32_t pb = smem_addr(b + ((lane & 7) + ((lane >> 4) << 3)) * pitch +
                                ((lane >> 3) & 1) * 16);
  const uint32_t pm = kSums ? smem_addr(smask + (lane & 3) * 4) : 0u;
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ++ks) {
    // loads run one step ahead of the mma that uses them
    const int kk = ks * 32;
    uint32_t af[2][4], bf[2][4];
    ldmatrix_x4(af[0], pa + kk);
    ldmatrix_x4(af[1], pa + 16 * pitch + kk);
    ldmatrix_x4(bf[0], pb + kk);
    if constexpr (kSums) {
      const uint32_t m0 = lds32(pm + kk), m1 = lds32(pm + kk + 16);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        af[mi][0] &= m0;
        af[mi][1] &= m0;
        af[mi][2] &= m1;
        af[mi][3] &= m1;
      }
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      if (nj >= 2 && !two) break;
      if (nj < 3 && (nj < 1 || two))
        ldmatrix_x4(bf[(nj + 1) & 1], pb + (nj + 1) * 16 * pitch + kk);
      if (kSums && nj == 0) {
        mma_s8(du[0], af[0], kOnes, kOnes);
        mma_s8(du[1], af[1], kOnes, kOnes);
      }
      const uint32_t(&b)[4] = bf[nj & 1];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_s8(acc[mi][2 * nj], af[mi], b[0], b[1]);
        mma_s8(acc[mi][2 * nj + 1], af[mi], b[2], b[3]);
      }
    }
  }
}

// The edge bits of a warp tile: bit ((mi * 2 + h) * 8 + ni) * 2 + j is the
// staged byte A[u,v] at the accumulator's position (row mi*16 + h*8 + g,
// column ni*8 + 2t + j) of lane (g, t); e points at the tile's first
// staged row and column, rows `pitch` apart.
__device__ __forceinline__ uint64_t edge_bits(const uint8_t* e, int pitch,
                                              bool two, int lane) {
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  uint64_t bits = 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint8_t* row = e + (mi * 16 + h * 8 + g) * pitch + t2;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        if (ni >= 4 && !two) break;
        const uint32_t x = *reinterpret_cast<const uint16_t*>(row + ni * 8);
        const uint64_t two_bits = ((x & 0xffu) != 0) | (((x >> 8) != 0) << 1);
        bits |= two_bits << (((mi * 2 + h) * 8 + ni) * 2);
      }
    }
  }
  return bits;
}

// The cn epilogue of a warp tile: the counts where the edge bit is set,
// to o (the tile's first staged output, rows op int32 apart) at (r, c), or
// at (c, r) for the mirrored block (kT).
template <bool kT>
__device__ __forceinline__ void cn_epilogue(const int (&acc)[2][8][4],
                                            uint64_t e, bool two, int lane,
                                            int* o, int op) {
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mi * 16 + h * 8 + g;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        if (ni >= 4 && !two) break;
        const int c = ni * 8 + t2, bit = ((mi * 2 + h) * 8 + ni) * 2;
        const int x0 = (e >> bit) & 1 ? acc[mi][ni][2 * h] : 0;
        const int x1 = (e >> (bit + 1)) & 1 ? acc[mi][ni][2 * h + 1] : 0;
        if constexpr (kT) {
          o[c * op + r] = x0;
          o[(c + 1) * op + r] = x1;
        } else {
          *reinterpret_cast<int2*>(o + r * op + c) = make_int2(x0, x1);
        }
      }
    }
  }
}

// The sums epilogue of a warp tile: rows[r] += live[u] sum_c e live[v] G
// over the tile's row r, and, where cols is given (kCols: the mirrored
// block of an off-diagonal tile pair), cols[c] += live[v] sum_r e live[u]
// G over its column c; lu and lv are the live bytes of the tile's rows
// and columns.  The quad's 4 lanes share a row, the 8 g lanes a column:
// both are reduced by shuffles, then added into shared memory.
template <bool kCols>
__device__ __forceinline__ void sums_epilogue(const int (&acc)[2][8][4],
                                              uint64_t e, bool two, int lane,
                                              const uint8_t* lu,
                                              const uint8_t* lv, int* rows,
                                              int* cols) {
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  int col[8][2] = {};
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mi * 16 + h * 8 + g;
      const bool live_u = lu[r] != 0;
      int rs = 0;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        if (ni >= 4 && !two) break;
        const int c = ni * 8 + t2, bit = ((mi * 2 + h) * 8 + ni) * 2;
        const uint32_t l = *reinterpret_cast<const uint16_t*>(lv + c);
        const int x0 = (e >> bit) & 1 ? acc[mi][ni][2 * h] : 0;
        const int x1 = (e >> (bit + 1)) & 1 ? acc[mi][ni][2 * h + 1] : 0;
        rs += ((l & 0xffu) ? x0 : 0) + ((l >> 8) ? x1 : 0);
        if (kCols && live_u) {
          col[ni][0] += x0;
          col[ni][1] += x1;
        }
      }
      rs += __shfl_xor_sync(kFull, rs, 1);
      rs += __shfl_xor_sync(kFull, rs, 2);
      if ((lane & 3) == 0 && live_u && rs != 0) atomicAdd(rows + r, rs);
    }
  }
  if (!kCols || cols == nullptr) return;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    if (ni >= 4 && !two) break;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int x = col[ni][j];
      x += __shfl_xor_sync(kFull, x, 4);
      x += __shfl_xor_sync(kFull, x, 8);
      x += __shfl_xor_sync(kFull, x, 16);
      const int c = ni * 8 + t2 + j;
      if (g == 0 && lv[c] != 0 && x != 0) atomicAdd(cols + c, x);
    }
  }
}

// deg of a warp tile's 32 rows (the quad's lanes hold the same du) to
// degs[r], 0 for a dead row.
__device__ __forceinline__ void deg_epilogue(const int (&du)[2][4], int lane,
                                             const uint8_t* lu, int* degs) {
  if ((lane & 3) != 0) return;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mi * 16 + h * 8 + (lane >> 2);
      degs[r] = lu[r] != 0 ? du[mi][2 * h] : 0;
    }
}

// Copies rows x cols staged int32 (rows op apart) to out (rows n apart).
template <bool kVec>
__device__ __forceinline__ void store_block(const int* src, int op,
                                            int* __restrict__ dst, int rows,
                                            int cols, int n) {
  if constexpr (kVec) {  // cols % 4 == 0: 16 bytes a thread
    const RowMap rm = row_map(cols >> 2);
    if (rm.piece >= (cols >> 2)) return;
    const int c = rm.piece << 2;
    for (int r = rm.row; r < rows; r += rm.pass)
      *reinterpret_cast<int4*>(dst + (long long)r * n + c) =
          *reinterpret_cast<const int4*>(src + r * op + c);
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      dst[(long long)r * n + c] = src[r * op + c];
    }
  }
}

// Unordered tile pair p (iu <= iv) of a graph of `tiles` tiles a side.
__device__ __forceinline__ void pair_of(int p, int tiles, int& iu, int& iv) {
  iu = 0;
  int row = tiles;
  while (p >= row) {
    p -= row;
    ++iu;
    --row;
  }
  iv = iu + p;
}

// Graph mapping (np <= kGraphMaxNp: one tile covers a graph): a persistent
// CTA takes groups of gpc graphs (group x holds graphs x*gpc ..
// x*gpc+gpc-1) blockIdx.x, blockIdx.x + gridDim.x, ...  It stages a group
// whole (np raw rows of each graph, and its mask for kSums) while the
// previous group computes, two buffers in turn; each warp takes one 32 x
// 64 warp tile.  out is cn (B,N,N), or tri2 (B,N) beside deg (kSums).
template <bool kSums, bool kVec>
__device__ void graph_mapping(uint8_t* sm, const uint8_t* __restrict__ adj,
                              const uint8_t* __restrict__ mask,
                              int* __restrict__ out, int* __restrict__ deg,
                              int batch, int n, int np, int gpc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pitch = np + kPad, op = np + kOutPad;
  const int in_bytes = gpc * np * pitch, buf_bytes = in_bytes + gpc * np;
  int* outs = reinterpret_cast<int*>(sm + 2 * buf_bytes);  // counts or sums
  const long long groups = ((long long)batch + gpc - 1) / gpc;
  const int per_row = np >> 4;
  const RowMap rm = row_map(per_row);
  const int c0 = rm.piece << 4;
  // this warp's tile: graph s of the group, rows ra.., columns rv..
  const int rbs = np >> 5, cbs = (np + 63) >> 6;
  const bool mine = warp < gpc * rbs * cbs;  // <= 8 warp tiles
  const int s = mine ? warp / (rbs * cbs) : 0;
  const int r = mine ? warp - s * rbs * cbs : 0;
  const int rb = r / cbs, cb = r - rb * cbs;
  const int ra = rb * 32, rv = cb * 64;
  const bool two = rv + 32 < np;

  auto issue = [&](long long grp, int buf) {
    uint8_t* in = sm + buf * buf_bytes;
    const long long b0 = grp * gpc;
    for (int t = 0; t < gpc; ++t) {
      const bool ok = b0 + t < batch;
      if (kSums && tid < per_row) {
        uint8_t* dst = in + in_bytes + t * np + (tid << 4);
        if (kVec && ok && (tid << 4) < n)
          cp_async16(dst, mask + (b0 + t) * n + (tid << 4));
        else
          *reinterpret_cast<uint4*>(dst) =
              mask16<kVec>(mask, b0 + t, ok, tid << 4, n);
      }
      if (rm.piece < per_row)
        for (int u = rm.row; u < np; u += rm.pass)
          stage_piece<kVec>(in + (t * np + u) * pitch + c0, adj, b0 + t, ok,
                            u, c0, n);
    }
  };

  if constexpr (kSums)
    for (int i = tid; i < 2 * gpc * np; i += kThreads) outs[i] = 0;
  long long grp = blockIdx.x;
  if (grp < groups) issue(grp, 0);
  cp_async_commit();
  for (int it = 0; grp < groups; ++it, grp += gridDim.x) {
    const int buf = it & 1;
    // the other buffer's last reader passed the previous group's barrier
    if (grp + gridDim.x < groups) issue(grp + gridDim.x, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // the group's rows (and masks) have landed
    const uint8_t* in = sm + buf * buf_bytes;
    const uint8_t* rows = in + (s * np + ra) * pitch;
    const uint8_t* live = in + in_bytes + s * np;
    if (mine) {
      int acc[2][8][4] = {}, du[2][4] = {};
      warp_gram<kSums>(acc, du, rows, in + (s * np + rv) * pitch, pitch, live,
                       np >> 5, two, lane);
      const uint64_t e = edge_bits(rows + rv, pitch, two, lane);
      if constexpr (kSums) {
        sums_epilogue<false>(acc, e, two, lane, live + ra, live + rv,
                             outs + s * np + ra, nullptr);
        if (cb == 0)
          deg_epilogue(du, lane, live + ra, outs + (gpc + s) * np + ra);
      } else {
        cn_epilogue<false>(acc, e, two, lane, outs + (s * np + ra) * op + rv,
                           op);
      }
    }
    __syncthreads();
    const long long b0 = grp * gpc;
    const int cnt = (int)min((long long)gpc, batch - b0);
    if constexpr (kSums) {
      // each sum is zeroed by its reader for the next group (the sums of
      // dead rows, padding rows and graphs past the batch stay 0)
      for (int i = tid; i < cnt * n; i += kThreads) {
        const int t = i / n, u = i - t * n;
        out[b0 * n + i] = outs[t * np + u];
        deg[b0 * n + i] = outs[(gpc + t) * np + u];
        outs[t * np + u] = outs[(gpc + t) * np + u] = 0;
      }
    } else {
      for (int t = 0; t < cnt; ++t)
        store_block<kVec>(outs + t * np * op, op,
                          out + (b0 + t) * n * (long long)n, n, n, n);
    }
    __syncthreads();
  }
}

// Tile mapping: CTA x takes unordered tile pair x % pairs of graph
// x / pairs and streams the u and v tiles' raw rows through the ring, a
// kChunk-byte slice of each row a stage.
template <bool kSums, bool kVec>
__device__ void tile_mapping(uint8_t* sm, const uint8_t* __restrict__ adj,
                             const uint8_t* __restrict__ mask,
                             int* __restrict__ out, int* __restrict__ deg,
                             int n, int np) {
  constexpr int tile = kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (np + tile - 1) / tile;
  const int pairs = tiles * (tiles + 1) / 2;
  const long long b = blockIdx.x / pairs;
  int iu, iv;
  pair_of((int)(blockIdx.x - b * pairs), tiles, iu, iv);
  const bool same = iu == iv;
  const int pitch = kChunk + kPad;
  const int stage_bytes = 2 * tile * pitch;
  const int ring = kStages * stage_bytes;
  // kSums: the u tile's row sums, then the v tile's column sums (or, in a
  // diagonal pair, the u tile's deg), then the graph's mask, zeros past N
  int* red = reinterpret_cast<int*>(sm + ring);
  uint8_t* smask = sm + ring + 8 * tile;
  const int rows = same ? tile : 2 * tile;  // staged: u tile, then v tile
  // 32 bytes of a row a thread: kChunk / 32 = 4 lanes a row, 64 rows a pass
  constexpr int kLg = 2;
  static_assert((32 << kLg) == kChunk, "4 lanes cover a chunk's row");
  constexpr int kPass = kThreads >> kLg;
  const int row0 = tid >> kLg, c = (tid & ((1 << kLg) - 1)) << 5;
  const int nk = (np + kChunk - 1) / kChunk;

  auto vertex = [&](int r) {  // graph-local vertex of staged row r
    return r < tile ? iu * tile + r : iv * tile + r - tile;
  };
  auto stage = [&](int k) {
    uint8_t* st = sm + (k % kStages) * stage_bytes;
#pragma unroll
    for (int j = 0; j < 2 * kTile / kPass; ++j) {
      const int r = row0 + j * kPass;
      if (r < rows) {
        uint8_t* dst = st + r * pitch + c;
        const int u = vertex(r), col = k * kChunk + c;
        if (kVec && u < n && col < n) {  // N % 16 == 0: halves are whole
          const uint8_t* src = adj + ((b * n + u) * (long long)n + col);
          cp_async16(dst, src);
          if (col + 16 < n)
            cp_async16(dst + 16, src + 16);
          else
            *reinterpret_cast<uint4*>(dst + 16) = make_uint4(0u, 0u, 0u, 0u);
        } else {
          stage_piece<kVec>(dst, adj, b, true, u, col, n);
          stage_piece<kVec>(dst + 16, adj, b, true, u, col + 16, n);
        }
      }
    }
  };
  const int tu = min(tile, np - iu * tile), tv = min(tile, np - iv * tile);
  const int rbs = tu >> 5, cbs = (tv + 63) >> 6;
  const bool mine = warp < rbs * cbs;  // one warp tile a warp (<= 8)
  const int rb = mine ? warp / cbs : 0, cb = mine ? warp - rb * cbs : 0;
  const bool two = cb * 64 + 32 < tv;
  const int row_b = (same ? 0 : tile) + cb * 64;
  int acc[2][8][4] = {}, du[2][4] = {};
  uint64_t e = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) stage(s);
    cp_async_commit();
  }
  // while the first chunks are in flight (the loop's barrier orders it)
  if constexpr (kSums) {
    for (int i = tid; i < 2 * tile; i += kThreads) red[i] = 0;
    for (int i = tid; i < (np >> 4); i += kThreads)
      *reinterpret_cast<uint4*>(smask + (i << 4)) =
          mask16<kVec>(mask, b, true, i << 4, n);
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk k is whole; chunk k-1's stage is free
    if (k + kStages - 1 < nk) stage(k + kStages - 1);
    cp_async_commit();
    const uint8_t* st = sm + (k % kStages) * stage_bytes;
    if (mine) {
      warp_gram<kSums>(acc, du, st + rb * 32 * pitch, st + row_b * pitch,
                       pitch, smask + k * kChunk,
                       min(kChunk, np - k * kChunk) >> 5, two, lane);
      if (k == iv)  // this chunk holds the v tile's columns
        e = edge_bits(st + rb * 32 * pitch + cb * 64, pitch, two, lane);
    }
  }
  const int u0 = iu * tile, v0 = iv * tile;
  if constexpr (kSums) {
    if (mine) {
      const uint8_t* lu = smask + u0 + rb * 32;
      sums_epilogue<true>(acc, e, two, lane, lu, smask + v0 + cb * 64,
                          red + rb * 32, same ? nullptr : red + tile + cb * 64);
      if (same && cb == 0) deg_epilogue(du, lane, lu, red + tile + rb * 32);
    }
    __syncthreads();  // the CTA's sums are whole
    int* tri = out + b * n;
    if (tid < tile) {
      if (u0 + tid < n && red[tid] != 0) atomicAdd(tri + u0 + tid, red[tid]);
    } else if (tid < 2 * tile) {
      const int i = tid - tile;
      if (same) {
        if (u0 + i < n) deg[b * n + u0 + i] = red[tile + i];
      } else if (v0 + i < n && red[tile + i] != 0) {
        atomicAdd(tri + v0 + i, red[tile + i]);
      }
    }
  } else {
    int* o = reinterpret_cast<int*>(sm);  // the ring is free for the output
    int* g = out + b * n * (long long)n;
    constexpr int op = tile + kOutPad, opt = tile + kOutPadT;
    __syncthreads();  // every warp is past the ring
    if (mine)
      cn_epilogue<false>(acc, e, two, lane, o + rb * 32 * op + cb * 64, op);
    __syncthreads();
    store_block<kVec>(o, op, g + (long long)u0 * n + v0, min(tile, n - u0),
                      min(tile, n - v0), n);
    if (!same) {  // the mirrored block, in the same buffer in turn
      __syncthreads();
      if (mine)
        cn_epilogue<true>(acc, e, two, lane, o + cb * 64 * opt + rb * 32, opt);
      __syncthreads();
      store_block<kVec>(o, opt, g + (long long)v0 * n + u0, min(tile, n - v0),
                        min(tile, n - u0), n);
    }
  }
}

template <bool kSums, bool kTileMapping, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    common_neighbors_gram_kernel(const uint8_t* __restrict__ adj,
                                 const uint8_t* __restrict__ mask,
                                 int* __restrict__ out, int* __restrict__ deg,
                                 int batch, int n, int gpc) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int np = (n + 31) & ~31;
  if constexpr (kTileMapping)
    tile_mapping<kSums, kVec>(sm, adj, mask, out, deg, n, np);
  else
    graph_mapping<kSums, kVec>(sm, adj, mask, out, deg, batch, n, np, gpc);
}

template <bool kSums, bool kTileMapping, bool kVec>
int launch(const void* adj, const void* mask, void* out, void* deg, int batch,
           int n, int gpc, long long ctas, int smem, cudaStream_t s) {
  static int smem_set = 48 * 1024;  // the default dynamic limit
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        common_neighbors_gram_kernel<kSums, kTileMapping, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    smem_set = kSmemMax;
  }
  common_neighbors_gram_kernel<kSums, kTileMapping, kVec>
      <<<(unsigned)ctas, kThreads, smem, s>>>(
          (const uint8_t*)adj, (const uint8_t*)mask, (int*)out, (int*)deg,
          batch, n, gpc);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of a launch (kernels/common_neighbors.py::smem_bytes
// computes the same): the graph mapping at padded N <= kGraphMaxNp (two
// group buffers of gpc graphs' rows and masks, then the group's int32
// counts, or its tri2 and deg with sums), else the tile mapping (gpc 1:
// the ring, which the counts reuse, or the ring, the two tiles' sums and
// the graph's mask); -1 for a layout the kernel does not take.
extern "C" long long common_neighbors_smem_bytes(int n, int gpc, int sums) {
  const int np = (n + 31) & ~31;
  if (n <= 0 || gpc < 1) return -1;
  long long bytes;
  if (np <= kGraphMaxNp) {
    if (gpc * (np >> 5) * ((np + 63) >> 6) > kWarps) return -1;
    bytes = 2LL * gpc * np * (np + kPad + 1) +
            (sums ? 8LL * gpc * np : 4LL * gpc * np * (np + kOutPad));
  } else {
    if (gpc != 1) return -1;
    const long long ring = (long long)kStages * 2 * kTile * (kChunk + kPad);
    bytes = sums ? ring + 8LL * kTile + np : ring;
  }
  return bytes <= kSmemMax ? bytes : -1;
}

namespace {

template <bool kSums>
int dispatch(const void* adj, const void* mask, void* out, void* deg,
             int batch, int n, int gpc, int ctas, int smem, cudaStream_t s) {
  if (batch <= 0 || n <= 0) return 0;
  if (common_neighbors_smem_bytes(n, gpc, kSums) != smem)
    return (int)cudaErrorInvalidValue;
  const int np = (n + 31) & ~31;
  const bool graph = np <= kGraphMaxNp;
  const int tiles = (np + kTile - 1) / kTile;
  const long long most = graph ? ((long long)batch + gpc - 1) / gpc
                               : (long long)batch * (tiles * (tiles + 1) / 2);
  if (ctas < 1 || ctas > most || (!graph && ctas != most))
    return (int)cudaErrorInvalidValue;
  const bool vec = n % 16 == 0 && ((uintptr_t)adj | (uintptr_t)mask |
                                   (uintptr_t)out | (uintptr_t)deg) %
                                          16 == 0;
  if (graph)
    return vec ? launch<kSums, false, true>(adj, mask, out, deg, batch, n,
                                            gpc, ctas, smem, s)
               : launch<kSums, false, false>(adj, mask, out, deg, batch, n,
                                             gpc, ctas, smem, s);
  return vec ? launch<kSums, true, true>(adj, mask, out, deg, batch, n, gpc,
                                         ctas, smem, s)
             : launch<kSums, true, false>(adj, mask, out, deg, batch, n, gpc,
                                          ctas, smem, s);
}

}  // namespace

// adj (B,N,N) bool -> out (B,N,N) int32, cn[b,u,v] = A[u,v] |N(u) ∩ N(v)|.
// At padded N <= kGraphMaxNp the graph mapping (gpc graphs a group, ctas
// persistent CTAs), above it the tile mapping (gpc 1, ctas B times the
// unordered pairs of 128-row tiles); smem must equal
// common_neighbors_smem_bytes(n, gpc, 0).  One launch; returns
// cudaGetLastError() after it (cudaErrorInvalidValue for a layout the
// kernel does not take).
extern "C" int common_neighbors_launch(const void* adj, void* out, int batch,
                                       int n, int gpc, int ctas, int smem,
                                       void* stream) {
  return dispatch<false>(adj, nullptr, out, nullptr, batch, n, gpc, ctas,
                         smem, (cudaStream_t)stream);
}

// adj (B,N,N) bool, mask (B,N) bool -> tri2 (B,N) int32 (zeroed by the
// caller for the tile mapping, which adds into it), deg (B,N) int32, of
// the adjacency restricted to live vertices.  Layout as above with
// common_neighbors_smem_bytes(n, gpc, 1).
extern "C" int common_neighbors_rowsums_launch(const void* adj,
                                               const void* mask, void* tri2,
                                               void* deg, int batch, int n,
                                               int gpc, int ctas, int smem,
                                               void* stream) {
  return dispatch<true>(adj, mask, tri2, deg, batch, n, gpc, ctas, smem,
                        (cudaStream_t)stream);
}
