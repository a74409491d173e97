// Dominated-vertex matrix for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces: src/repro/kernels/domination.py::domination_pallas,
//   dom[b,u,v] = (|N[u] \ N[v]| == 0) && u != v && live(u) && live(v),
//   which the TPU kernel computes as the f32 MXU product viol = Nc . NotNc^T
//   (exact below 2^24) with the comparison fused into the epilogue.
//
// The algebra: with Ahat = A | I (the diagonal byte set) and m the mask,
//   the closed neighbourhood is Nc[u,w] = Ahat[u,w] m[w] m[u], and for live
//   u, v:  Nc[u] is a subset of Nc[v]  iff  G[u,v] == d[u], where
//   G[u,v] = sum_w (Ahat[u,w] m[w]) Ahat[v,w] and d[u] = sum_w Ahat[u,w] m[w].
//   The mask enters one operand only (m[w]^2 = m[w]); both live bits are
//   tested in the epilogue.  The sums of 0/1 bytes are an int8 tensor-core
//   product with int32 sums: exact.  Bool bytes are 0 or 1, so the staged
//   adjacency is the int8 operand as it is.
//
// What bounds it on an H100: the bytes (one read of adj, one write of out,
//   3.35 TB/s) at n64 (4096x64x64), n320 (256x320x320) and Table 1
//   (16x1024x1024); the B*N^2*(N+1) int8 operations of the N(N+1)/2 inner
//   products a graph needs (G is symmetric; 1,979e12/s) come to 0.87 of the
//   bytes' time at Table 1 and less below it.
//
// Design: one launch, no scratch, 8 warps a CTA, two CTAs an SM.  Rows of
//   adj go straight to shared memory with 16-byte cp.async copies (a byte
//   path where N is not a multiple of 16), rows padded by 16 bytes so that
//   ldmatrix's 8 row addresses hit 8 distinct 16-byte bank groups; ragged
//   u, v and K edges stage as zero bytes.  The thread that copied the piece
//   holding a row's diagonal sets that byte once its copy landed.  Each warp
//   computes a 32 x 64 tile of G with mma.sync.m16n8k32.s8 fed by ldmatrix:
//   both operands are rows of adj, which is what .row.col wants, so nothing
//   is transposed.  The A fragments are ANDed with the mask words in
//   registers, and d[u] is one more mma of them against ones.  The epilogue
//   compares, stages the bools in shared memory and stores them 16 bytes a
//   thread, coalesced.  Two work mappings (kernels/domination.py::layout
//   picks one from B, N and the SM count):
//   * graph (padded N <= 128, one tile a graph): persistent CTAs stage
//     groups of whole graphs (4 at n64) once, the next group's copies in
//     flight meanwhile, so each graph's bytes cross device memory once
//     each way; a warp computes one 32 x 64 tile of one graph;
//   * tile (above 128, n320 and Table 1): a CTA takes one (graph, u tile,
//     v tile) pair of 128 x 128 and streams K through a 3-stage ring of
//     128-byte chunks.  G is symmetric, so it computes each unordered tile
//     pair once and writes dom[u,v] and dom[v,u], each against its own d
//     (the v rows' d from the same mma against ones, 16 rows a warp).
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
constexpr int kPad = 16;  // bytes past every staged or output row
constexpr int kSmemMax = 232448;  // 227 KB, a block's limit on sm_90
constexpr uint32_t kOnes = 0x01010101u;  // four int8 ones

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
// c0..c0+15 to dst: a cp.async copy of the raw bytes (kVec; the diagonal
// byte is set once it landed) or byte loads with the diagonal byte set;
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
        if (c0 + j < n && (row[c0 + j] != 0 || c0 + j == u))
          w[j >> 2] |= 1u << ((j & 3) * 8);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One warp over ksteps * 32 staged columns: acc += (A masked) . B^T for
// its 32 u rows and 32 or 64 v rows, du += the masked u rows' sums (d[u],
// an mma against ones) and, where v16 is given, dv += the masked sums of
// 16 v rows (d[v] for the mirrored block).  a, b, v16 point at each set's
// first staged row, rows `pitch` apart; smask at the mask byte of the
// range's first column.  Only the A side (and the sums) take the mask.
__device__ __forceinline__ void warp_gram(int (&acc)[2][8][4],
                                          int (&du)[2][4], int (&dv)[4],
                                          const uint8_t* a, const uint8_t* b,
                                          const uint8_t* v16, int pitch,
                                          const uint8_t* smask, int ksteps,
                                          bool two, int lane) {
  // 32-bit shared addresses of this lane's rows (ldmatrix's layout)
  const uint32_t pa = smem_addr(a + (lane & 15) * pitch + (lane >> 4) * 16);
  const uint32_t pb = smem_addr(b + ((lane & 7) + ((lane >> 4) << 3)) * pitch +
                                ((lane >> 3) & 1) * 16);
  const uint32_t pv =
      v16 != nullptr ? smem_addr(v16 + (lane & 15) * pitch + (lane >> 4) * 16)
                     : 0u;
  const uint32_t pm = smem_addr(smask + (lane & 3) * 4);
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ++ks) {
    // loads run one step ahead of the mma that uses them
    const int kk = ks * 32;
    uint32_t af[2][4], bf[2][4];
    ldmatrix_x4(af[0], pa + kk);
    ldmatrix_x4(af[1], pa + 16 * pitch + kk);
    ldmatrix_x4(bf[0], pb + kk);
    const uint32_t m0 = lds32(pm + kk), m1 = lds32(pm + kk + 16);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      af[mi][0] &= m0;
      af[mi][1] &= m0;
      af[mi][2] &= m1;
      af[mi][3] &= m1;
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      if (nj >= 2 && !two) break;
      if (nj < 3 && (nj < 1 || two))
        ldmatrix_x4(bf[(nj + 1) & 1], pb + (nj + 1) * 16 * pitch + kk);
      if (nj == 0) {
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
    if (v16 != nullptr) {
      uint32_t vf[4];
      ldmatrix_x4(vf, pv + kk);
      vf[0] &= m0;
      vf[1] &= m0;
      vf[2] &= m1;
      vf[3] &= m1;
      mma_s8(dv, vf, kOnes, kOnes);
    }
  }
}

// The comparison for one warp tile: oa gets dom[u,v] at (row r, col c),
// ob (when not null: an off-diagonal tile pair) dom[v,u] at (c, r).  du
// holds d[u] of the tile's rows (warp_gram's layout), dvc d[v] of its
// columns (for ob); live is the graph's mask; u0, v0 are the graph-local
// indices of the tile's first row and column.
__device__ __forceinline__ void warp_epilogue(const int (&acc)[2][8][4],
                                              const int (&du)[2][4], bool two,
                                              int lane, uint8_t* oa,
                                              uint8_t* ob, int opitch,
                                              const uint8_t* live,
                                              const int* dvc, int u0, int v0) {
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mi * 16 + h * 8 + g;
      const int u = u0 + r, d = du[mi][2 * h];
      const bool lu = live[u] != 0;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        if (ni >= 4 && !two) break;
        const int c = ni * 8 + t2, v = v0 + c;
        const uint32_t lv = *reinterpret_cast<const uint16_t*>(live + v);
        const bool e0 = lu && (lv & 0xffu) && u != v;
        const bool e1 = lu && (lv >> 8) && u != v + 1;
        const int x0 = acc[mi][ni][2 * h], x1 = acc[mi][ni][2 * h + 1];
        *reinterpret_cast<uint16_t*>(oa + r * opitch + c) =
            (uint16_t)((e0 && x0 == d) | ((e1 && x1 == d) << 8));
        if (ob != nullptr) {
          ob[c * opitch + r] = e0 && x0 == dvc[c];
          ob[(c + 1) * opitch + r] = e1 && x1 == dvc[c + 1];
        }
      }
    }
  }
}

// Copies rows x cols staged bools (rows opitch apart) to out (rows n apart).
template <bool kVec>
__device__ __forceinline__ void store_block(const uint8_t* src, int opitch,
                                            uint8_t* __restrict__ dst,
                                            int rows, int cols, int n) {
  if constexpr (kVec) {
    const RowMap rm = row_map(cols >> 4);
    if (rm.piece >= (cols >> 4)) return;
    const int c = rm.piece << 4;
    for (int r = rm.row; r < rows; r += rm.pass)
      *reinterpret_cast<uint4*>(dst + (long long)r * n + c) =
          *reinterpret_cast<const uint4*>(src + r * opitch + c);
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      dst[(long long)r * n + c] = src[r * opitch + c];
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
// whole (np raw rows and the mask of each graph) while the previous group
// computes, two buffers in turn; each warp takes one 32 x 64 warp tile.
template <bool kVec>
__device__ void graph_mapping(uint8_t* sm, const uint8_t* __restrict__ adj,
                              const uint8_t* __restrict__ mask,
                              uint8_t* __restrict__ out, int batch, int n,
                              int np, int gpc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pitch = np + kPad, opitch = np + kPad;
  const int in_bytes = gpc * np * pitch, buf_bytes = in_bytes + gpc * np;
  uint8_t* out_a = sm + 2 * buf_bytes;
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
      if (tid < per_row) {
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

  long long grp = blockIdx.x;
  if (grp < groups) issue(grp, 0);
  cp_async_commit();
  for (int it = 0; grp < groups; ++it, grp += gridDim.x) {
    const int buf = it & 1;
    // the other buffer's last reader passed the previous group's barrier
    if (grp + gridDim.x < groups) issue(grp + gridDim.x, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    uint8_t* in = sm + buf * buf_bytes;
    if (kVec && rm.piece < per_row)  // each row's diagonal byte, as above
      for (int t = 0; t < gpc; ++t)
        for (int u = rm.row; u < n; u += rm.pass)
          if ((unsigned)(u - c0) < 16u) in[(t * np + u) * pitch + u] = 1;
    __syncthreads();  // the group's rows and masks have landed
    const uint8_t* live = in + in_bytes + s * np;
    if (mine) {
      int acc[2][8][4] = {}, du[2][4] = {}, dv[4] = {};
      warp_gram(acc, du, dv, in + (s * np + ra) * pitch,
                in + (s * np + rv) * pitch, nullptr, pitch, live, np >> 5,
                two, lane);
      warp_epilogue(acc, du, two, lane,
                    out_a + (s * np + ra) * opitch + rv, nullptr, opitch,
                    live, nullptr, ra, rv);
    }
    __syncthreads();
    const long long b0 = grp * gpc;
    for (int t = 0; t < gpc && b0 + t < batch; ++t)
      store_block<kVec>(out_a + t * np * opitch, opitch,
                        out + (b0 + t) * n * (long long)n, n, n, n);
    __syncthreads();
  }
}

// Tile mapping: CTA x takes unordered tile pair x % pairs of graph
// x / pairs and streams the u and v tiles' raw rows through the ring, a
// kChunk-byte slice of each row a stage.
template <bool kVec>
__device__ void tile_mapping(uint8_t* sm, const uint8_t* __restrict__ adj,
                             const uint8_t* __restrict__ mask,
                             uint8_t* __restrict__ out, int n, int np) {
  constexpr int tile = kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (np + tile - 1) / tile;
  const int pairs = tiles * (tiles + 1) / 2;
  const long long b = blockIdx.x / pairs;
  int iu, iv;
  pair_of((int)(blockIdx.x - b * pairs), tiles, iu, iv);
  const bool same = iu == iv;
  const int pitch = kChunk + kPad, opitch = tile + kPad;
  const int stage_bytes = 2 * tile * pitch;
  const int ring = max(kStages * stage_bytes, 2 * tile * opitch);
  int* degv = reinterpret_cast<int*>(sm + ring);
  uint8_t* smask = sm + ring + 4 * tile;  // the graph's mask, zeros past N
  const int rows = same ? tile : 2 * tile;  // staged: u tile, then v tile
  // 32 bytes of a row a thread: kChunk / 32 = 4 lanes a row, 64 rows a pass
  constexpr int kLg = 2;
  static_assert((32 << kLg) == kChunk && kTile <= kChunk,
                "a tile's diagonal bytes fall in one chunk");
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
  // kVec: the diagonal byte of each row, in the piece that holds it, once
  // the thread's own copy of chunk k landed (the byte path stages it)
  auto set_diag = [&](int k) {
    uint8_t* st = sm + (k % kStages) * stage_bytes;
#pragma unroll
    for (int j = 0; j < 2 * kTile / kPass; ++j) {
      const int r = row0 + j * kPass, col = k * kChunk + c;
      const int u = vertex(r);
      if (r < rows && u < n && (unsigned)(u - col) < 32u)
        st[r * pitch + u - k * kChunk] = 1;
    }
  };
  const int tu = min(tile, np - iu * tile), tv = min(tile, np - iv * tile);
  const int rbs = tu >> 5, cbs = (tv + 63) >> 6;
  const bool mine = warp < rbs * cbs;  // one warp tile a warp (<= 8)
  const int rb = mine ? warp / cbs : 0, cb = mine ? warp - rb * cbs : 0;
  const bool two = cb * 64 + 32 < tv;
  const int row_b = (same ? 0 : tile) + cb * 64;
  const int ra = iu * tile + rb * 32, rv = iv * tile + cb * 64;
  const bool vsum = !same && 16 * warp < tv;  // then mine: tu is whole
  int acc[2][8][4] = {}, du[2][4] = {}, dv[4] = {};

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) stage(s);
    cp_async_commit();
  }
  // while the first chunks are in flight (the loop's barrier orders it)
  for (int i = tid; i < (np >> 4); i += kThreads)
    *reinterpret_cast<uint4*>(smask + (i << 4)) =
        mask16<kVec>(mask, b, true, i << 4, n);
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<kStages - 2>();
    // a tile's rows have their diagonal bytes in one chunk (tile <= kChunk)
    if (kVec && (k == iu * tile / kChunk || k == iv * tile / kChunk))
      set_diag(k);
    __syncthreads();  // chunk k is whole; chunk k-1's stage is free
    if (k + kStages - 1 < nk) stage(k + kStages - 1);
    cp_async_commit();
    const uint8_t* st = sm + (k % kStages) * stage_bytes;
    if (mine)
      warp_gram(acc, du, dv, st + rb * 32 * pitch, st + row_b * pitch,
                vsum ? st + (tile + 16 * warp) * pitch : nullptr, pitch,
                smask + k * kChunk, min(kChunk, np - k * kChunk) >> 5, two,
                lane);
  }
  if (vsum && (lane & 3) == 0) {
    degv[16 * warp + (lane >> 2)] = dv[0];
    degv[16 * warp + (lane >> 2) + 8] = dv[2];
  }
  __syncthreads();  // d[v] is whole; the ring is free for the output

  uint8_t* out_a = sm;
  uint8_t* out_b = sm + tile * opitch;
  if (mine)
    warp_epilogue(acc, du, two, lane, out_a + rb * 32 * opitch + cb * 64,
                  same ? nullptr : out_b + cb * 64 * opitch + rb * 32, opitch,
                  smask, degv + cb * 64, ra, rv);
  __syncthreads();
  const int u0 = iu * tile, v0 = iv * tile;
  uint8_t* g = out + b * n * (long long)n;
  store_block<kVec>(out_a, opitch, g + (long long)u0 * n + v0,
                    min(tile, n - u0), min(tile, n - v0), n);
  if (!same)
    store_block<kVec>(out_b, opitch, g + (long long)v0 * n + u0,
                      min(tile, n - v0), min(tile, n - u0), n);
}

template <bool kTileMapping, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    domination_gram_kernel(const uint8_t* __restrict__ adj,
                           const uint8_t* __restrict__ mask,
                           uint8_t* __restrict__ out, int batch, int n,
                           int gpc) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int np = (n + 31) & ~31;
  if constexpr (kTileMapping)
    tile_mapping<kVec>(sm, adj, mask, out, n, np);
  else
    graph_mapping<kVec>(sm, adj, mask, out, batch, n, np, gpc);
}

template <bool kTileMapping, bool kVec>
int launch(const void* adj, const void* mask, void* out, int batch, int n,
           int gpc, long long ctas, int smem, cudaStream_t s) {
  static int smem_set = 48 * 1024;  // the default dynamic limit
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        domination_gram_kernel<kTileMapping, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    smem_set = kSmemMax;
  }
  domination_gram_kernel<kTileMapping, kVec><<<(unsigned)ctas, kThreads, smem,
                                               s>>>(
      (const uint8_t*)adj, (const uint8_t*)mask, (uint8_t*)out, batch, n,
      gpc);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of a launch (kernels/domination.py::layout computes
// the same): the graph mapping at padded N <= kGraphMaxNp (two group
// buffers of gpc graphs' rows and masks, and their output), else the tile
// mapping (gpc 1); -1 for a layout the kernel does not take.
extern "C" long long domination_smem_bytes(int n, int gpc) {
  const int np = (n + 31) & ~31;
  if (n <= 0 || gpc < 1) return -1;
  long long bytes;
  if (np <= kGraphMaxNp) {
    if (gpc * (np >> 5) * ((np + 63) >> 6) > kWarps) return -1;
    bytes = 2LL * gpc * np * (np + kPad + 1) + (long long)gpc * np * (np + kPad);
  } else {
    if (gpc != 1) return -1;
    const long long ring = (long long)kStages * 2 * kTile * (kChunk + kPad);
    const long long outs = 2LL * kTile * (kTile + kPad);
    bytes = (ring > outs ? ring : outs) + 4LL * kTile + np;
  }
  return bytes <= kSmemMax ? bytes : -1;
}

// adj (B,N,N) bool, mask (B,N) bool, out (B,N,N) bool.  At padded N <=
// kGraphMaxNp the graph mapping (gpc graphs a group, ctas persistent
// CTAs), above it the tile mapping (gpc 1, ctas B times the unordered
// pairs of 128-row tiles); smem must equal domination_smem_bytes.  One
// launch; returns cudaGetLastError() after it (cudaErrorInvalidValue for a
// layout the kernel does not take).
extern "C" int domination_launch(const void* adj, const void* mask, void* out,
                                 int batch, int n, int gpc, int ctas,
                                 int smem, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (domination_smem_bytes(n, gpc) != smem)
    return (int)cudaErrorInvalidValue;
  const int np = (n + 31) & ~31;
  const bool graph = np <= kGraphMaxNp;
  const int tiles = (np + kTile - 1) / kTile;
  const long long most = graph ? ((long long)batch + gpc - 1) / gpc
                               : (long long)batch * (tiles * (tiles + 1) / 2);
  if (ctas < 1 || ctas > most || (!graph && ctas != most))
    return (int)cudaErrorInvalidValue;
  const bool vec = n % 16 == 0 && ((uintptr_t)adj | (uintptr_t)mask |
                                   (uintptr_t)out) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (graph)
    return vec ? launch<false, true>(adj, mask, out, batch, n, gpc, ctas,
                                     smem, s)
               : launch<false, false>(adj, mask, out, batch, n, gpc, ctas,
                                      smem, s);
  return vec ? launch<true, true>(adj, mask, out, batch, n, gpc, ctas, smem,
                                  s)
             : launch<true, false>(adj, mask, out, batch, n, gpc, ctas, smem,
                                   s);
}
