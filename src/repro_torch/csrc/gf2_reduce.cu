// Bit-packed GF(2) boundary-matrix reduction for Hopper (sm_90a), bound to
// Python through ctypes.
//
// Replaces: src/repro/kernels/gf2_reduce.py::gf2_reduce_pallas (one packed
//   (S,W) matrix in VMEM) and ::gf2_reduce_batch_pallas (one complex per grid
//   step).  For each column j in order: l = low(col); while row l is claimed,
//   col ^= the column that claimed it and recompute l; then claim row l for
//   j, or mark the column positive when it reduced to zero.  Returns the
//   reduced matrix, owner[n_rows] and positive[S], bit for bit as
//   repro.core.persistence_jax.reduce_packed.
//
// What bounds it on an H100: the chase.  Each matrix is read once and
//   written once, but its columns are reduced in order and each column's
//   XORs depend on the previous one, so a launch lasts as long as its
//   slowest matrix's chain of steps (a step: one XOR, or the claim or
//   emptying that ends a column) times the latency of one step.
//
// Design: one launch covers every (graph, dimension block) pair of a call
//   (grid y: the block; x: its CTAs); each block has its own layout
//   (kernels/gf2_reduce.py::layout picks it from G, S, W, R and the SM
//   count), and a CTA of 128 threads takes `mpc` consecutive matrices of
//   one block, contiguous in every input and output.
//   1. Staging: the CTA copies its matrices to shared memory, 16 bytes a
//      load and eight loads in flight a thread, and on the way finds each
//      matrix's last nonzero column (se - 1): per chunk the highest nonzero
//      word, one shared atomicMax per (warp, matrix) from its top lane.
//      Past se every column is zero: positive, owning no row.
//   2. The chase runs to se only.  Layouts "thread" (W <= 4: lane 0 of a
//      warp per matrix, the column a 16-byte register quad, low from four
//      FLOs and a max) and "segment" (W <= 32: 8, 16 or 32 lanes per
//      matrix, a word a lane, low from a ballot and a shuffle) keep a pivot
//      table indexed by row: piv[l] holds the reduced column that claimed
//      row l, zero while the row is unclaimed (a claimed column has a low,
//      so it is never zero).  A step takes low of the column in registers,
//      reads piv[low] once and XORs it in registers; a zero row ends the
//      column, which claims the row (or, empty, the spare row R) and
//      advances to the next staged column, prefetched one ahead.  Each lane
//      only touches its own words of the table, so the chase needs no
//      barrier.  Owner, positive and the reduced columns are kept in
//      shared memory and written out once, coalesced, by the whole CTA.
//   3. Above 32 words ("warp": several words a lane) the working column
//      stays in memory and the table is the owner vector beside the staged
//      columns, as in the Pallas kernel; past a CTA's shared memory
//      ("global") the same chase runs in place in the output buffer
//      (L2-resident), with the output owner vector as the table.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBlocks = 4;
constexpr int kThreads = 128;
constexpr int kUnroll = 8;  // staging loads in flight a thread
enum Kind { kThread = 0, kSegment = 1, kWarp = 2, kGlobal = 3 };

struct Block {
  const uint32_t* src;
  uint32_t* dst;
  int* owner;
  uint8_t* positive;
  int s, w, r, kind, lanes, mpc, vec;
};

struct Gf2Params {
  Block b[kMaxBlocks];
  int graphs;
};

__host__ __device__ inline long long ceil4(long long x) {
  return (x + 3) & ~3LL;
}

// Words of one pivot-table row: a padded quad (thread), W (segment), none
// (warp: the table is the owner vector).
__host__ __device__ inline int table_words(int kind, int w) {
  return kind == kThread ? 4 : kind == kSegment ? w : 0;
}

// Shared-memory words of a CTA: se[mpc]; the staged columns mpc*S*W; per
// matrix the pivot table, R + 1 rows (row R takes the stores of columns
// that claim nothing), then owner R + 1 ints and positive S bytes padded to
// words.  The global layout keeps only se.
__host__ __device__ inline long long smem_words(int kind, int mpc, int s,
                                                int w, int r) {
  if (kind == kGlobal) return ceil4(mpc);
  return ceil4(mpc) + ceil4((long long)mpc * s * w)
         + (long long)mpc * (r + 1) * (table_words(kind, w) + 1)
         + (long long)mpc * ceil4(s) / 4;
}

// ------------------------------------------------------------- staging

__device__ inline int top_word(uint4 v) {
  return v.w ? 3 : v.z ? 2 : v.y ? 1 : v.x ? 0 : -1;
}
__device__ inline int top_word(uint32_t v) { return v ? 0 : -1; }

// Copy n_words words src -> out in chunks of V words (V = 4: 16-byte
// loads and stores, both pointers 16-byte aligned and S*W % 4 == 0, so no
// chunk straddles two matrices), and raise se[m] to one past each matrix's
// last nonzero column: one shared atomicMax per warp and matrix, from the
// highest lane whose chunk of that matrix is nonzero.  Every lane of the
// CTA runs the same trip count, so the warp votes see all 32 lanes.
template <int V>
__device__ void stage(const uint32_t* __restrict__ src,
                      uint32_t* __restrict__ out, int* se, int n_words,
                      int sw, int w) {
  using T = typename std::conditional<V == 4, uint4, uint32_t>::type;
  const T* s4 = reinterpret_cast<const T*>(src);
  T* o4 = reinterpret_cast<T*>(out);
  const int lane = threadIdx.x & 31;
  const int n = n_words / V;
  for (int i0 = 0; i0 < n; i0 += kThreads * kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads + threadIdx.x;
      if (i < n) v[u] = s4[i];
      else v[u] = T{};
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads + threadIdx.x;
      if (i < n) o4[i] = v[u];
      const int hi = top_word(v[u]);
      const int m = (i * V) / sw;
      const unsigned nz = __ballot_sync(kFull, hi >= 0);
      const unsigned same = __match_any_sync(kFull, m);
      if (hi >= 0 && lane == 31 - __clz(nz & same)) {
        const int col = (i * V + hi - m * sw) / w;
        atomicMax(se + m, col + 1);
      }
    }
  }
}

// --------------------------------------------------------- thread layout

template <int W>
__device__ inline uint4 load_col(const uint32_t* p) {
  if (W == 4) return *reinterpret_cast<const uint4*>(p);
  return make_uint4(p[0], W > 1 ? p[1] : 0u, W > 2 ? p[2] : 0u, 0u);
}

template <int W>
__device__ inline void store_col(uint32_t* p, uint4 c) {
  if (W == 4) {
    *reinterpret_cast<uint4*>(p) = c;
    return;
  }
  p[0] = c.x;
  if (W > 1) p[1] = c.y;
  if (W > 2) p[2] = c.z;
}

// A word's top set bit (one FLO), or -1 for 0.
__device__ inline int top_bit(uint32_t x) {
  int b;
  asm("bfind.u32 %0, %1;" : "=r"(b) : "r"(x));
  return b;
}

// Highest set row of a 4-word column, or -1, without a branch: word k
// offers its top bit | 32k (32k + the bit; still -1 when the word is 0),
// and the highest nonzero word's offer is the largest.
__device__ inline int low4(uint4 c) {
  return max(max(top_bit(c.w) | 96, top_bit(c.z) | 64),
             max(top_bit(c.y) | 32, top_bit(c.x)));
}

// One thread reduces one matrix of W <= 4 words a column, all in shared
// memory.  The inner loop is one XOR step a turn: low, one 16-byte load of
// piv[low], the XOR in registers.  A zero row (unclaimed, or the column
// empty) ends the column without a branch: the column goes to piv and owner
// at its row (row R when it claims none), its flag and its reduced words
// to their places, and the next column, prefetched one ahead, comes in.
template <int W>
__device__ void chase_thread(uint32_t* cols, uint4* piv, int* own,
                             uint8_t* pos, int se, int R) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (se == 0) return;
  uint4 col = load_col<W>(cols);
  uint4 nxt = load_col<W>(cols + W * min(1, se - 1));
  for (int j = 0; j < se; ++j) {
    int low;
    bool live;
    for (;;) {
      low = low4(col);
      live = (unsigned)low < (unsigned)R;
      const uint4 p = live ? piv[low] : zero;
      if (!(p.x | p.y | p.z | p.w)) break;
      col.x ^= p.x;
      col.y ^= p.y;
      col.z ^= p.z;
      col.w ^= p.w;
    }
    const int slot = live ? low : R;
    piv[slot] = col;
    own[slot] = j;
    pos[j] = !live;
    store_col<W>(cols + (long long)j * W, col);
    col = nxt;
    nxt = load_col<W>(cols + (long long)W * min(j + 2, se - 1));
  }
}

// -------------------------------------------------------- segment layout

// L lanes reduce one matrix of W <= L words, lane k holding word k: low
// from a ballot of the nonzero words, its top lane and a shuffle of that
// lane's bit.  Every lane of the warp runs the loop until all of its
// segments are done; a segment's steps are uniform across its lanes.
template <int L>
__device__ void chase_segment(uint32_t* cols, uint32_t* piv, int* own,
                              uint8_t* pos, int se, int W, int R) {
  const int lane = threadIdx.x & 31;
  const int k = lane % L;
  const unsigned seg = (L == 32 ? kFull : ((1u << L) - 1u)) << (lane - k);
  const bool word = k < W;
  uint32_t v = (word && se > 0) ? cols[k] : 0u;
  uint32_t nxt = (word && se > 1) ? cols[W + k] : 0u;
  int j = 0;
  while (__any_sync(kFull, j < se)) {
    const bool act = j < se;
    const int best = v ? (k << 5) + 31 - __clz(v) : -1;
    const unsigned nz = __ballot_sync(kFull, v != 0u) & seg;
    const int low = __shfl_sync(kFull, best, nz ? 31 - __clz(nz) : lane);
    const bool live = act && (unsigned)low < (unsigned)R;
    const uint32_t p = (live && word) ? piv[(long long)low * W + k] : 0u;
    const unsigned claimed = __ballot_sync(kFull, p != 0u) & seg;
    v ^= p;  // zero unless the row is claimed
    if (act && !claimed) {  // the column ends
      const int slot = live ? low : R;
      if (word) {
        piv[(long long)slot * W + k] = v;
        cols[(long long)j * W + k] = v;
      }
      if (k == 0) {
        own[slot] = j;
        pos[j] = !live;
      }
      ++j;
      v = nxt;
      nxt = (word && j + 1 < se) ? cols[(long long)(j + 1) * W + k] : 0u;
    }
  }
}

// ------------------------------------------------- warp and global layouts

// A warp reduces one matrix whose working column stays in memory (staged
// in shared memory, or the output itself), in place: lane i owns words i,
// i+32, ... of every column; `table` is the owner vector (the column that
// claimed row l, or -1).
__device__ void chase_wide(uint32_t* cols, int* table, uint8_t* pos, int se,
                           int W, int R) {
  const int lane = threadIdx.x & 31;
  int j = 0;
  while (j < se) {
    uint32_t* col = cols + (long long)j * W;
    int best = -1;
    for (int x = lane; x < W; x += 32) {
      const uint32_t v = col[x];
      if (v) best = (x << 5) + 31 - __clz(v);
    }
    const int low = __reduce_max_sync(kFull, best);
    const bool live = (unsigned)low < (unsigned)R;
    const int piv = live ? table[low] : -1;
    if (piv >= 0) {
      const uint32_t* pc = cols + (long long)piv * W;
      for (int x = lane; x < W; x += 32) col[x] ^= pc[x];
      continue;
    }
    if (live && lane == 0) {
      table[low] = j;
      pos[j] = 0;
    }
    __syncwarp();  // publish table[low] before the next column reads it
    ++j;
  }
}

// --------------------------------------------------------------- kernel

__global__ void __launch_bounds__(kThreads)
gf2_reduce_kernel(const __grid_constant__ Gf2Params p) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Block& B = p.b[blockIdx.y];
  const int S = B.s, W = B.w, R = B.r, kind = B.kind, mpc = B.mpc;
  const int g0 = (int)blockIdx.x * mpc;
  if (g0 >= p.graphs) return;  // past this block's CTAs
  const int M = min(mpc, p.graphs - g0);
  const int sw = S * W;
  const bool shared = kind != kGlobal;
  const int tw = table_words(kind, W);
  const int ps = (int)ceil4(S);  // positive bytes a matrix in smem

  int* se = reinterpret_cast<int*>(smem);
  uint32_t* st = smem + ceil4(mpc);
  uint32_t* tab = st + ceil4((long long)mpc * sw);
  int* own_s = reinterpret_cast<int*>(tab + (long long)mpc * (R + 1) * tw);
  uint8_t* pos_s = reinterpret_cast<uint8_t*>(own_s + mpc * (R + 1));
  const uint32_t* src = B.src + (long long)g0 * sw;
  uint32_t* dst = B.dst + (long long)g0 * sw;
  int* own = B.owner + (long long)g0 * R;
  uint8_t* pos = B.positive + (long long)g0 * S;

  // se 0; owner -1, positive true, empty pivot tables
  for (int i = threadIdx.x; i < M; i += kThreads) se[i] = 0;
  if (shared) {
    for (long long i = threadIdx.x; i < (long long)M * (R + 1) * tw;
         i += kThreads)
      tab[i] = 0u;
    for (int i = threadIdx.x; i < M * (R + 1); i += kThreads) own_s[i] = -1;
    for (int i = threadIdx.x; i < M * ps / 4; i += kThreads)
      reinterpret_cast<uint32_t*>(pos_s)[i] = 0x01010101u;
  } else {
    for (long long i = threadIdx.x; i < (long long)M * R; i += kThreads)
      own[i] = -1;
    for (long long i = threadIdx.x; i < (long long)M * S; i += kThreads)
      pos[i] = 1;
  }
  __syncthreads();
  if (B.vec) stage<4>(src, shared ? st : dst, se, M * sw, sw, W);
  else stage<1>(src, shared ? st : dst, se, M * sw, sw, W);
  __syncthreads();

  const int lanes = B.lanes;
  const int m = threadIdx.x / lanes;  // this thread's matrix in the CTA
  const int mm = min(m, M - 1);       // (idle segments of a live warp)
  const int sem = m < M ? se[m] : 0;
  uint32_t* st_m = st + (long long)mm * sw;
  uint32_t* tab_m = tab + (long long)mm * (R + 1) * tw;
  int* own_m = own_s + mm * (R + 1);
  uint8_t* pos_m = pos_s + (long long)mm * ps;
  switch (kind) {
    case kThread:
      if (m < M && threadIdx.x % 32 == 0) {  // lane 0 chases
        uint4* piv = reinterpret_cast<uint4*>(tab_m);
        if (W == 1) chase_thread<1>(st_m, piv, own_m, pos_m, sem, R);
        else if (W == 2) chase_thread<2>(st_m, piv, own_m, pos_m, sem, R);
        else if (W == 3) chase_thread<3>(st_m, piv, own_m, pos_m, sem, R);
        else chase_thread<4>(st_m, piv, own_m, pos_m, sem, R);
      }
      break;
    case kSegment:
      if (m - m % (32 / lanes) < M) {  // a warp with a matrix
        if (lanes == 8)
          chase_segment<8>(st_m, tab_m, own_m, pos_m, sem, W, R);
        else if (lanes == 16)
          chase_segment<16>(st_m, tab_m, own_m, pos_m, sem, W, R);
        else
          chase_segment<32>(st_m, tab_m, own_m, pos_m, sem, W, R);
      }
      break;
    case kWarp:
      if (m < M) chase_wide(st_m, own_m, pos_m, sem, W, R);
      break;
    default:  // kGlobal: in place in the output, its owner as the table
      if (m < M)
        chase_wide(dst + (long long)mm * sw, own + (long long)mm * R,
                   pos + (long long)mm * S, sem, W, R);
      return;
  }

  // The CTA's matrices are contiguous in every output: write them once.
  __syncthreads();
  if (sw % 4 == 0) {
    for (int i = threadIdx.x; i < M * sw / 4; i += kThreads)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(st)[i];
  } else {
    for (int i = threadIdx.x; i < M * sw; i += kThreads) dst[i] = st[i];
  }
  for (int k = 0; k < M; ++k) {
    for (int i = threadIdx.x; i < R; i += kThreads)
      own[k * R + i] = own_s[k * (R + 1) + i];
    for (int i = threadIdx.x; i < S; i += kThreads)
      pos[k * S + i] = pos_s[k * ps + i];
  }
}

int g_optin[64];
long long g_smem_set[64];

}  // namespace

// Shared-memory bytes of one CTA of a block with this layout; the Python
// selector (kernels/gf2_reduce.py::smem_bytes) computes the same.
extern "C" long long gf2_reduce_smem_bytes(int kind, int mpc, int s, int w,
                                           int r) {
  return 4 * smem_words(kind, mpc, s, w, r);
}

// args: per block, 10 int64 values: src, dst, owner, positive (device
// pointers: (graphs, S, W) int32 bit patterns, the same shape 16-byte
// aligned, (graphs, R) int32, (graphs, S) bool), then S, W, R, kind (0
// thread, 1 segment, 2 warp, 3 global), lanes a matrix and matrices a
// CTA.  Returns cudaErrorInvalidValue for a layout that does not fit its
// block, else cudaGetLastError() after the launch.
extern "C" int gf2_reduce_launch(int n_blocks, int graphs,
                                 const long long* args, void* stream) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks) return (int)cudaErrorInvalidValue;
  if (graphs <= 0) return 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!g_optin[dev])
    cudaDeviceGetAttribute(&g_optin[dev],
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  Gf2Params p = {};
  p.graphs = graphs;
  long long smem = 0;
  int ctas = 0;
  for (int d = 0; d < n_blocks; ++d) {
    const long long* a = args + 10 * d;
    Block& b = p.b[d];
    b.src = reinterpret_cast<const uint32_t*>(a[0]);
    b.dst = reinterpret_cast<uint32_t*>(a[1]);
    b.owner = reinterpret_cast<int*>(a[2]);
    b.positive = reinterpret_cast<uint8_t*>(a[3]);
    b.s = (int)a[4];
    b.w = (int)a[5];
    b.r = (int)a[6];
    b.kind = (int)a[7];
    b.lanes = (int)a[8];
    b.mpc = (int)a[9];
    const bool lanes_ok =
        b.kind == kThread ? b.lanes == 32 && b.w <= 4
        : b.kind == kSegment ? (b.lanes == 8 || b.lanes == 16 || b.lanes == 32)
                                   && b.w <= b.lanes
        : (b.kind == kWarp || b.kind == kGlobal) && b.lanes == 32;
    if (!lanes_ok || b.mpc < 1 || b.mpc * b.lanes > kThreads || b.s < 0
        || b.w < 0 || b.r < 0 || (long long)b.mpc * b.s * b.w > (1LL << 31) - 1)
      return (int)cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(b.dst) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    b.vec = (long long)b.s * b.w % 4 == 0
            && reinterpret_cast<uintptr_t>(b.src) % 16 == 0;
    ctas = max(ctas, (graphs + b.mpc - 1) / b.mpc);
    const long long bytes = 4 * smem_words(b.kind, b.mpc, b.s, b.w, b.r);
    if (bytes > g_optin[dev]) return (int)cudaErrorInvalidValue;
    if (bytes > smem) smem = bytes;
  }
  if (smem > 48 * 1024 && smem > g_smem_set[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        gf2_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    g_smem_set[dev] = smem;
  }
  gf2_reduce_kernel<<<dim3(ctas, n_blocks), kThreads, smem,
                      (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
