// Batched ε-scaled auction solvers for the assignment problem, for Hopper
// (sm_90a), bound to Python through ctypes.
//
// Replaces: src/repro/kernels/auction_lap.py::auction_lap_pallas (the Jacobi
//   auction on (B, M, M) costs: assign, total, converged, rounds) and
//   ::auction_lap_collapsed_pallas (the forward/reverse auction on (B, K, K)
//   reduced costs with one zero-price, unlimited-capacity OUT pseudo-object:
//   p2o, total, converged, rounds, price).  Each kernel computes what
//   repro's auction_solve / auction_solve_collapsed compute for one problem,
//   round for round: the same f32 additions, subtractions, maxima and one
//   IEEE division per cost (the normalization, __fdiv_rn), no FMA and no
//   --use_fast_math, so assignments, prices, round counts and convergence
//   flags equal the plain PyTorch versions' (kernels/auction_lap.py) bit for
//   bit.  Only the totals differ in the last bits: thread 0 sums them in
//   index order, torch.sum in its own order.  The ε ladder comes in as a
//   float32 tensor built by the host, so no powf runs here.
//
// What bounds it on an H100: neither bytes nor operations, but latency.  A
//   problem reads its costs once (4·M² bytes) and then runs a data-dependent
//   chain of rounds, each a row scan by every bidder (M subtractions and two
//   max passes) between barriers; a round cannot start before the previous
//   one's prices are known.  The throughput bound chip_smoke.py reports
//   (costs in, outputs out; 3·M lane operations per row scan the run really
//   made) is far below the time, which is set by rounds × (barrier chain +
//   one scan).  The costs sit in shared memory (padded to an odd row pitch,
//   so row scans and column scans are free of bank conflicts), every
//   per-slot state vector sits in shared memory beside them, and a cost
//   matrix past the shared-memory budget (M > ~230) is normalized into a
//   global scratch buffer instead and read from there (L2-resident, as
//   kcore_peel.cu and gf2_reduce.cu do).
//
// A round's winner per object is "highest bid, ties to the lowest person":
//   a shared-memory atomicMax on a 64-bit key, the bid's order-preserving
//   bits in the high word and M-1-person in the low word, gives exactly that
//   in any order of arrival (±0 bids are keyed alike, as they compare equal).
//   The winner's own bid value is read back from a per-person array.  The
//   reverse round's "best offer per person, ties to the lowest object" works
//   the same way.
//
// auction_lap_kernel (expanded): one CTA per problem, blockDim =
//   min(1024, 32·⌈M/32⌉); thread t owns person row t (and t + blockDim, ...)
//   and scans it alone, one value after another; block barriers between the
//   phases of a round.
//
// auction_collapsed_kernel: the scans are shared by a segment of S lanes (8,
//   16 or 32).  Each lane walks j = lane, lane + S, ... and keeps the top two
//   of its values as the serial scan keeps them (strictly greater replaces,
//   so the first of equal values stays); the segment then merges: at S = 32
//   with warp reductions (the largest order-preserving value bits, ±0 alike,
//   then the lowest index holding them, then the same over every lane's best
//   candidate but that index), at S < 32 with xor shuffles of 64-bit keys
//   (value bits above ~j).  Either gives the lowest index among the maxima
//   (js) and, over j != js, the lowest index among the next maxima: what one
//   thread's serial scan keeps when equal values arrive.  v1 and v2 are
//   then recomputed at those two indices with the serial scan's own
//   subtraction, so they are its bits, ±0 included (an all -inf row gives
//   js = 0; M = 1 gives v2 = -inf).  Row maxima (the initial profits and the
//   ε-CS reset) are fmaxf trees: their zero sign reaches no output, since
//   every use compares them or adds a nonzero ε.
//   K <= 32: one warp per problem, kWarpProblems problems per CTA, one slot
//   per lane, S the least of 8, 16, 32 that covers K; the warp runs alone
//   (__syncwarp, warp votes), so each problem stops at its own round.
//   K > 32: one CTA per problem of max(kWideThreads, 32·⌈K/32⌉) threads, a
//   warp per segment, so up to blockDim/32 bidders scan at once.
//   A round has two barriers.  Bids: each free person (a stale object in a
//   reverse round) is scanned by a segment, the e-th of them found through
//   the round's bit masks and slot lists; the segment records its bid (or
//   offer) and target and raises the target's key in this round's key
//   buffer.  Barrier.  Then
//   each slot's owner thread updates the slot as a person and as an object
//   from the keys and bids alone (a person won its target, was evicted, or
//   accepted an offer; an object went to its highest bidder, was released,
//   or had its offer accepted), so no thread writes another's slot and no
//   barrier is needed before the survey: it compares the slot with the
//   state a round and two rounds back (the livelock exits), keeps the
//   copies, clears the slot's key in the other buffer, and the warp ballots
//   the next round's free persons and stale objects into the bit masks, each
//   such slot writing itself into a list at its rank among the word's bits
//   (one popcount, no atomics).
//   Barrier; popcounts of the masks and an OR of the flags give the next
//   round's termination tests, in the serial order: converged (no free
//   person, no stale object), round cap, stalled.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kOut = -2;  // collapsed code: person at the OUT pseudo-object
// dynamic shared memory one block may take: the 227 KB opt-in of sm_90 less
// room for the static reduction scratch
constexpr int kSharedBudget = 232448 - 1024;
constexpr unsigned kFull = 0xffffffffu;
// the collapsed solver: problems of K <= 32 slots run one per warp, this
// many to a CTA; wider ones one per CTA of at least kWideThreads threads
constexpr int kWarpProblems = 4;
constexpr int kWideThreads = 512;
// survey flag bits: some slot differs from the state a round / two rounds back
constexpr unsigned kMoved1 = 1u, kMoved2 = 2u;

__host__ __device__ inline int pitch_of(int m) { return m | 1; }

// per-problem state bytes (16-byte aligned) of each solver: the expanded
// one's keys and four vectors of length m; the collapsed one's two key
// buffers, four f32 and three i32 vectors (the state, the bids and their
// targets), three bit masks, two slot lists and the two valid-slot masks
__host__ __device__ inline size_t state_bytes(int m, bool collapsed) {
  size_t bytes = collapsed ? 16 * (size_t)m + 4 * 7 * (size_t)m +
                                 268 * (size_t)((m + 31) / 32) + 2 * (size_t)m
                           : 8 * (size_t)m + 4 * 4 * (size_t)m;
  return (bytes + 15) & ~(size_t)15;
}

__host__ __device__ inline size_t cost_bytes(int m) {
  return 4 * (size_t)m * pitch_of(m);
}

inline bool fits_shared(int m, bool collapsed) {
  return state_bytes(m, collapsed) + cost_bytes(m) <= (size_t)kSharedBudget;
}

// shared bytes of one warp's problem in the collapsed solver's warp layout
__host__ __device__ inline size_t warp_region_bytes(int m) {
  return state_bytes(m, true) + ((cost_bytes(m) + 15) & ~(size_t)15);
}

// order-preserving bits of a float, above 0 for every one (-inf:
// 0x007fffff); -0 keys as +0 (they compare equal)
__device__ __forceinline__ unsigned order_bits(float x) {
  const unsigned u = __float_as_uint(x == 0.f ? 0.f : x);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ unsigned long long bid_key(float x, int low) {
  return ((unsigned long long)order_bits(x) << 32) | (unsigned)low;
}

__device__ float block_max(float x, float* s_red) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_red[warp] = x;
  __syncthreads();
  x = lane < (int)(blockDim.x >> 5) ? s_red[lane] : 0.f;  // inputs are >= 0
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  __syncthreads();  // s_red is free again
  return x;
}

// Scan values v(j) = row[j*stride] - sub[j], j < m: the first argmax js, the
// maximum v1 and the maximum over j != js, v2 (-inf when there is none).
// An all -inf row gives js = 0, as jnp.argmax does.
__device__ __forceinline__ void top2(const float* row, int stride,
                                     const float* sub, int m, int& js,
                                     float& v1, float& v2) {
  js = 0;
  v1 = -INFINITY;
  v2 = -INFINITY;
  for (int j = 0; j < m; ++j) {
    const float v = __fsub_rn(row[(size_t)j * stride], sub[j]);
    if (v > v1) {
      v2 = v1;
      v1 = v;
      js = j;
    } else if (v > v2) {
      v2 = v;
    }
  }
}

__device__ __forceinline__ float row_max(const float* row, const float* sub,
                                         int m) {
  float best = -INFINITY;
  for (int j = 0; j < m; ++j) best = fmaxf(best, __fsub_rn(row[j], sub[j]));
  return best;
}

template <bool kSharedCost>
__global__ void __launch_bounds__(kMaxThreads)
auction_lap_kernel(const float* __restrict__ cost,
                   const float* __restrict__ ladder, float* scratch,
                   int* __restrict__ assign_out, float* __restrict__ total_out,
                   bool* __restrict__ conv_out, int* __restrict__ rounds_out,
                   int m, int n_scales, int max_rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_red[32];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int pitch = pitch_of(m);
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem);
  float* price = reinterpret_cast<float*>(key + m);
  float* bidv = price + m;
  int* p2o = reinterpret_cast<int*>(bidv + m);
  int* o2p = p2o + m;
  float* a = kSharedCost
                 ? reinterpret_cast<float*>(smem + state_bytes(m, false))
                 : scratch + (size_t)b * m * pitch;
  const float* c = cost + (size_t)b * m * m;
  int* assign = assign_out + (size_t)b * m;

  float mx = 0.f;
  for (int e = tid; e < m * m; e += nt) mx = fmaxf(mx, fabsf(c[e]));
  const float c_scale = fmaxf(block_max(mx, s_red), 1e-30f);
  for (int e = tid; e < m * m; e += nt) {
    const int i = e / m, j = e - i * m;
    a[(size_t)i * pitch + j] = -__fdiv_rn(c[e], c_scale);
  }
  for (int t = tid; t < m; t += nt) {
    key[t] = 0ull;
    price[t] = 0.f;
    p2o[t] = -1;
  }
  __syncthreads();

  int rounds = 0;
  bool any_conv = false, conv_fine = false;
  for (int s = 0; s < n_scales; ++s) {
    const float eps = ladder[s];
    // partial reset (ε-CS): keep assignments still within eps of each
    // person's best value at the new scale
    for (int i = tid; i < m; i += nt) {
      const int p = p2o[i];
      if (p < 0) continue;
      const float* row = a + (size_t)i * pitch;
      const float best = row_max(row, price, m);
      const float mine = __fsub_rn(row[p], price[p]);
      if (!(mine >= __fsub_rn(best, eps))) p2o[i] = -1;
    }
    __syncthreads();
    for (int j = tid; j < m; j += nt) o2p[j] = -1;
    __syncthreads();
    for (int i = tid; i < m; i += nt)
      if (p2o[i] >= 0) o2p[p2o[i]] = i;
    __syncthreads();

    int it = 0;
    bool stalled = false;
    bool conv = false;
    for (;;) {
      bool free_mine = false;
      for (int i = tid; i < m; i += nt) free_mine |= p2o[i] < 0;
      conv = !__syncthreads_or(free_mine);
      if (conv || it >= max_rounds || stalled) break;
      // every free person bids its best value + eps over its second best
      for (int i = tid; i < m; i += nt) {
        if (p2o[i] >= 0) continue;
        const float* row = a + (size_t)i * pitch;
        int js;
        float v1, v2;
        top2(row, 1, price, m, js, v1, v2);
        if (!isfinite(v2)) v2 = v1;  // M == 1
        const float bid = __fadd_rn(__fsub_rn(row[js], v2), eps);
        bidv[i] = bid;
        atomicMax(&key[js], bid_key(bid, m - 1 - i));
      }
      __syncthreads();
      // each object with bids goes to the highest, evicting its owner
      bool same = true;
      for (int j = tid; j < m; j += nt) {
        const unsigned long long k = key[j];
        if (k == 0ull) continue;
        key[j] = 0ull;
        const int w = m - 1 - (int)(k & 0xffffffffu);
        const float bid = bidv[w];
        same &= bid == price[j];
        price[j] = bid;
        const int old = o2p[j];
        if (old >= 0) p2o[old] = -1;
        o2p[j] = w;
        p2o[w] = j;
      }
      // an unchanged price vector: the increments fell below f32
      // resolution and no later round can make progress
      stalled = __syncthreads_and(same);
      ++it;
    }
    rounds += it;
    if (conv) {
      for (int i = tid; i < m; i += nt) assign[i] = p2o[i];
      any_conv = true;
    }
    if (s >= n_scales - 2) conv_fine |= conv;
  }
  if (!any_conv)
    for (int i = tid; i < m; i += nt) assign[i] = p2o[i];
  // deterministic completion of still-free rows: the k-th free person takes
  // the k-th free object (o2p now flags owned objects)
  __syncthreads();
  for (int j = tid; j < m; j += nt) o2p[j] = 0;
  __syncthreads();
  for (int i = tid; i < m; i += nt)
    if (assign[i] >= 0) o2p[assign[i]] = 1;
  __syncthreads();
  if (tid == 0) {
    int next = 0;
    float total = 0.f;
    for (int i = 0; i < m; ++i) {
      int p = assign[i];
      if (p < 0) {
        while (next < m && o2p[next]) ++next;
        p = next++;
        assign[i] = p;
      }
      total = __fadd_rn(total, c[(size_t)i * m + p]);
    }
    total_out[b] = total;
    conv_out[b] = conv_fine;
    rounds_out[b] = rounds;
  }
}

// ------------------------------------------------- the collapsed solver

// The threads that solve one problem: a warp (kWarp) or the whole CTA.
template <bool kWarp>
struct Group {
  __device__ int rank() const {
    return kWarp ? (int)(threadIdx.x & 31) : (int)threadIdx.x;
  }
  __device__ int size() const { return kWarp ? 32 : (int)blockDim.x; }
  __device__ void sync() const {
    if constexpr (kWarp) __syncwarp(); else __syncthreads();
  }
  __device__ bool any(bool p) const {
    if constexpr (kWarp) {
      __syncwarp();
      return __any_sync(kFull, p);
    } else {
      return __syncthreads_or(p);
    }
  }
  // max over the group of values >= 0
  __device__ float max(float x, float* s_red) const {
    if constexpr (kWarp) {
      for (int o = 16; o > 0; o >>= 1)
        x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
      return x;
    } else {
      return block_max(x, s_red);
    }
  }
};

// The e-th (from 0) slot of a bit mask, in slot order: slot 32w + r of the
// mask is list[32w + (its rank among the word's set bits)]; c0 is the count
// of word 0.
__device__ __forceinline__ int nth_slot(const int* list, const unsigned* mask,
                                        int c0, int e) {
  if (e < c0) return list[e];
  e -= c0;
  int w = 1;
  for (int c = __popc(mask[1]); e >= c; c = __popc(mask[w])) {
    e -= c;
    ++w;
  }
  return list[32 * w + e];
}

// Over v(j) = x[j*xs] - sub[j], j < m, scanned by the S lanes of a segment
// (lane lis of it): js, the lowest index among the maxima, and j2, the
// lowest index among the maxima over j != js (-1: none).  Each lane keeps
// the serial scan's top two of its own j = lis, lis + S, ...; S = 32 merges
// them with warp reductions of order-preserving value bits (±0 alike) and
// then of indices, S < 32 with xor shuffles of bid_key(v, ~j).  Every lane
// of the warp calls it and gets the result.
template <int S>
__device__ __forceinline__ void seg_top2(const float* x, int xs,
                                         const float* sub, int m, int lis,
                                         int& js, int& j2) {
  if constexpr (S == 32) {
    unsigned a = 0u, b = 0u, ia = 0xffffffffu, ib = 0xffffffffu;
    // two values a step, with selects: no branch for K <= 64
    for (int j0 = lis; j0 < m; j0 += 2 * S) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + h * S;
        const unsigned k =
            j < m ? order_bits(__fsub_rn(x[(size_t)j * xs], sub[j])) : 0u;
        const bool over_a = k > a, over_b = k > b;
        b = over_a ? a : over_b ? k : b;
        ib = over_a ? ia : over_b ? (unsigned)j : ib;
        a = over_a ? k : a;
        ia = over_a ? (unsigned)j : ia;
      }
    }
    const unsigned m1 = __reduce_max_sync(kFull, a);
    js = (int)__reduce_min_sync(kFull, a == m1 ? ia : 0xffffffffu);
    const bool top = ia == (unsigned)js;
    const unsigned c = top ? b : a, ic = top ? ib : ia;
    const unsigned m2 = __reduce_max_sync(kFull, c);
    j2 = m2 ? (int)__reduce_min_sync(kFull, c == m2 ? ic : 0xffffffffu) : -1;
  } else {
    unsigned long long a = 0ull, b = 0ull;
    for (int j = lis; j < m; j += S) {
      const unsigned long long k =
          bid_key(__fsub_rn(x[(size_t)j * xs], sub[j]), ~j);
      if (k > a) {
        b = a;
        a = k;
      } else if (k > b) {
        b = k;
      }
    }
#pragma unroll
    for (int o = S / 2; o > 0; o >>= 1) {
      const unsigned long long pa = __shfl_xor_sync(kFull, a, o);
      const unsigned long long pb = __shfl_xor_sync(kFull, b, o);
      const bool mine = a > pa;  // keys of distinct indices never tie
      const unsigned long long s1 = mine ? b : pb, s2 = mine ? pa : a;
      b = s1 > s2 ? s1 : s2;
      a = mine ? a : pa;
    }
    js = ~(int)(unsigned)a;
    j2 = b ? ~(int)(unsigned)b : -1;
  }
}

// max_j row[j] - sub[j] over a segment (-inf for m = 0)
template <int S>
__device__ __forceinline__ float seg_row_max(const float* row,
                                             const float* sub, int m,
                                             int lis) {
  float best = -INFINITY;
  for (int j = lis; j < m; j += S)
    best = fmaxf(best, __fsub_rn(row[j], sub[j]));
#pragma unroll
  for (int o = S / 2; o > 0; o >>= 1)
    best = fmaxf(best, __shfl_xor_sync(kFull, best, o));
  return best;
}

// the winner encoded in a bid key (m - 1 - winner in the low word)
__device__ __forceinline__ int key_winner(unsigned long long k, int m) {
  return m - 1 - (int)(k & 0xffffffffu);
}

// The counts of the round's free persons and stale objects (all, and in
// mask word 0), and the survey's flags.
struct Survey {
  int n_free, n_stale, free0, stale0;
  unsigned moved;
};

// a forward bidder's target when it took OUT instead
constexpr int kTookOut = -2;

template <bool kWarp, int S, bool kSharedCost>
__global__ void __launch_bounds__(kMaxThreads)
auction_collapsed_kernel(const float* __restrict__ cbar,
                         const bool* __restrict__ keep1,
                         const bool* __restrict__ keep2,
                         const float* __restrict__ price0,
                         const float* __restrict__ ladder, float* scratch,
                         int* __restrict__ p2o_out, float* __restrict__ total_out,
                         bool* __restrict__ conv_out,
                         int* __restrict__ rounds_out,
                         float* __restrict__ price_out, int batch, int m,
                         int n_scales, int max_rounds, int rev_every) {
  // slots per thread: one, but two where m may reach 2 * blockDim
  constexpr int kSlots = kSharedCost ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_red[32];
  const Group<kWarp> g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = kWarp ? blockIdx.x * kWarpProblems + warp : blockIdx.x;
  if (b >= batch) return;  // warp layout: a whole warp without a problem
  const int tid = g.rank(), nt = g.size();
  const int seg = tid / S, lis = tid % S, nseg = nt / S;
  const int pitch = pitch_of(m), words = (m + 31) / 32;
  unsigned char* base = smem + (kWarp ? warp * warp_region_bytes(m) : 0);
  // bid keys, two buffers: a round uses one and clears the other
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(base);
  float* price = reinterpret_cast<float*>(keys + 2 * m);
  float* pi = price + m;
  float* f1 = pi + m;  // forward: a bidder's bid; reverse: an object's offer
  float* f2 = f1 + m;  // forward: a bidder's new profit; reverse: its price
  int* p2o = reinterpret_cast<int*>(f2 + m);
  int* o2p = p2o + m;
  // a bid's object (kTookOut: took OUT), an offer's person (-1: dropped)
  int* tgt = o2p + m;
  // the round's free persons and stale objects, and the survey's flags, by
  // 32-slot word
  unsigned* free_mask = reinterpret_cast<unsigned*>(tgt + m);
  unsigned* stale_mask = free_mask + words;
  unsigned* moved = stale_mask + words;
  // each word's set slots in slot order, at 32 * word + rank (nth_slot)
  int* free_list = reinterpret_cast<int*>(moved + words);
  int* stale_list = free_list + 32 * words;
  unsigned char* k1 =
      reinterpret_cast<unsigned char*>(stale_list + 32 * words);
  unsigned char* k2 = k1 + m;
  float* a = kSharedCost
                 ? reinterpret_cast<float*>(base + state_bytes(m, true))
                 : scratch + (size_t)b * m * pitch;
  const float* c = cbar + (size_t)b * m * m;
  int* p2o_b = p2o_out + (size_t)b * m;

  for (int t = tid; t < m; t += nt) {
    k1[t] = keep1[(size_t)b * m + t];
    k2[t] = keep2[(size_t)b * m + t];
    keys[t] = keys[m + t] = 0ull;
  }
  g.sync();
  float mx = 0.f;
  for (int e = tid; e < m * m; e += nt) {
    const int i = e / m, j = e - i * m;
    if (k1[i] && k2[j]) mx = fmaxf(mx, fabsf(c[e]));
  }
  const float c_scale = fmaxf(g.max(mx, s_red), 1e-30f);
  for (int e = tid; e < m * m; e += nt) {
    const int i = e / m, j = e - i * m;
    a[(size_t)i * pitch + j] =
        (k1[i] && k2[j]) ? -__fdiv_rn(c[e], c_scale) : -INFINITY;
  }
  bool warm_mine = false;
  for (int j = tid; j < m; j += nt) {
    price[j] = k2[j] ? fmaxf(price0[(size_t)b * m + j], 0.f) : 0.f;
    warm_mine |= price[j] > 0.f;
    o2p[j] = -1;
  }
  // a warm lane runs every scale at the finest eps
  const bool warm = g.any(warm_mine);
  // initial profits over-claim nothing: the best value attainable now
  for (int r0 = 0; r0 < m; r0 += nseg) {
    const int i = r0 + seg;
    const bool act = i < m;
    const float best = seg_row_max<S>(a + (size_t)(act ? i : 0) * pitch,
                                      price, act ? m : 0, lis);
    if (act && lis == 0) pi[i] = fmaxf(best, 0.f);
  }
  for (int t = tid; t < m; t += nt) p2o[t] = k1[t] ? -1 : kOut;
  g.sync();

  // Slot t = tid + k * nt of this thread, k < kSlots: its state (price,
  // profit, p2o, o2p) lives here in registers, published to shared memory
  // for the scans, and so do its copies a round and two rounds back.
  float r_price[kSlots], r_pi[kSlots], old_price[kSlots], old_pi[kSlots],
      prev_price[kSlots], prev_pi[kSlots];
  int r_p2o[kSlots], r_o2p[kSlots], old_p2o[kSlots], prev_p2o[kSlots];
  bool r_k2[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int t = tid + k * nt;
    r_k2[k] = t < m && k2[t];
  }

  // Each slot's owner, after the bids (mode 1: forward, 2: reverse; keys
  // of buffer `parity`): the round's update of the slot as a person and as
  // an object, from the keys and the bids alone (no other thread writes
  // the slot); then (and in mode 0, at the start of a scale, from shared
  // memory) the survey: compare with the state a round and two rounds back,
  // keep the copies, and mark the free persons and stale objects of the
  // next round.  Ends with the group synchronised and every thread holding
  // the masks' first two words, the counts and the flags.
  auto slot_pass = [&](int mode, int parity) -> Survey {
    const unsigned long long* key = keys + parity * m;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int t = tid + k * nt, w = (k * nt >> 5) + (tid >> 5);
      bool is_free = false, stale = false;
      unsigned bits = 0u;
      if (t < m) {
        float pr = r_price[k], pf = r_pi[k];
        int q = r_p2o[k], o = r_o2p[k];
        if (mode == 0) {
          pr = price[t];
          pf = pi[t];
          q = p2o[t];
          o = o2p[t];
        } else if (mode == 1) {
          const unsigned long long ko = key[t];
          if (q == -1) {  // a bidder: won its target, or took OUT
            const int j = tgt[t];
            if (j == kTookOut) {
              q = kOut;
              pf = 0.f;
            } else if (key_winner(key[j], m) == t) {
              q = j;
              pf = f2[t];
            }
          } else if (q >= 0 && key[q] != 0ull) {
            q = -1;  // evicted
          }
          if (ko) {  // the object goes to its highest bidder
            o = key_winner(ko, m);
            pr = f1[o];
          }
        } else {
          const unsigned long long kp = key[t];
          if (pr > 0.f && o < 0 && r_k2[k]) {  // offered, or dropped out
            const int i = tgt[t];
            if (i < 0) {
              pr = 0.f;
            } else if (key_winner(key[i], m) == t) {
              o = i;
              pr = f2[t];
            }
          } else if (o >= 0 && key[o] != 0ull) {
            o = -1;  // released, the price intact
          }
          if (kp) {  // the person accepts its best offer
            q = key_winner(kp, m);
            pf = f1[q];
          }
        }
        if (mode != 0) {
          keys[(parity ^ 1) * m + t] = 0ull;
          price[t] = pr;
          pi[t] = pf;
          p2o[t] = q;
          o2p[t] = o;
        }
        if (mode == 0) {
          prev_price[k] = -1.f;
          prev_pi[k] = -1.f;
          prev_p2o[k] = -3;
        } else {
          if (!(pr == old_price[k] && pf == old_pi[k] && q == old_p2o[k]))
            bits |= kMoved1;
          if (!(pr == prev_price[k] && pf == prev_pi[k] && q == prev_p2o[k]))
            bits |= kMoved2;
          prev_price[k] = old_price[k];
          prev_pi[k] = old_pi[k];
          prev_p2o[k] = old_p2o[k];
        }
        old_price[k] = r_price[k] = pr;
        old_pi[k] = r_pi[k] = pf;
        old_p2o[k] = r_p2o[k] = q;
        r_o2p[k] = o;
        is_free = q == -1;
        stale = r_k2[k] && o < 0 && pr > 0.f;
      }
      const unsigned fm = __ballot_sync(kFull, is_free);
      const unsigned sm = __ballot_sync(kFull, stale);
      const unsigned below = (1u << lane) - 1u;
      if (is_free) free_list[32 * w + __popc(fm & below)] = t;
      if (stale) stale_list[32 * w + __popc(sm & below)] = t;
      bits = __reduce_or_sync(kFull, bits);
      if (lane == 0 && w < words) {
        free_mask[w] = fm;
        stale_mask[w] = sm;
        moved[w] = bits;
      }
    }
    g.sync();
    const int f1w = words > 1 ? __popc(free_mask[1]) : 0;
    const int s1w = words > 1 ? __popc(stale_mask[1]) : 0;
    Survey sv{0, 0, __popc(free_mask[0]), __popc(stale_mask[0]),
              moved[0] | (words > 1 ? moved[1] : 0u)};
    sv.n_free = sv.free0 + f1w;
    sv.n_stale = sv.stale0 + s1w;
#pragma unroll 1
    for (int w = 2; w < words; ++w) {
      sv.n_free += __popc(free_mask[w]);
      sv.n_stale += __popc(stale_mask[w]);
      sv.moved |= moved[w];
    }
    return sv;
  };

  int rounds = 0, parity = 0;
  bool any_conv = false, conv_fine = false;
  for (int s = 0; s < n_scales; ++s) {
    const float eps = warm ? ladder[n_scales - 1] : ladder[s];
    // ε-CS partial reset: persons keep their slot (real object or OUT) while
    // it is within eps of their best option (OUT is worth 0)
    for (int r0 = 0; r0 < m; r0 += nseg) {
      const int i = r0 + seg;
      const bool act = i < m;
      const float* row = a + (size_t)(act ? i : 0) * pitch;
      const float best =
          fmaxf(seg_row_max<S>(row, price, act ? m : 0, lis), 0.f);
      if (act && lis == 0) {
        const int p = p2o[i];
        const float mine = p >= 0 ? __fsub_rn(row[p], price[p]) : 0.f;
        const bool keep =
            (p != -1 && mine >= __fsub_rn(best, eps)) || !k1[i];
        if (!keep) p2o[i] = -1;
      }
    }
    g.sync();
    for (int j = tid; j < m; j += nt) o2p[j] = -1;
    g.sync();
    for (int t = tid; t < m; t += nt)
      if (p2o[t] >= 0) o2p[p2o[t]] = t;
    g.sync();
    Survey sv = slot_pass(0, parity);

    int it = 0;
    bool stalled = false;
    bool conv = false;
    for (;;) {
      conv = sv.n_free == 0 && sv.n_stale == 0;
      if (conv || it >= max_rounds || stalled) break;
      const bool periodic =
          rev_every > 0 && (it % rev_every) == rev_every - 1;
      const bool do_rev = sv.n_stale > 0 && (sv.n_free == 0 || periodic);
      // Bids: a forward round's free persons scan their rows of a - price
      // and bid best over second best (OUT folded into the second best) +
      // eps, or take OUT; a reverse round's stale objects (unowned, priced
      // above 0) scan their columns of a - pi and offer their best person
      // the raised profit at price max(0, second - eps), or drop out at
      // price 0 below eps.  One loop serves both, so the round's code stays
      // small.
      const bool fwd = !do_rev;
      const unsigned* mask = fwd ? free_mask : stale_mask;
      const int* list = fwd ? free_list : stale_list;
      const int c0 = fwd ? sv.free0 : sv.stale0;
      const int n_bids = fwd ? sv.n_free : sv.n_stale;
      const float* sub = fwd ? price : pi;
      const int xs = fwd ? 1 : pitch;
      unsigned long long* key = keys + parity * m;
      for (int e0 = 0; e0 < n_bids; e0 += nseg) {
        const bool act = e0 + seg < n_bids;
        const int u = act ? nth_slot(list, mask, c0, e0 + seg) : 0;
        const float* x = fwd ? a + (size_t)u * pitch : a + u;
        int j1, j2;
        seg_top2<S>(x, xs, sub, act ? m : 0, lis, j1, j2);
        if (!act || lis != 0) continue;
        const float x1 = x[(size_t)j1 * xs];
        const float v1 = __fsub_rn(x1, sub[j1]);
        const float v2 =
            j2 >= 0 ? __fsub_rn(x[(size_t)j2 * xs], sub[j2]) : -INFINITY;
        if (fwd ? v1 <= 0.f : v1 < eps) {
          tgt[u] = fwd ? kTookOut : -1;
          continue;
        }
        // the second-best option: with OUT (forward), or the new price
        const float v2c =
            fwd ? fmaxf(v2, 0.f) : fmaxf(0.f, __fsub_rn(v2, eps));
        const float val =
            fwd ? __fadd_rn(__fsub_rn(x1, v2c), eps) : __fsub_rn(x1, v2c);
        f1[u] = val;
        f2[u] = fwd ? __fsub_rn(v2c, eps) : v2c;
        tgt[u] = j1;
        atomicMax(&key[j1], bid_key(val, m - 1 - u));
      }
      g.sync();
      sv = slot_pass(do_rev ? 2 : 1, parity);
      // two livelock exits: the state unchanged, or equal to the state two
      // rounds back (a forced forward/reverse interleave ping-ponging)
      stalled = !(sv.moved & kMoved1) || !(sv.moved & kMoved2);
      parity ^= 1;
      ++it;
    }
    rounds += it;
    if (conv) {
      for (int i = tid; i < m; i += nt) p2o_b[i] = p2o[i];
      any_conv = true;
    }
    if (s >= n_scales - 2) conv_fine |= conv;
    g.sync();  // the next reset scans rows other threads copied
  }
  for (int t = tid; t < m; t += nt) {
    if (!any_conv) p2o_b[t] = p2o[t];
    price_out[(size_t)b * m + t] = price[t];
  }
  g.sync();
  if (tid == 0) {
    float total = 0.f;
    for (int i = 0; i < m; ++i) {
      const int p = p2o_b[i];
      if (p >= 0) total = __fadd_rn(total, c[(size_t)i * m + p]);
    }
    total_out[b] = total;
    conv_out[b] = conv_fine;
    rounds_out[b] = rounds;
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

inline int threads_for(int m) {
  const int t = (m + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// the collapsed launcher's operands, as the kernel takes them
struct CollapsedArgs {
  const float* cbar;
  const bool* keep1;
  const bool* keep2;
  const float* price0;
  const float* ladder;
  float* scratch;
  int* p2o;
  float* total;
  bool* conv;
  int* rounds;
  float* price;
  int batch, m, n_scales, max_rounds, rev_every;
};

template <bool kWarp, int S, bool kSharedCost>
int launch_collapsed(const CollapsedArgs& p, int blocks, int threads,
                     size_t smem, cudaStream_t s) {
  auto kernel = auction_collapsed_kernel<kWarp, S, kSharedCost>;
  const cudaError_t e = allow_shared(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, threads, smem, s>>>(
      p.cbar, p.keep1, p.keep2, p.price0, p.ladder, p.scratch, p.p2o, p.total,
      p.conv, p.rounds, p.price, p.batch, p.m, p.n_scales, p.max_rounds,
      p.rev_every);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 when an M-wide problem's costs and state fit in shared memory (the
// launcher then needs no global scratch), 0 when the costs go to a
// B * M * (M | 1) float scratch buffer.
extern "C" int auction_fits_shared(int m, int collapsed) {
  return fits_shared(m, collapsed != 0) ? 1 : 0;
}

extern "C" int auction_lap_launch(const void* cost, const void* ladder,
                                  void* scratch, void* assign, void* total,
                                  void* conv, void* rounds, int batch, int m,
                                  int n_scales, int max_rounds,
                                  void* stream) {
  if (batch <= 0 || m <= 0) return 0;
  const bool shared = fits_shared(m, false);
  const size_t smem = state_bytes(m, false) + (shared ? cost_bytes(m) : 0);
  cudaError_t e = shared ? allow_shared(auction_lap_kernel<true>, smem)
                         : allow_shared(auction_lap_kernel<false>, smem);
  if (e != cudaSuccess) return (int)e;
  auto kernel = shared ? auction_lap_kernel<true> : auction_lap_kernel<false>;
  kernel<<<batch, threads_for(m), smem, (cudaStream_t)stream>>>(
      (const float*)cost, (const float*)ladder, (float*)scratch, (int*)assign,
      (float*)total, (bool*)conv, (int*)rounds, m, n_scales, max_rounds);
  return (int)cudaGetLastError();
}

extern "C" int auction_lap_collapsed_launch(
    const void* cbar, const void* keep1, const void* keep2,
    const void* price0, const void* ladder, void* scratch, void* p2o,
    void* total, void* conv, void* rounds, void* price, int batch, int m,
    int n_scales, int max_rounds, int rev_every, void* stream) {
  if (batch <= 0 || m <= 0) return 0;
  const CollapsedArgs p{(const float*)cbar, (const bool*)keep1,
                        (const bool*)keep2, (const float*)price0,
                        (const float*)ladder, (float*)scratch, (int*)p2o,
                        (float*)total, (bool*)conv, (int*)rounds,
                        (float*)price, batch, m, n_scales, max_rounds,
                        rev_every};
  cudaStream_t s = (cudaStream_t)stream;
  if (m <= 32) {  // one warp per problem, kWarpProblems to a CTA
    const int blocks = (batch + kWarpProblems - 1) / kWarpProblems;
    const int threads = 32 * kWarpProblems;
    const size_t smem = kWarpProblems * warp_region_bytes(m);
    if (m <= 8) return launch_collapsed<true, 8, true>(p, blocks, threads,
                                                       smem, s);
    if (m <= 16) return launch_collapsed<true, 16, true>(p, blocks, threads,
                                                         smem, s);
    return launch_collapsed<true, 32, true>(p, blocks, threads, smem, s);
  }
  // one CTA per problem, a warp per segment
  const int threads = threads_for(m) > kWideThreads ? threads_for(m)
                                                    : kWideThreads;
  if (fits_shared(m, true))
    return launch_collapsed<false, 32, true>(
        p, batch, threads, state_bytes(m, true) + cost_bytes(m), s);
  return launch_collapsed<false, 32, false>(p, batch, threads,
                                            state_bytes(m, true), s);
}
