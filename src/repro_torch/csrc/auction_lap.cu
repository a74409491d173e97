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
//   max passes) between block barriers; a round cannot start before the
//   previous one's prices are known.  The throughput bound chip_smoke.py
//   reports (costs in, outputs out; 3·M lane operations per row scan the run
//   really made) is far below the time, which is set by rounds × (barrier
//   chain + one M-step scan).  What the design does about it: the costs sit
//   in shared memory (padded to an odd row pitch, so a warp's row scans and
//   column scans are free of bank conflicts), every per-slot state vector
//   sits in shared memory beside them, and many problems run at once, one
//   CTA each, so the card hides one problem's barrier latency behind others'
//   work.  A cost matrix past the shared-memory budget (M > ~232) is
//   normalized into a global scratch buffer instead and read from there
//   (L2-resident, as kcore_peel.cu and gf2_reduce.cu do).
//
// Design: one CTA per problem, blockDim = min(1024, 32·⌈M/32⌉); thread t owns
//   person row t (and t + blockDim, ...) for the row scans and object column
//   t for collecting bids and for the reverse round's column scans.  A
//   round's winner per object is "highest bid, ties to the lowest person":
//   a shared-memory atomicMax on a 64-bit key, the bid's order-preserving
//   bits in the high word and M-1-person in the low word, gives exactly that
//   in any order of arrival (±0 bids are keyed alike, as they compare equal).
//   The winner's own bid value is read back from a per-person array.  The
//   reverse round's "best offer per person, ties to the lowest object" works
//   the same way.  The termination tests are __syncthreads_or ("any free
//   person / any stale object") and __syncthreads_and (the price vector
//   unchanged; in the collapsed solver, the state equal to the one a round
//   or two rounds back, the latter starting at (-1, -1, -3)).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kOut = -2;  // collapsed code: person at the OUT pseudo-object
// dynamic shared memory one block may take: the 227 KB opt-in of sm_90 less
// room for the static reduction scratch
constexpr int kSharedBudget = 232448 - 1024;

__host__ __device__ inline int pitch_of(int m) { return m | 1; }

// per-problem state bytes (16-byte aligned) of each solver
__host__ __device__ inline size_t state_bytes(int m, bool collapsed) {
  const size_t words = collapsed ? 12 : 4;  // f32/i32 vectors of length m
  size_t bytes = 8 * (size_t)m + 4 * words * m + (collapsed ? 2 * m : 0);
  return (bytes + 15) & ~(size_t)15;
}

__host__ __device__ inline size_t cost_bytes(int m) {
  return 4 * (size_t)m * pitch_of(m);
}

inline bool fits_shared(int m, bool collapsed) {
  return state_bytes(m, collapsed) + cost_bytes(m) <= (size_t)kSharedBudget;
}

// order-preserving bits of a float; -0 keys as +0 (they compare equal)
__device__ __forceinline__ unsigned long long bid_key(float x, int low) {
  const unsigned u = __float_as_uint(x == 0.f ? 0.f : x);
  const unsigned o = u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
  return ((unsigned long long)o << 32) | (unsigned)low;
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

template <bool kSharedCost>
__global__ void __launch_bounds__(kMaxThreads)
auction_collapsed_kernel(const float* __restrict__ cbar,
                         const bool* __restrict__ keep1,
                         const bool* __restrict__ keep2,
                         const float* __restrict__ price0,
                         const float* __restrict__ ladder, float* scratch,
                         int* __restrict__ p2o_out, float* __restrict__ total_out,
                         bool* __restrict__ conv_out,
                         int* __restrict__ rounds_out,
                         float* __restrict__ price_out, int m, int n_scales,
                         int max_rounds, int rev_every) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_red[32];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int pitch = pitch_of(m);
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem);
  float* price = reinterpret_cast<float*>(key + m);
  float* pi = price + m;
  float* f1 = pi + m;  // forward: a bidder's bid; reverse: an object's offer
  float* f2 = f1 + m;  // forward: a bidder's new profit; reverse: its price
  float* old_price = f2 + m;
  float* old_pi = old_price + m;
  float* prev_price = old_pi + m;
  float* prev_pi = prev_price + m;
  int* p2o = reinterpret_cast<int*>(prev_pi + m);
  int* o2p = p2o + m;
  int* old_p2o = o2p + m;
  int* prev_p2o = old_p2o + m;
  unsigned char* k1 = reinterpret_cast<unsigned char*>(prev_p2o + m);
  unsigned char* k2 = k1 + m;
  float* a = kSharedCost
                 ? reinterpret_cast<float*>(smem + state_bytes(m, true))
                 : scratch + (size_t)b * m * pitch;
  const float* c = cbar + (size_t)b * m * m;
  int* p2o_b = p2o_out + (size_t)b * m;

  for (int t = tid; t < m; t += nt) {
    k1[t] = keep1[(size_t)b * m + t];
    k2[t] = keep2[(size_t)b * m + t];
  }
  __syncthreads();
  float mx = 0.f;
  for (int e = tid; e < m * m; e += nt) {
    const int i = e / m, j = e - i * m;
    if (k1[i] && k2[j]) mx = fmaxf(mx, fabsf(c[e]));
  }
  const float c_scale = fmaxf(block_max(mx, s_red), 1e-30f);
  for (int e = tid; e < m * m; e += nt) {
    const int i = e / m, j = e - i * m;
    a[(size_t)i * pitch + j] =
        (k1[i] && k2[j]) ? -__fdiv_rn(c[e], c_scale) : -INFINITY;
  }
  bool warm_mine = false;
  for (int j = tid; j < m; j += nt) {
    price[j] = k2[j] ? fmaxf(price0[(size_t)b * m + j], 0.f) : 0.f;
    warm_mine |= price[j] > 0.f;
    key[j] = 0ull;
    o2p[j] = -1;
  }
  // a warm lane runs every scale at the finest eps
  const bool warm = __syncthreads_or(warm_mine);
  // initial profits over-claim nothing: the best value attainable now
  for (int i = tid; i < m; i += nt) {
    pi[i] = fmaxf(row_max(a + (size_t)i * pitch, price, m), 0.f);
    p2o[i] = k1[i] ? -1 : kOut;
  }
  __syncthreads();

  int rounds = 0;
  bool any_conv = false, conv_fine = false;
  for (int s = 0; s < n_scales; ++s) {
    const float eps = warm ? ladder[n_scales - 1] : ladder[s];
    // ε-CS partial reset: persons keep their slot (real object or OUT) while
    // it is within eps of their best option (OUT is worth 0)
    for (int i = tid; i < m; i += nt) {
      const int p = p2o[i];
      const float* row = a + (size_t)i * pitch;
      const float best = fmaxf(row_max(row, price, m), 0.f);
      const float mine = p >= 0 ? __fsub_rn(row[p], price[p]) : 0.f;
      const bool keep =
          (p != -1 && mine >= __fsub_rn(best, eps)) || !k1[i];
      if (!keep) p2o[i] = -1;
    }
    __syncthreads();
    for (int j = tid; j < m; j += nt) o2p[j] = -1;
    __syncthreads();
    for (int t = tid; t < m; t += nt) {
      if (p2o[t] >= 0) o2p[p2o[t]] = t;
      prev_price[t] = -1.f;
      prev_pi[t] = -1.f;
      prev_p2o[t] = -3;
    }
    __syncthreads();

    int it = 0;
    bool stalled = false;
    bool conv = false;
    for (;;) {
      bool free_mine = false, stale_mine = false;
      for (int t = tid; t < m; t += nt) {
        free_mine |= p2o[t] == -1;
        stale_mine |= k2[t] && o2p[t] < 0 && price[t] > 0.f;
      }
      const bool free_any = __syncthreads_or(free_mine);
      const bool stale_any = __syncthreads_or(stale_mine);
      conv = !free_any && !stale_any;
      if (conv || it >= max_rounds || stalled) break;
      const bool periodic =
          rev_every > 0 && (it % rev_every) == rev_every - 1;
      const bool do_rev = stale_any && (!free_any || periodic);
      for (int t = tid; t < m; t += nt) {
        old_price[t] = price[t];
        old_pi[t] = pi[t];
        old_p2o[t] = p2o[t];
      }
      if (!do_rev) {
        // forward: free persons take OUT or bid (OUT folded into the
        // second-best option)
        for (int i = tid; i < m; i += nt) {
          if (p2o[i] != -1) continue;
          const float* row = a + (size_t)i * pitch;
          int js;
          float v1, v2;
          top2(row, 1, price, m, js, v1, v2);
          const float v2o = fmaxf(v2, 0.f);
          if (v1 <= 0.f) {
            p2o[i] = kOut;
            pi[i] = 0.f;
            continue;
          }
          const float bid = __fadd_rn(__fsub_rn(row[js], v2o), eps);
          f1[i] = bid;
          f2[i] = __fsub_rn(v2o, eps);
          atomicMax(&key[js], bid_key(bid, m - 1 - i));
        }
        __syncthreads();
        for (int j = tid; j < m; j += nt) {
          const unsigned long long k = key[j];
          if (k == 0ull) continue;
          key[j] = 0ull;
          const int w = m - 1 - (int)(k & 0xffffffffu);
          price[j] = f1[w];
          const int old = o2p[j];
          if (old >= 0) p2o[old] = -1;
          o2p[j] = w;
          p2o[w] = j;
          pi[w] = f2[w];
        }
      } else {
        // reverse: unowned objects priced above 0 bid for persons through
        // the profits; below eps they drop out at price 0
        for (int j = tid; j < m; j += nt) {
          if (!(k2[j] && o2p[j] < 0 && price[j] > 0.f)) continue;
          int is;
          float b1, b2;
          top2(a + j, pitch, pi, m, is, b1, b2);
          if (b1 < eps) {
            price[j] = 0.f;
            continue;
          }
          const float p_new = fmaxf(0.f, __fsub_rn(b2, eps));
          const float offer = __fsub_rn(a[(size_t)is * pitch + j], p_new);
          f1[j] = offer;
          f2[j] = p_new;
          atomicMax(&key[is], bid_key(offer, m - 1 - j));
        }
        __syncthreads();
        // a person accepts its best offer and releases its old object with
        // the price intact (an owned object never bids: no conflicts)
        for (int i = tid; i < m; i += nt) {
          const unsigned long long k = key[i];
          if (k == 0ull) continue;
          key[i] = 0ull;
          const int j = m - 1 - (int)(k & 0xffffffffu);
          const int old = p2o[i];
          if (old >= 0) o2p[old] = -1;
          o2p[j] = i;
          price[j] = f2[j];
          p2o[i] = j;
          pi[i] = f1[j];
        }
      }
      __syncthreads();
      // two livelock exits: the state unchanged, or equal to the state two
      // rounds back (a forced forward/reverse interleave ping-ponging)
      bool same1 = true, same2 = true;
      for (int t = tid; t < m; t += nt) {
        same1 &= price[t] == old_price[t] && pi[t] == old_pi[t] &&
                 p2o[t] == old_p2o[t];
        same2 &= price[t] == prev_price[t] && pi[t] == prev_pi[t] &&
                 p2o[t] == prev_p2o[t];
        prev_price[t] = old_price[t];
        prev_pi[t] = old_pi[t];
        prev_p2o[t] = old_p2o[t];
      }
      const bool s1 = __syncthreads_and(same1);
      const bool s2 = __syncthreads_and(same2);
      stalled = s1 || s2;
      ++it;
    }
    rounds += it;
    if (conv) {
      for (int i = tid; i < m; i += nt) p2o_b[i] = p2o[i];
      any_conv = true;
    }
    if (s >= n_scales - 2) conv_fine |= conv;
  }
  for (int t = tid; t < m; t += nt) {
    if (!any_conv) p2o_b[t] = p2o[t];
    price_out[(size_t)b * m + t] = price[t];
  }
  __syncthreads();
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
  const bool shared = fits_shared(m, true);
  const size_t smem = state_bytes(m, true) + (shared ? cost_bytes(m) : 0);
  cudaError_t e = shared ? allow_shared(auction_collapsed_kernel<true>, smem)
                         : allow_shared(auction_collapsed_kernel<false>, smem);
  if (e != cudaSuccess) return (int)e;
  auto kernel =
      shared ? auction_collapsed_kernel<true> : auction_collapsed_kernel<false>;
  kernel<<<batch, threads_for(m), smem, (cudaStream_t)stream>>>(
      (const float*)cbar, (const bool*)keep1, (const bool*)keep2,
      (const float*)price0, (const float*)ladder, (float*)scratch, (int*)p2o,
      (float*)total, (bool*)conv, (int*)rounds, (float*)price, m, n_scales,
      max_rounds, rev_every);
  return (int)cudaGetLastError();
}
