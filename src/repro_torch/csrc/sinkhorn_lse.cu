// Blocked Sinkhorn reductions for Hopper (sm_90a), cost rebuilt on the fly,
// bound to Python through ctypes.
//
// Replaces: src/repro/kernels/sinkhorn_lse.py::sinkhorn_lse_pallas and
//   ::sinkhorn_pair_sum_pallas.  Both read two diagonal-augmented diagram
//   clouds as coordinate planes (plane 0 birth, 1 death, 2 the diagonal-slot
//   flag; here (B, 3, M) f32, without the TPU layout's five zero planes) and
//   rebuild c_ij = (xb_i - yb_j)^2 + (xd_i - yd_j)^2, 0 between two diagonal
//   slots, so no (M, N) cost matrix is ever stored.
//   * sinkhorn_lse: out[b,i] = LSE_j(logw_j + (dual_j - c_ij) / e_b), with a
//     running (max, shifted sum) merged across column tiles.  A row whose
//     log weights are all -inf gives -inf.
//   * sinkhorn_pair_sum: sum over the pairs whose log weights are both
//     finite of exp(la_i + lb_j + (f_i + g_j - c_ij) / e_b) * c_ij ("plan")
//     or of c_ij ("cost").
//
// What bounds it on an H100: operations.  The function needs, per (row,
//   column of nonzero weight) pair, one cost, one IEEE division and one
//   accurate expf: about 26 f32/integer lane instructions and 2 MUFU
//   operations (a reciprocal seed, an ex2), against 20 bytes per column.
//   Columns of weight 0 (and, in the pair sum, rows of weight 0) add nothing
//   and are left out, so the work is (rows x weighted columns) for the LSE
//   and (weighted rows x weighted columns) for the pair sum, which on the
//   full diagram tensor (mostly padding slots) is a small share of M x N.
//
// sinkhorn_lse: one thread per output row, in CTAs of kRows.  The caller
//   packs each batch item's columns of log weight other than -inf once, in
//   column order (kernels/sinkhorn_lse.py::pack_columns: their indices, their
//   count, their planes and log weights), and keeps the pack for every
//   launch with the same log weights: a Sinkhorn call passes the same log_a
//   and log_b to all of its half-updates.  A CTA stages up to kStage packed
//   columns at once (their planes, log weights, and the dual gathered
//   through the indices; one pass and one barrier for a diagram cloud of
//   the DD rung, ~92 columns), every thread reading them as broadcasts.
//   Each thread then walks the staged columns in chunks of kChunk: it forms
//   the chunk's z values once, keeps them in registers, takes their maximum,
//   sums exp(z - max) in column order, and merges (max, shifted sum) into
//   its running pair, the block algebra of the TPU kernel's _lse_kernel.  A
//   column of log weight -inf has z = -inf and moves neither the maximum nor
//   the sum, so leaving it out changes no bit; columns past the count are
//   never read.  Exponents of -inf - (-inf) count as exp(-inf) = 0, as
//   repro's _safe_exp does.  The cost and z are formed with explicit
//   round-to-nearest intrinsics: no fused multiply-add contraction and a true
//   division, so each z is bitwise the z of the plain PyTorch version (one
//   ulp of z at the last eps stage is ~1e-4 relative after exp).  No
//   atomics: equal inputs give equal bits.
// sinkhorn_pair_sum: one launch, in the work mapping that
//   kernels/sinkhorn_lse.py::layout derives from B, M, N and the SM count:
//   `per_item` CTAs an item, each owning a share of `share` consecutive rows
//   (one CTA an item when the batch alone fills the card, several when it
//   is small), `kThreads` threads a CTA (64 to 512).  A CTA compacts its
//   share's rows of finite log weight, in row order, into shared memory
//   (planes, f, log_a), and the item's columns of finite log weight the same
//   way (planes, g, log_b).  A compaction step scans kSlots * kThreads slots,
//   coalesced: one ballot per slot a thread, one count per (slot, warp) and
//   one exclusive scan by a warp, two barriers.  Where the share and the
//   columns each fit one step and one stage of 2 * kThreads (the main path's
//   inputs), both sides go through one step side by side; otherwise a stage
//   of rows at a time, and for each the columns a stage at a time, a stage
//   that would overflow ending at a slot that the next resumes from.  A CTA
//   whose share holds no row of finite weight stops after its compaction.
//   The nr x nc pairs of a row stage and a column stage are spread over all
//   threads: thread t takes pairs p = t, t + kThreads, ... (row p / nc,
//   column p % nc) and adds their terms to its own sum in that order,
//   across the stages in order.  Each term is
//   formed as in the plain version, with the same cost() and the same
//   __fsub_rn/__fdiv_rn/__fadd_rn/expf chain.  A fixed halving tree sums the
//   CTA's threads (s[t] += s[t + h], h = kThreads / 2 ... 1); with one CTA
//   an item it is the item's sum.  With several, each CTA stores its sum,
//   and the last CTA of the item to finish (the one that draws the last
//   ticket of a per-item counter, which it resets to 0 for the next launch)
//   adds the item's partials in CTA order.  No float atomics, so equal
//   inputs give equal bits from run to run, which the Sinkhorn divergence
//   needs for a self-distance of exactly 0.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 128;  // LSE: threads per CTA, one output row each
constexpr int kStage = 512;  // LSE: packed columns staged at once
constexpr int kChunk = 16;   // LSE: z values a thread keeps in registers
constexpr int kSlots = 8;    // pair sum: slots a thread scans per step

__device__ __forceinline__ float cost(float xb, float xd, bool xdiag,
                                      float yb, float yd, float yf) {
  const float dx = __fsub_rn(xb, yb);
  const float dy = __fsub_rn(xd, yd);
  const float c = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  return (xdiag && yf > 0.f) ? 0.f : c;
}

// exp with NaN exponents (from -inf - (-inf)) taken as exp(-inf) = 0
__device__ __forceinline__ float safe_exp(float t) {
  return isnan(t) ? 0.f : expf(t);
}

__global__ void __launch_bounds__(kRows)
sinkhorn_lse_kernel(const float* __restrict__ xp, const float* __restrict__ yq,
                    const int* __restrict__ idx, const int* __restrict__ count,
                    const float* __restrict__ dual,
                    const float* __restrict__ lwq,
                    const float* __restrict__ e_t, float* __restrict__ out,
                    int m, int n) {
  // a staged column: (birth, death, diagonal flag, dual), and its log weight
  __shared__ float4 s_col[kStage];
  __shared__ float s_logw[kStage];
  const int b = blockIdx.x;
  const int i = blockIdx.y * kRows + threadIdx.x;
  const bool live = i < m;
  const float* x = xp + (size_t)b * 3 * m;
  const float* y = yq + (size_t)b * 3 * n;
  const int* ix = idx + (size_t)b * n;
  const float* du = dual + (size_t)b * n;
  const float* lw = lwq + (size_t)b * n;
  float xb = 0.f, xd = 0.f;
  bool xdiag = false;
  if (live) {
    xb = x[i];
    xd = x[m + i];
    xdiag = x[2 * m + i] > 0.f;
  }
  const int weighted = count[b];
  const float e = e_t[b];
  float m_run = -INFINITY, s_run = 0.f;
  for (int j0 = 0; j0 < weighted; j0 += kStage) {
    const int cols = min(kStage, weighted - j0);
    // whole chunks: the padding columns have log weight -inf, so z = -inf,
    // which moves neither the maximum nor the sum (exp(-inf) adds +0)
    const int padded = (cols + kChunk - 1) / kChunk * kChunk;
    if (j0 > 0) __syncthreads();  // the previous stage is no longer read
    for (int t = threadIdx.x; t < padded; t += kRows) {
      const int q = j0 + t;
      const bool real = t < cols;
      s_col[t] = real ? make_float4(y[q], y[n + q], y[2 * n + q], du[ix[q]])
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      s_logw[t] = real ? lw[q] : -INFINITY;
    }
    __syncthreads();
    if (!live) continue;
    for (int c0 = 0; c0 < padded; c0 += kChunk) {
      float z[kChunk];
      float m_blk = -INFINITY;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int t = c0 + u;
        const float4 col = s_col[t];
        const float c = cost(xb, xd, xdiag, col.x, col.y, col.z);
        z[u] = __fadd_rn(s_logw[t], __fdiv_rn(__fsub_rn(col.w, c), e));
        m_blk = fmaxf(m_blk, z[u]);
      }
      float s_blk = 0.f;
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
        s_blk = __fadd_rn(s_blk, safe_exp(__fsub_rn(z[u], m_blk)));
      const float m_new = fmaxf(m_run, m_blk);
      s_run = __fadd_rn(__fmul_rn(s_run, safe_exp(__fsub_rn(m_run, m_new))),
                        __fmul_rn(s_blk, safe_exp(__fsub_rn(m_blk, m_new))));
      m_run = m_new;
    }
  }
  if (live)
    out[(size_t)b * m + i] =
        isfinite(m_run) ? __fadd_rn(m_run, logf(s_run)) : -INFINITY;
}

// A compaction's scratch: the kept slots per (slot k, warp), turned into
// their exclusive prefix in place, the step's total, and where an
// overflowing stage resumes.
template <int kThreads>
struct ScanScratch {
  static constexpr int kEntries = kSlots * (kThreads / 32);
  int count[kEntries];
  int total;
  int resume;
};

// A compaction step's loads: slot at + k * kThreads + t for thread t, -inf
// from hi on.
template <int kThreads>
__device__ __forceinline__ void load_slots(const float* __restrict__ logw,
                                           int at, int hi,
                                           float (&w)[kSlots]) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int j = at + k * kThreads + threadIdx.x;
    w[k] = j < hi ? logw[j] : -INFINITY;
  }
}

// The warp's ballots of its finite slots, and lane 0's counts of them.
template <int kThreads>
__device__ __forceinline__ void count_slots(const float (&w)[kSlots],
                                            unsigned (&kept)[kSlots],
                                            ScanScratch<kThreads>& sc) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    kept[k] = __ballot_sync(0xffffffffu, isfinite(w[k]));
  __syncwarp();  // this warp's reads of the previous step's prefix are done
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      sc.count[k * kWarps + warp] = __popc(kept[k]);
  }
}

// One warp turns the counts into their exclusive prefix, in (slot, warp)
// order, which is slot order, and stores the total.
template <int kThreads>
__device__ __forceinline__ void scan_counts(ScanScratch<kThreads>& sc) {
  constexpr int kEntries = ScanScratch<kThreads>::kEntries;
  constexpr int kPerLane = (kEntries + 31) / 32;
  const int lane = threadIdx.x & 31;
  int v[kPerLane], run = 0;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int at = lane * kPerLane + e;
    v[e] = at < kEntries ? sc.count[at] : 0;
    run += v[e];
  }
  int incl = run;
#pragma unroll
  for (int h = 1; h < 32; h <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, h);
    if (lane >= h) incl += o;
  }
  int base = incl - run;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int at = lane * kPerLane + e;
    if (at < kEntries) sc.count[at] = base;
    base += v[e];
  }
  if (lane == 31) sc.total = incl;
}

// Stages the step's finite slots at position filled + their prefix, those
// below cap; the slot at position cap, if there is one, is where the next
// stage resumes.
template <int kThreads, typename Put>
__device__ __forceinline__ void put_slots(int at, const float (&w)[kSlots],
                                          const unsigned (&kept)[kSlots],
                                          int filled, int cap,
                                          ScanScratch<kThreads>& sc,
                                          Put put) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (kept[k] >> lane & 1u) {
      const int q = filled + sc.count[k * kWarps + warp] +
                    __popc(kept[k] & below);
      const int j = at + k * kThreads + threadIdx.x;
      if (q < cap)
        put(q, j, w[k]);
      else if (q == cap)
        sc.resume = j;
    }
  }
}

// Stages, in slot order, the slots of [*cursor, hi) whose log weight is
// finite, up to `cap` of them: put(q, j, w) stores slot j of log weight w at
// compacted position q.  Returns how many it staged and leaves *cursor at
// the first slot not staged.  Every thread of the CTA calls it with the same
// arguments.  A thread's put() writes are not yet visible to the others
// when it returns: the caller synchronises before reading the stage.
template <int kThreads, typename Put>
__device__ __forceinline__ int compact(const float* __restrict__ logw,
                                       int* cursor, int hi, int cap,
                                       ScanScratch<kThreads>& sc, Put put) {
  int at = *cursor, filled = 0;
  while (at < hi && filled < cap) {
    float w[kSlots];
    unsigned kept[kSlots];
    load_slots<kThreads>(logw, at, hi, w);
    count_slots<kThreads>(w, kept, sc);
    __syncthreads();
    if (threadIdx.x < 32) scan_counts<kThreads>(sc);
    __syncthreads();
    const int total = sc.total;
    put_slots<kThreads>(at, w, kept, filled, cap, sc, put);
    if (filled + total > cap) {  // the stage is full inside this step
      __syncthreads();
      at = sc.resume;
      filled = cap;
      break;
    }
    filled += total;
    at += kSlots * kThreads;
  }
  *cursor = min(at, hi);
  return filled;
}

// Adds this thread's pairs of the staged nr rows x nc columns to acc: pairs
// p = t, t + kThreads, ... (row p / nc, column p % nc), in that order.
template <bool kPlan, int kThreads>
__device__ __forceinline__ float add_pairs(
    float acc, int nr, int nc, float e, const float4* s_row,
    const float* s_la, const float4* s_col, const float* s_lb) {
  int i = threadIdx.x / nc, j = threadIdx.x - i * nc;
  const int di = kThreads / nc, dj = kThreads - di * nc;
  while (i < nr) {
    const float4 r = s_row[i], c4 = s_col[j];
    const float c = cost(r.x, r.y, r.z > 0.f, c4.x, c4.y, c4.z);
    if (kPlan) {
      const float z = __fadd_rn(
          __fadd_rn(s_la[i], s_lb[j]),
          __fdiv_rn(__fsub_rn(__fadd_rn(r.w, c4.w), c), e));
      acc = __fadd_rn(acc, __fmul_rn(expf(z), c));
    } else {
      acc = __fadd_rn(acc, c);
    }
    i += di;
    j += dj;
    if (j >= nc) {
      j -= nc;
      ++i;
    }
  }
  return acc;
}

template <bool kPlan, int kThreads>
__global__ void __launch_bounds__(kThreads)
sinkhorn_pair_sum_kernel(const float* __restrict__ xp,
                         const float* __restrict__ yp,
                         const float* __restrict__ f,
                         const float* __restrict__ g,
                         const float* __restrict__ log_a,
                         const float* __restrict__ log_b,
                         const float* __restrict__ e_t,
                         float* __restrict__ partial,
                         unsigned* __restrict__ ticket,
                         float* __restrict__ out, int m, int n, int per_item,
                         int share) {
  constexpr int kCap = 2 * kThreads;  // rows or columns a stage holds
  constexpr int kStep = kSlots * kThreads;  // slots a compaction step scans
  // a staged row: (birth, death, diagonal flag, f) and log_a; a staged
  // column: (birth, death, diagonal flag, g) and log_b
  __shared__ float4 s_row[kCap], s_col[kCap];
  __shared__ float s_la[kCap], s_lb[kCap];
  __shared__ float s_sum[kThreads];
  __shared__ ScanScratch<kThreads> sc_row, sc_col;
  const int b = blockIdx.x / per_item;
  const int part = blockIdx.x - b * per_item;
  const int r_lo = part * share;
  const int r_hi = min(m, r_lo + share);
  const float* x = xp + (size_t)b * 3 * m;
  const float* y = yp + (size_t)b * 3 * n;
  const float* fb = f + (size_t)b * m;
  const float* gb = g + (size_t)b * n;
  const float* la = log_a + (size_t)b * m;
  const float* lb = log_b + (size_t)b * n;
  const float e = kPlan ? e_t[b] : 1.f;
  auto put_row = [=](int q, int i, float w) {
    s_row[q] = make_float4(x[i], x[m + i], x[2 * m + i], kPlan ? fb[i] : 0.f);
    s_la[q] = w;
  };
  auto put_col = [=](int q, int j, float w) {
    s_col[q] = make_float4(y[j], y[n + j], y[2 * n + j], kPlan ? gb[j] : 0.f);
    s_lb[q] = w;
  };
  float acc = 0.f;
  bool any = false;  // the share holds a row of finite weight
  bool staged = false;
  if (r_hi - r_lo <= kStep && n <= kStep) {
    // the rows and the columns each in one step, side by side: one round
    // of loads and two barriers, then both stages if both fit
    float wr[kSlots], wc[kSlots];
    unsigned kr[kSlots], kc[kSlots];
    load_slots<kThreads>(la, r_lo, r_hi, wr);
    load_slots<kThreads>(lb, 0, n, wc);
    count_slots<kThreads>(wr, kr, sc_row);
    count_slots<kThreads>(wc, kc, sc_col);
    __syncthreads();
    if (threadIdx.x < 32)
      scan_counts<kThreads>(sc_row);
    else if (threadIdx.x < 64)
      scan_counts<kThreads>(sc_col);
    __syncthreads();
    const int nr = sc_row.total, nc = sc_col.total;
    if (nr <= kCap && nc <= kCap) {
      staged = true;
      any = nr > 0;
      if (any && nc > 0) {
        put_slots<kThreads>(r_lo, wr, kr, 0, kCap, sc_row, put_row);
        put_slots<kThreads>(0, wc, kc, 0, kCap, sc_col, put_col);
        __syncthreads();  // both stages visible
        acc = add_pairs<kPlan, kThreads>(acc, nr, nc, e, s_row, s_la, s_col,
                                         s_lb);
      }
    }
  }
  // otherwise stage by stage: a stage of rows, then the columns a stage at
  // a time
  for (int r_at = r_lo; !staged && r_at < r_hi;) {
    const int nr = compact<kThreads>(la, &r_at, r_hi, kCap, sc_row, put_row);
    if (nr == 0) break;
    any = true;
    for (int c_at = 0; c_at < n;) {
      const int nc = compact<kThreads>(lb, &c_at, n, kCap, sc_col, put_col);
      if (nc == 0) break;
      __syncthreads();  // both stages visible
      acc = add_pairs<kPlan, kThreads>(acc, nr, nc, e, s_row, s_la, s_col,
                                       s_lb);
    }
  }
  float total = 0.f;  // a share with no weighted row sums to exactly 0
  if (any) {
    // fixed halving tree over the CTA's threads
    s_sum[threadIdx.x] = acc;
    __syncthreads();
#pragma unroll
    for (int h = kThreads / 2; h >= 32; h >>= 1) {
      if (threadIdx.x < h)
        s_sum[threadIdx.x] = __fadd_rn(s_sum[threadIdx.x],
                                       s_sum[threadIdx.x + h]);
      __syncthreads();
    }
    if (threadIdx.x < 32) {
      float v = s_sum[threadIdx.x];
#pragma unroll
      for (int h = 16; h > 0; h >>= 1)
        v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, h));
      total = v;
    }
  }
  if (threadIdx.x != 0) return;
  if (per_item == 1) {
    out[b] = total;
    return;
  }
  // several CTAs an item: the last to finish sums the partials in order
  partial[blockIdx.x] = total;
  __threadfence();
  if (atomicAdd(&ticket[b], 1u) != (unsigned)per_item - 1u) return;
  __threadfence();
  const float* p = partial + (size_t)b * per_item;
  float s = 0.f;
  for (int k = 0; k < per_item; ++k) s = __fadd_rn(s, __ldcg(p + k));
  out[b] = s;
  ticket[b] = 0u;  // ready for the next launch on this stream
}

template <bool kPlan, int kThreads>
int launch_pair_sum(const void* xp, const void* yp, const void* f,
                    const void* g, const void* log_a, const void* log_b,
                    const void* e_t, void* partial, void* ticket, void* out,
                    int b, int m, int n, int per_item, int share,
                    cudaStream_t s) {
  sinkhorn_pair_sum_kernel<kPlan, kThreads>
      <<<(unsigned)b * (unsigned)per_item, kThreads, 0, s>>>(
          (const float*)xp, (const float*)yp, (const float*)f,
          (const float*)g, (const float*)log_a, (const float*)log_b,
          (const float*)e_t, (float*)partial, (unsigned*)ticket, (float*)out,
          m, n, per_item, share);
  return (int)cudaGetLastError();
}

template <bool kPlan>
int launch_pair_sum_threads(int threads, const void* xp, const void* yp,
                            const void* f, const void* g, const void* log_a,
                            const void* log_b, const void* e_t, void* partial,
                            void* ticket, void* out, int b, int m, int n,
                            int per_item, int share, cudaStream_t s) {
  switch (threads) {
    case 64:
      return launch_pair_sum<kPlan, 64>(xp, yp, f, g, log_a, log_b, e_t,
                                        partial, ticket, out, b, m, n,
                                        per_item, share, s);
    case 128:
      return launch_pair_sum<kPlan, 128>(xp, yp, f, g, log_a, log_b, e_t,
                                         partial, ticket, out, b, m, n,
                                         per_item, share, s);
    case 256:
      return launch_pair_sum<kPlan, 256>(xp, yp, f, g, log_a, log_b, e_t,
                                         partial, ticket, out, b, m, n,
                                         per_item, share, s);
    case 512:
      return launch_pair_sum<kPlan, 512>(xp, yp, f, g, log_a, log_b, e_t,
                                         partial, ticket, out, b, m, n,
                                         per_item, share, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// xp (B,3,M) float32; the packed columns of the y side: yq (B,3,N) planes,
// idx (B,N) int32 column indices, count (B,) int32, lwq (B,N) log weights
// (entries past count[b] are not read); dual (B,N) and e_t (B,) float32;
// out (B,M).  Contiguous, on the device of ``stream``.
extern "C" int sinkhorn_lse_launch(const void* xp, const void* yq,
                                   const void* idx, const void* count,
                                   const void* dual, const void* lwq,
                                   const void* e_t, void* out, int b, int m,
                                   int n, void* stream) {
  if (b <= 0 || m <= 0) return 0;
  const dim3 grid(b, (m + kRows - 1) / kRows);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  sinkhorn_lse_kernel<<<grid, kRows, 0, (cudaStream_t)stream>>>(
      (const float*)xp, (const float*)yq, (const int*)idx, (const int*)count,
      (const float*)dual, (const float*)lwq, (const float*)e_t, (float*)out,
      m, n);
  return (int)cudaGetLastError();
}

// xp (B,3,M), yp (B,3,N), f/log_a (B,M), g/log_b (B,N), e_t (B,) float32;
// out (B,).  The layout (kernels/sinkhorn_lse.py::layout): `per_item` CTAs
// an item of `threads` threads, each owning `share` rows; with per_item > 1,
// partial (B * per_item,) float32 scratch and ticket (B,) uint32 counters,
// zero before the launch and left zero by it.  plan != 0: the plan sum.
extern "C" int sinkhorn_pair_sum_launch(const void* xp, const void* yp,
                                        const void* f, const void* g,
                                        const void* log_a, const void* log_b,
                                        const void* e_t, void* partial,
                                        void* ticket, void* out, int b, int m,
                                        int n, int plan, int threads,
                                        int per_item, int share,
                                        void* stream) {
  if (b <= 0) return 0;
  if (m <= 0 || per_item <= 0 || share <= 0 ||
      (long long)(per_item - 1) * share >= m ||
      (long long)b * per_item > 0x7fffffffLL ||
      (per_item > 1 && (partial == nullptr || ticket == nullptr)))
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  return plan ? launch_pair_sum_threads<true>(threads, xp, yp, f, g, log_a,
                                              log_b, e_t, partial, ticket,
                                              out, b, m, n, per_item, share, s)
              : launch_pair_sum_threads<false>(threads, xp, yp, f, g, log_a,
                                               log_b, e_t, partial, ticket,
                                               out, b, m, n, per_item, share,
                                               s);
}
