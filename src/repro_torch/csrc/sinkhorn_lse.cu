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
// sinkhorn_pair_sum: a CTA of kRows rows walks the y side in tiles of kCols
//   columns, staging each tile's columns of nonzero weight, packed in column
//   order (warp ballots and a prefix over the CTA's four warps).  It keeps a
//   per-thread sum over its row in column order, reduces the CTA's rows in a
//   fixed tree into partial[b, cta], and a second kernel sums each batch
//   item's partials in order: no float atomics, so equal inputs give equal
//   bits from run to run, which the Sinkhorn divergence needs for a
//   self-distance of exactly 0.
// The grid is (B, ceil(M / kRows)), so a wide batch fills the SMs.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 128;  // threads per CTA, one output row each
constexpr int kCols = 128;  // pair sum: y columns staged per tile
constexpr int kStage = 512;  // LSE: packed columns staged at once
constexpr int kChunk = 16;   // LSE: z values a thread keeps in registers
constexpr int kWarps = kRows / 32;
static_assert(kRows == kCols, "each thread stages one column of a tile");

// Where thread t's column goes among the tile's kept columns (those with
// keep set, in column order), and how many there are.  Every thread of the
// CTA must call it; it ends with the CTA synchronised.
__device__ __forceinline__ int pack_slot(bool keep, int* s_warp, int* kept) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int base = 0, total = 0;
  for (int k = 0; k < kWarps; ++k) {
    base += k < warp ? s_warp[k] : 0;
    total += s_warp[k];
  }
  *kept = total;
  return base + __popc(ballot & ((1u << lane) - 1u));
}

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

template <bool kPlan>
__global__ void __launch_bounds__(kRows)
sinkhorn_pair_sum_kernel(const float* __restrict__ xp,
                         const float* __restrict__ yp,
                         const float* __restrict__ f,
                         const float* __restrict__ g,
                         const float* __restrict__ log_a,
                         const float* __restrict__ log_b,
                         const float* __restrict__ e_t,
                         float* __restrict__ partial, int m, int n) {
  __shared__ float s_yb[kCols], s_yd[kCols], s_yf[kCols], s_g[kCols],
      s_lb[kCols];
  __shared__ float s_sum[kRows];
  __shared__ int s_warp[kWarps];
  const int b = blockIdx.x;
  const int i = blockIdx.y * kRows + threadIdx.x;
  const float* x = xp + (size_t)b * 3 * m;
  const float* y = yp + (size_t)b * 3 * n;
  float xb = 0.f, xd = 0.f, fi = 0.f, la = -INFINITY;
  bool xdiag = false;
  if (i < m) {
    xb = x[i];
    xd = x[m + i];
    xdiag = x[2 * m + i] > 0.f;
    la = log_a[(size_t)b * m + i];
    if (kPlan) fi = f[(size_t)b * m + i];
  }
  const bool live = isfinite(la);  // rows past M and invalid rows add nothing
  const float e = kPlan ? e_t[b] : 1.f;
  float acc = 0.f;
  for (int j0 = 0; j0 < n; j0 += kCols) {
    const int j = j0 + threadIdx.x;
    const float lb_j = j < n ? log_b[(size_t)b * n + j] : -INFINITY;
    __syncthreads();
    int cols;
    const int slot = pack_slot(isfinite(lb_j), s_warp, &cols);
    if (isfinite(lb_j)) {
      s_yb[slot] = y[j];
      s_yd[slot] = y[n + j];
      s_yf[slot] = y[2 * n + j];
      s_lb[slot] = lb_j;
      if (kPlan) s_g[slot] = g[(size_t)b * n + j];
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < cols; ++t) {
      const float lb = s_lb[t];
      const float c = cost(xb, xd, xdiag, s_yb[t], s_yd[t], s_yf[t]);
      if (kPlan) {
        const float z = __fadd_rn(
            __fadd_rn(la, lb),
            __fdiv_rn(__fsub_rn(__fadd_rn(fi, s_g[t]), c), e));
        acc = __fadd_rn(acc, __fmul_rn(expf(z), c));
      } else {
        acc = __fadd_rn(acc, c);
      }
    }
  }
  // fixed-order tree over the CTA's rows
  s_sum[threadIdx.x] = acc;
  __syncthreads();
  for (int h = kRows / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h)
      s_sum[threadIdx.x] = __fadd_rn(s_sum[threadIdx.x],
                                     s_sum[threadIdx.x + h]);
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[(size_t)b * gridDim.y + blockIdx.y] = s_sum[0];
}

__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int b, int parts) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= b) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p)
    s = __fadd_rn(s, partial[(size_t)k * parts + p]);
  out[k] = s;
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

// Rows per CTA, so the caller can size the pair sum's partial scratch.
extern "C" int sinkhorn_rows_per_cta() { return kRows; }

// xp (B,3,M), yp (B,3,N), f/log_a (B,M), g/log_b (B,N), e_t (B,),
// partial (B, ceil(M / sinkhorn_rows_per_cta())) scratch, out (B,).
// plan != 0: the plan sum.
extern "C" int sinkhorn_pair_sum_launch(const void* xp, const void* yp,
                                        const void* f, const void* g,
                                        const void* log_a, const void* log_b,
                                        const void* e_t, void* partial,
                                        void* out, int b, int m, int n,
                                        int plan, void* stream) {
  if (b <= 0) return 0;
  const int parts = (m + kRows - 1) / kRows;
  cudaStream_t s = (cudaStream_t)stream;
  if (parts == 0) {
    cudaMemsetAsync(out, 0, sizeof(float) * (size_t)b, s);
    return (int)cudaGetLastError();
  }
  if (parts > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(b, parts);
  if (plan)
    sinkhorn_pair_sum_kernel<true><<<grid, kRows, 0, s>>>(
        (const float*)xp, (const float*)yp, (const float*)f, (const float*)g,
        (const float*)log_a, (const float*)log_b, (const float*)e_t,
        (float*)partial, m, n);
  else
    sinkhorn_pair_sum_kernel<false><<<grid, kRows, 0, s>>>(
        (const float*)xp, (const float*)yp, (const float*)f, (const float*)g,
        (const float*)log_a, (const float*)log_b, (const float*)e_t,
        (float*)partial, m, n);
  int err = (int)cudaGetLastError();
  if (err) return err;
  sum_partials_kernel<<<(b + 127) / 128, 128, 0, s>>>(
      (const float*)partial, (float*)out, b, parts);
  return (int)cudaGetLastError();
}
