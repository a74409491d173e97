// Masked Hamming distances over packed LSH codes for Hopper (sm_90a), bound
// to Python through ctypes.
//
// Replaces: src/repro/kernels/hamming.py::hamming_scan_pallas,
//   dist[i,j] = sum_w popcount((q[i,w] ^ c[j,w]) & m[i,w])  over (Q,W)
//   query codes and masks and (N,W) corpus codes, 32-bit words, which the
//   TPU kernel computes as (TQ, TN, W) broadcast blocks in VMEM reduced over
//   the word axis into an int32 (TQ, TN) tile.
//
// What bounds it on an H100: bytes.  Per (i, j, w) the work is XOR, AND, a
//   popcount and an add; the popcount unit does 16 per SM per clock (4.18e12/s)
//   and the lane instructions run at 33.5e12/s, while the int32 (Q,N) output
//   alone is 4 bytes per (i, j).  At W = 4 the output's bytes (4 B at
//   3.35 TB/s, 1.2 ps) outweigh the 4 popcounts (0.96 ps) and 12 lane
//   instructions (0.36 ps) of one (i, j).  At the index's 256 x 4096 that
//   bound is ~1.3 us, so a launch there costs its launch latency.
//
// Design: a CTA of 128 threads covers `group` queries x 512 corpus rows, in
//   the launch shape kernels/hamming.py::layout picks; the grid runs the
//   query groups of one row block next to each other, so the row block is
//   read from L2 by all of them.  A thread owns 4 consecutive corpus rows,
//   so for each query it writes one 16-byte streaming store (st.global.cs:
//   the output is not read again here) and a warp writes 512 consecutive
//   bytes of an output row (4-byte stores where N is not a multiple of 4 or
//   at a ragged tail).  Up to W = 8 words (lsh_bits <= 256)
//   the four rows' 4W words are one contiguous run that the thread loads
//   with W 16-byte loads into registers, issued before the CTA's query and
//   mask words are staged in shared memory once, behind one barrier.  Wider codes take
//   a chunked path: 8 words a step, the query and mask words of the step
//   staged for 16 queries.  Three masked words feed two popcounts through
//   a carry-save step, popc(a) + popc(b) + popc(c) = 2 popc(maj(a, b, c)) +
//   popc(a ^ b ^ c), which is exact.  Words past W, rows past N and queries
//   past Q load as 0, so the host pads nothing; only in-range outputs are
//   written.  The words are read as unsigned, so a word with bit 31 set
//   (negative as int32) is no different from any other.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 4;
constexpr int kTileN = kThreads * kRowsPerThread;  // corpus rows a CTA, 512
constexpr int kMaxRegWords = 8;  // the register path's widest code
constexpr int kChunk = 8;        // chunked path: words a step
constexpr int kChunkGroup = 16;  // chunked path: queries a CTA
static_assert(kChunk * kChunkGroup == kThreads, "a thread stages one word");

// sum of the popcounts of x[0..K), three words at a time through a
// carry-save step
template <int K>
__device__ __forceinline__ int popc_sum(const uint32_t* x) {
  int s = 0;
  int w = 0;
#pragma unroll
  for (; w + 3 <= K; w += 3) {
    const uint32_t a = x[w], b = x[w + 1], c = x[w + 2];
    const uint32_t maj = (a & b) | (a & c) | (b & c);
    s += 2 * __popc(maj) + __popc(a ^ b ^ c);
  }
#pragma unroll
  for (; w < K; ++w) s += __popc(x[w]);
  return s;
}

// the 4 distances of a thread's rows for one query, or the row block's
// chunk of them: rows r of cw[r * K + w], query and mask words qs[w], ms[w]
template <int K>
__device__ __forceinline__ void distances(const uint32_t* qs,
                                          const uint32_t* ms,
                                          const uint32_t (&cw)[4 * K],
                                          int (&d)[4]) {
  uint32_t qw[K], mw[K];
#pragma unroll
  for (int w = 0; w < K; ++w) {
    qw[w] = qs[w];
    mw[w] = ms[w];
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    uint32_t x[K];
#pragma unroll
    for (int w = 0; w < K; ++w) x[w] = (qw[w] ^ cw[r * K + w]) & mw[w];
    d[r] = popc_sum<K>(x);
  }
}

__device__ __forceinline__ void store4(int32_t* dst, long long j0, int n,
                                       const int (&d)[4], bool vec) {
  if (vec && j0 + kRowsPerThread <= n) {
    // streaming: the output is written once and not read back here
    __stcs(reinterpret_cast<int4*>(dst), make_int4(d[0], d[1], d[2], d[3]));
    return;
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
    if (j0 + r < n) dst[r] = d[r];
}

// W <= 8: the codes in registers.  Shared memory: group x W query words,
// then group x W mask words.
template <int W>
__global__ void __launch_bounds__(kThreads)
hamming_scan_regs_kernel(const uint32_t* __restrict__ q,
                         const uint32_t* __restrict__ m,
                         const uint32_t* __restrict__ c,
                         int32_t* __restrict__ out, int nq, int n, int group,
                         int qgroups, bool vec_load, bool vec_store) {
  extern __shared__ uint32_t s_words[];
  uint32_t* s_q = s_words;
  uint32_t* s_m = s_words + group * W;
  const int gq = blockIdx.x % qgroups;
  const long long rb = blockIdx.x / qgroups;
  const int q0 = gq * group;
  const int nqg = min(group, nq - q0);
  const long long j0 = (rb * kThreads + threadIdx.x) * kRowsPerThread;
  // the corpus rows first, so their loads are in flight during the staging
  uint32_t cw[kRowsPerThread * W];
  if (vec_load && j0 + kRowsPerThread <= n) {
    // rows j0..j0+3 are 4W contiguous words starting 16 * W * (j0 / 4)
    // bytes in: W aligned 16-byte loads
    const uint4* src = reinterpret_cast<const uint4*>(c + j0 * W);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const uint4 v = src[k];
      cw[4 * k] = v.x;
      cw[4 * k + 1] = v.y;
      cw[4 * k + 2] = v.z;
      cw[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int w = 0; w < W; ++w)
        cw[r * W + w] = j0 + r < n ? c[(j0 + r) * W + w] : 0u;
  }
  for (int t = threadIdx.x; t < group * W; t += kThreads) {
    const bool in = t < nqg * W;
    const long long at = (long long)q0 * W + t;
    s_q[t] = in ? q[at] : 0u;
    s_m[t] = in ? m[at] : 0u;
  }
  __syncthreads();
  if (j0 >= n) return;
  int32_t* dst = out + (long long)q0 * n + j0;
  for (int i = 0; i < nqg; ++i, dst += n) {
    int d[kRowsPerThread];
    distances<W>(s_q + i * W, s_m + i * W, cw, d);
    store4(dst, j0, n, d, vec_store);
  }
}

// W > 8: kChunk words a step, the step's query and mask words staged for
// kChunkGroup queries.
__global__ void __launch_bounds__(kThreads)
hamming_scan_chunked_kernel(const uint32_t* __restrict__ q,
                            const uint32_t* __restrict__ m,
                            const uint32_t* __restrict__ c,
                            int32_t* __restrict__ out, int nq, int n, int w,
                            int qgroups, bool vec_store) {
  __shared__ uint32_t s_q[kChunkGroup][kChunk];
  __shared__ uint32_t s_m[kChunkGroup][kChunk];
  const int gq = blockIdx.x % qgroups;
  const long long rb = blockIdx.x / qgroups;
  const int q0 = gq * kChunkGroup;
  const int nqg = min(kChunkGroup, nq - q0);
  const long long j0 = (rb * kThreads + threadIdx.x) * kRowsPerThread;
  int acc[kChunkGroup][kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kChunkGroup; ++i)
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[i][r] = 0;
  for (int w0 = 0; w0 < w; w0 += kChunk) {
    {
      const int i = threadIdx.x / kChunk, k = threadIdx.x % kChunk;
      const bool in = i < nqg && w0 + k < w;
      const long long at = (long long)(q0 + i) * w + w0 + k;
      s_q[i][k] = in ? q[at] : 0u;
      s_m[i][k] = in ? m[at] : 0u;
    }
    uint32_t cw[kRowsPerThread * kChunk];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        cw[r * kChunk + k] = (j0 + r < n && w0 + k < w)
                                 ? c[(j0 + r) * w + w0 + k]
                                 : 0u;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kChunkGroup; ++i) {
      int d[kRowsPerThread];
      distances<kChunk>(s_q[i], s_m[i], cw, d);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[i][r] += d[r];
    }
    __syncthreads();
  }
  if (j0 >= n) return;
  int32_t* dst = out + (long long)q0 * n + j0;
#pragma unroll
  for (int i = 0; i < kChunkGroup; ++i, dst += n)
    if (i < nqg) store4(dst, j0, n, acc[i], vec_store);
}

template <int W>
int launch_regs(const uint32_t* q, const uint32_t* m, const uint32_t* c,
                int32_t* out, int nq, int n, int group, int qgroups,
                unsigned ctas, bool vec_load, bool vec_store,
                cudaStream_t s) {
  hamming_scan_regs_kernel<W>
      <<<ctas, kThreads, 2 * group * W * sizeof(uint32_t), s>>>(
          q, m, c, out, nq, n, group, qgroups, vec_load, vec_store);
  return (int)cudaGetLastError();
}

}  // namespace

// q (Q,W) and m (Q,W) int32 bit patterns, c (N,W), out (Q,N) int32, all
// contiguous; `group` queries a CTA (the layout's; 16 for W > 8).  Returns
// cudaGetLastError() after the launch.
extern "C" int hamming_scan_launch(const void* q, const void* m, const void* c,
                                   void* out, int nq, int n, int w, int group,
                                   void* stream) {
  if (nq <= 0 || n <= 0) return 0;
  if (w <= 0 || group <= 0 || (w > kMaxRegWords && group != kChunkGroup) ||
      2LL * group * w * 4 > 48 * 1024)
    return (int)cudaErrorInvalidConfiguration;
  const long long qgroups = (nq + group - 1) / group;
  const long long ctas = qgroups * ((n + kTileN - 1) / kTileN);
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool vec_load = ((uintptr_t)c & 15u) == 0;
  const bool vec_store = n % 4 == 0 && ((uintptr_t)out & 15u) == 0;
  const uint32_t *qw = (const uint32_t*)q, *mw = (const uint32_t*)m,
                 *cw = (const uint32_t*)c;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const int qg = (int)qgroups;
  const unsigned nb = (unsigned)ctas;
  if (w <= kMaxRegWords) {
    using Launch = int (*)(const uint32_t*, const uint32_t*, const uint32_t*,
                           int32_t*, int, int, int, int, unsigned, bool, bool,
                           cudaStream_t);
    constexpr Launch kLaunch[kMaxRegWords] = {
        launch_regs<1>, launch_regs<2>, launch_regs<3>, launch_regs<4>,
        launch_regs<5>, launch_regs<6>, launch_regs<7>, launch_regs<8>};
    return kLaunch[w - 1](qw, mw, cw, o, nq, n, group, qg, nb, vec_load,
                          vec_store, s);
  }
  hamming_scan_chunked_kernel<<<nb, kThreads, 0, s>>>(qw, mw, cw, o, nq, n, w,
                                                      qg, vec_store);
  return (int)cudaGetLastError();
}
