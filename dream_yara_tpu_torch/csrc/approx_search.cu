// Enumerated approximate seed search on Hopper (sm_90a): the SA interval of
// every <= budget-edit layout of each seed's matched window, as
// ops/approx_search.py's plain edition computes it, bit for bit.
//
// Replaces no TPU kernel: the JAX package runs this search as an XLA
// lockstep (dream_yara_tpu/ops/approx_search.py), and so does the plain
// edition. There every (seed, layout) lane advances at every trip of the
// backward search, each trip a row gather and a nibble decode of every
// lane's two fused rows, 2 * S * NL rank queries a trip whether a lane is
// live, dead or padding, in about a hundred launches a trip.
//
// Bounds. The work is the rank rows the live lanes fetch: a 96 B fused row
// a bound a step, from a table that sits in the 50 MB L2 for the port's
// bins. Each lane's steps form a dependent chain (the next row is the
// count of the last), so what bounds the kernel is the latency of those
// chains, not the bytes; its bytes bound is rows fetched x 96 B at
// 3.35 TB/s.
// Design. One block takes one seed. Its matched window goes to shared
// memory; one thread runs the exact lane and records its interval before
// every step. A layout lane reads the exact lane's chars up to its first
// edit (its branch step, eff - back, `back` given per layout by the host:
// ops/approx_search.py::layout_branch), so it starts there from the
// recorded interval, derives its char at each step from its layout as the
// plain edition does, and stops at the first step whose interval is empty
// (the plain edition freezes such a lane) or at its length. A lane outside
// its window, or of a seed with no window, fetches nothing. Each step
// loads only the 16-byte vectors of the two rows that the rank of its char
// reads (the occ column, the words before the in-block position), both
// rows in flight at once, and counts matching nibbles with popc. The
// fetched rows are counted when the caller asks: one atomicAdd a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROW_VECS = 6;             // a fused row: 24 int32, 6 int4
constexpr int MAX_M = 4096;             // longest matched window
constexpr uint32_t NIBBLE_LSB = 0x11111111u;

__device__ __forceinline__ int col_of(const int4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// The vectors of the fused row of SA position i that the rank of c at i
// reads: occ[c] (vector 0 or 1) and the words of the chars before the
// in-block position (cols 6..21, vectors 1..5). The row is i's block,
// clamped to the table as the row gather clamps; the rest stay 0.
__device__ __forceinline__ void load_row(const int4* __restrict__ fused,
                                         long long nb, int i, int c,
                                         int4 (&v)[ROW_VECS]) {
  long long b = i >> 7;
  b = b < 0 ? 0 : (b >= nb ? nb - 1 : b);
  const int r = i & 127;
  const int4* p = fused + b * ROW_VECS;
  const int last = (c >= 0 && c < 8 && r > 0) ? (6 + ((r - 1) >> 3)) >> 2 : 0;
#pragma unroll
  for (int k = 0; k < ROW_VECS; ++k) {
    const bool need = (k == 0 && c >= 0 && c < 4)
                      || (k == 1 && (c == 4 || c == 5)) || (k >= 1 && k <= last);
    v[k] = need ? __ldg(p + k) : make_int4(0, 0, 0, 0);
  }
}

// Occurrences of c in bwt[0 : i) from i's row: ops/rank.py::rank_fused_rows.
// Symbols outside 0..5 have no occ column, outside 0..7 match no char. The
// words are uint32 (bit 31 is live); a char is 3 bits of its nibble, so
// the XOR with c zeroes a match and bits 0..2 OR into the nibble's bit 0.
// Words before r >> 3 count whole, word r >> 3 its first r & 7 nibbles
// (a right shift of 4..28 bits: no shift reaches the word's width).
__device__ __forceinline__ int rank_in_row(const int4 (&v)[ROW_VECS], int c,
                                           int i) {
  const int r = i & 127;
  const int base = c == 0 ? v[0].x : c == 1 ? v[0].y : c == 2 ? v[0].z
                 : c == 3 ? v[0].w : c == 4 ? v[1].x : c == 5 ? v[1].y : 0;
  if (c < 0 || c >= 8) return base;
  const uint32_t cc = static_cast<uint32_t>(c) * NIBBLE_LSB;
  const int q = r >> 3, rem = r & 7;
  const uint32_t partial = rem == 0 ? 0u : NIBBLE_LSB >> (32 - 4 * rem);
  int hits = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t w = static_cast<uint32_t>(col_of(v[(6 + j) >> 2], (6 + j) & 3));
    const uint32_t x = w ^ cc;
    const uint32_t mask = j < q ? NIBBLE_LSB : (j == q ? partial : 0u);
    hits += __popc(~(x | (x >> 1) | (x >> 2)) & mask);
  }
  return base + hits;
}

// One backward-search step of the interval [lo, hi) by char c: both rows
// are loaded before either is counted. counts[c] indexes as the plain
// edition's tensor index does (a negative c from the end); a char outside
// the table counts 0 (the plain edition raises there).
__device__ __forceinline__ void extend(const int4* __restrict__ fused,
                                       long long nb,
                                       const int* __restrict__ counts,
                                       int n_counts, int c, int& lo, int& hi) {
  int4 a[ROW_VECS], b[ROW_VECS];
  load_row(fused, nb, lo, c, a);
  load_row(fused, nb, hi, c, b);
  const int ci = c < 0 ? c + n_counts : c;
  const int cnt = (ci >= 0 && ci < n_counts) ? __ldg(counts + ci) : 0;
  const int nlo = cnt + rank_in_row(a, c, lo);
  const int nhi = cnt + rank_in_row(b, c, hi);
  lo = nlo;
  hi = nhi;
}

// The char a lane reads at step t (ops/approx_search.py::_lane_step): the
// window index counts back from the end; a deletion skips p1, an insertion
// consumes its char a1 at t == eff - p1; substitutions replace ACGT only.
__device__ __forceinline__ int lane_char(const signed char* win, int eff,
                                         int t, int kind, int p1, int a1,
                                         int p2, int a2) {
  const int base = eff - 1 - t;
  int idx = base;
  if (kind == 2) idx = t < eff - 1 - p1 ? base : base - 1;
  else if (kind == 3) idx = t < eff - p1 ? base : base + 1;
  // never engages for a valid layout at an active step
  idx = idx < 0 ? 0 : (idx >= eff ? eff - 1 : idx);
  int c = win[idx];
  if (c < 4) {
    if (kind == 1 && idx == p1) c = (c + a1) & 3;
    if (kind == 4 && idx == p1) c = (c + a1) & 3;
    if (kind == 4 && idx == p2) c = (c + a2) & 3;
  }
  if (kind == 3 && t == eff - p1) c = a1;
  return c;
}

__global__ void __launch_bounds__(THREADS)
approx_seed_search(const int4* __restrict__ fused, long long nb,
                   const int* __restrict__ counts, int n_counts,
                   const int* __restrict__ n_ptr,
                   const signed char* __restrict__ reads, int L,
                   const int* __restrict__ rows, const int* __restrict__ starts,
                   const int* __restrict__ slens, int m,
                   const int* __restrict__ layouts, int nl,
                   int* __restrict__ lo_out, int* __restrict__ hi_out,
                   unsigned char* __restrict__ valid_out,
                   int* __restrict__ w_start_out,
                   unsigned long long* __restrict__ fetched) {
  extern __shared__ int smem[];
  int* rec_lo = smem;                     // the exact lane before step t,
  int* rec_hi = smem + (m + 1);           // t = 0..eff
  signed char* win = reinterpret_cast<signed char*>(smem + 2 * (m + 1));
  __shared__ unsigned long long block_fetched;

  const long long s = blockIdx.x;
  const int slen = slens[s];
  const int eff = slen < m ? slen : m;
  const int w_start = starts[s] + slen - eff;
  const bool seeded = slen > 0;
  if (threadIdx.x == 0) {
    w_start_out[s] = w_start;
    block_fetched = 0;
  }
  const long long rbase = static_cast<long long>(rows[s]) * L;
  for (int j = threadIdx.x; j < eff; j += THREADS) {
    int ri = w_start + j;
    ri = ri < 0 ? 0 : (ri >= L ? L - 1 : ri);
    win[j] = reads[rbase + ri];
  }
  __syncthreads();

  unsigned int my_fetched = 0;
  if (threadIdx.x == 0 && seeded) {
    int lo = 0, hi = *n_ptr;
    for (int t = 0; t < eff; ++t) {
      rec_lo[t] = lo;
      rec_hi[t] = hi;
      if (lo < hi) {
        extend(fused, nb, counts, n_counts, win[eff - 1 - t], lo, hi);
        my_fetched += 2;
      }
    }
    rec_lo[eff] = lo;
    rec_hi[eff] = hi;
  }
  __syncthreads();

  for (int l = threadIdx.x; l < nl; l += THREADS) {
    const int kind = __ldg(layouts + l);
    const int p1 = __ldg(layouts + nl + l);
    const int p2 = __ldg(layouts + 3 * nl + l);
    int lo = 0, hi = 0;
    bool ok = false;
    if (seeded && p1 < eff && (kind != 4 || p2 < eff)) {
      const int a1 = __ldg(layouts + 2 * nl + l);
      const int a2 = __ldg(layouts + 4 * nl + l);
      const int back = __ldg(layouts + 5 * nl + l);
      const int lane_len = eff + __ldg(layouts + 6 * nl + l);
      int t = eff - back;
      t = t > lane_len ? lane_len : t;
      t = t < 0 ? 0 : t;
      lo = rec_lo[t];
      hi = rec_hi[t];
      for (; t < lane_len && lo < hi; ++t) {
        extend(fused, nb, counts, n_counts,
               lane_char(win, eff, t, kind, p1, a1, p2, a2), lo, hi);
        my_fetched += 2;
      }
      ok = lo < hi && lane_len > 0;
      hi = hi > lo ? hi : lo;
    }
    const long long o = s * nl + l;
    lo_out[o] = lo;
    hi_out[o] = hi;
    valid_out[o] = ok;
  }

  if (fetched != nullptr) {             // the same branch for the whole block
    const unsigned int warp_sum = __reduce_add_sync(0xffffffffu, my_fetched);
    if ((threadIdx.x & 31) == 0)
      atomicAdd(&block_fetched, static_cast<unsigned long long>(warp_sum));
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(fetched, block_fetched);
  }
}

}  // namespace

// fused: (nb, 24) int32 fused rank rows, 16-byte aligned; counts: (n_counts,)
// int32; n: a device int32, the text length; reads: (R2, L) int8; rows,
// starts, slens: (S,) int32; layouts: (7, nl) int32 tables kind, p1, a1, p2,
// a2, back, dlen; lo, hi: (S, nl) int32, valid: (S, nl) bool, w_start: (S,)
// int32, all written; fetched: a device int64 the rank rows fetched are
// added to, or null. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue (nothing launched) for arguments outside that
// contract.
extern "C" int dy_approx_search(const void* fused, long long nb,
                                const void* counts, int n_counts, const void* n,
                                const void* reads, int L, const void* rows,
                                const void* starts, const void* slens,
                                long long S, int m, const void* layouts, int nl,
                                void* lo, void* hi, void* valid, void* w_start,
                                void* fetched, cudaStream_t stream) {
  if (nb <= 0 || n_counts <= 0 || L <= 0 || S < 0 || S > 0x7fffffffLL
      || m < 1 || m > MAX_M || nl < 1
      || reinterpret_cast<uintptr_t>(fused) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return static_cast<int>(cudaSuccess);
  const size_t shared = sizeof(int) * 2 * (m + 1) + ((m + 3) & ~3);
  approx_seed_search<<<static_cast<unsigned>(S), THREADS, shared, stream>>>(
      static_cast<const int4*>(fused), nb, static_cast<const int*>(counts),
      n_counts, static_cast<const int*>(n),
      static_cast<const signed char*>(reads), L,
      static_cast<const int*>(rows), static_cast<const int*>(starts),
      static_cast<const int*>(slens), m, static_cast<const int*>(layouts), nl,
      static_cast<int*>(lo), static_cast<int*>(hi),
      static_cast<unsigned char*>(valid), static_cast<int*>(w_start),
      static_cast<unsigned long long*>(fetched));
  return static_cast<int>(cudaGetLastError());
}
