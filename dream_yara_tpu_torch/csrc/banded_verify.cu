// Banded verification DP on Hopper (sm_90a): stage, then compute.
//
// Replaces dream_yara_tpu/ops/pallas_verify.py::_dp_kernel, the TPU kernel
// behind both of its launchers: banded_verify_pallas (one bin's text,
// entry dy_banded_verify) and banded_verify_pallas_hooked (the flat
// multi-bin step's stacked per-bin text, entry dy_banded_verify_stacked).
// It computes what that kernel and the plain edition
// (dream_yara_tpu_torch/ops/verify.py) compute: the edit distance of the
// whole read against the text window [anchor-E, anchor+len+E), with free
// leading text, band W = 2E+1 and the begin position carried through the
// DP. Codes >= 4 mismatch everything; a read row outside [0, n_rows) reads
// as code 4 and a window position outside [0, n) as code 6. Tie-breaks: a
// read-gap is taken only when strictly smaller than the diagonal; the in-row
// insertion is a running minimum over d taken only when strictly smaller
// (the closest origin wins, as with the reference's doubling scan); the
// final argmin takes the smallest d. A lane stops at its own length; a
// length-0 or over-long lane returns (INF, 0, 0).
//
// Stacked text. The texts of B bins are rows of one (B, stride) int8 array;
// lane c verifies in bin b = lane_bin[c] (clamped to [0, B)) and reads
// text[b * stride + p] only for 0 <= p < bin_n[b], else code 6. The row
// offset is 64-bit: a GRCh38-sized database stacks past 2^31 chars. One
// template serves both entries (STACKED), so the DP and its tie-breaks are
// the same code.
//
// What bounds it. Per call the kernel must move about C * (2L + 2E) bytes
// of read and window chars plus 24-28 bytes of lane fields and outputs, and
// compute C * L * W DP cells: at the config-1 shape (C = 131,072, L = 100,
// E = 3) 29 MB (8.6 us at 3.35 TB/s) and 87 M cells (7.8 us at six
// operations a cell and 67 T op/s). The first edition (one thread per lane
// reading its bytes straight from device memory: 32 sectors a warp step
// for 32 useful bytes, a 64-bit bounds test per text char, W register
// moves a row) took 0.110 ms there. This edition takes about 0.05 ms, 17 %
// of that bound. What holds it back is the integer pipe: its SASS issues
// about 9 instructions a cell, 5 of them on the ALU pipe (byte permute,
// compare, two add-mins, the priority clear), and H100 has 64 INT32 lanes
// a SM, not 128: the six operations a cell alone need 31 us at that rate.
// Staging a tile (16-byte cp.async a chunk) overlaps the DP of the last.
// On the stacked config-5 text (102 MB, past the L2) the windows come
// from device memory at random: that shape varies most between cards.
//
// Design.
//  * Stage, then compute. A block of T threads takes T lanes. Per tile of
//    K = 32 read positions it copies each lane's read chars [j0, j0 + K)
//    and window chars [a0 + j0, a0 + j0 + K + W - 1), widened to 16-byte
//    aligned chunks, into shared memory: consecutive threads take
//    consecutive chunks of one lane's row (coalesced), by cp.async where
//    the chunk lies inside the read matrix or the bin, else byte by byte
//    with the code-4 / code-6 substitution (the ragged ends). Tile t + 1 is
//    in flight (double buffer) while the DP runs on tile t, and the DP loop
//    has no bounds test and no 64-bit address.
//  * The DP reads its window from shared memory, four chars a word every
//    four rows (a funnel shift realigns a lane's words, a byte permute
//    picks a char). Rows are whole 16-byte chunks, as cp.async needs, so
//    up to 4 lanes of a warp can share a bank; the lanes' own alignment
//    shifts spread them. The first step of this design (4-byte copies into
//    rows of an odd word stride, conflict-free) was slower: 0.0588 against
//    0.0494 ms at config-1, its staging then as costly as the DP.
//  * One word a cell. D, the begin origin S (< 64) and a two-bit source
//    priority pack into one int, P = D * 256 + prio + S: the diagonal has
//    priority 0, the read-gap 64, the in-row insertion 128, so a min over
//    packed values keeps the tie-breaks above, and Hopper's fused add-min
//    (VIADDMNMX) takes each candidate in one instruction.
//  * Buckets that fit the band: W_MAX is 7, 9, 13, 17, 25, 33 or 63. A
//    band that fills its bucket runs the FIT instance, with W a
//    compile-time constant; any other W runs its bucket with W read at run
//    time. With 4-byte staging (this design's first step) E = 3, 4 and 12
//    (W = 7, 9, 25) took 0.060 / 0.095 / 0.072 ms in these buckets and
//    0.072 / 0.130 / 0.156 ms in the first edition's 8, 16, 32 and 64. FIT
//    against the same bucket with W read at run time, in turns in one call
//    on one H100 at a 1980 MHz SM clock (verify_bench.py): E = 3, 4, 6, 8
//    at C = 131,072 (L = 100, then 150) took 0.050 / 0.081 / 0.107 / 0.132
//    ms against 0.061 / 0.102 / 0.135 / 0.168 ms; E = 12, 16, 31 at
//    C = 8,192, L = 250 took 0.055 / 0.066 / 0.112 ms against 0.124 /
//    0.157 / 0.287 ms. Every bucket keeps both instances; they cost 13 s
//    of nvcc against 8 s for one.
//  * ptxas (-Xptxas -v, sm_90a; both entries alike; no spills, no stack):
//      W_MAX              7    9   13   17   25   33   63
//      registers, FIT    58   62   60   66   74   84  115
//      registers, W run  58   60   62   66   72   82  113
//    and 33,796 bytes of shared memory a block at W_MAX <= 17, 37,892 at
//    25 and 33, 46,084 at 63.
//  * One warp per lane (the band across its threads) was not taken: at
//    W <= 63 a thread keeps its band in registers without a spill.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INF = 1 << 20;
constexpr int OUT_OF_TEXT = 6;
constexpr int BAD_READ = 4;
constexpr int T = 128;   // lanes (threads) a block
constexpr int K = 32;    // read positions a tile
constexpr int RCH = 3;   // 16-byte chunks of a lane's read row (shift + K)
constexpr int RWW = 4 * RCH;
constexpr int BIG = 1 << 30;   // "no bound": positions a tile touches are < BIG
// packed DP value: D * UNIT + priority + S (S < 64)
constexpr int UNIT = 256;
constexpr int UP_ADD = UNIT + 64;
constexpr int LEFT_ADD = UNIT + 128;
constexpr int CLEAR = ~192;
constexpr uint32_t NO_CHAR = 1000;  // a read char >= 4: equals no byte

template <int W_MAX>
struct Shape {
  static constexpr int NA = (W_MAX + 2) / 4 + 1;        // aligned words a group
  static constexpr int WCH = (15 + K + W_MAX - 1 + 15) / 16;  // window chunks
  static constexpr int WWW = 4 * WCH;
  // the DP's last word: shift / 4 + (K - 4) / 4 + NA
  static_assert(3 + K / 4 - 1 + NA < WWW, "window row covers every group");
  static_assert(3 + K / 4 < RWW, "read row covers every group");
};

struct Lane {   // per-lane staging parameters, shared by the block
  uintptr_t wbase;   // address of the first staged window char (16-aligned)
  uintptr_t rbase;   // address of the first staged read char (16-aligned)
  int wlo, whi;      // window chars [wlo, whi) from wbase lie in the bin
  int rlo, rhi;      // read bytes [rlo, rhi) from rbase lie in the matrix
  int row_ok;        // 0: the read row is outside the read matrix (code 4)
  int len;           // rows to run (0: none)
};

__device__ __forceinline__ int clamp_big(long long v) {
  return static_cast<int>(v < 0 ? 0 : (v > BIG ? BIG : v));
}

// One 16-byte chunk at offset p from base: cp.async when [p, p + 16) lies
// in [lo, hi), else byte by byte with `fill` outside it.
__device__ __forceinline__ void stage_chunk(uint32_t* dst, uintptr_t base,
                                            int p, int lo, int hi,
                                            uint32_t fill) {
  if (p >= lo && p + 16 <= hi) {
    __pipeline_memcpy_async(dst, reinterpret_cast<const void*>(base + p), 16);
    return;
  }
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int q = p + i;
    const uint32_t c = (q >= lo && q < hi)
        ? static_cast<uint8_t>(*reinterpret_cast<const int8_t*>(base + q))
        : fill;
    if (i % 4 == 0) w[i / 4] = 0;
    w[i / 4] |= c << (8 * (i % 4));
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Copy tile `tile` of every lane of the block into s_read and s_win:
// consecutive threads take consecutive 16-byte chunks of a lane's row.
template <int W_MAX>
__device__ __forceinline__ void stage(const Lane* __restrict__ lanes, int tile,
                                      uint32_t* __restrict__ s_read,
                                      uint32_t* __restrict__ s_win) {
  using S = Shape<W_MAX>;
  const int j0 = tile * K;
  for (int job = threadIdx.x; job < T * RCH; job += T) {
    const int l = job / RCH, k = job - l * RCH;
    const Lane& ln = lanes[l];
    if (ln.len <= j0) continue;
    uint32_t* dst = s_read + l * RWW + 4 * k;
    if (ln.row_ok)
      stage_chunk(dst, ln.rbase, j0 + 16 * k, ln.rlo, ln.rhi, BAD_READ);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0x04040404u, 0x04040404u,
                                                  0x04040404u, 0x04040404u);
  }
  for (int job = threadIdx.x; job < T * S::WCH; job += T) {
    const int l = job / S::WCH, k = job - l * S::WCH;
    const Lane& ln = lanes[l];
    if (ln.len <= j0) continue;
    stage_chunk(s_win + l * S::WWW + 4 * k, ln.wbase, j0 + 16 * k, ln.wlo,
                ln.whi, OUT_OF_TEXT);
  }
}

// FIT: W == W_MAX, so every band slot is a compile-time constant (1.2-2.6x
// faster than W read at run time in the same bucket; see the note above).
template <int W_MAX, bool FIT, bool STACKED>
__global__ void __launch_bounds__(T)
banded_verify_kernel(const int8_t* __restrict__ text_all, long long n_all,
                     long long stride, int n_bins,
                     const int32_t* __restrict__ bin_n,
                     const int32_t* __restrict__ lane_bin,
                     const int32_t* __restrict__ anchors,
                     const int8_t* __restrict__ reads, int L, int n_rows,
                     const int32_t* __restrict__ read_rows,
                     const int32_t* __restrict__ lengths, int C, int E,
                     int32_t* __restrict__ dist, int32_t* __restrict__ beg,
                     int32_t* __restrict__ end) {
  using S = Shape<W_MAX>;
  __shared__ __align__(16) uint32_t s_read[2][T * RWW];
  __shared__ __align__(16) uint32_t s_win[2][T * S::WWW];
  __shared__ Lane lanes[T];
  __shared__ int s_max_len;

  const int tid = threadIdx.x;
  const int c = blockIdx.x * T + tid;
  const int W = FIT ? W_MAX : 2 * E + 1;
  if (tid == 0) s_max_len = 0;

  // lane parameters
  int len = 0, wsh = 0, rsh = 0;
  long long a0 = 0;
  {
    Lane ln{0, 0, 0, 0, 0, 0, 0, 0};
    if (c < C) {
      long long tbase = 0, n = n_all;
      if (STACKED) {
        int b = lane_bin[c];
        b = b < 0 ? 0 : (b >= n_bins ? n_bins - 1 : b);
        tbase = static_cast<long long>(b) * stride;
        n = bin_n[b];
      }
      len = lengths[c];
      if (len > 0 && len <= L) {
        a0 = static_cast<long long>(anchors[c]) - E;
        const uintptr_t w0 = reinterpret_cast<uintptr_t>(text_all) + tbase + a0;
        wsh = static_cast<int>(w0 & 15);
        ln.wbase = w0 - wsh;                    // char a0 - wsh of the bin
        ln.wlo = clamp_big(wsh - a0);           // bin char 0
        ln.whi = clamp_big(n - a0 + wsh);       // bin char n
        const int row = read_rows[c];
        if (row >= 0 && row < n_rows) {
          const long long r0 = static_cast<long long>(row) * L;
          const uintptr_t rp = reinterpret_cast<uintptr_t>(reads) + r0;
          rsh = static_cast<int>(rp & 15);
          ln.rbase = rp - rsh;
          ln.rlo = clamp_big(rsh - r0);
          ln.rhi = clamp_big(static_cast<long long>(n_rows) * L - r0 + rsh);
          ln.row_ok = 1;
        }
        ln.len = len;
      } else {
        len = 0;
      }
    }
    lanes[tid] = ln;
  }
  __syncthreads();
  if (len > 0) atomicMax(&s_max_len, len);
  __syncthreads();
  const int n_tiles = (s_max_len + K - 1) / K;

  int P[W_MAX];
#pragma unroll
  for (int d = 0; d < W_MAX; ++d) P[d] = d;  // D = 0, S = d

  if (n_tiles > 0) {
    stage<W_MAX>(lanes, 0, s_read[0], s_win[0]);
    __pipeline_commit();
  }
  const uint32_t ws8 = 8u * (wsh & 3), rs8 = 8u * (rsh & 3);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles)
      stage<W_MAX>(lanes, tile + 1, s_read[buf ^ 1], s_win[buf ^ 1]);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();

    const uint32_t* wr = s_win[buf] + tid * S::WWW + (wsh >> 2);
    const uint32_t* rr = s_read[buf] + tid * RWW + (rsh >> 2);
    const int rows = len - tile * K;   // <= 0: this lane is done
    for (int jj = 0; jj < K && jj < rows; jj += 4) {
      const int q = jj >> 2;
      uint32_t aw[S::NA];
#pragma unroll
      for (int k = 0; k < S::NA; ++k)
        aw[k] = __funnelshift_r(wr[q + k], wr[q + k + 1], ws8);
      const uint32_t rw = __funnelshift_r(rr[q], rr[q + 1], rs8);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (jj + t < rows) {
          const uint32_t rb = (rw >> (8 * t)) & 0xFFu;
          const uint32_t ru = (rb >= 4u && rb < 128u) ? NO_CHAR : rb;
          int left = 0;
#pragma unroll
          for (int d = 0; d < W_MAX; ++d) {
            if (d < W) {
              const uint32_t wc = __byte_perm(aw[(t + d) >> 2], 0u,
                                              0x4440u | ((t + d) & 3));
              int m = P[d] + (wc != ru ? UNIT : 0);
              // P[d + 1] still holds the previous row: d ascends
              if (d + 1 < W_MAX && d + 1 < W)
                m = __viaddmin_s32(P[d + 1 < W_MAX ? d + 1 : d], UP_ADD, m);
              if (d > 0) m = __viaddmin_s32(left, LEFT_ADD, m);
              m &= CLEAR;
              P[d] = m;
              left = m;
            }
          }
        }
      }
    }
    __syncthreads();   // buffer `buf` is staged again at tile + 2
  }

  if (c >= C) return;
  if (len <= 0) {  // never reaches its last row
    dist[c] = INF;
    beg[c] = 0;
    end[c] = 0;
    return;
  }
  int best = P[0], d_best = 0;
#pragma unroll
  for (int d = 1; d < W_MAX; ++d) {
    if (d < W && (P[d] >> 8) < (best >> 8)) {
      best = P[d];
      d_best = d;
    }
  }
  dist[c] = best >> 8;
  beg[c] = static_cast<int32_t>(a0 + (best & 63));
  end[c] = static_cast<int32_t>(a0 + len + d_best);
}

struct Args {
  const int8_t* text;
  long long n, stride;
  int n_bins;
  const int32_t *bin_n, *lane_bin, *anchors;
  const int8_t* reads;
  int L, n_rows;
  const int32_t *read_rows, *lengths;
  int C, E;
  int32_t *dist, *beg, *end;
};

template <int W_MAX, bool STACKED>
void launch(const Args& a, cudaStream_t stream) {
  const int blocks = (a.C + T - 1) / T;
  auto kernel = 2 * a.E + 1 == W_MAX ? banded_verify_kernel<W_MAX, true, STACKED>
                                     : banded_verify_kernel<W_MAX, false, STACKED>;
  kernel<<<blocks, T, 0, stream>>>(
      a.text, a.n, a.stride, a.n_bins, a.bin_n, a.lane_bin, a.anchors, a.reads,
      a.L, a.n_rows, a.read_rows, a.lengths, a.C, a.E, a.dist, a.beg, a.end);
}

template <bool STACKED>
int dispatch(const Args& a, cudaStream_t stream) {
  if (a.E < 0 || a.E > 31 || a.C < 0 || a.L < 0 || a.n_rows < 0 || a.n < 0 ||
      a.stride < 0 || (STACKED && a.n_bins <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.C == 0) return static_cast<int>(cudaSuccess);
  const int W = 2 * a.E + 1;
  if (W <= 7) launch<7, STACKED>(a, stream);
  else if (W <= 9) launch<9, STACKED>(a, stream);
  else if (W <= 13) launch<13, STACKED>(a, stream);
  else if (W <= 17) launch<17, STACKED>(a, stream);
  else if (W <= 25) launch<25, STACKED>(a, stream);
  else if (W <= 33) launch<33, STACKED>(a, stream);
  else launch<63, STACKED>(a, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries return cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an E outside [0, 31], negative sizes or no
// bins: nothing is launched then).
extern "C" int dy_banded_verify(const int8_t* text, long long n,
                                const int32_t* anchors, const int8_t* reads,
                                int L, int n_rows, const int32_t* read_rows,
                                const int32_t* lengths, int C, int E,
                                int32_t* dist, int32_t* beg, int32_t* end,
                                cudaStream_t stream) {
  const Args a{text, n, 0, 1, nullptr, nullptr, anchors, reads, L, n_rows,
               read_rows, lengths, C, E, dist, beg, end};
  return dispatch<false>(a, stream);
}

// text: the (n_bins, stride) stack; bin_n: (n_bins,) bin lengths; lane_bin:
// (C,) bin of each lane.
extern "C" int dy_banded_verify_stacked(const int8_t* text, long long stride,
                                        int n_bins, const int32_t* bin_n,
                                        const int32_t* lane_bin,
                                        const int32_t* anchors,
                                        const int8_t* reads, int L, int n_rows,
                                        const int32_t* read_rows,
                                        const int32_t* lengths, int C, int E,
                                        int32_t* dist, int32_t* beg,
                                        int32_t* end, cudaStream_t stream) {
  const Args a{text, 0, stride, n_bins, bin_n, lane_bin, anchors, reads, L,
               n_rows, read_rows, lengths, C, E, dist, beg, end};
  return dispatch<true>(a, stream);
}
