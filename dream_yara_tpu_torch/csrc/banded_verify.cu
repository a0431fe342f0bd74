// Banded verification DP on Hopper (sm_90a), one thread per candidate.
//
// Replaces dream_yara_tpu/ops/pallas_verify.py::_dp_kernel, the TPU kernel
// behind both of its launchers: banded_verify_pallas (one bin's text,
// entry dy_banded_verify) and banded_verify_pallas_hooked (the flat
// multi-bin step's stacked per-bin text, entry dy_banded_verify_stacked).
// It computes what that kernel and the plain
// edition (dream_yara_tpu_torch/ops/verify.py) compute: the edit distance of
// the whole read against the text window [anchor-E, anchor+len+E), with free
// leading text, band W = 2E+1 and the begin position carried through the DP.
// Codes >= 4 mismatch everything; a window position outside [0, n) reads as
// code 6. Tie-breaks: a read-gap is taken only when strictly smaller than the
// diagonal; the in-row insertion is a running minimum over d taken only when
// strictly smaller (the closest origin wins, as with the reference's doubling
// scan); the final argmin takes the smallest d. A lane stops at its own
// length; a length-0 lane returns (INF, 0, 0).
//
// Stacked text. The texts of B bins are rows of one (B, stride) int8 array;
// lane c verifies in bin b = lane_bin[c] (clamped to [0, B)) and reads
// text[b * stride + p] only for 0 <= p < bin_n[b], else code 6. The row
// offset is 64-bit: a GRCh38-sized database stacks past 2^31 chars. One
// template serves both entries (STACKED), so the DP and its tie-breaks are
// the same code.
//
// Design. The TPU kernel pre-expanded the windows (wexp), padded the band to
// 8 sublanes and fetched 128-char text blocks with a log-shift, all for
// Mosaic's layout rules. Here each thread keeps its band (D, S) and the W
// window chars it needs in registers (W_MAX is a compile-time bucket, so all
// indexing is static) and reads text and read chars straight from device
// memory: one new text char and one read char per step.
//
// Bounds. Per call the kernel moves about C * (2L + 2E) bytes of gathered
// read and text chars (plus 28 bytes of lane metadata) and does about
// C * L * W * 10 integer operations, so at L = 100, E = 3 it is bound by
// latency of the scattered byte loads and by issue rate, not by bandwidth.
// Left for later work: one warp per candidate (the band across lanes) and
// staging each block's windows and reads in shared memory with coalesced
// 16-byte loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INF = 1 << 20;
constexpr int OUT_OF_TEXT = 6;
constexpr int THREADS = 128;

__device__ __forceinline__ int text_char(const int8_t* __restrict__ text,
                                         long long n, long long p) {
  return (p >= 0 && p < n) ? static_cast<int>(text[p]) : OUT_OF_TEXT;
}

template <int W_MAX, bool STACKED>
__global__ void __launch_bounds__(THREADS)
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
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int8_t* __restrict__ text = text_all;
  long long n = n_all;
  if (STACKED) {
    int b = lane_bin[c];
    b = b < 0 ? 0 : (b >= n_bins ? n_bins - 1 : b);
    text = text_all + static_cast<long long>(b) * stride;
    n = bin_n[b];
  }
  const int W = 2 * E + 1;
  const int len = lengths[c];
  const int anchor = anchors[c];
  if (len <= 0 || len > L) {  // never reaches its last row
    dist[c] = INF;
    beg[c] = 0;
    end[c] = 0;
    return;
  }
  const int row = read_rows[c];
  const bool row_ok = row >= 0 && row < n_rows;
  const int8_t* __restrict__ read = reads + static_cast<long long>(row_ok ? row : 0) * L;
  const long long a0 = static_cast<long long>(anchor) - E;

  int D[W_MAX], S[W_MAX], wc[W_MAX];
#pragma unroll
  for (int d = 0; d < W_MAX; ++d) {
    D[d] = 0;
    S[d] = d;
    wc[d] = d < W ? text_char(text, n, a0 + d) : OUT_OF_TEXT;
  }

  for (int j = 0; j < len; ++j) {
    const int rc = row_ok ? static_cast<int>(read[j]) : 4;
    const bool r_bad = rc >= 4;
    int left_D = INF, left_S = 0;  // final value of row d-1 (in-row origin)
#pragma unroll
    for (int d = 0; d < W_MAX; ++d) {
      if (d < W) {
        const int sub = (r_bad || wc[d] >= 4 || wc[d] != rc) ? 1 : 0;
        const int diag = D[d] + sub;
        // D[d + 1] still holds the previous row: d ascends
        const int up = (d + 1 < W_MAX && d + 1 < W) ? D[d + 1 < W_MAX ? d + 1 : d] + 1
                                                   : INF + 1;
        const int up_S = (d + 1 < W_MAX && d + 1 < W) ? S[d + 1 < W_MAX ? d + 1 : d] : 0;
        int nd = diag, ns = S[d];
        if (up < diag) { nd = up; ns = up_S; }
        if (d > 0 && left_D + 1 < nd) { nd = left_D + 1; ns = left_S; }
        D[d] = nd;
        S[d] = ns;
        left_D = nd;
        left_S = ns;
      }
    }
    // slide the window one char: wc[d] <- wc[d + 1], new char at W - 1
    const int incoming = text_char(text, n, a0 + j + W);
#pragma unroll
    for (int d = 0; d < W_MAX; ++d) {
      if (d + 1 < W) wc[d] = wc[d + 1 < W_MAX ? d + 1 : d];
      else if (d + 1 == W) wc[d] = incoming;
    }
  }

  int best = D[0], d_best = 0, s_best = S[0];
#pragma unroll
  for (int d = 1; d < W_MAX; ++d) {
    if (d < W && D[d] < best) {
      best = D[d];
      d_best = d;
      s_best = S[d];
    }
  }
  dist[c] = best;
  beg[c] = static_cast<int32_t>(a0 + s_best);
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
  const int blocks = (a.C + THREADS - 1) / THREADS;
  banded_verify_kernel<W_MAX, STACKED><<<blocks, THREADS, 0, stream>>>(
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
  if (W <= 8)
    launch<8, STACKED>(a, stream);
  else if (W <= 16)
    launch<16, STACKED>(a, stream);
  else if (W <= 32)
    launch<32, STACKED>(a, stream);
  else
    launch<64, STACKED>(a, stream);
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
