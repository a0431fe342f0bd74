// Banded global alignment -> CIGAR strings, for reported matches.
//
// Native analog of the reference's MatchesAligner (src/mapper_aligner.h [U]):
// re-align read vs text[begin:end] at the known edit distance and emit M/I/D
// runs. Semantics are EXACTLY pipeline/cigar.py's (_cigars_block): same cell
// preference (diagonal <= read-gap; in-row text-gap only when strictly
// better), same traceback order — tests assert byte-equality against the
// NumPy engine. OpenMP across matches.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC align.cpp -o libdyalign.so

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

const int32_t INF = 1 << 20;

inline int sub_cost(int8_t a, int8_t b) {
    return (a != b || a >= 4 || b >= 4) ? 1 : 0;
}

// Emit CIGAR for one match into buf (cap bytes); returns length or -1.
int one_cigar(const int8_t* text, int64_t text_len,
              const int8_t* read, int32_t m,
              int64_t begin, int64_t end, int32_t dist, int32_t E,
              char* buf, int64_t cap,
              int32_t* D, int8_t* CH, int8_t* moves) {
    int64_t n = end - begin;
    const int W = 2 * E + 1;

    // fast path: equal length + hamming distance achieved
    if (n == m) {
        int ham = 0;
        for (int j = 0; j < m && ham <= dist; j++)
            ham += sub_cost(read[j], text[begin + j]);
        if (ham == dist)
            return snprintf(buf, size_t(cap), "%dM", m);
    }

    // banded DP, d = x - j + E in [0, 2E]
    for (int d = 0; d < W; d++) {
        int64_t x0 = d - E;
        D[d] = (x0 >= 0 && x0 <= n) ? int32_t(x0) : INF;
    }
    for (int j = 1; j <= m; j++) {
        int32_t* Dj = D + j * W;
        int32_t* Dp = D + (j - 1) * W;
        int8_t* Cj = CH + j * W;
        for (int d = 0; d < W; d++) {
            int64_t x = j + d - E - 1;  // text index consumed by diagonal
            int32_t sub;
            if (x < 0 || x >= n) {
                sub = INF;
            } else {
                int8_t w = (begin + x < text_len) ? text[begin + x] : 6;
                sub = sub_cost(read[j - 1], w);
            }
            int32_t diag = (Dp[d] >= INF) ? INF : Dp[d] + sub;
            int32_t up = (d + 1 < W && Dp[d + 1] < INF) ? Dp[d + 1] + 1 : INF;
            if (diag <= up) { Dj[d] = diag; Cj[d] = 0; }
            else            { Dj[d] = up;   Cj[d] = 2; }
        }
        for (int d = 1; d < W; d++) {
            if (Dj[d - 1] < INF && Dj[d - 1] + 1 < Dj[d]) {
                Dj[d] = Dj[d - 1] + 1;
                Cj[d] = 3;
            }
        }
    }

    // traceback
    int64_t fd = n - m + E;
    if (fd < 0) fd = 0;
    if (fd > W - 1) fd = W - 1;
    int j = m;
    int64_t d = fd;
    int k = m + E + 1;  // moves buffer filled right-to-left, size m+E+1
    while (!(j == 0 && d == E)) {
        int c = (j == 0) ? 3 : CH[j * W + d];
        if (k <= 0) return -2;  // should not happen
        k--;
        if (c == 0)      { moves[k] = 1; j--; }
        else if (c == 2) { moves[k] = 2; j--; d++; }
        else             { moves[k] = 3; d--; }
        if (d < 0 || d >= W) return -2;
    }
    // run-length encode
    int64_t len = 0;
    const char sym[4] = {'?', 'M', 'I', 'D'};
    int total = m + E + 1;
    int i = k;
    while (i < total) {
        int run_start = i;
        int8_t mv = moves[i];
        while (i < total && moves[i] == mv) i++;
        int written = snprintf(buf + len, size_t(cap - len), "%d%c",
                               i - run_start, sym[mv]);
        if (written < 0 || len + written >= cap) return -1;
        len += written;
    }
    if (len == 0)
        len = snprintf(buf, size_t(cap), "%dM", m);
    return int(len);
}

}  // namespace

extern "C" {

// CIGARs for n_matches matches. out_off must hold n_matches+1 entries.
// Returns total bytes written, -1 on out_buf overflow.
int64_t dy_cigars(const int8_t* text, int64_t text_len,
                  const int8_t* reads, int64_t read_stride,
                  const int32_t* rows, const int32_t* lengths,
                  const int64_t* begins, const int64_t* ends,
                  const int32_t* dists,
                  int32_t n_matches, int32_t max_err, int32_t n_threads,
                  char* out_buf, int64_t out_cap, int64_t* out_off) {
    const int W = 2 * max_err + 1;
    // first pass: per-match lengths into out_off[1..]
    std::vector<int64_t> lens(n_matches);
    std::vector<std::vector<char>> bufs(n_matches);
    bool fail = false;

#ifdef _OPENMP
    if (n_threads > 0) omp_set_num_threads(n_threads);
#pragma omp parallel
#endif
    {
        std::vector<int32_t> D;
        std::vector<int8_t> CH, moves;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 256)
#endif
        for (int32_t i = 0; i < n_matches; i++) {
            int32_t m = lengths[i];
            D.resize(size_t(m + 1) * W);
            CH.resize(size_t(m + 1) * W);
            moves.resize(size_t(m) + max_err + 1);
            char local[4096];
            int len = one_cigar(text, text_len,
                                reads + int64_t(rows[i]) * read_stride, m,
                                begins[i], ends[i], dists[i], max_err,
                                local, sizeof(local),
                                D.data(), CH.data(), moves.data());
            if (len < 0) { fail = true; len = 0; }
            bufs[i].assign(local, local + len);
            lens[i] = len;
        }
    }
    if (fail) return -1;

    int64_t total = 0;
    out_off[0] = 0;
    for (int32_t i = 0; i < n_matches; i++) {
        if (total + lens[i] > out_cap) return -1;
        std::memcpy(out_buf + total, bufs[i].data(), size_t(lens[i]));
        total += lens[i];
        out_off[i + 1] = total;
    }
    return total;
}

}  // extern "C"
