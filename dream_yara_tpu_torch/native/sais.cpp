// SA-IS suffix array construction (induced sorting), O(n).
//
// Native analog of the reference's SeqAn suffix-array construction used by
// indexCreate(FibreSALF()) (SURVEY.md §2.4 [U]) — the offline indexer hot
// spot. From-scratch textbook SA-IS (Nong, Zhang, Chan 2009): classify S/L
// types, induced-sort LMS substrings, name + recurse, induce the final SA.
//
// Memory layout follows the canonical NZC space-efficient variant: the
// reduced problem (s1), its suffix array (SA1) and the LMS position table
// all live INSIDE the caller's SA buffer (s1 at the right end, SA1 at the
// left; disjoint because n1 <= n/2), so each recursion level only allocates
// the type bitvector (n/8 B) and the bucket table (K ints). Level 0 runs
// directly on a uint8 copy of the text (+1 shift, virtual 0 sentinel) —
// peak working set is ~6 bytes/char total vs ~22 for the naive layout,
// which is what makes GRCh38-scale bins (3 Gbp ≈ 19 GB peak) buildable
// in-image (tools/bench_index_1g.py records the measured rate/RSS).
//
// Build: g++ -O3 -march=native -shared -fPIC sais.cpp -o libdysais.so

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

using std::vector;

template <class TChar>
void get_buckets(const TChar* T, int32_t n, int32_t K,
                 vector<int32_t>& bkt, bool end) {
    std::fill(bkt.begin(), bkt.end(), 0);
    for (int32_t i = 0; i < n; i++) bkt[T[i]]++;
    int32_t sum = 0;
    for (int32_t k = 0; k < K; k++) {
        sum += bkt[k];
        bkt[k] = end ? sum : sum - bkt[k];
    }
}

template <class TChar>
void induce(const TChar* T, int32_t* SA, int32_t n, int32_t K,
            const vector<bool>& is_s, vector<int32_t>& bkt) {
    // induce L-type from sorted LMS/S placements
    get_buckets(T, n, K, bkt, false);
    for (int32_t i = 0; i < n; i++) {
        int32_t j = SA[i] - 1;
        if (SA[i] > 0 && !is_s[j]) SA[bkt[T[j]]++] = j;
    }
    // induce S-type right-to-left
    get_buckets(T, n, K, bkt, true);
    for (int32_t i = n - 1; i >= 0; i--) {
        int32_t j = SA[i] - 1;
        if (SA[i] > 0 && is_s[j]) SA[--bkt[T[j]]] = j;
    }
}

// T[n-1] must be a unique smallest sentinel.
template <class TChar>
void sais(const TChar* T, int32_t* SA, int32_t n, int32_t K) {
    if (n == 1) { SA[0] = 0; return; }
    vector<bool> is_s(n);
    is_s[n - 1] = true;
    for (int32_t i = n - 2; i >= 0; i--)
        is_s[i] = T[i] < T[i + 1] || (T[i] == T[i + 1] && is_s[i + 1]);
    auto is_lms = [&](int32_t i) {
        return i > 0 && is_s[i] && !is_s[i - 1];
    };

    vector<int32_t> bkt(K);
    // 1) rough sort: LMS suffixes at bucket ends, induce everything
    std::fill(SA, SA + n, -1);
    get_buckets(T, n, K, bkt, true);
    for (int32_t i = n - 1; i >= 1; i--)
        if (is_lms(i)) SA[--bkt[T[i]]] = i;
    induce(T, SA, n, K, is_s, bkt);

    // 2) compact sorted LMS positions into SA[0..n1)
    int32_t n1 = 0;
    for (int32_t i = 0; i < n; i++)
        if (is_lms(SA[i])) SA[n1++] = SA[i];

    // 3) name LMS substrings (equal substrings share a name); sparse names
    //    at SA[n1 + pos/2] (pos/2 < n/2 and n1 <= n/2, so in-bounds), then
    //    compacted right-to-left into s1 = SA + n - n1 (write index always
    //    >= read index, so the in-place compaction is safe)
    std::fill(SA + n1, SA + n, -1);
    int32_t name = 0, prev = -1;
    for (int32_t i = 0; i < n1; i++) {
        int32_t pos = SA[i];
        bool diff = false;
        if (prev < 0) {
            diff = true;
        } else {
            for (int32_t d = 0; d < n; d++) {
                if (T[pos + d] != T[prev + d] || is_s[pos + d] != is_s[prev + d]) {
                    diff = true;
                    break;
                }
                if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
                    diff = !(is_lms(pos + d) && is_lms(prev + d));
                    break;
                }
            }
        }
        if (diff) { name++; prev = pos; }
        SA[n1 + pos / 2] = name - 1;
    }
    int32_t* s1 = SA + n - n1;
    for (int32_t i = n - 1, j = n - 1; i >= n1; i--)
        if (SA[i] >= 0) { int32_t v = SA[i]; SA[i] = -1; SA[j--] = v; }

    // 4) sort the reduced problem; SA1 = SA[0..n1) (disjoint from s1)
    int32_t* SA1 = SA;
    if (name < n1) {
        sais<int32_t>(s1, SA1, n1, name);
    } else {
        for (int32_t i = 0; i < n1; i++) SA1[s1[i]] = i;
    }

    // 5) map reduced order back to text positions: reuse the s1 slots for
    //    the LMS position table (s1's values are consumed by the recursion)
    for (int32_t i = 1, j = 0; i < n; i++)
        if (is_lms(i)) s1[j++] = i;
    for (int32_t i = 0; i < n1; i++) SA1[i] = s1[SA1[i]];
    // clear the tail (including the s1 region) and place LMS from the right;
    // each placement index --bkt[c] >= its rank i, so reads stay ahead of
    // writes in the descending loop (NZC'09 in-place placement)
    std::fill(SA + n1, SA + n, -1);
    get_buckets(T, n, K, bkt, true);
    for (int32_t i = n1 - 1; i >= 0; i--) {
        int32_t j = SA[i];
        SA[i] = -1;
        SA[--bkt[T[j]]] = j;
    }
    induce(T, SA, n, K, is_s, bkt);
}

}  // namespace

extern "C" {

// Suffix array of byte text (values 0..255). SA_out must hold n int32.
int32_t dy_sais_u8(const uint8_t* T, int32_t* SA_out, int32_t n) {
    if (n <= 0) return 0;
    uint8_t maxc = 0;
    for (int32_t i = 0; i < n; i++) maxc = std::max(maxc, T[i]);
    vector<int32_t> SA(size_t(n) + 1);
    if (maxc < 255) {
        vector<uint8_t> T8(size_t(n) + 1);
        for (int32_t i = 0; i < n; i++) T8[i] = T[i] + 1;
        T8[n] = 0;  // unique smallest virtual sentinel
        sais<uint8_t>(T8.data(), SA.data(), n + 1, int32_t(maxc) + 2);
    } else {
        vector<int32_t> T32(size_t(n) + 1);
        for (int32_t i = 0; i < n; i++) T32[i] = int32_t(T[i]) + 1;
        T32[n] = 0;
        sais<int32_t>(T32.data(), SA.data(), n + 1, 257);
    }
    std::memcpy(SA_out, SA.data() + 1, size_t(n) * sizeof(int32_t));
    return 0;
}

// Low-memory variant: SA_out must hold n+1 int32 (row 0 is the virtual
// sentinel — the caller slices it off). The text must have max byte < 255.
// Total allocations beyond the caller's buffers: the +1-shifted uint8 text
// copy and the per-level type bitvectors (~1.3 bytes/char).
int32_t dy_sais_u8_into(const uint8_t* T, int32_t* SA_out, int32_t n) {
    if (n <= 0) { if (n == 0) SA_out[0] = 0; return 0; }
    uint8_t maxc = 0;
    for (int32_t i = 0; i < n; i++) maxc = std::max(maxc, T[i]);
    if (maxc >= 255) return -1;  // caller falls back to dy_sais_u8
    vector<uint8_t> T8(size_t(n) + 1);
    for (int32_t i = 0; i < n; i++) T8[i] = T[i] + 1;
    T8[n] = 0;
    sais<uint8_t>(T8.data(), SA_out, n + 1, int32_t(maxc) + 2);
    return 0;
}

}  // extern "C"
