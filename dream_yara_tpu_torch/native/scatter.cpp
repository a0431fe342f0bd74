// Bit-scatter for filter construction — the insert loop of the reference's
// SeqAnBloomFilter::addKmers (src/d_bloom_filter.h [U]). numpy's
// bitwise_or.at runs ~5M updates/s; this loop runs ~200M/s.
//
// Build: g++ -O3 -march=native -shared -fPIC scatter.cpp -o libdyscatter.so

#include <cstdint>

extern "C" {

// words: (n_rows, row_words) uint32 row-major; set `bit` in column word_col
// of each listed row.
void dy_scatter_or_u32(uint32_t* words, const int64_t* rows, int64_t n,
                       int64_t row_words, int64_t word_col, uint32_t bit) {
    for (int64_t i = 0; i < n; i++)
        words[rows[i] * row_words + word_col] |= bit;
}

}  // extern "C"
