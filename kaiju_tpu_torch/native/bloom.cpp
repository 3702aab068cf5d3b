// Bloom presence bitmap over the database's m-mers (letter codes 1..20).
//
// Screening support for the fused device search (kaiju_tpu/ops/bloom.py):
// a query end position can host a recordable match (length >= m) only if
// the m-mer ending there is present in the database, so one bitmap probe
// replaces ~m backward-extension rank queries for the ~98% of junk
// positions whose m-mer is absent.  No false negatives by construction;
// false positives only cost extension work, never correctness.
//
// The hash must match kaiju_tpu.ops.bloom exactly (uint32 wraparound):
//   h(window c_{j-m+1}..c_j) = sum_t c_{j-t} * A^t   (A = 0x01000193)
//   bit index = (h * 0x9E3779B1) >> (32 - lb)

#include <cstdint>

namespace {
constexpr uint32_t A = 0x01000193u;
constexpr uint32_t GOLD = 0x9E3779B1u;
}

extern "C" {

// codes: text letter codes (terminators 0 / wildcards >20 break windows).
// words: caller-zeroed uint32[1 << (lb - 5)].
void kt_bloom_fill(const uint8_t* codes, int64_t n, int32_t m, int32_t lb,
                   uint32_t* words) {
    if (n < m) return;
    uint32_t am = 1;  // A^m
    for (int t = 0; t < m; ++t) am *= A;
    uint32_t h = 0;
    int64_t bad_run = 0;  // letters since the last invalid code
    // prime the first m-1 letters
    for (int64_t j = 0; j < n; ++j) {
        uint32_t c = codes[j];
        bool ok = c >= 1 && c <= 20;
        bad_run = ok ? bad_run + 1 : 0;
        // rolling: h_j = A*h_{j-1} + c_j - c_{j-m}*A^m
        uint32_t drop = (j >= m) ? (uint32_t)codes[j - m] : 0u;
        h = A * h + c - drop * am;
        if (bad_run >= m) {
            uint32_t idx = (h * GOLD) >> (32 - lb);
            words[idx >> 5] |= 1u << (idx & 31);
        }
    }
}

}  // extern "C"
