// Native index construction: generalized suffix array via SA-IS and
// BWT/sample emission with kaiju ordering semantics.
//
// Role-equivalent of the reference's kaiju-mkbwt + kaiju-mkfmi toolchain
// (reference: src/bwt/mkbwt.c, mkfmi.c) with a different mechanism: instead
// of 2-letter bucket partitioning + multikey quicksort over order-encoded
// padding, we build one int32 text where the terminator of input sequence i
// gets the distinct symbol (1+i) — smaller than every letter, ordered by
// input index — and run linear-time SA-IS.  This realizes exactly the
// reference's suffix order: letters compare as letters, a sequence end
// sorts below any letter, and identical letter suffixes tie-break by input
// order (what encodeOrder's negative base-100 words achieve,
// mkbwt.c:834-856).
//
// Exposed via a C ABI for ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using std::int32_t;
using std::int64_t;

// ---------------------------------------------------------------------
// SA-IS (Nong, Zhang & Chan, 2009) over an int32 text with sentinel 0 at
// the end.  n < 2^31 per shard.
// ---------------------------------------------------------------------

struct Sais {
    static void get_counts(const int32_t* T, int64_t n, int64_t K,
                           std::vector<int64_t>& cnt) {
        std::fill(cnt.begin(), cnt.end(), 0);
        for (int64_t i = 0; i < n; ++i) cnt[T[i]]++;
    }
    static void get_buckets(const std::vector<int64_t>& cnt,
                            std::vector<int64_t>& bkt, int64_t K, bool end) {
        int64_t sum = 0;
        for (int64_t c = 0; c < K; ++c) {
            sum += cnt[c];
            bkt[c] = end ? sum : sum - cnt[c];
        }
    }

    static void induce(const int32_t* T, int32_t* SA, int64_t n, int64_t K,
                       const std::vector<bool>& stype,
                       std::vector<int64_t>& cnt, std::vector<int64_t>& bkt) {
        // induce L from LMS
        get_buckets(cnt, bkt, K, false);
        int64_t j = n - 1;  // sentinel predecessor
        if (j >= 0 && !stype[j]) SA[bkt[T[j]]++] = (int32_t)j;
        for (int64_t i = 0; i < n; ++i) {
            j = SA[i];
            if (j > 0 && !stype[j - 1]) SA[bkt[T[j - 1]]++] = (int32_t)(j - 1);
        }
        // induce S
        get_buckets(cnt, bkt, K, true);
        for (int64_t i = n - 1; i >= 0; --i) {
            j = SA[i];
            if (j > 0 && stype[j - 1]) SA[--bkt[T[j - 1]]] = (int32_t)(j - 1);
        }
    }

    // T[n-1] must be the unique smallest symbol (sentinel).
    static void sais(const int32_t* T, int32_t* SA, int64_t n, int64_t K) {
        if (n == 1) { SA[0] = 0; return; }
        std::vector<bool> stype(n);
        stype[n - 1] = true;
        for (int64_t i = n - 2; i >= 0; --i)
            stype[i] = T[i] < T[i + 1] || (T[i] == T[i + 1] && stype[i + 1]);
        auto is_lms = [&](int64_t i) {
            return i > 0 && stype[i] && !stype[i - 1];
        };

        std::vector<int64_t> cnt(K), bkt(K);
        get_counts(T, n, K, cnt);

        // Step 1: rough-place LMS suffixes at bucket ends
        std::fill(SA, SA + n, -1);
        get_buckets(cnt, bkt, K, true);
        for (int64_t i = 1; i < n; ++i)
            if (is_lms(i)) SA[--bkt[T[i]]] = (int32_t)i;
        induce(T, SA, n, K, stype, cnt, bkt);

        // Step 2: name LMS substrings in sorted order
        std::vector<int32_t> lms_order;
        lms_order.reserve(n / 2 + 1);
        for (int64_t i = 0; i < n; ++i) {
            int64_t p = SA[i];
            if (p > 0 && is_lms(p)) lms_order.push_back((int32_t)p);
        }
        int64_t n_lms = (int64_t)lms_order.size();
        std::vector<int32_t> name_of(n, -1);
        int32_t name = 0;
        int64_t prev = -1;
        for (int64_t r = 0; r < n_lms; ++r) {
            int64_t pos = lms_order[r];
            bool diff = false;
            if (prev < 0) {
                diff = true;
            } else {
                for (int64_t d = 0;; ++d) {
                    bool lms_p = d > 0 && is_lms(pos + d);
                    bool lms_q = d > 0 && is_lms(prev + d);
                    if (T[pos + d] != T[prev + d] || stype[pos + d] != stype[prev + d]) {
                        diff = true;
                        break;
                    }
                    if (lms_p || lms_q) {
                        if (!(lms_p && lms_q)) diff = true;
                        break;
                    }
                }
            }
            if (diff) ++name;
            name_of[pos] = name - 1;
            prev = pos;
        }

        // collect LMS positions in text order
        std::vector<int32_t> lms_pos;
        lms_pos.reserve(n_lms);
        for (int64_t i = 1; i < n; ++i)
            if (is_lms(i)) lms_pos.push_back((int32_t)i);

        std::vector<int32_t> sorted_lms(n_lms);
        if (name < n_lms) {
            // recurse on the reduced string
            std::vector<int32_t> T1(n_lms), SA1(n_lms);
            for (int64_t i = 0; i < n_lms; ++i) T1[i] = name_of[lms_pos[i]];
            sais(T1.data(), SA1.data(), n_lms, name);
            for (int64_t i = 0; i < n_lms; ++i)
                sorted_lms[i] = lms_pos[SA1[i]];
        } else {
            for (int64_t r = 0; r < n_lms; ++r) sorted_lms[r] = lms_order[r];
        }

        // Step 3: place LMS in final order, induce again
        std::fill(SA, SA + n, -1);
        get_buckets(cnt, bkt, K, true);
        for (int64_t r = n_lms - 1; r >= 0; --r) {
            int64_t p = sorted_lms[r];
            SA[--bkt[T[p]]] = (int32_t)p;
        }
        induce(T, SA, n, K, stype, cnt, bkt);
    }
};

}  // namespace

extern "C" {

// Build a kaiju-ordered BWT + SA samples from concatenated letter codes.
//
//   codes:       uint8[total_letters], letter codes 1..alen-1, all
//                sequences concatenated in INPUT order (no separators)
//   seq_len:     int64[nseq] per-sequence letter counts
//   chpt_exp:    SA sample spacing exponent e (samples at SA pos % 2^e == 0)
// Outputs (caller-allocated):
//   bwt:          uint8[total_letters + nseq]
//   content_rank: int32[nseq]   rank of each input sequence by content
//   sa_seq:       int32[n_samples]  (content-rank) per sampled SA slot
//   sa_off:       int32[n_samples]
// n_samples must equal the number of multiples of 2^e in
// [nseq, total_letters + nseq).
// Returns 0 on success, negative on error.
int kt_build_bwt(const uint8_t* codes, const int64_t* seq_len, int64_t nseq,
                 int64_t total_letters, int32_t alen, int32_t chpt_exp,
                 uint8_t* bwt, int32_t* content_rank, int32_t* sa_seq,
                 int32_t* sa_off, int64_t n_samples) {
    const int64_t n = total_letters + nseq + 1;  // + terminators + sentinel
    if (n >= (int64_t)1 << 31) return -1;

    // sequence start offsets in the packed (letters-only) coordinate system
    std::vector<int64_t> start(nseq + 1);
    start[0] = 0;
    for (int64_t i = 0; i < nseq; ++i) start[i + 1] = start[i] + seq_len[i];
    if (start[nseq] != total_letters) return -2;

    // int32 text: letters -> nseq + code, terminator of seq i -> 1 + i,
    // global sentinel 0 at the end.
    const int64_t K = nseq + 1 + alen;
    std::vector<int32_t> T(n);
    {
        int64_t w = 0;
        for (int64_t i = 0; i < nseq; ++i) {
            const uint8_t* s = codes + start[i];
            for (int64_t p = 0; p < seq_len[i]; ++p) {
                uint8_t c = s[p];
                if (c == 0 || c >= alen) return -3;
                T[w++] = (int32_t)(nseq + c);
            }
            T[w++] = (int32_t)(1 + i);
        }
        T[w++] = 0;
        if (w != n) return -4;
    }

    std::vector<int32_t> SA(n);
    Sais::sais(T.data(), SA.data(), n, K);

    // text position -> (seq, offset): seq boundaries in text coords
    std::vector<int64_t> tstart(nseq + 1);
    for (int64_t i = 0; i <= nseq; ++i) tstart[i] = start[i] + i;

    // Terminator block: bwt[j] = last letter of input seq j
    // (reference: mkbwt.c:860-873 write_term with readOrder).
    for (int64_t j = 0; j < nseq; ++j) {
        if (seq_len[j] <= 0) return -5;
        bwt[j] = codes[start[j + 1] - 1];
    }

    // SA layout: SA[0]=sentinel, SA[1..nseq]=terminator suffixes,
    // SA[nseq+1..]=letter suffixes in kaiju order; kaiju SA position
    // k = r - 1 for SA index r >= nseq+1.
    const int64_t check = ((int64_t)1 << chpt_exp) - 1;
    int32_t next_rank = 0;
    int64_t sample_i = 0;
    int64_t seq_cursor = 0;  // monotone hint for binary search
    for (int64_t r = nseq + 1; r < n; ++r) {
        const int64_t pos = SA[r];
        const int64_t k = r - 1;
        const int32_t prev = pos > 0 ? T[pos - 1] : 0;
        uint8_t bc;
        if (prev > nseq) {
            bc = (uint8_t)(prev - nseq);
        } else {
            // sequence start: preceding symbol is terminator (1+i of the
            // previous seq) or the position is 0 (first sequence)
            bc = 0;
            const int64_t iseq = (pos == 0) ? 0 : (int64_t)prev;  // 1+(i-1)=i
            content_rank[iseq] = next_rank++;
        }
        bwt[k] = bc;
        if ((k & check) == 0) {
            if (sample_i >= n_samples) return -6;
            // find owning sequence: largest i with tstart[i] <= pos
            int64_t lo = 0, hi = nseq;
            while (lo + 1 < hi) {
                int64_t mid = (lo + hi) >> 1;
                if (tstart[mid] <= pos) lo = mid; else hi = mid;
            }
            sa_seq[sample_i] = (int32_t)lo;  // provisional: input index
            sa_off[sample_i] = (int32_t)(pos - tstart[lo]);
            ++sample_i;
        }
        (void)seq_cursor;
    }
    if (next_rank != nseq) return -7;
    if (sample_i != n_samples) return -8;

    // samples store CONTENT rank (reference: SortSeqs + checkpoint
    // encoding, suffixArray.c:210-215)
    for (int64_t s = 0; s < n_samples; ++s)
        sa_seq[s] = content_rank[sa_seq[s]];

    return 0;
}

}  // extern "C"
