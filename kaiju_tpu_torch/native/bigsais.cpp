// Scalable index construction: threaded, prefix-bucketed suffix sorting
// with NO 2^31 length cap (role-equivalent of the reference kaiju-mkbwt
// bucket pipeline, /root/reference/src/bwt/mkbwt.c:82-138,569-671, with a
// from-scratch mechanism).
//
// Suffix order contract (identical to kaiju_tpu/native/sais.cpp and the
// reference's encodeOrder padding trick, mkbwt.c:834-856): letters compare
// as letters, every sequence terminator sorts below any letter, and
// terminators of different sequences compare by input order.  Suffixes are
// partitioned by their first two symbols into buckets; buckets are sorted
// independently (multikey quicksort with terminator short-circuits and a
// homopolymer-run "leap") and emitted in bucket order, so peak memory is
// O(text + one first-letter group of positions) instead of O(8 * text) —
// the property that lets refseq_ref-scale (> 2^31 letters) databases build
// on one host.
//
// Exposed via the same C ABI style as sais.cpp (ctypes, no pybind11).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

using std::int32_t;
using std::int64_t;

struct BigCtx {
    const uint8_t* text;        // 0-separated: seq i at [tstart[i], tend[i]), 0 at tend[i]
    const int64_t* tstart;      // [nseq + 1]; tstart[nseq] = N (one past last terminator? no: see below)
    int64_t nseq;
    int64_t N;                  // total text length incl. terminators

    // seq index owning terminator position p (text[p] == 0)
    int64_t term_seq(int64_t p) const {
        // terminator of seq i sits at tstart[i+1] - 1
        int64_t lo = 0, hi = nseq;  // find i with tstart[i+1]-1 == p
        while (lo + 1 < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (tstart[mid] <= p) lo = mid; else hi = mid;
        }
        return lo;
    }

    // full suffix comparison from byte offset d (used by insertion sort)
    bool suf_less(int64_t a, int64_t b, int64_t d) const {
        int64_t pa = a + d, pb = b + d;
        for (;;) {
            uint8_t ca = text[pa], cb = text[pb];
            if (ca != cb) return ca < cb;
            if (ca == 0) return term_seq(pa) < term_seq(pb);
            ++pa;
            ++pb;
        }
    }
};

void insertion_sort(const BigCtx& cx, int64_t* a, int64_t n, int64_t d) {
    for (int64_t i = 1; i < n; ++i) {
        int64_t v = a[i];
        int64_t j = i;
        while (j > 0 && cx.suf_less(v, a[j - 1], d)) {
            a[j] = a[j - 1];
            --j;
        }
        a[j] = v;
    }
}

void mkqs(const BigCtx& cx, int64_t* a, int64_t n, int64_t d);

// Homopolymer leap: every member of `a` has text[p+d .. ] starting with
// run-char c; order is decided by (run length rho, tail symbol) without
// descending one level per run character (see the ordering proof in the
// repo's round-3 notes: tails < c sort ascending by rho, tails > c sort
// descending by rho, and all tail<c members precede all tail>c members).
void run_leap(const BigCtx& cx, int64_t* a, int64_t n, int64_t d, uint8_t c) {
    struct Ent { int64_t p, rho; uint8_t tail; };
    std::vector<Ent> es(n);
    for (int64_t i = 0; i < n; ++i) es[i].p = a[i] + d;
    // memoized run scans: sort by start position so intra-run members
    // reuse the previous scan's end
    std::sort(es.begin(), es.end(),
              [](const Ent& x, const Ent& y) { return x.p < y.p; });
    int64_t run_s = -1, run_e = -1;
    for (auto& e : es) {
        if (e.p >= run_s && e.p < run_e) {
            e.rho = run_e - e.p;
        } else {
            int64_t q = e.p;
            while (cx.text[q] == c) ++q;  // terminators (0) stop the scan
            run_s = e.p;
            run_e = q;
            e.rho = q - e.p;
        }
        e.tail = cx.text[e.p + e.rho];
    }
    // group A (tail < c): rho ascending; group B (tail > c): rho descending
    std::sort(es.begin(), es.end(), [c](const Ent& x, const Ent& y) {
        bool xa = x.tail < c, ya = y.tail < c;
        if (xa != ya) return xa;
        if (x.rho != y.rho) return xa ? x.rho < y.rho : x.rho > y.rho;
        return false;
    });
    for (int64_t i = 0; i < n; ++i) a[i] = es[i].p - d;
    // resolve rho ties by the tail suffixes (depth d + rho; tails != c)
    int64_t i = 0;
    while (i < n) {
        int64_t j = i + 1;
        bool ia = es[i].tail < c;
        while (j < n && es[j].rho == es[i].rho && (es[j].tail < c) == ia) ++j;
        if (j - i > 1) mkqs(cx, a + i, j - i, d + es[i].rho);
        i = j;
    }
}

void mkqs(const BigCtx& cx, int64_t* a, int64_t n, int64_t d) {
    while (n > 1) {
        if (n < 24) {
            insertion_sort(cx, a, n, d);
            return;
        }
        // median-of-3 pivot byte at depth d
        uint8_t x = cx.text[a[0] + d];
        uint8_t y = cx.text[a[n / 2] + d];
        uint8_t z = cx.text[a[n - 1] + d];
        uint8_t v = std::max(std::min(x, y), std::min(std::max(x, y), z));
        // ternary partition on the byte
        int64_t lt = 0, i = 0, gt = n;
        while (i < gt) {
            uint8_t c = cx.text[a[i] + d];
            if (c < v) std::swap(a[lt++], a[i++]);
            else if (c > v) std::swap(a[i], a[--gt]);
            else ++i;
        }
        // recurse smaller sides explicitly, loop on the largest (bounded
        // stack depth)
        int64_t n_lt = lt, n_eq = gt - lt, n_gt = n - gt;
        if (n_lt > 1) mkqs(cx, a, n_lt, d);
        if (n_eq > 1) {
            if (v == 0) {
                // all-terminator partition: distinct seq ids, direct sort
                std::sort(a + lt, a + gt, [&cx, d](int64_t p, int64_t q) {
                    return cx.term_seq(p + d) < cx.term_seq(q + d);
                });
            } else if (n_eq >= 64) {
                run_leap(cx, a + lt, n_eq, d, v);
            } else {
                mkqs(cx, a + lt, n_eq, d + 1);
            }
        }
        if (n_gt > 1) {
            a += gt;
            n = n_gt;
            continue;
        }
        return;
    }
}

}  // namespace

extern "C" {

// Threaded, unbounded-length BWT + SA-sample builder.
//
//   text:      uint8[N] 0-separated letter codes: seq i occupies
//              [tstart[i], tstart[i+1]-1), terminator 0 at tstart[i+1]-1
//   tstart:    int64[nseq + 1], tstart[0] = 0, tstart[nseq] = N
//   alen:      alphabet size (letter codes 1..alen-1)
//   chpt_exp:  SA sample spacing exponent e
//   n_threads: sorting threads
// Outputs (caller-allocated) — same contract as kt_build_bwt
// (kaiju_tpu/native/sais.cpp):
//   bwt:          uint8[N]        (terminator block first, then letter ranks)
//   content_rank: int32[nseq]
//   sa_seq:       int32[n_samples]  content ranks at sampled SA slots
//   sa_off:       int64[n_samples]
// Returns 0 on success, negative on error.
int kt_build_bwt_big(const uint8_t* text, const int64_t* tstart, int64_t nseq,
                     int64_t N, int32_t alen, int32_t chpt_exp,
                     int32_t n_threads, uint8_t* bwt, int32_t* content_rank,
                     int32_t* sa_seq, int64_t* sa_off, int64_t n_samples) {
    if (nseq <= 0 || N <= nseq) return -1;
    if (tstart[0] != 0 || tstart[nseq] != N) return -2;
    const int64_t nlet = alen - 1;  // letter codes 1..nlet
    if (nlet < 1 || nlet > 127) return -3;

    BigCtx cx{text, tstart, nseq, N};

    // ---- terminator block: bwt[j] = last letter of input seq j --------
    for (int64_t j = 0; j < nseq; ++j) {
        int64_t tpos = tstart[j + 1] - 1;
        if (tpos <= tstart[j]) return -4;   // empty sequence
        if (text[tpos] != 0) return -5;
        uint8_t last = text[tpos - 1];
        if (last == 0 || last >= alen) return -6;
        bwt[j] = last;
    }

    // ---- global counts: per (c1, c2) bucket; c2 = 0 means "terminator"
    // (those sub-buckets are pre-sorted by input order) ------------------
    const int64_t nbuck = nlet * (nlet + 1);  // (c1-1)*(nlet+1) + c2
    std::vector<int64_t> bcount(nbuck, 0);
    {
        std::vector<std::thread> ths;
        std::vector<std::vector<int64_t>> parts(n_threads,
                                                std::vector<int64_t>(nbuck, 0));
        int64_t chunk = (N + n_threads - 1) / n_threads;
        for (int t = 0; t < n_threads; ++t) {
            ths.emplace_back([&, t]() {
                int64_t lo = t * chunk, hi = std::min(N, lo + chunk);
                auto& cnt = parts[t];
                for (int64_t p = lo; p < hi; ++p) {
                    uint8_t c1 = text[p];
                    if (c1 == 0) continue;
                    uint8_t c2 = text[p + 1];  // p+1 <= N-1: last char is 0
                    cnt[(int64_t)(c1 - 1) * (nlet + 1) + c2]++;
                }
            });
        }
        for (auto& th : ths) th.join();
        for (auto& cnt : parts)
            for (int64_t b = 0; b < nbuck; ++b) bcount[b] += cnt[b];
    }
    std::vector<int64_t> bstart(nbuck + 1, 0);
    for (int64_t b = 0; b < nbuck; ++b) bstart[b + 1] = bstart[b] + bcount[b];
    if (bstart[nbuck] != N - nseq) return -7;

    // ---- per-first-letter groups: fill, sort (threads), emit ----------
    const int64_t check = ((int64_t)1 << chpt_exp) - 1;
    int32_t next_rank = 0;
    int64_t sample_i = 0;
    int64_t k = nseq;  // global SA position of the next letter suffix
    std::vector<int64_t> sample_iseq(n_samples);  // input index, remapped later

    for (int64_t c1 = 1; c1 <= nlet; ++c1) {
        int64_t gb0 = (c1 - 1) * (nlet + 1);           // first bucket of group
        int64_t gsize = bstart[gb0 + nlet + 1] - bstart[gb0];
        if (gsize == 0) continue;
        std::vector<int64_t> pos(gsize);
        std::vector<int64_t> fill(nlet + 1);
        for (int64_t c2 = 0; c2 <= nlet; ++c2)
            fill[c2] = bstart[gb0 + c2] - bstart[gb0];
        // text-order scan keeps the (c1, terminator) sub-bucket in input
        // order automatically (terminator ids ascend with position)
        for (int64_t p = 0; p < N; ++p) {
            if (text[p] != (uint8_t)c1) continue;
            pos[fill[text[p + 1]]++] = p;
        }
        // sort the letter-letter buckets (depth 2) across threads
        std::atomic<int64_t> next_c2{1};
        std::vector<std::thread> ths;
        int nt = (int)std::min<int64_t>(n_threads, nlet);
        for (int t = 0; t < nt; ++t) {
            ths.emplace_back([&]() {
                for (;;) {
                    int64_t c2 = next_c2.fetch_add(1);
                    if (c2 > nlet) break;
                    int64_t lo = bstart[gb0 + c2] - bstart[gb0];
                    int64_t hi = (c2 == nlet ? gsize
                                             : bstart[gb0 + c2 + 1] - bstart[gb0]);
                    if (hi - lo > 1) mkqs(cx, pos.data() + lo, hi - lo, 2);
                }
            });
        }
        for (auto& th : ths) th.join();

        // emit group: BWT bytes + content ranks + SA samples
        for (int64_t i = 0; i < gsize; ++i, ++k) {
            int64_t p = pos[i];
            uint8_t prev = (p == 0) ? 0 : text[p - 1];
            if (prev == 0) {
                // suffix starts a sequence: find which
                int64_t lo = 0, hi = nseq;
                while (lo + 1 < hi) {
                    int64_t mid = (lo + hi) >> 1;
                    if (tstart[mid] <= p) lo = mid; else hi = mid;
                }
                content_rank[lo] = next_rank++;
                bwt[k] = 0;
            } else {
                bwt[k] = prev;
            }
            if ((k & check) == 0) {
                if (sample_i >= n_samples) return -8;
                int64_t lo = 0, hi = nseq;
                while (lo + 1 < hi) {
                    int64_t mid = (lo + hi) >> 1;
                    if (tstart[mid] <= p) lo = mid; else hi = mid;
                }
                sample_iseq[sample_i] = lo;
                sa_off[sample_i] = p - tstart[lo];
                ++sample_i;
            }
        }
    }
    if (next_rank != nseq) return -9;
    if (sample_i != n_samples) return -10;
    for (int64_t s = 0; s < n_samples; ++s)
        sa_seq[s] = content_rank[sample_iseq[s]];
    return 0;
}

}  // extern "C"
