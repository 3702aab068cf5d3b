// SEG low-complexity filter — C++ twin of kaiju_tpu/engine/seg.py.
//
// Same algorithm and numerics as the Python port (see seg.py docstring for
// the behavioral contract against the vendored NCBI implementation,
// reference: src/include/ncbi-blast+/algo/blast/core/blast_seg.c):
// window=12, locut=2.2, hicut=2.5, maxtrim=50, overlaps merge, ln(n!)
// table rounded to 6 decimals, strict-'<' trim tie-breaks, head-only
// nested prepend.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <vector>

namespace {

constexpr double LN2 = 0.69314718055994530941723212145818;
constexpr double LN20 = 2.9957322735539909;
constexpr int WINDOW = 12;
constexpr double LOCUT = 2.2;
constexpr double HICUT = 2.5;
constexpr int MAXTRIM = 50;
constexpr int MAXBOGUS = 2;

constexpr double LOG_WIN10[11] = {
    0.0, -2.30258509, -1.60943791, -1.203982804, -0.916290731,
    -0.693147181, -0.510825624, -0.356674944, -0.223143551,
    -0.105360516, 0.0,
};

// lnfact with the reference's 6-decimal table rounding for n <= 10000.
// The fragmenter calls SEG from several threads: the table is a static
// built by its initializer, which C++ runs once and makes the other
// threads wait for.
double lnfact(int n) {
    static const std::vector<double> table = [] {
        std::vector<double> t(10001);
        for (int i = 0; i <= 10000; ++i) {
            char buf[64];
            std::snprintf(buf, sizeof buf, "%.6f", std::lgamma((double)i + 1.0));
            t[i] = std::atof(buf);
        }
        return t;
    }();
    if (n <= 10000) return table[n];
    return ((double)n + 0.5) * std::log((double)n) - n + 0.9189385332;
}

double entropy(const int* sv) {
    int total = 0;
    for (int i = 0; sv[i] != 0; ++i) total += sv[i];
    if (total == 0) return 0.0;
    double ent = 0.0;
    if (total == 10) {
        for (int i = 0; sv[i] != 0; ++i)
            ent += sv[i] * LOG_WIN10[sv[i]] / LN2;
    } else {
        for (int i = 0; sv[i] != 0; ++i)
            ent += sv[i] * std::log((double)sv[i] / total) / LN2;
    }
    return std::fabs(ent / total);
}

void state_vector(const int* counts, int* sv) {
    int n = 0;
    for (int c = 0; c < 20; ++c)
        if (counts[c]) sv[n++] = counts[c];
    std::sort(sv, sv + n, std::greater<int>());
    for (; n < 21; ++n) sv[n] = 0;
}

double ln_ass(const int* sv) {
    double ans = lnfact(20);
    if (sv[0] == 0) return ans;
    int total = 20, cls = 1, idx = 0, svim1 = sv[0], i = 0;
    for (;;) {
        ++i;
        if (i == 20) { ans -= lnfact(cls); break; }
        int svi = sv[++idx];
        if (svi == svim1) { ++cls; continue; }
        total -= cls;
        ans -= lnfact(cls);
        if (svi == 0) { ans -= lnfact(total); break; }
        cls = 1;
        svim1 = svi;
    }
    return ans;
}

double ln_perm(const int* sv, int window_length) {
    double ans = lnfact(window_length);
    for (int i = 0; sv[i] != 0; ++i) ans -= lnfact(sv[i]);
    return ans;
}

double get_prob(const int* sv, int total) {
    return ln_ass(sv) + ln_perm(sv, total) - total * LN20;
}

struct Seg { int begin, end; };

void trim(const int8_t* codes, int start, int length, int* lend_out, int* rend_out) {
    int lend = 0, rend = length - 1;
    int minlen = 1;
    if (length - MAXTRIM > minlen) minlen = length - MAXTRIM;
    double minprob = 1.0;
    int sv[21];
    for (int ln = length; ln > minlen; --ln) {
        int counts[20] = {0};
        for (int p = start; p < start + ln; ++p)
            if (codes[p] >= 0) counts[codes[p]]++;
        for (int i = 0; i <= length - ln; ++i) {
            state_vector(counts, sv);
            double prob = get_prob(sv, ln);
            if (prob < minprob) { minprob = prob; lend = i; rend = ln + i - 1; }
            int p = start + i;
            if (p + ln < start + length) {
                if (codes[p] >= 0) counts[codes[p]]--;
                if (codes[p + ln] >= 0) counts[codes[p + ln]]++;
            }
        }
    }
    *lend_out = lend;
    *rend_out = rend;
}

// Fast exact window entropy: the reference sums sv[i]*log(sv[i]/total)/LN2
// over the DESCENDING-sorted count vector (blast_seg.c s_Entropy); summing
// per count VALUE from 12 down, with duplicates consecutive, adds the
// bit-identical term sequence without the per-window sort — terms come
// from tables holding exactly the expressions the reference evaluates.
struct EntTables {
    double term[WINDOW + 1][WINDOW + 1];  // [total][v] = v*log(v/total)/LN2
    double term10[WINDOW + 1];            // total==10 LOG_WIN10 path
    EntTables() {
        for (int total = 1; total <= WINDOW; ++total)
            for (int v = 1; v <= WINDOW; ++v)
                term[total][v] = v * std::log((double)v / total) / LN2;
        for (int v = 1; v <= 10; ++v) term10[v] = v * LOG_WIN10[v] / LN2;
        for (int v = 11; v <= WINDOW; ++v) term10[v] = 0.0;
    }
};

double entropy_hist(const int* hist, int total) {
    if (total == 0) return 0.0;
    static const EntTables T;
    const double* term = (total == 10) ? T.term10 : T.term[total];
    double ent = 0.0;
    for (int v = WINDOW; v >= 1; --v)
        for (int k = 0; k < hist[v]; ++k) ent += term[v];
    return std::fabs(ent / total);
}

void seg_seq(const int8_t* codes, int start, int length, int offset,
             std::vector<Seg>& segs) {
    const int downset = (WINDOW + 1) / 2 - 1;
    const int upset = WINDOW - downset;
    if (WINDOW > length) return;

    std::vector<double> H(length, -1.0);
    {
        int counts[20] = {0};
        int hist[WINDOW + 1] = {0};  // hist[v] = #letters with count v
        int total = 0;
        int bogus = 0;
        auto inc = [&](int c) {
            int v = counts[c]++;
            if (v) --hist[v];
            ++hist[v + 1];
            ++total;
        };
        auto dec = [&](int c) {
            int v = counts[c]--;
            --hist[v];
            if (v > 1) ++hist[v - 1];
            --total;
        };
        for (int p = start; p < start + WINDOW; ++p) {
            if (codes[p] >= 0) inc(codes[p]); else ++bogus;
        }
        int first = downset, last = length - upset;
        for (int i = first; i <= last; ++i) {
            if (bogus > MAXBOGUS) H[i] = -1.0;
            else H[i] = entropy_hist(hist, total);
            int p = start + (i - downset);
            if (p + WINDOW < start + length) {
                if (codes[p] >= 0) dec(codes[p]); else --bogus;
                int q = p + WINDOW;
                if (codes[q] >= 0) inc(codes[q]); else ++bogus;
            }
        }
    }

    int first = downset, last = length - upset, lowlim = first;
    for (int i = first; i <= last; ++i) {
        if (H[i] <= LOCUT && H[i] != -1.0) {
            int j = i;
            while (j >= lowlim && H[j] != -1.0 && H[j] <= HICUT) --j;
            int loi = j + 1;
            j = i;
            while (j <= last && H[j] != -1.0 && H[j] <= HICUT) ++j;
            int hii = j - 1;

            int leftend = loi - downset;
            int rightend = hii + upset - 1;
            int tlen = rightend - leftend + 1;
            int lend, rend;
            trim(codes, start + leftend, tlen, &lend, &rend);
            int new_left = leftend + lend;
            int new_right = rightend - (tlen - rend - 1);

            if (i + upset - 1 < new_left) {
                int lrec_start = loi - downset;
                int lrec_len = new_left - lrec_start;
                std::vector<Seg> sub;
                seg_seq(codes, start + lrec_start, lrec_len,
                        offset + lrec_start, sub);
                // head-only prepend (reference: blast_seg.c:2093-2097)
                if (!sub.empty()) segs.insert(segs.begin(), sub.front());
            }
            segs.insert(segs.begin(), Seg{new_left + offset, new_right + offset});
            i = std::min(hii, new_right + downset);
            lowlim = i + 1;
        }
    }
}

}  // namespace

extern "C" {

// seq: AA codes (0..19 for the 20 AAs in "ACDEFGHIKLMNPQRSTVWY" order,
// -1 for anything else).  out: pairs (left,right) buffer of cap entries.
// Returns interval count (ascending, overlap-merged), or -1 on overflow.
int kt_seg_intervals(const int8_t* seq, int len, int32_t* out, int cap) {
    std::vector<Seg> segs;
    seg_seq(seq, 0, len, 0, segs);
    if (segs.empty()) return 0;
    // merge overlapping neighbors from the head (rightmost first)
    std::vector<Seg> merged;
    merged.push_back(segs[0]);
    for (size_t t = 1; t < segs.size(); ++t) {
        Seg& cur = merged.back();
        const Seg& nxt = segs[t];
        if (cur.begin - nxt.end - 1 < 0) {
            cur.end = std::max(cur.end, nxt.end);
            cur.begin = std::min(cur.begin, nxt.begin);
        } else {
            merged.push_back(nxt);
        }
    }
    int n = (int)merged.size();
    if (n > cap) return -1;
    for (int t = 0; t < n; ++t) {
        out[2 * t] = merged[n - 1 - t].begin;  // restore ascending
        out[2 * t + 1] = merged[n - 1 - t].end;
    }
    return n;
}

}  // extern "C"
