// Device functions of the text-compare hybrid, shared by kernel G
// (text_extend.cu, the MEM funnel) and kernel E (greedy_search.cu, the
// last variant level).
//
// A backward search whose SA interval is narrow (at most kSwWcap
// occurrences) stops stepping the FM index: each occurrence is walked to
// its text position (walk_pos), and the rest of the extension is a direct
// comparison of the database text with the query (text_extend).  The
// occurrences that reach the longest extension are exactly the FM interval
// the steps would have ended on, in SA order, so their sequence ids stand
// in for it as a virtual row: positions kVBase + slot .. + n, whose ids
// sit in sw_ids[slot ..].
#pragma once

#include "fm_common.cuh"

namespace kt {

constexpr int kSwWcap = 8;         // widest interval that switches (SW_WCAP)
constexpr int kVBase = 1 << 30;    // virtual rows start here (VBASE)

struct WalkPos {
    int iseq, pos;
};

// K4's _walk_pos (kaiju_tpu/ops/fused_mem2.py:345-416): get_suffix
// (bwt.c:105-121) returning the content rank of the sequence and the
// offset in it.  LF-walks from SA position k until a sampled slot, where
// the sample gives (sa_seq, sa_off + steps), or a terminator, where the LF
// result is the content rank and the offset the steps taken.  kRank1:
// each step's rank through rank1 (its loads issued four at a time).
template <bool kRank1 = false, class Ix>
__device__ __forceinline__ WalkPos walk_pos(const Ix& ix,
                                            const int* __restrict__ C,
                                            int nseq, int chpt_exp, int k) {
    const int check = (1 << chpt_exp) - 1;
    int steps = 0;
    while (k & check) {
        const int c = bwt_byte(ix.row(k >> 7), k & 127);
        int kn;
        if constexpr (kRank1) kn = rank1(ix, C, c, k);
        else kn = rank(ix, C, c, k);
        if (c == 0) return {kn, steps};
        k = kn;
        ++steps;
    }
    int idx = (k >> chpt_exp) - ((nseq - 1) >> chpt_exp) - 1;
    idx = min(max(idx, 0), ix.nsamp - 1);
    return {ix.seq(idx), ix.off(idx) + steps};
}

// K8's _text_extend (kaiju_tpu/ops/fused_mem2.py:228-274): the longest u
// with text[p-1-t] == flat[qg-1-t] for every t < u, stopping at t = avail,
// at t = p (the text's start) and at a text code of 0 (a separator).  The
// bytes go 8 at a time: their 16 loads are issued together, so a chunk
// costs one memory latency, not eight.
template <class Ix>
__device__ __forceinline__ int text_extend(const Ix& ix,
                                           const uint8_t* __restrict__ flat,
                                           int p, int qg, int avail) {
    constexpr int kChunk = 8;
    const int lim = min(avail, p);
    for (int u = 0; u < lim; u += kChunk) {
        const int n = min(kChunk, lim - u);
        int t[kChunk], q[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
            t[k] = k < n ? ix.letter(p - 1 - u - k) : 0;
            q[k] = k < n ? __ldg(flat + qg - 1 - u - k) : 0;
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
            if (k >= n || t[k] == 0 || t[k] != q[k]) return u + k;
    }
    return lim;
}

// The whole switch of one interval on one thread: walk each occurrence
// s0 + q (q < s1 - s0 <= kSwWcap) to its text start, compare backwards
// from query position qg with avail letters left, and keep the
// occurrences that reach the longest extension.  Returns that extension;
// ids[0, *n) receives their sequence ids in SA order.
template <class Ix>
__device__ __forceinline__ int switch_serial(
    const Ix& ix, const int* __restrict__ C, int nseq, int chpt_exp,
    const int* __restrict__ rank_start, const uint8_t* __restrict__ flat,
    int s0, int s1, int qg, int avail, int* ids, int* n) {
    int best = -1;
    *n = 0;
    for (int k = s0; k < s1; ++k) {
        const WalkPos w = walk_pos(ix, C, nseq, chpt_exp, k);
        const int p =
            __ldg(rank_start + min(max(w.iseq, 0), nseq - 1)) + w.pos;
        const int e = text_extend(ix, flat, p, qg, avail);
        if (e > best) {
            best = e;
            *n = 0;
        }
        if (e == best) ids[(*n)++] = w.iseq;
    }
    return best;
}

}  // namespace kt
