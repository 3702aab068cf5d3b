// Device functions of the text-compare hybrid, shared by kernel G
// (text_extend.cu, the MEM funnel) and kernel E (greedy_search.cu, the
// last variant level), and the walk to a text position that kernel H
// (sa_lookup.cu) runs alone.
//
// A backward search whose SA interval is narrow (at most kSwWcap
// occurrences) stops stepping the FM index: each occurrence is walked to
// its text position (walk_group), and the rest of the extension is a
// direct comparison of the database text with the query
// (text_extend_group), each on a group of lanes sized to the work.  The
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
// offset in it, walked by a group of G lanes (1, 2, 4 or 8; gl: the
// lane's place in it, gmask: the group's lanes, as for kt::rank2), every
// lane of which gets it.  LF-walks from SA position k until a sampled
// slot, where the sample gives (sa_seq, sa_off + steps), or a terminator,
// where the LF result is the content rank and the offset the steps
// taken.  A group takes a step in one memory latency (lf_group); one lane
// reads the letter, then its rank through rank1, as kt::sa_walk does.
template <int G, class Ix>
__device__ __forceinline__ WalkPos walk_group(const Ix& ix,
                                              const int* __restrict__ C,
                                              int nseq, int chpt_exp, int k,
                                              int gl, unsigned gmask) {
    const int check = (1 << chpt_exp) - 1;
    int steps = 0;
    while (k & check) {
        int c, kn;
        if constexpr (G == 1) {
            c = bwt_byte(ix.row(k >> 7), k & 127);
            kn = rank1(ix, C, c, k);
        } else {
            kn = lf_group<G>(ix, C, k, gl, gmask, &c);
        }
        if (c == 0) return {kn, steps};
        k = kn;
        ++steps;
    }
    int idx = (k >> chpt_exp) - ((nseq - 1) >> chpt_exp) - 1;
    idx = min(max(idx, 0), ix.nsamp - 1);
    return {ix.seq(idx), ix.off(idx) + steps};
}

// The compare of K8's _text_extend (kaiju_tpu/ops/fused_mem2.py:228-274)
// from u0 on, by a group of G lanes (1, 2, 4 or 8): the least t in [u0,
// lim) with letter(p-1-t) == 0 or != flat[qg-1-t], else lim.  letter(x)
// reads text byte x.  Lane gl compares letters gl * 8 .. + 8 of each round
// of 8 G, their 16 loads issued together, so that a round costs one memory
// latency; the first stop is the group's least.
template <int G, class Letter>
__device__ __forceinline__ int match_back(const Letter& letter,
                                          const uint8_t* __restrict__ flat,
                                          int p, int qg, int u0, int lim,
                                          int gl, unsigned gmask) {
    constexpr int kC = 8;
    for (int u = u0; u < lim; u += kC * G) {
        const int base = u + gl * kC;
        int t[kC], q[kC];
#pragma unroll
        for (int k = 0; k < kC; ++k) {
            const bool in = base + k < lim;
            t[k] = in ? letter(p - 1 - base - k) : 0;
            q[k] = in ? __ldg(flat + qg - 1 - base - k) : 0;
        }
        int stop = 0x7fffffff;
#pragma unroll
        for (int k = kC - 1; k >= 0; --k)
            if (base + k >= lim || t[k] == 0 || t[k] != q[k]) stop = base + k;
#pragma unroll
        for (int m = G / 2; m > 0; m >>= 1)
            stop = min(stop, __shfl_xor_sync(gmask, stop, m, G));
        if (stop != 0x7fffffff) return min(stop, lim);
    }
    return lim;
}

// The text byte x of an index (kt::FlatIx, kt::ShardIx, kt::HostIx).
template <class Ix>
struct IxLetter {
    const Ix& ix;
    __device__ __forceinline__ int operator()(int x) const {
        return ix.letter(x);
    }
};

// K8's _text_extend by a group of G lanes (match_back from 0): the
// longest u with text[p-1-t] == flat[qg-1-t] for every t < u, stopping at
// t = avail, at t = p (the text's start) and at a text code of 0 (a
// separator).
template <int G, class Ix>
__device__ __forceinline__ int text_extend_group(
    const Ix& ix, const uint8_t* __restrict__ flat, int p, int qg, int avail,
    int gl, unsigned gmask) {
    return match_back<G>(IxLetter<Ix>{ix}, flat, p, qg, 0, min(avail, p), gl,
                         gmask);
}

}  // namespace kt
