// The parts of the Greedy search that kernel E (greedy_search.cu) shares
// with kernel U (greedy_levels.cu), which runs E's per-read work level by
// level for a group of processes on several hosts, and kernel X
// (greedy_variants.cu), which runs a level's FM steps in between: the
// fields of their arguments, a warp's shared memory, the tie list, the
// level-0 scan (the read's fragment views, the diagonal prefix sums, the
// node scan and the planned-node rule, the level-0 events and sources),
// the length histogram, push_src, settle and the read's row.  The
// semantics are E's (greedy_search.cu, ops/greedy.py).
#pragma once

#include "text_common.cuh"

namespace kg {

constexpr unsigned kFull = kt::kFullMask;
constexpr int kBig = 0x3fffffff;
constexpr int kStrip = 4;     // the JAX funnel's strip width W
constexpr int kQlCap = 512;   // planned-node groups clamp lengths below
constexpr int kNSub = 19;     // substitutions a position
constexpr int kMaxS = 32;     // slots a read
constexpr int kSrcInts = 8;   // fid qi effL s0 s1 delta diffc ml
constexpr int kFlagTieOver = 1;
constexpr int kFlagScratch = 4;
constexpr int kLcap = 512;    // a read's positions held in shared memory
constexpr int kWin = 32;      // variants a window of a level: one a lane
constexpr int kWinInts = 8;   // a variant's result, see settle
constexpr int kHistWords = kQlCap * 2 / 32;  // two bits a length
// U's state a read (best, ties so far, sources, over vcap), and a variant
// of U's list, X's input: code | pos << 8 (the substituted letter and its
// position qi - 1), the source's s0 and s1, its fragment's start in flat,
// settle's need, and the slot's r[5..7] (delta, diffc, fid | effL << 8)
constexpr int kStateInts = 4;
constexpr int kVarInts = 8;

using kt::lanes_below;
using kt::warp_incl_min;
using kt::warp_incl_sum;
using kt::warp_max;

// The arguments that E and U share: B's lanes, the flat codes and the
// slot table, the scoring tables, the search parameters, the scratch and
// the outputs.
struct Params {
    const int *li, *ls0, *ls1;  // B's lanes
    const uint8_t* flat;
    const int* frag_off;
    const int* rf_rows;
    int B, S;
    const int *diag, *submat, *subcode, *subdiag;  // [32], [32 * 19] x 3
    int Lmap, mfl, min_score, mismatches, T, vcap;
    uint8_t* node;  // per position: 1 = node, 2 = planned (long reads)
    int* pincl;     // per position: inclusive diagonal prefix sum (long)
    int* src;       // [B, 2, vcap, kSrcInts]
    int *best, *flags, *g_s0, *g_s1;
};

// The part of a warp's shared memory that E and U share: the read's
// fragments, the planned-node rule's histogram and a source group's first
// variants.
struct Head {
    unsigned hist[kHistWords];  // lengths seen once, twice or more
    int frag[kMaxS];   // fragment rows, ascending
    int base[kMaxS];   // their starts in flat
    int len[kMaxS];    // their lengths
    int vo[kMaxS + 1];  // their starts in the views
    int exc[32];       // a source group's first variants
};

// E's warp: the read's positions in fragment order (its views), and the
// state of its level 0 and variant levels.
struct Warp : Head {
    int pincl[kLcap];  // inclusive diagonal prefix sums
    union {
        int li[kLcap];  // level 0: B's i
        struct {        // variant levels: a window's
            int res[kWin][kWinInts];        // results
            int ext[kWin][kt::kSwWcap];  // switched occurrences' reach
            int first[kWin];                // first pending occurrence
        } w;
    } u;
    uint8_t flat[kLcap];
    uint8_t node[kLcap];  // 1 = node, 2 = planned
    int next;          // the window's next extension or occurrence
};

// Where a read's per-position arrays live: fragment f's positions at
// x + Warp::vo[f], in the warp's shared memory or in global memory.
struct Views {
    const int* li;
    int* pincl;
    uint8_t* node;
    const uint8_t* flat;
};

// The read's running best and its tie list, in event order.  Every lane
// of the warp calls add() with its event (ev false for none), in the order
// of the events; an event with nid > 0 ids is a switched interval, whose
// tie row becomes virtual (sw: the read's [T, kSwWcap] id slots, slot0:
// their offset from sw_ids' start).
struct Ties {
    int best, cnt, T;
    int *s0, *s1, *sw;
    int slot0;
    __device__ void add(bool ev, int score, int a0, int a1, int lane,
                        const int* ids = nullptr, int nid = 0) {
        const int m = warp_max(ev ? score : 0);
        if (m > best) {  // a new best: the earlier ties no longer count
            best = m;
            cnt = 0;
        }
        const bool tie = ev && score == best && score > 0;
        const unsigned bal = __ballot_sync(kFull, tie);
        const int r = cnt + __popc(bal & lanes_below(lane));
        if (tie && r < T) {
            if (nid > 0) {
                for (int q = 0; q < nid; ++q) sw[r * kt::kSwWcap + q] = ids[q];
                a0 = kt::kVBase + slot0 + r * kt::kSwWcap;
                a1 = a0 + nid;
            }
            s0[r] = a0;
            s1[r] = a1;
        }
        cnt += __popc(bal);
    }
};

// Diagonal sum over the first x codes of a fragment's pincl view.
__device__ __forceinline__ int pref(const int* pincl, int x) {
    return x > 0 ? pincl[x - 1] : 0;
}

// The planned-node rule's histogram: two bits a length, the first set by
// its first node, the second by any later one.
__device__ __forceinline__ void hist_add(unsigned* hist, int ql) {
    const unsigned once = 1u << ((ql & 15) * 2);
    if (atomicOr(&hist[ql >> 4], once) & once)
        atomicOr(&hist[ql >> 4], once << 1);
}

__device__ __forceinline__ bool hist_multi(const unsigned* hist, int ql) {
    return (hist[ql >> 4] >> ((ql & 15) * 2 + 1)) & 1u;
}

// Appends a source in lane order; returns the new count (may pass vcap:
// the caller flags the read, nothing past vcap is written).  f is the
// fragment's place in the read (Warp::frag).
__device__ __forceinline__ int push_src(int* buf, int n, int vcap, bool on,
                                        int lane, int f, int qi, int effL,
                                        int s0, int s1, int delta, int diffc,
                                        int ml) {
    const unsigned bal = __ballot_sync(kFull, on);
    const int r = n + __popc(bal & lanes_below(lane));
    if (on && r < vcap) {
        int* e = buf + (size_t)r * kSrcInts;
        e[0] = f;
        e[1] = qi;
        e[2] = effL;
        e[3] = s0;
        e[4] = s1;
        e[5] = delta;
        e[6] = diffc;
        e[7] = ml;
    }
    return n + __popc(bal);
}

// A variant's result from its final interval [n0, n1) and start i: r[0]
// score, r[1] n0, r[2] n1, r[3] i, r[4] has_si | ev << 1 | nid << 2;
// r[5] delta, r[6] diffc and r[7] f | effL << 8 are set before.
__device__ __forceinline__ void settle(const Params& a, const int* pin,
                                       int* r, int n0, int n1, int i,
                                       int need, int nid) {
    const int veff = r[7] >> 8;
    bool has_si = false, ev = false;
    int score = 0;
    if (n0 < n1) {
        const int mlen = veff - i;
        has_si = mlen >= need;
        if (has_si) {
            score = max(pref(pin, veff) - pref(pin, i) + r[5] + r[6], 0);
            ev = mlen >= a.mfl && score >= a.min_score;
        }
    }
    r[0] = score;
    r[1] = n0;
    r[2] = n1;
    r[3] = i;
    r[4] = (int)has_si | (int)ev << 1 | nid << 2;
}

// The read's fragment rows, ascending, into sm.frag, their starts and
// lengths into sm.base and sm.len, and their view offsets into sm.vo: the
// fragment's start in the warp's copy where the read's positions fit in
// shared memory and may_stage (*staged), else its start in flat.  Returns
// the fragments; *total: the read's positions.  Whole warp.
__device__ __forceinline__ int read_views(const Params& a, Head& sm, int b,
                                          int lane, bool may_stage,
                                          bool* staged, int* total) {
    const int* rf = a.rf_rows + (size_t)b * a.S;
    const int mine = lane < a.S ? rf[lane] : -1;
    int below = 0;
    for (int t = 0; t < a.S; ++t) {
        const int o = __shfl_sync(kFull, mine, t);
        below += o >= 0 && (o < mine || (o == mine && t < lane));
    }
    const int nfr = __popc(__ballot_sync(kFull, mine >= 0));
    if (mine >= 0) sm.frag[below] = mine;
    __syncwarp();
    int base = 0, flen = 0;
    if (lane < nfr) {
        base = a.frag_off[sm.frag[lane]];
        flen = a.frag_off[sm.frag[lane] + 1] - base;
    }
    const int incl = warp_incl_sum(flen, lane);
    *total = __shfl_sync(kFull, incl, 31);
    *staged = may_stage && *total <= kLcap;
    if (lane < nfr) {
        sm.base[lane] = base;
        sm.len[lane] = flen;
        sm.vo[lane] = *staged ? incl - flen : base;
    }
    __syncwarp();
    return nfr;
}

// A staged read's B lanes (i) and codes copied into the warp's shared
// memory, kU loads a lane in flight.  Whole warp.
__device__ __forceinline__ void stage_read(const Params& a, Warp& sm, int nfr,
                                           int total, int lane) {
    constexpr int kU = 4;
    for (int x0 = 0; x0 < total; x0 += 32 * kU) {
        int iv[kU];
        int cv[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            const int x = x0 + u * 32 + lane;
            iv[u] = cv[u] = 0;
            if (x < total) {
                int f = 0;  // the last fragment starting at or before x
                for (int step = 16; step > 0; step >>= 1)
                    if (f + step < nfr && sm.vo[f + step] <= x) f += step;
                const int g = sm.base[f] + x - sm.vo[f];
                iv[u] = __ldg(a.li + g);
                cv[u] = __ldg(a.flat + g);
            }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            const int x = x0 + u * 32 + lane;
            if (x < total) {
                sm.u.li[x] = iv[u];
                sm.flat[x] = (uint8_t)cv[u];
            }
        }
    }
    __syncwarp();
}

// Per fragment of the read: the diagonal prefix sums, then the nodes (1)
// and the planned nodes (3) into the views.  Whole warp.
__device__ __forceinline__ void level0_nodes(const Params& a, Head& sm,
                                             const Views& v, int nfr,
                                             int lane) {
    const int j0 = a.Lmap - 1;
    for (int k = 0; k < nfr; ++k) {
        const int vo = sm.vo[k], n = sm.len[k];
        const int* li = v.li + vo;
        const uint8_t* fl = v.flat + vo;
        int* pincl = v.pincl + vo;
        uint8_t* node = v.node + vo;
        int carry = 0;
        for (int x0 = 0; x0 < n; x0 += 32) {
            const int x = x0 + lane;
            const int d = x < n ? __ldg(a.diag + (fl[x] & 31)) : 0;
            const int inc = warp_incl_sum(d, lane) + carry;
            if (x < n) pincl[x] = inc;
            carry = __shfl_sync(kFull, inc, 31);
        }
        int js = -1;
        for (int x0 = j0; x0 < n; x0 += 32) {
            const int j = x0 + lane;
            if (j < n && li[j] <= 1) js = max(js, j);
        }
        js = warp_max(js);
        if (lane < kHistWords) sm.hist[lane] = 0;
        __syncwarp();
        // scanning j downward, 32 positions a step: a node's i is below the
        // minimum over the eligible positions above it
        int above = kBig;
        for (int hi = n - 1; hi >= j0; hi -= 32) {
            const int j = hi - lane;
            const bool in = j >= j0;
            const int ii = in ? li[j] : 0;
            const bool elig = in && j >= js && j - ii + 1 >= a.Lmap;
            const int inc = warp_incl_min(elig ? ii : kBig, lane);
            int exc = __shfl_up_sync(kFull, inc, 1);
            if (lane == 0) exc = kBig;
            const bool ins = elig && ii < min(above, exc);
            if (in) node[j] = ins;
            if (ins) hist_add(sm.hist, min(j - ii + 1, kQlCap - 1));
            above = min(above, __shfl_sync(kFull, inc, 31));
        }
        __syncwarp();
        // planned: lengths at least the longest with two or more nodes
        int qt = -1;
        for (int x0 = j0; x0 < n; x0 += 32) {
            const int j = x0 + lane;
            if (j < n && node[j]) {
                const int ql = j - li[j] + 1;
                if (hist_multi(sm.hist, min(ql, kQlCap - 1))) qt = max(qt, ql);
            }
        }
        qt = warp_max(qt);
        for (int x0 = j0; x0 < n; x0 += 32) {
            const int j = x0 + lane;
            if (j < n && node[j] && j - li[j] + 1 >= qt) node[j] = 3;
        }
        __syncwarp();
    }
}

// Level 0: the node events into ties and, with mismatches, the level-1
// sources into X, in node order (the strip nodes first, each in fragment
// order then ascending j).  Returns the sources (may pass vcap).  Whole
// warp.
__device__ __forceinline__ int level0_events(const Params& a, const Head& sm,
                                             const Views& v, int nfr,
                                             Ties& ties, int* X, int lane) {
    const int j0 = a.Lmap - 1;
    int nsrc = 0;
    for (int strip = 1; strip >= 0; --strip) {
        for (int k = 0; k < nfr; ++k) {
            const int vo = sm.vo[k], n = sm.len[k], gb = sm.base[k];
            const int* li = v.li + vo;
            const int* pincl = v.pincl + vo;
            const uint8_t* node = v.node + vo;
            const int lo = strip ? max(n - kStrip, j0) : j0;
            const int hi = strip ? n : n - kStrip;
            for (int x0 = lo; x0 < hi; x0 += 32) {
                const int j = x0 + lane;
                const int fl = j < hi ? node[j] : 0;
                int qi = 0, s0 = 0, s1 = 0, score = 0;
                bool ev = false;
                if (fl & 1) {
                    qi = li[j];
                    s0 = __ldg(a.ls0 + gb + j);
                    s1 = __ldg(a.ls1 + gb + j);
                    score = max(pref(pincl, j + 1) - pref(pincl, qi), 0);
                    ev = j - qi + 1 >= a.mfl && score >= a.min_score;
                }
                ties.add(ev, score, s0, s1, lane);
                if (a.mismatches > 0)
                    nsrc = push_src(X, nsrc, a.vcap,
                                    (fl & 2) && qi > 0 && j + 1 >= a.mfl,
                                    lane, k, qi, j + 1, s0, s1, 0, 0,
                                    j - qi + 1);
            }
        }
    }
    return nsrc;
}

// The read's row: best (0 when over vcap), its flags (kFlagScratch when
// over, kFlagTieOver past T ties), the kept ties and zeros after them;
// with the hybrid's id slots, a kept virtual row's ids and zeros
// elsewhere (a tie that a later best replaced may have left ids behind).
// Whole warp.
__device__ __forceinline__ void finish_read(const Params& a, Ties& ties,
                                            bool over, int b, int lane) {
    __syncwarp();
    const int kept = over ? 0 : min(ties.cnt, a.T);
    for (int x = lane; ties.sw != nullptr && x < a.T * kt::kSwWcap; x += 32) {
        const int t = x / kt::kSwWcap;
        const bool virt = t < kept && ties.s0[t] >= kt::kVBase;
        if (!virt || x % kt::kSwWcap >= ties.s1[t] - ties.s0[t])
            ties.sw[x] = 0;
    }
    __syncwarp();
    for (int t = kept + lane; t < a.T; t += 32) {
        ties.s0[t] = 0;
        ties.s1[t] = 0;
    }
    if (lane == 0) {
        a.best[b] = over ? 0 : ties.best;
        a.flags[b] = over ? kFlagScratch : (ties.cnt > a.T ? kFlagTieOver : 0);
    }
}

}  // namespace kg
