// Kernel E: the Greedy search of each read, from kernel B's lanes to the
// read's best score, its flags and the SA ranges of its first T ties.
//
// Replaces kaiju_tpu/ops/fused_greedy.py:greedy_core (K13: the inserted-
// and planned-node rules, node scores, the variant levels with the 19-way
// BLOSUM62 fan-out and the UpdateSI probe, the tie rows) and
// _extend_two_stage (K14: the resumed extension of the substituted
// variants), with the rank of K1, and the last level's text-compare
// hybrid (K8: _switch_pool with _text_extend and K4's _walk_pos, called at
// fused_greedy.py:488-505).  The search funnel before it is kernel B; the
// tail after it (SA walks, capped ids, LCA) is kernel F.
//
// Semantics per read, as ops/greedy.py states them:
//   level 0  jstop = the highest j >= j0 whose match reaches i <= 1;
//            candidates j >= jstop with length >= Lmap; scanning j downward
//            a candidate is a node iff its i is below every higher-j
//            candidate's (bwt.c:225-252); a node's score is the diagonal
//            sum over [qi, j] and it is an eval event when ql >= mfl and
//            score >= min_score; the planned nodes are the lengths down to
//            and including the longest group of two or more (lengths
//            clamped at 511);
//   level k  each source (a planned node, then a variant that found an
//            interval) fans out its 19 substitutions at qi - 1, in the
//            reference's descending order, kept while the new score bound
//            is at least max(the read's best after level k - 1,
//            min_score); each variant probes UpdateSI and resumes the
//            backward extension (bwt.c:298-336).  With a text copy
//            (sw_ids given), a variant of the last level whose probe
//            interval holds at most kSwWcap occurrences, with letters left,
//            finishes by text comparison instead (text_common.cuh): the
//            same start, and the achieving occurrences' ids in place of
//            the interval;
//   ties     eval events at the read's final best (> 0) in the JAX order:
//            level, then at level 0 the strip nodes (j >= flen - 4) before
//            the others, each in fragment order then ascending j, and at a
//            variant level the source order then the column.  The first T
//            are written; flag 1 when there are more.  A switched tie's
//            row is virtual: kVBase + slot .. + n with slot = (b T + r) 8
//            for tie r of read b, its n ids in sw_ids[slot ..].
// A read keeps at most vcap sources a level in scratch; one that needs
// more gets flag 4 and a zero row, and the host replays it.  Nothing is
// dropped silently.
//
// Bound: the FM steps of the variants' probes and extensions, one random
// 256-byte record row per rank, plus B's lanes and the flat codes read
// once; device-memory bytes at 3.35 TB/s.  But a read's work is a chain:
// its level 0 walks its fragments in turn, each variant level waits for
// the one before (its threshold is the best so far), and a variant's
// steps and a switch's SA walks and text compares are dependent memory
// reads.  So the kernel lasts as long as its slowest read: on phase 3's
// batches a read averages ~40-50 us and the slowest, with hundreds of
// variants a level or dozens of narrow intervals to switch, 150-400 us
// (per-read timers on the H100, PERF.md section 6).  The first design
// (one warp a read) kept level 0's per-position arrays in global memory,
// ran a level's variants 32 at a time, each lane scanning its rows with
// loads that waited on one another, and switched a narrow interval's
// occurrences one after another on one lane, each walk step and each 8
// letters one memory latency or more.
// Design: one warp per read.  The JAX program is level-synchronous over
// the batch only because XLA needs static shapes; its pruning bound is per
// read, so a read run on its own explores the same set.  The read's B
// lanes (i) and codes are first copied into the warp's shared memory, all
// loads issued together; level 0 (diagonal prefix sums, the node scan as
// a warp prefix minimum, the planned-node rule on a two-bit length
// histogram) then runs on shared memory.  A read longer than kLcap
// positions runs the same code on global scratch the wrapper allocates.
// Each variant level splits into an unordered and an ordered part.  A
// warp prefix sum over a group of 32 sources' kept counts numbers the
// group's variants; a window of 32 of them runs unordered in three
// steps, each result to the variant's slot in shared memory: a probe a
// lane (most variants end there); then the resumed extensions and then
// the last level's switch occurrences, each taken by a group of lanes as
// wide as their number allows (8 lanes for up to 4, down to one lane for
// more than 16), a group taking the next as soon as its own ends.  A
// group of 8 reads each row as one coalesced line (kt::rank2<8>,
// lf_group: a walk step in one memory latency) and compares 64 letters
// of text a latency.  Ordered: the warp reads the slots in order and
// appends ties and next-level sources in lane order through ballots,
// which keeps the JAX order.
//
// kt_greedy_search_sharded runs the same body on an index split into
// shards (kt::ShardIx): K16f, kaiju_tpu/parallel/sharded_fused.py:
// make_sharded_greedy_classify (:278-390), whose rank pairs are
// _make_rank1's and whose last level's walks are _make_walk's.  Virtual
// tie rows are slots of sw_ids, never rows of a shard.
#include "text_common.cuh"

namespace {

constexpr int kWarps = 4;  // reads a block
constexpr int kMinBlocks = 8;  // an SM's blocks: 4,096 reads in one wave
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
constexpr int kWinInts = 8;   // a variant's result, see Variant
constexpr int kHistWords = kQlCap * 2 / 32;  // two bits a length

using kt::lanes_below;
using kt::warp_incl_min;
using kt::warp_incl_sum;
using kt::warp_max;

template <class Ix>
struct Args {
    const int *li, *ls0, *ls1;  // B's lanes
    const uint8_t* flat;
    const int* frag_off;
    const int* rf_rows;
    int B, S;
    Ix index;  // rank rows; with the hybrid also SA samples and text
    const int* C;
    const int *diag, *submat, *subcode, *subdiag;  // [32], [32 * 19] x 3
    int Lmap, mfl, min_score, mismatches, T, vcap;
    uint8_t* node;  // per position: 1 = node, 2 = planned (long reads)
    int* pincl;     // per position: inclusive diagonal prefix sum (long)
    int* src;       // [B, 2, vcap, kSrcInts]
    int *best, *flags, *g_s0, *g_s1;
    // the last level's hybrid: off when sw_ids is null
    const int* rank_start;
    int nseq, chpt_exp;
    int* sw_ids;  // [B, T, kSwWcap]

    __device__ const Ix& ix() const { return index; }
};

// A warp's shared memory: the read's positions in fragment order (its
// views), and the state of its level 0 and variant levels.
struct Warp {
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
    unsigned hist[kHistWords];  // lengths seen once, twice or more
    int frag[kMaxS];   // fragment rows, ascending
    int base[kMaxS];   // their starts in flat
    int len[kMaxS];    // their lengths
    int vo[kMaxS + 1];  // their starts in the views
    int exc[32];       // a source group's first variants
    int next;          // the window's next extension or occurrence
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
template <class Ix>
__device__ __forceinline__ void settle(const Args<Ix>& a, const int* pin,
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

// r[4] of a variant still to finish: the switch is to run, or the resumed
// extension (with the need of settle in the low bits)
constexpr int kPending = 1 << 30;
constexpr int kExtend = 1 << 29;

// One variant of a level on one lane: column col of source src, probed.
// A probe that finds no interval, or leaves no letter, settles r (see
// settle).  Otherwise r[1], r[2] hold the probe's interval, r[3] the
// letters left, and r[4] what is left to run: the last level's switch
// (kPending: with the hybrid, hyb, an interval of at most kSwWcap
// occurrences), or the resumed extension (kExtend | need), with r[0] the
// substituted code and its position (code | pos << 8).
template <class Ix>
__device__ __forceinline__ void probe(const Args<Ix>& a, const Warp& sm,
                                      const int* pincl_all,
                                      const uint8_t* flat_all,
                                      const int* src, int col, bool last,
                                      bool hyb, int* r) {
    const int4 e0 = reinterpret_cast<const int4*>(src)[0];
    const int4 e1 = reinterpret_cast<const int4*>(src)[1];
    const int f = e0.x, vqi = e0.y, veff = e0.z;
    const int oc = flat_all[sm.vo[f] + vqi - 1] & 31;
    const int x = oc * kNSub + col;
    const int code = __ldg(a.subcode + x);
    r[5] = e1.y + __ldg(a.subdiag + x) - __ldg(a.diag + oc);
    r[6] = e1.z + __ldg(a.submat + x) - __ldg(a.subdiag + x);
    r[7] = f | veff << 8;
    const int need = last ? a.mfl : e1.w + 1;
    // UpdateSI probe (bwt.c:160-173)
    int n0, n1;
    kt::rank2<1>(a.ix(), a.C, code, e0.w, e1.x, 0, 0, &n0, &n1);
    const int i = veff - e1.w - 1;
    if (n0 >= n1 || i <= 0) {
        settle(a, pincl_all + sm.vo[f], r, n0, n1, i, need, 0);
        return;
    }
    r[0] = code | (vqi - 1) << 8;
    r[1] = n0;
    r[2] = n1;
    r[3] = i;
    // the probe took the substitution at qi - 1 = i: with the hybrid, a
    // narrow interval finishes on the query's own letters by text
    r[4] = hyb && n1 - n0 <= kt::kSwWcap ? kPending : kExtend | need;
}

// The resumed extensions listed in first[0, ne) (bwt.c:298-336), one a
// group of G lanes, each group taking the next as soon as its own ends;
// every FM step reads its row through kt::rank2<G>, as one coalesced
// line for G = 8.  The group's first lane settles the variant.
template <int G, class Ix>
__device__ __forceinline__ void extend_groups(const Args<Ix>& a, Warp& sm,
                                              const int* pincl_all,
                                              const uint8_t* flat_all,
                                              int ne, int lane) {
    const int gl = lane & (G - 1);
    const unsigned gmask = kt::group_mask<G>(lane);
    int k = gl == 0 ? atomicAdd(&sm.next, 1) : 0;
    k = __shfl_sync(gmask, k, 0, G);
    while (k < ne) {
        int* r = sm.u.w.res[sm.u.w.first[k]];
        const int code = r[0] & 255, pos = r[0] >> 8, f = r[7] & 255;
        const uint8_t* fl = flat_all + sm.vo[f];
        int n0 = r[1], n1 = r[2], i = r[3];
        while (i > 0) {
            const int y = i - 1;
            const int c = y == pos ? code : fl[y];
            int m0, m1;
            kt::rank2<G>(a.ix(), a.C, c, n0, n1, gl, gmask, &m0, &m1);
            if (m0 >= m1) break;
            n0 = m0;
            n1 = m1;
            --i;
        }
        if (gl == 0) {
            settle(a, pincl_all + sm.vo[f], r, n0, n1, i,
                   r[4] & (kExtend - 1), 0);
            k = atomicAdd(&sm.next, 1);
        }
        k = __shfl_sync(gmask, k, 0, G);
    }
}

// The resumed extensions of a window: groups as wide as leave every
// extension a group (8 lanes for up to 4 extensions, down to one lane
// for more than 16), so that few long chains step on coalesced rows and
// many run side by side.
template <class Ix>
__device__ __forceinline__ void extend_window(const Args<Ix>& a, Warp& sm,
                                              const int* pincl_all,
                                              const uint8_t* flat_all,
                                              int wn, int lane) {
    const bool ext = lane < wn && (sm.u.w.res[lane][4] & kExtend);
    const unsigned bal = __ballot_sync(kFull, ext);
    if (bal == 0) return;
    if (ext) sm.u.w.first[__popc(bal & lanes_below(lane))] = lane;
    if (lane == 0) sm.next = 0;
    __syncwarp();
    const int ne = __popc(bal);
    if (ne > 16) extend_groups<1>(a, sm, pincl_all, flat_all, ne, lane);
    else if (ne > 8) extend_groups<2>(a, sm, pincl_all, flat_all, ne, lane);
    else if (ne > 4) extend_groups<4>(a, sm, pincl_all, flat_all, ne, lane);
    else extend_groups<8>(a, sm, pincl_all, flat_all, ne, lane);
    __syncwarp();
}

// One LF step of an SA walk by a group of G (2, 4 or 8) lanes: *c = the
// BWT letter at k and the result FMindex(*c, k) to every lane.  Lane gl
// loads the row's 16-byte groups gl, gl + G, ... of both halves, the occ
// words and the BWT bytes, so that the step costs one memory latency; the
// letter and its occ word come by shuffle from the lanes that hold them.
template <int G, class Ix>
__device__ __forceinline__ int lf_group(const Ix& ix,
                                        const int* __restrict__ C, int k,
                                        int gl, unsigned gmask, int* c) {
    const int* row = ix.row(k >> 7);
    const int off = k & 127, qb = off >> 4;
    const uint4* bw = reinterpret_cast<const uint4*>(row + 32);
    const uint4* ow = reinterpret_cast<const uint4*>(row);
    uint4 v[8 / G], o[8 / G];
#pragma unroll
    for (int t = 0; t < 8 / G; ++t) {
        const int q = gl + t * G;
        v[t] = q <= qb ? __ldg(bw + q) : make_uint4(0, 0, 0, 0);
        o[t] = __ldg(ow + q);
    }
    // the letter at off: group qb, held by lane qb % G
    uint4 g = v[0];
#pragma unroll
    for (int t = 1; t < 8 / G; ++t)
        if (t == qb / G) g = v[t];
    const int b = off & 15;
    const unsigned word = b < 4 ? g.x : b < 8 ? g.y : b < 12 ? g.z : g.w;
    const int letter = __shfl_sync(gmask, (int)(word >> ((b & 3) * 8)) & 255,
                                   qb % G, G);
    // its occ word: group letter >> 2, held by lane (letter >> 2) % G
    uint4 h = o[0];
#pragma unroll
    for (int t = 1; t < 8 / G; ++t)
        if (t == (letter >> 2) / G) h = o[t];
    const int x = letter & 3;
    const int occ = __shfl_sync(
        gmask, (int)(x == 0 ? h.x : x == 1 ? h.y : x == 2 ? h.z : h.w),
        (letter >> 2) % G, G);
    const unsigned pat = 0x01010101u * (unsigned)letter;
    int cnt = 0;
#pragma unroll
    for (int t = 0; t < 8 / G; ++t)
        cnt += kt::count_eq16(v[t], pat, off - 16 * (gl + t * G));
#pragma unroll
    for (int m = G / 2; m > 0; m >>= 1)
        cnt += __shfl_xor_sync(gmask, cnt, m, G);
    *c = letter;
    return __ldg(C + letter) + occ + cnt;
}

// kt::walk_pos by a group of G lanes (lf_group steps).
template <int G, class Ix>
__device__ __forceinline__ kt::WalkPos walk_group(const Ix& ix,
                                                  const int* __restrict__ C,
                                                  int nseq, int chpt_exp,
                                                  int k, int gl,
                                                  unsigned gmask) {
    const int check = (1 << chpt_exp) - 1;
    int steps = 0;
    while (k & check) {
        int c;
        const int kn = lf_group<G>(ix, C, k, gl, gmask, &c);
        if (c == 0) return {kn, steps};
        k = kn;
        ++steps;
    }
    int idx = (k >> chpt_exp) - ((nseq - 1) >> chpt_exp) - 1;
    idx = min(max(idx, 0), ix.nsamp - 1);
    return {ix.seq(idx), ix.off(idx) + steps};
}

// kt::text_extend by a group of G lanes: lane gl compares letters gl * 8
// .. + 8 of each round of 8 G, so that a round costs one memory latency;
// the first stop is the group's least.
template <int G, class Ix>
__device__ __forceinline__ int text_extend_group(
    const Ix& ix, const uint8_t* __restrict__ flat, int p, int qg, int avail,
    int gl, unsigned gmask) {
    constexpr int kC = 8;
    const int lim = min(avail, p);
    for (int u = 0; u < lim; u += kC * G) {
        const int base = u + gl * kC;
        int t[kC], q[kC];
#pragma unroll
        for (int k = 0; k < kC; ++k) {
            const bool in = base + k < lim;
            t[k] = in ? ix.letter(p - 1 - base - k) : 0;
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

// The window's switch occurrences numbered in first[], taken a group of G
// (2, 4 or 8) lanes each, each group taking the next as soon as its own
// ends: walked to its text start and compared backwards from its
// variant's query position, its reach and id to the slots.
template <int G, class Ix>
__device__ __forceinline__ void switch_groups(const Args<Ix>& a, Warp& sm,
                                              int total, int* ids,
                                              int lane) {
    const int gl = lane & (G - 1);
    const unsigned gmask = kt::group_mask<G>(lane);
    int o = gl == 0 ? atomicAdd(&sm.next, 1) : 0;
    o = __shfl_sync(gmask, o, 0, G);
    while (o < total) {
        int t = 0;  // the last slot whose first occurrence is at or before o
        for (int step = 16; step > 0; step >>= 1)
            if (sm.u.w.first[t + step] <= o) t += step;
        const int q = o - sm.u.w.first[t];
        const int* rt = sm.u.w.res[t];
        const kt::WalkPos w = walk_group<G>(a.ix(), a.C, a.nseq, a.chpt_exp,
                                            rt[1] + q, gl, gmask);
        const int p =
            __ldg(a.rank_start + min(max(w.iseq, 0), a.nseq - 1)) + w.pos;
        const int avail = rt[3];
        const int e = text_extend_group<G>(a.ix(), a.flat, p,
                                           sm.base[rt[7] & 255] + avail,
                                           avail, gl, gmask);
        if (gl == 0) {
            sm.u.w.ext[t][q] = e;
            ids[t * kt::kSwWcap + q] = w.iseq;
            o = atomicAdd(&sm.next, 1);
        }
        o = __shfl_sync(gmask, o, 0, G);
    }
}

// The pending switches of a window (text_common.cuh's switch_serial with
// its occurrences spread over the lanes): every lane takes the next
// occurrence of any pending variant as soon as its own ends, walks it to
// its text start and compares backwards from the variant's query
// position; then the lane of each pending slot keeps the occurrences that
// reach the longest extension, their ids in SA order at ids + slot *
// kSwWcap, and settles the variant.
template <class Ix>
__device__ __forceinline__ void switch_window(const Args<Ix>& a, Warp& sm,
                                              const int* pincl_all, int wn,
                                              int* ids, int lane) {
    int* r = sm.u.w.res[lane];
    const bool pend = lane < wn && r[4] == kPending;
    if (__ballot_sync(kFull, pend) == 0) return;
    const int n = pend ? r[2] - r[1] : 0;
    const int inc = warp_incl_sum(n, lane);
    const int total = __shfl_sync(kFull, inc, 31);
    sm.u.w.first[lane] = inc - n;
    if (lane == 0) sm.next = 0;
    __syncwarp();
    // few occurrences: a group each, whose steps and compares read whole
    // lines; many: a lane each
    if (total <= 4) switch_groups<8>(a, sm, total, ids, lane);
    else if (total <= 8) switch_groups<4>(a, sm, total, ids, lane);
    else if (total <= 16) switch_groups<2>(a, sm, total, ids, lane);
    else for (int o = atomicAdd(&sm.next, 1); o < total;
              o = atomicAdd(&sm.next, 1)) {
        int t = 0;  // the last slot whose first occurrence is at or before o
        for (int step = 16; step > 0; step >>= 1)
            if (sm.u.w.first[t + step] <= o) t += step;
        const int q = o - sm.u.w.first[t];
        const int* rt = sm.u.w.res[t];
        const kt::WalkPos w = kt::walk_pos<true>(a.ix(), a.C, a.nseq,
                                                 a.chpt_exp, rt[1] + q);
        const int p =
            __ldg(a.rank_start + min(max(w.iseq, 0), a.nseq - 1)) + w.pos;
        const int avail = rt[3];
        sm.u.w.ext[t][q] = kt::text_extend(a.ix(), a.flat, p,
                                           sm.base[rt[7] & 255] + avail,
                                           avail);
        ids[t * kt::kSwWcap + q] = w.iseq;
    }
    __syncwarp();
    if (pend) {
        int best = 0, nid = 0;
        for (int q = 0; q < n; ++q) best = max(best, sm.u.w.ext[lane][q]);
        for (int q = 0; q < n; ++q)  // in place: nid <= q
            if (sm.u.w.ext[lane][q] == best)
                ids[lane * kt::kSwWcap + nid++] = ids[lane * kt::kSwWcap + q];
        settle(a, pincl_all + sm.vo[r[7] & 255], r, r[1], r[2], r[3] - best,
               a.mfl, nid);
    }
    __syncwarp();
}

template <class Ix>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
greedy_search_kernel(Args<Ix> a) {
    __shared__ Warp s_warp[kWarps];
    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarps + w;
    if (b >= a.B) return;  // whole warps leave together
    Warp& sm = s_warp[w];
    const int j0 = a.Lmap - 1;

    // ---- the read's fragment rows, ascending, and their views -------------
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
    const int total = __shfl_sync(kFull, incl, 31);
    const bool staged = total <= kLcap;
    if (lane < nfr) {
        sm.base[lane] = base;
        sm.len[lane] = flen;
        sm.vo[lane] = staged ? incl - flen : base;
    }
    __syncwarp();
    // a view: a fragment's positions at all + vo[f]
    const int* li_all = staged ? sm.u.li : a.li;
    int* pincl_all = staged ? sm.pincl : a.pincl;
    uint8_t* node_all = staged ? sm.node : a.node;
    const uint8_t* flat_all = staged ? sm.flat : a.flat;
    if (staged) {  // copy i and the codes, kU loads a lane in flight
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


    // ---- per fragment: diagonal prefix sums, then nodes -------------------
    for (int k = 0; k < nfr; ++k) {
        const int vo = sm.vo[k], n = sm.len[k];
        const int* li = li_all + vo;
        const uint8_t* fl = flat_all + vo;
        int* pincl = pincl_all + vo;
        uint8_t* node = node_all + vo;
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


    // ---- level 0: node events and level-1 sources, in node order ----------
    Ties ties{0, 0, a.T, a.g_s0 + (size_t)b * a.T, a.g_s1 + (size_t)b * a.T,
              a.sw_ids ? a.sw_ids + (size_t)b * a.T * kt::kSwWcap : nullptr,
              b * a.T * kt::kSwWcap};
    int* X = a.src + (size_t)b * 2 * a.vcap * kSrcInts;  // this level's
    int* Xn = X + (size_t)a.vcap * kSrcInts;             // the next level's
    int nsrc = 0;
    for (int strip = 1; strip >= 0; --strip) {
        for (int k = 0; k < nfr; ++k) {
            const int vo = sm.vo[k], n = sm.len[k], gb = sm.base[k];
            const int* li = li_all + vo;
            const int* pincl = pincl_all + vo;
            const uint8_t* node = node_all + vo;
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
    bool over = a.mismatches > 0 && nsrc > a.vcap;
    __syncwarp();  // level 0's i (u.li) gives way to the windows (u.w)

    // ---- variant levels ----------------------------------------------------
    for (int level = 1; level <= a.mismatches && !over; ++level) {
        const bool last = level == a.mismatches;
        const bool hyb = last && a.sw_ids != nullptr;
        const int thr = max(ties.best, a.min_score);
        int nnext = 0;
        for (int g0 = 0; g0 < nsrc; g0 += 32) {
            // a source a lane, and how many of its substitutions are kept
            // (a prefix: the columns descend in score)
            const int s = g0 + lane;
            int nk = 0;
            if (s < nsrc) {
                const int* e = X + (size_t)s * kSrcInts;
                const int f = e[0], qi = e[1], effL = e[2];
                if (qi > 0 && effL >= a.mfl) {
                    const int vo = sm.vo[f];
                    const int oc = flat_all[vo + qi - 1] & 31;
                    const int basev =
                        max(pref(pincl_all + vo, effL) + e[5] + e[6], 0) -
                        __ldg(a.diag + oc);
                    for (int c = 0; c < kNSub; ++c)
                        nk += basev + __ldg(a.submat + oc * kNSub + c) >= thr;
                }
            }
            const int inc = warp_incl_sum(nk, lane);
            sm.exc[lane] = inc - nk;
            const int total_v = __shfl_sync(kFull, inc, 31);
            __syncwarp();
            // with the hybrid a window's ids go to the next level's
            // source slots, unused on the last level: vcap x 8 ints
            const int win = hyb ? min(kWin, a.vcap) : kWin;
            for (int w0 = 0; w0 < total_v; w0 += win) {
                const int wn = min(win, total_v - w0);
                // unordered: a probe a lane (variant v belongs to the last
                // source whose first variant is at or before v), then the
                // extensions, a group of lanes each, then the switches,
                // an occurrence a lane
                if (lane < wn) {
                    const int v = w0 + lane;
                    int sl = 0;
                    for (int step = 16; step > 0; step >>= 1)
                        if (sm.exc[sl + step] <= v) sl += step;
                    probe(a, sm, pincl_all, flat_all,
                          X + (size_t)(g0 + sl) * kSrcInts, v - sm.exc[sl],
                          last, hyb, sm.u.w.res[lane]);
                }
                __syncwarp();
                extend_window(a, sm, pincl_all, flat_all, wn, lane);
                if (hyb) switch_window(a, sm, pincl_all, wn, Xn, lane);
                // ordered: ties and next-level sources in variant order
                int r[kWinInts] = {0, 0, 0, 0, 0, 0, 0, 0};
                if (lane < wn)
                    for (int q = 0; q < kWinInts; ++q)
                        r[q] = sm.u.w.res[lane][q];
                const bool has_si = r[4] & 1, ev = (r[4] >> 1) & 1;
                ties.add(ev, r[0], r[1], r[2], lane,
                         Xn + lane * kt::kSwWcap, r[4] >> 2);
                if (!last)
                    nnext = push_src(Xn, nnext, a.vcap, has_si, lane,
                                     r[7] & 255, r[3], r[7] >> 8, r[1], r[2],
                                     r[5], r[6], (r[7] >> 8) - r[3]);
                __syncwarp();
            }
        }
        if (last) break;
        over = nnext > a.vcap;
        int* t = X;
        X = Xn;
        Xn = t;
        nsrc = nnext;
        __syncwarp();  // the next level reads what other lanes wrote
    }

    // ---- the read's row ------------------------------------------------------
    __syncwarp();
    const int kept = over ? 0 : min(ties.cnt, a.T);
    // id slots: a kept virtual row's ids, zeros elsewhere (a tie that a
    // later best replaced may have left ids behind)
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

template <class Ix>
int launch(const Args<Ix>& a, cudaStream_t stream) {
    const int blocks = (a.B + kWarps - 1) / kWarps;
    greedy_search_kernel<<<blocks, kWarps * 32, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

KT_EXPORT int kt_greedy_search(
    const int* li, const int* ls0, const int* ls1, const uint8_t* flat,
    const int* frag_off, int F, const int* rf_rows, int B, int S,
    const int* rec, int nb1, const int* C, const int* diag, const int* submat,
    const int* subcode, const int* subdiag, int Lmap, int mfl, int min_score,
    int mismatches, int T, int vcap, uint8_t* node, int* pincl, int* src,
    int* best, int* flags, int* g_s0, int* g_s1, const uint8_t* text,
    const int* rank_start, const int* sa_seq, const int* sa_off, int nsamp,
    int nseq, int chpt_exp, int* sw_ids, cudaStream_t stream) {
    (void)F;  // the slot table names the fragment rows
    return launch(
        Args<kt::FlatIx>{li, ls0, ls1, flat, frag_off, rf_rows, B, S,
                         kt::FlatIx{rec, nb1, sa_seq, sa_off, nsamp, text},
                         C, diag, submat, subcode, subdiag, Lmap, mfl,
                         min_score, mismatches, T, vcap, node, pincl, src,
                         best, flags, g_s0, g_s1, rank_start, nseq, chpt_exp,
                         sw_ids},
        stream);
}

KT_EXPORT int kt_greedy_search_sharded(
    const int* li, const int* ls0, const int* ls1, const uint8_t* flat,
    const int* frag_off, int F, const int* rf_rows, int B, int S,
    KT_SHARD_PARAMS, const int* C, const int* diag, const int* submat,
    const int* subcode, const int* subdiag, int Lmap, int mfl, int min_score,
    int mismatches, int T, int vcap, uint8_t* node, int* pincl, int* src,
    int* best, int* flags, int* g_s0, int* g_s1, const int* rank_start,
    int nseq, int chpt_exp, int* sw_ids, cudaStream_t stream) {
    (void)F;
    return launch(
        Args<kt::ShardIx>{li, ls0, ls1, flat, frag_off, rf_rows, B, S,
                          KT_SHARD_IX, C, diag, submat, subcode, subdiag,
                          Lmap, mfl, min_score, mismatches, T, vcap, node,
                          pincl, src, best, flags, g_s0, g_s1, rank_start,
                          nseq, chpt_exp, sw_ids},
        stream);
}
