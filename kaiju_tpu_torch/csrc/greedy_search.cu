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
// once; device-memory bytes at 3.35 TB/s.
// Design: one warp per read.  The JAX program is level-synchronous over
// the batch only because XLA needs static shapes; its pruning bound is per
// read, so a read run on its own explores the same set.  The 32 lanes share
// out a read's positions (prefix sums, the node scan as a warp prefix
// minimum) and its variants (a warp prefix sum over the sources' kept
// counts, then one variant a lane); each lane runs its own data-dependent
// extension loop.  Ties and next-level sources are appended in lane order
// through ballots, which keeps the JAX order.  Per position, node flags and
// diagonal prefix sums live in scratch the wrapper allocates; the length
// histogram of the planned-node rule lives in shared memory.
//
// kt_greedy_search_sharded runs the same body on an index split into
// shards (kt::ShardIx): K16f, kaiju_tpu/parallel/sharded_fused.py:
// make_sharded_greedy_classify (:278-390), whose rank pairs are
// _make_rank1's and whose last level's walks are _make_walk's.  Virtual
// tie rows are slots of sw_ids, never rows of a shard.
#include "text_common.cuh"

namespace {

constexpr int kWarps = 4;  // reads a block
constexpr unsigned kFull = kt::kFullMask;
constexpr int kBig = 0x3fffffff;
constexpr int kStrip = 4;     // the JAX funnel's strip width W
constexpr int kQlCap = 512;   // planned-node groups clamp lengths below
constexpr int kNSub = 19;     // substitutions a position
constexpr int kMaxS = 32;     // slots a read
constexpr int kSrcInts = 8;   // fid qi effL s0 s1 delta diffc ml
constexpr int kFlagTieOver = 1;
constexpr int kFlagScratch = 4;

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
    uint8_t* node;  // per position: 1 = node, 2 = planned
    int* pincl;     // per position: inclusive diagonal prefix sum
    int* src;       // [B, 2, vcap, kSrcInts]
    int *best, *flags, *g_s0, *g_s1;
    // the last level's hybrid: off when sw_ids is null
    const int* rank_start;
    int nseq, chpt_exp;
    int* sw_ids;  // [B, T, kSwWcap]

    __device__ const Ix& ix() const { return index; }
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

// Diagonal sum over the first x codes of the fragment at base.
template <class A>
__device__ __forceinline__ int pref(const A& a, int base, int x) {
    return x > 0 ? a.pincl[base + x - 1] : 0;
}

// Appends a source in lane order; returns the new count (may pass vcap:
// the caller flags the read, nothing past vcap is written).
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

template <class Ix>
__global__ void greedy_search_kernel(Args<Ix> a) {
    __shared__ int s_hist[kWarps][kQlCap];
    __shared__ int s_frag[kWarps][kMaxS];
    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarps + w;
    if (b >= a.B) return;  // whole warps leave together
    int* hist = s_hist[w];
    int* frags = s_frag[w];
    const int j0 = a.Lmap - 1;

    // ---- the read's fragment rows, ascending -------------------------------
    const int* rf = a.rf_rows + (size_t)b * a.S;
    const int mine = lane < a.S ? rf[lane] : -1;
    int below = 0;
    for (int t = 0; t < a.S; ++t) {
        const int o = __shfl_sync(kFull, mine, t);
        below += o >= 0 && (o < mine || (o == mine && t < lane));
    }
    const int nfr = __popc(__ballot_sync(kFull, mine >= 0));
    if (mine >= 0) frags[below] = mine;
    __syncwarp();

    // ---- per fragment: diagonal prefix sums, then nodes -------------------
    for (int k = 0; k < nfr; ++k) {
        const int f = frags[k];
        const int base = a.frag_off[f];
        const int flen = a.frag_off[f + 1] - base;
        int carry = 0;
        for (int x0 = 0; x0 < flen; x0 += 32) {
            const int x = x0 + lane;
            const int d = x < flen ? a.diag[a.flat[base + x] & 31] : 0;
            const int inc = warp_incl_sum(d, lane) + carry;
            if (x < flen) a.pincl[base + x] = inc;
            carry = __shfl_sync(kFull, inc, 31);
        }
        int js = -1;
        for (int x0 = j0; x0 < flen; x0 += 32) {
            const int j = x0 + lane;
            if (j < flen && a.li[base + j] <= 1) js = max(js, j);
        }
        js = warp_max(js);
        for (int q = lane; q < kQlCap; q += 32) hist[q] = 0;
        __syncwarp();
        // scanning j downward, 32 positions a step: a node's i is below the
        // minimum over the eligible positions above it
        int above = kBig;
        for (int hi = flen - 1; hi >= j0; hi -= 32) {
            const int j = hi - lane;
            const bool in = j >= j0;
            const int ii = in ? a.li[base + j] : 0;
            const bool elig = in && j >= js && j - ii + 1 >= a.Lmap;
            const int inc = warp_incl_min(elig ? ii : kBig, lane);
            int exc = __shfl_up_sync(kFull, inc, 1);
            if (lane == 0) exc = kBig;
            const bool ins = elig && ii < min(above, exc);
            if (in) a.node[base + j] = ins;
            if (ins) atomicAdd(&hist[min(j - ii + 1, kQlCap - 1)], 1);
            above = min(above, __shfl_sync(kFull, inc, 31));
        }
        __syncwarp();
        // planned: lengths at least the longest with two or more nodes
        int qt = -1;
        for (int x0 = j0; x0 < flen; x0 += 32) {
            const int j = x0 + lane;
            if (j < flen && a.node[base + j]) {
                const int ql = j - a.li[base + j] + 1;
                if (hist[min(ql, kQlCap - 1)] >= 2) qt = max(qt, ql);
            }
        }
        qt = warp_max(qt);
        for (int x0 = j0; x0 < flen; x0 += 32) {
            const int j = x0 + lane;
            if (j < flen && a.node[base + j] &&
                j - a.li[base + j] + 1 >= qt)
                a.node[base + j] = 3;
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
            const int f = frags[k];
            const int base = a.frag_off[f];
            const int flen = a.frag_off[f + 1] - base;
            const int lo = strip ? max(flen - kStrip, j0) : j0;
            const int hi = strip ? flen : flen - kStrip;
            for (int x0 = lo; x0 < hi; x0 += 32) {
                const int j = x0 + lane;
                const int fl = j < hi ? a.node[base + j] : 0;
                int qi = 0, s0 = 0, s1 = 0, score = 0;
                bool ev = false;
                if (fl & 1) {
                    qi = a.li[base + j];
                    s0 = a.ls0[base + j];
                    s1 = a.ls1[base + j];
                    score = max(pref(a, base, j + 1) - pref(a, base, qi), 0);
                    ev = j - qi + 1 >= a.mfl && score >= a.min_score;
                }
                ties.add(ev, score, s0, s1, lane);
                if (a.mismatches > 0)
                    nsrc = push_src(X, nsrc, a.vcap,
                                    (fl & 2) && qi > 0 && j + 1 >= a.mfl,
                                    lane, f, qi, j + 1, s0, s1, 0, 0,
                                    j - qi + 1);
            }
        }
    }
    bool over = a.mismatches > 0 && nsrc > a.vcap;

    // ---- variant levels ----------------------------------------------------
    for (int level = 1; level <= a.mismatches && !over; ++level) {
        const bool last = level == a.mismatches;
        const int thr = max(ties.best, a.min_score);
        int nnext = 0;
        for (int g0 = 0; g0 < nsrc; g0 += 32) {
            // a source a lane, and how many of its substitutions are kept
            // (a prefix: the columns descend in score)
            const int s = g0 + lane;
            int f = 0, qi = 0, effL = 0, s0 = 0, s1 = 0, delta = 0, diffc = 0;
            int ml = 0, base = 0, oc = 0, nk = 0;
            if (s < nsrc) {
                const int* e = X + (size_t)s * kSrcInts;
                f = e[0];
                qi = e[1];
                effL = e[2];
                s0 = e[3];
                s1 = e[4];
                delta = e[5];
                diffc = e[6];
                ml = e[7];
                base = a.frag_off[f];
                if (qi > 0 && effL >= a.mfl) {
                    oc = a.flat[base + qi - 1] & 31;
                    const int basev =
                        max(pref(a, base, effL) + delta + diffc, 0) -
                        a.diag[oc];
                    for (int c = 0; c < kNSub; ++c)
                        nk += basev + a.submat[oc * kNSub + c] >= thr;
                }
            }
            const int inc = warp_incl_sum(nk, lane);
            const int exc = inc - nk;
            const int total = __shfl_sync(kFull, inc, 31);
            for (int v0 = 0; v0 < total; v0 += 32) {
                // variant v of this group: the last lane whose first
                // variant is at or before v owns it
                const int v = v0 + lane;
                int sl = 0;
                for (int step = 16; step > 0; step >>= 1)
                    if (__shfl_sync(kFull, exc, sl + step) <= v) sl += step;
                const int col = v - __shfl_sync(kFull, exc, sl);
                const int vf = __shfl_sync(kFull, f, sl);
                const int vqi = __shfl_sync(kFull, qi, sl);
                const int veff = __shfl_sync(kFull, effL, sl);
                const int vs0 = __shfl_sync(kFull, s0, sl);
                const int vs1 = __shfl_sync(kFull, s1, sl);
                const int vdel = __shfl_sync(kFull, delta, sl);
                const int vdif = __shfl_sync(kFull, diffc, sl);
                const int vml = __shfl_sync(kFull, ml, sl);
                const int vbase = __shfl_sync(kFull, base, sl);
                const int voc = __shfl_sync(kFull, oc, sl);
                bool has_si = false, ev = false;
                int score = 0, i = 0, n0 = 0, n1 = 0, ndel = 0, ndif = 0;
                int ids[kt::kSwWcap], nid = 0;
                if (v < total) {
                    const int e = voc * kNSub + col;
                    const int code = a.subcode[e];
                    ndif = vdif + a.submat[e] - a.subdiag[e];
                    ndel = vdel + a.subdiag[e] - a.diag[voc];
                    const int ml1 = vml + 1;
                    // UpdateSI probe (bwt.c:160-173), then the resumed
                    // extension with code at the substituted position
                    n0 = kt::rank(a.ix(), a.C, code, vs0);
                    n1 = kt::rank(a.ix(), a.C, code, vs1);
                    i = veff - ml1;
                    if (n0 < n1 && last && a.sw_ids != nullptr &&
                        n1 - n0 <= kt::kSwWcap && i > 0) {
                        // the probe took the substitution at qi - 1 = i:
                        // the letters left are the query's own
                        i -= kt::switch_serial(
                            a.ix(), a.C, a.nseq, a.chpt_exp, a.rank_start,
                            a.flat, n0, n1, vbase + i, i, ids, &nid);
                    } else if (n0 < n1) {
                        const int pos = vqi - 1;
                        while (i > 0) {
                            const int x = i - 1;
                            const int c = x == pos ? code : a.flat[vbase + x];
                            const int m0 = kt::rank(a.ix(), a.C, c, n0);
                            const int m1 = kt::rank(a.ix(), a.C, c, n1);
                            if (m0 >= m1) break;
                            n0 = m0;
                            n1 = m1;
                            --i;
                        }
                    }
                    if (n0 < n1) {
                        const int mlen = veff - i;
                        has_si = mlen >= (last ? a.mfl : ml1);
                        if (has_si) {
                            score = max(pref(a, vbase, veff) -
                                            pref(a, vbase, i) + ndel + ndif,
                                        0);
                            ev = mlen >= a.mfl && score >= a.min_score;
                        }
                    }
                }
                ties.add(ev, score, n0, n1, lane, ids, nid);
                if (!last)
                    nnext = push_src(Xn, nnext, a.vcap, has_si, lane, vf, i,
                                     veff, n0, n1, ndel, ndif, veff - i);
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
