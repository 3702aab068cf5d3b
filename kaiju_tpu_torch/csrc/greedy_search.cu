// Kernel E: the Greedy search of each read, from kernel B's lanes to the
// read's best score, its flags and the SA ranges of its first T ties.
//
// Replaces kaiju_tpu/ops/fused_greedy.py:greedy_core (K13: the inserted-
// and planned-node rules, node scores, the variant levels with the 19-way
// BLOSUM62 fan-out and the UpdateSI probe, the tie rows) and
// _extend_two_stage (K14: the resumed extension of the substituted
// variants), with the rank of K1, and the last level's text-compare
// hybrid (K8: _switch_pool with _text_extend and K4's _walk_pos, called at
// fused_greedy.py:488-505; kt::walk_group and kt::text_extend_group of
// text_common.cuh, shared with kernel G).  The search funnel before it is
// kernel B; the tail after it (SA walks, capped ids, LCA) is kernel F.
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
// E's shared parts (the arguments, the warp's shared memory, the tie
// list, level 0, push_src, settle, the read's row) are greedy_common.cuh's,
// which kernel U (greedy_levels.cu) runs level by level.
#include "greedy_common.cuh"

namespace {

using namespace kg;

constexpr int kWarps = 4;  // reads a block
constexpr int kMinBlocks = 8;  // an SM's blocks: 4,096 reads in one wave

template <class Ix>
struct Args : Params {
    Ix index;  // rank rows; with the hybrid also SA samples and text
    const int* C;
    // the last level's hybrid: off when sw_ids is null
    const int* rank_start;
    int nseq, chpt_exp;
    int* sw_ids;  // [B, T, kSwWcap]

    __device__ const Ix& ix() const { return index; }
};

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

// The window's switch occurrences numbered in first[], taken a group of G
// (1, 2, 4 or 8) lanes each, each group taking the next as soon as its own
// ends: walked to its text start (kt::walk_group) and compared backwards
// from its variant's query position (kt::text_extend_group), its reach
// and id to the slots.
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
        const kt::WalkPos w = kt::walk_group<G>(
            a.ix(), a.C, a.nseq, a.chpt_exp, rt[1] + q, gl, gmask);
        const int p =
            __ldg(a.rank_start + min(max(w.iseq, 0), a.nseq - 1)) + w.pos;
        const int avail = rt[3];
        const int e = kt::text_extend_group<G>(
            a.ix(), a.flat, p, sm.base[rt[7] & 255] + avail, avail, gl,
            gmask);
        if (gl == 0) {
            sm.u.w.ext[t][q] = e;
            ids[t * kt::kSwWcap + q] = w.iseq;
            o = atomicAdd(&sm.next, 1);
        }
        o = __shfl_sync(gmask, o, 0, G);
    }
}

// The pending switches of a window, their occurrences spread over the
// lanes: every group takes the next occurrence of any pending variant as
// soon as its own ends, walks it to its text start and compares backwards
// from the variant's query position; then the lane of each pending slot
// keeps the occurrences that reach the longest extension, their ids in SA
// order at ids + slot * kSwWcap, and settles the variant.
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
    else switch_groups<1>(a, sm, total, ids, lane);
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

    // ---- level 0 (greedy_common.cuh): a read that fits in shared memory
    // runs it there, a longer one on global scratch ------------------------
    bool staged;
    int total;
    const int nfr = read_views(a, sm, b, lane, true, &staged, &total);
    const Views views = staged ? Views{sm.u.li, sm.pincl, sm.node, sm.flat}
                               : Views{a.li, a.pincl, a.node, a.flat};
    if (staged) stage_read(a, sm, nfr, total, lane);
    int* pincl_all = views.pincl;
    const uint8_t* flat_all = views.flat;
    level0_nodes(a, sm, views, nfr, lane);
    Ties ties{0, 0, a.T, a.g_s0 + (size_t)b * a.T, a.g_s1 + (size_t)b * a.T,
              a.sw_ids ? a.sw_ids + (size_t)b * a.T * kt::kSwWcap : nullptr,
              b * a.T * kt::kSwWcap};
    int* X = a.src + (size_t)b * 2 * a.vcap * kSrcInts;  // this level's
    int* Xn = X + (size_t)a.vcap * kSrcInts;             // the next level's
    int nsrc = level0_events(a, sm, views, nfr, ties, X, lane);
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

    // ---- the read's row ------------------------------------------------
    finish_read(a, ties, over, b, lane);
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
        Args<kt::FlatIx>{{li, ls0, ls1, flat, frag_off, rf_rows, B, S, diag,
                          submat, subcode, subdiag, Lmap, mfl, min_score,
                          mismatches, T, vcap, node, pincl, src, best, flags,
                          g_s0, g_s1},
                         kt::FlatIx{rec, nb1, sa_seq, sa_off, nsamp, text},
                         C, rank_start, nseq, chpt_exp, sw_ids},
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
        Args<kt::ShardIx>{{li, ls0, ls1, flat, frag_off, rf_rows, B, S,
                           diag, submat, subcode, subdiag, Lmap, mfl,
                           min_score, mismatches, T, vcap, node, pincl, src,
                           best, flags, g_s0, g_s1},
                          KT_SHARD_IX, C, rank_start, nseq, chpt_exp, sw_ids},
        stream);
}
