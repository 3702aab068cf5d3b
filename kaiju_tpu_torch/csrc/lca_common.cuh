// The per-read classification tail shared by kernels D (read_lca) and F
// (ranges_lca): range expansion, SA walks, the capped id set and the LCA.
//
// Replaces the second half of kaiju_tpu/ops/fused_classify.py:ranges_lca
// (K11) with the SA walk _sa_walk_local (K4) under it:
//   * the first R SA positions of the read's ranges, in range order;
//   * one SA walk per position to its sequence, seq_tax to its taxon; with
//     sw_ids (the text-compare hybrid's virtual rows, text_common.cuh) a
//     position k >= kVBase takes its sequence from sw_ids[k - kVBase]
//     instead (fused_classify.py:192-227); without, every position is
//     walked;
//   * the capped unique set: a taxon is kept when it is new and fewer than
//     cap + 1 new taxa came before it (ConsumerThread.cpp:799-845);
//   * the LCA (util.cpp:194-263): one kept taxon is returned as it is;
//     otherwise taxa absent from the tree (depth 0) are dropped, the rest
//     lifted to the shallowest depth and climbed in lock step.
// need_more: the R positions ran out before the id cap (total > R and at
// most cap unique taxa among them).  cut: the id cap may have cut the
// read's taxa (more than cap + 1 unique among the R positions, or cap + 1
// and positions past R), so that the kept set depends on the order of the
// ranges; n_ranges: the ranges that contribute.
//
// Bound: a chain of dependent loads, not bytes.  An SA walk's LF steps
// follow one another, and a walk ends only at a sampled SA slot (one in
// 2^chpt_exp, so the longest of a batch's walks takes tens of steps); the
// lift and the climb follow parent links, 20-40 of them on NCBI's tree.
// Design: one warp per read, every stage spread over the lanes, none on
// one lane while the others wait.
//   1. Ranges 32 at a time: a warp prefix sum of their sizes (each
//      counted up to R + 1, so that the sum cannot pass 2^31) gives each
//      its offset; the nonempty ones are written out in turn by the whole
//      warp, up to R positions, into shared memory (list_positions).
//   2. Positions 32 at a time: each walked by a group of G lanes, G = 8,
//      4 or 2 for at most 4, 8 or 16 positions (kt::lf_group: a step in
//      one memory latency), one lane a position past 16 (kt::rank1's
//      loads, four at a time); its taxon from seq_tax.  Groups for every
//      chunk, past 16 positions in two passes, took 1.2x longer on reads
//      of 32 positions, and a lane a position for every chunk 2.3x longer
//      (PERF.md, PR 11).
//   3. The capped set by warp intrinsics: __match_any_sync finds each
//      taxon's first lane in the chunk, a scan of the list of unique taxa
//      so far (shared memory) drops the ones earlier chunks saw, a ballot
//      numbers the new ones.  n_uniq matters only up to cap + 2 (need_more
//      and cut), so the list holds at most that many, and positions after
//      the chunk that reaches it are not walked.
//   4. The LCA a kept taxon a lane (several past 32): their depths loaded
//      together, the shallowest by a warp minimum, each taxon lifted on
//      its own lane, then every lane climbs one parent a step until
//      __all_sync finds them all equal to the first present taxon.  The
//      chain is the longest lift plus the climb, where a single lane
//      would take the sum of the lifts plus the climb times the taxa.
#pragma once

#include "text_common.cuh"

namespace kt {

struct LcaResult {
    int lca, n_ids, need_more, cut, n_ranges;
};

// The ints of a warp's shared memory that ranges_lca_warp takes for R
// positions: the positions (later the kept taxa's depths) and the list of
// unique taxa (at most min(R, cap + 2)).
__host__ __device__ constexpr int lca_warp_ints(int R) { return 2 * R; }

// Whether position k is a virtual row of the hybrid (sw_ids given, k >=
// kVBase), and its sequence id, sw_ids[k - kVBase], which stands in for
// its SA walk.  Kernels D and F read it in walk_taxon, kernels W and V in
// their list forms, which send only the other positions to kernel Q.
__device__ __forceinline__ bool is_virtual(int k, const int* sw_ids) {
    return sw_ids != nullptr && k >= kVBase;
}
__device__ __forceinline__ int virtual_id(int k, const int* sw_ids,
                                          int nsw) {
    return __ldg(sw_ids + min(k - kVBase, nsw - 1));
}

// A listed position's sequence where the list form knows it: its virtual
// row's id, else -1 (kernel Q walks it).
__device__ __forceinline__ int listed_id(int k, const int* sw_ids, int nsw) {
    return is_virtual(k, sw_ids) ? virtual_id(k, sw_ids, nsw) : -1;
}

// The taxon of position pos[lane / G] (m positions, m * G <= 32) in every
// lane of its group of G; 0 in lanes past the m groups.
template <int G, class Ix>
__device__ __forceinline__ int walk_taxon(
    const int* pos, int m, int lane, const Ix& ix,
    const int* __restrict__ C, const int* __restrict__ seq_tax, int ntax,
    int nseq, int chpt_exp, const int* __restrict__ sw_ids, int nsw) {
    const int r = lane / G;
    if (r >= m) return 0;  // whole groups
    const int k = pos[r];
    const int iseq =
        is_virtual(k, sw_ids)
            ? virtual_id(k, sw_ids, nsw)
            : sa_walk<G>(ix, C, nseq, chpt_exp, k, lane & (G - 1),
                         group_mask<G>(lane));
    return __ldg(seq_tax + min(max(iseq, 0), ntax - 1));
}

// Step 1, whole warp: the first R positions of the ranges, in range
// order, into pos (shared memory).  range(g, &start, &size) gives range g
// of G (size <= 0: not contributing), from any lane.  *total: the
// positions of all the ranges, each range counted up to R + 1 (only
// min(total, R) and total > R matter, so this is exact where it counts
// and never overflows: S x T = 128 intervals near 2^31 would pass an
// int32 sum); *n_ranges: the ranges that contribute.
template <class Range>
__device__ __forceinline__ void list_positions(const Range& range, int G,
                                               int* pos, int R, int* total,
                                               int* n_ranges) {
    const int lane = threadIdx.x & 31;
    int tot = 0, nr = 0;
    for (int g0 = 0; g0 < G; g0 += 32) {
        int a = 0, size = 0;
        if (g0 + lane < G) range(g0 + lane, a, size);
        size = min(max(size, 0), R + 1);
        const int inc = warp_incl_sum(size, lane);
        const unsigned live = __ballot_sync(kFullMask, size > 0);
        for (unsigned w = live; w != 0; w &= w - 1) {
            const int src = __ffs(w) - 1;
            const int ra = __shfl_sync(kFullMask, a, src);
            const int rs = __shfl_sync(kFullMask, size, src);
            const int ro = tot + __shfl_sync(kFullMask, inc - size, src);
            if (ro >= R) break;
            for (int x = lane; x < rs && ro + x < R; x += 32)
                pos[ro + x] = ra + x;
        }
        tot += __shfl_sync(kFullMask, inc, 31);
        nr += __popc(live);
    }
    *total = tot;
    *n_ranges = nr;
    __syncwarp();  // every lane's positions are visible to the warp
}

// The taxa of the listed positions by SA walks: taxon of position r0 +
// lane (of m from r0) in every lane, groups of gs lanes a walk.
template <class Ix>
struct WalkTaxa {
    const int* pos;
    const Ix& ix;
    const int* C;
    const int* seq_tax;
    int ntax, nseq, chpt_exp;
    const int* sw_ids;
    int nsw;

    __device__ __forceinline__ int operator()(int r0, int m, int lane) const {
        const int* p = pos + r0;
        const int gs = m <= 4 ? 8 : m <= 8 ? 4 : m <= 16 ? 2 : 1;
        int t;  // the taxon of position r0 + lane / gs
        if (gs == 8)
            t = walk_taxon<8>(p, m, lane, ix, C, seq_tax, ntax, nseq,
                              chpt_exp, sw_ids, nsw);
        else if (gs == 4)
            t = walk_taxon<4>(p, m, lane, ix, C, seq_tax, ntax, nseq,
                              chpt_exp, sw_ids, nsw);
        else if (gs == 2)
            t = walk_taxon<2>(p, m, lane, ix, C, seq_tax, ntax, nseq,
                              chpt_exp, sw_ids, nsw);
        else
            t = walk_taxon<1>(p, m, lane, ix, C, seq_tax, ntax, nseq,
                              chpt_exp, sw_ids, nsw);
        // position r0 + lane's taxon, from the first lane of its group
        return __shfl_sync(kFullMask, t, min(lane * gs, 31));
    }
};

// The taxon of position r0 + lane from a resolved table (a read's row of
// seq, the sequences that kernel Q's walks gave; kernels W and V), 0 past
// the m positions.
struct TableTaxa {
    const int* seq;
    const int* seq_tax;
    int ntax;

    __device__ __forceinline__ int operator()(int r0, int m, int lane) const {
        if (lane >= m) return 0;
        const int s = __ldg(seq + r0 + lane);
        return __ldg(seq_tax + min(max(s, 0), ntax - 1));
    }
};

// Steps 2-4, whole warp: the taxa of the n listed positions chunk by chunk
// (taxa(r0, m, lane): the taxon of position r0 + lane of the m from r0,
// every lane calling), the capped set and the LCA.  sh is
// lca_warp_ints(R) ints of the warp's shared memory (its positions, if
// listed there, are read by taxa only).  Every lane gets the result.
template <class Taxa>
__device__ LcaResult lca_of_positions(
    const Taxa& taxa, int n, int total, int n_ranges, int* sh,
    const int* __restrict__ parent, const int* __restrict__ depth,
    int maxtax, int R, int cap) {
    const int lane = threadIdx.x & 31;
    int* pos = sh;
    int* list = sh + R;
    const int listcap = max(min(R, cap + 2), 0);

    // 2-3. chunks of 32 positions: their taxa, then the new ones listed
    int n_uniq = 0;
    for (int r0 = 0; r0 < n && n_uniq < cap + 2; r0 += 32) {
        const int m = min(32, n - r0);
        const int tax = taxa(r0, m, lane);
        const bool valid = lane < m;
        bool seen = false;
        for (int j = 0; valid && !seen && j < n_uniq; ++j)
            seen = list[j] == tax;
        // a lane past m may hold any value, but a valid lane below it comes
        // first among the lanes of that value
        const unsigned same = __match_any_sync(kFullMask, tax);
        const bool fresh = valid && !seen && __ffs(same) - 1 == lane;
        const unsigned news = __ballot_sync(kFullMask, fresh);
        const int prior = n_uniq + __popc(news & lanes_below(lane));
        if (fresh && prior < listcap) list[prior] = tax;
        n_uniq += __popc(news);
        __syncwarp();
    }

    // the kept taxa are list[0, n_ids), in order
    LcaResult res;
    res.n_ids = max(min(n_uniq, cap + 1), 0);
    res.need_more = total > R && n_uniq <= cap;
    res.cut = n_uniq > cap + 1 || (total > R && n_uniq > cap);
    res.n_ranges = n_ranges;
    res.lca = res.n_ids > 0 ? list[0] : 0;
    if (res.n_ids < 2) return res;

    // 4. the LCA: x = lane + 32 i is the lane's i-th kept taxon; pres
    // marks those in the tree, pos[x] holds their depths
    unsigned pres = 0;
    int dmin = 0x7fffffff, xfirst = 0x7fffffff;
    for (int i = 0, x = lane; x < res.n_ids; ++i, x += 32) {
        const int tx = list[x];
        const int d = tx >= 0 && tx < maxtax ? __ldg(depth + tx) : 0;
        pos[x] = d;
        if (d > 0) {
            pres |= 1u << i;
            dmin = min(dmin, d);
            xfirst = min(xfirst, x);
        }
    }
    dmin = __reduce_min_sync(kFullMask, dmin);
    xfirst = __reduce_min_sync(kFullMask, xfirst);
    res.lca = 0;
    if (xfirst == 0x7fffffff) return res;  // none in the tree
    for (int i = 0, x = lane; x < res.n_ids; ++i, x += 32) {
        if (!(pres >> i & 1)) continue;
        int tx = list[x];
        for (int up = pos[x] - dmin; up > 0; --up)
            tx = __ldg(parent + min(max(tx, 0), maxtax - 1));
        list[x] = tx;
    }
    __syncwarp();
    // every lifted taxon reaches depth 1 after dmin - 1 steps; a forest
    // with several roots never meets, so the climb is bounded
    int ref = list[xfirst];
    for (int step = 0; step < dmin; ++step) {
        bool same = true;
        for (int i = 0, x = lane; x < res.n_ids; ++i, x += 32)
            if (pres >> i & 1) same = same && list[x] == ref;
        if (__all_sync(kFullMask, same)) break;
        for (int i = 0, x = lane; x < res.n_ids; ++i, x += 32)
            if (pres >> i & 1)
                list[x] = __ldg(parent + min(max(list[x], 0), maxtax - 1));
        ref = __ldg(parent + min(max(ref, 0), maxtax - 1));
    }
    res.lca = ref;
    return res;
}

// Whole warp: steps 1-4 (list_positions, then lca_of_positions with the
// SA walks of WalkTaxa).  range as for list_positions; sh is
// lca_warp_ints(R) ints of the warp's shared memory.  Every lane gets the
// read's result.  ix: the index the SA walks read (kt::FlatIx or
// kt::ShardIx; fm_common.cuh).
template <class Range, class Ix>
__device__ LcaResult ranges_lca_warp(
    const Range& range, int G, int* sh, const Ix& ix,
    const int* __restrict__ C, const int* __restrict__ seq_tax, int ntax,
    const int* __restrict__ parent, const int* __restrict__ depth,
    int maxtax, int R, int cap, int nseq, int chpt_exp,
    const int* __restrict__ sw_ids, int nsw) {
    int total, n_ranges;
    list_positions(range, G, sh, R, &total, &n_ranges);
    return lca_of_positions(
        WalkTaxa<Ix>{sh, ix, C, seq_tax, ntax, nseq, chpt_exp, sw_ids, nsw},
        min(total, R), total, n_ranges, sh, parent, depth, maxtax, R, cap);
}

}  // namespace kt
