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
// Design: one warp per read.  The lanes expand 32 ranges at a time into
// positions in shared memory, each at its offset from a warp prefix sum
// of the sizes; they walk the positions in parallel (the walks are the
// latency-bound part) and mark first occurrences; lane 0 runs the short
// sequential cap and LCA logic.
#pragma once

#include "text_common.cuh"

namespace kt {

struct LcaResult {
    int lca, n_ids, need_more, cut, n_ranges;
};

// Whole warp.  range(g, &start, &size) gives range g of G (size 0: not
// contributing), from any lane; pos and first are R ints each of the
// warp's shared memory.  The result is the read's in lane 0, zeros in the
// other lanes.  ix: the index the SA walks read (kt::FlatIx or
// kt::ShardIx; fm_common.cuh).
template <class Range, class Ix>
__device__ LcaResult ranges_lca_warp(
    const Range& range, int G, int* pos, int* first, const Ix& ix,
    const int* __restrict__ C, const int* __restrict__ seq_tax, int ntax,
    const int* __restrict__ parent, const int* __restrict__ depth,
    int maxtax, int R, int cap, int nseq, int chpt_exp,
    const int* __restrict__ sw_ids, int nsw) {
    const int lane = threadIdx.x & 31;
    int total = 0, n_ranges = 0;
    for (int g0 = 0; g0 < G; g0 += 32) {
        int a = 0, size = 0;
        if (g0 + lane < G) range(g0 + lane, a, size);
        const int inc = warp_incl_sum(size, lane);
        for (int x = 0, off = total + inc - size; x < size && off + x < R; ++x)
            pos[off + x] = a + x;
        total += __shfl_sync(kFullMask, inc, 31);
        n_ranges += __popc(__ballot_sync(kFullMask, size > 0));
    }
    const int n = min(total, R);
    __syncwarp();  // every lane's positions are visible to the warp

    for (int r = lane; r < n; r += 32) {
        const int k = pos[r];
        const int iseq =
            sw_ids != nullptr && k >= kVBase
                ? __ldg(sw_ids + min(k - kVBase, nsw - 1))
                : sa_walk(ix, C, nseq, chpt_exp, k);
        pos[r] = seq_tax[min(max(iseq, 0), ntax - 1)];
    }
    __syncwarp();
    for (int r = lane; r < n; r += 32) {
        int is_first = 1;
        for (int q = 0; q < r && is_first; ++q) is_first = pos[q] != pos[r];
        first[r] = is_first;
    }
    __syncwarp();
    LcaResult res{0, 0, 0, 0, 0};
    if (lane != 0) return res;

    // kept taxa: new ones while at most cap new ones came before; the ones
    // present in the tree are compacted, lifted, into pos[0, m)
    int n_uniq = 0, first_id = 0, m = 0, dmin = 0x7fffffff;
    for (int r = 0; r < n; ++r) {
        if (!first[r]) continue;
        const int tax = pos[r];
        if (n_uniq++ > cap) continue;
        if (res.n_ids++ == 0) first_id = tax;
        if (tax >= 0 && tax < maxtax && depth[tax] > 0) {
            dmin = min(dmin, depth[tax]);
            pos[m++] = tax;
        }
    }
    if (res.n_ids == 1) {
        res.lca = first_id;
    } else if (m > 0) {
        for (int x = 0; x < m; ++x)
            for (int up = depth[pos[x]] - dmin; up > 0; --up)
                pos[x] = parent[pos[x]];
        // all lifted taxa reach depth 1 after dmin - 1 steps; a forest with
        // several roots never meets, so the climb is bounded
        for (int step = 0; step < dmin; ++step) {
            bool same = true;
            for (int x = 1; x < m && same; ++x) same = pos[x] == pos[0];
            if (same) break;
            for (int x = 0; x < m; ++x) pos[x] = parent[pos[x]];
        }
        res.lca = pos[0];
    }
    res.need_more = total > R && n_uniq <= cap;
    res.cut = n_uniq > cap + 1 || (total > R && n_uniq > cap);
    res.n_ranges = n_ranges;
    return res;
}

}  // namespace kt
