// Kernel U: kernel E's per-read work between its FM steps, level by level,
// for a group of processes on several hosts, where a variant's rank pair
// may need a row that only another host holds (kernel X, greedy_variants.cu,
// runs a level's FM steps in rounds in between; parallel/exchange.py).
//
// Replaces kaiju_tpu/ops/fused_greedy.py:greedy_core (K13: the inserted-
// and planned-node rules, node scores, the 19-way fan-out of each level,
// the ties) as kaiju_tpu's sharded Greedy runs it over a mesh of hosts
// (K16f, kaiju_tpu/parallel/sharded_fused.py:make_sharded_greedy_classify,
// :278-390), which is level-synchronous over the batch (fused_greedy.py:
// 428).  E's own pruning threshold is fixed at the start of a level
// (max(best, min_score)), so cut at each level boundary a level's variants
// are independent, and a read's outputs equal E's; with the hybrid, once
// kernel Y (switch_hosts.cu) has finished the last level's narrow variants.
//
// Contract (ops/greedy.py greedy_levels, U's state LevelState): a warp a
// read, its fragment rows sorted and its per-position arrays in global
// memory (E's case of a read past kLcap positions).
//   form 0  E's level 0 from B's lanes (greedy_common.cuh): the prefix
//           sums into pincl, the ties so far into g_s0/g_s1, the level-1
//           sources into src half 0, state = (best, ties, sources, over
//           vcap); with no level, the read's row (finish_read).
//   form 1  the fan-out of level k: each source of half (k - 1) & 1 keeps
//           the prefix of its 19 columns (descending scores) whose bound
//           reaches max(best, min_score).  voff null: the read's count to
//           counts[b]; else the variants, by source then column, to
//           var[voff[b] ...], kVarInts each (greedy_common.cuh).
//   form 2  the settle of level k: the read's variants var[voff[b],
//           voff[b + 1]) with X's (n0, n1, i) in vout, in list order: E's
//           settle, ties, best and the next level's sources into half
//           k & 1 (over vcap: flagged, as E); at the last level the row.
//           With the hybrid (the last level, sw_ids not null) vnid[v] > 0
//           marks a variant that kernel Y finished, its vnid ids in SA
//           order at vids[8 v]: its tie r of read b becomes E's virtual
//           row (kVBase + (b T + r) 8, + vnid) with the ids at sw_ids
//           [(b T + r) 8], and finish_read zeroes the other id slots.
// A read over vcap takes no further level; its row is E's (a zero row,
// kFlagScratch).
//
// Bound: bytes, the lanes, codes and prefix sums a read reads once a form,
// its sources and variants, and the rows out; no index row.  The chain is
// E's level 0 (a warp scan a fragment) and, per level, the window loop.
// Design: E's code on global views, a warp a read; the fan-out writes the
// exact list (counts, a scan on the host side, then the list), never a
// B x vcap x 19 bound, a lane a variant, so that a warp's stores are
// neighbouring records (a lane writing its source's variants in turn took
// 0.36 ms on 27,893 variants, NVIDIA H100 80GB HBM3, 700.00 W, PERF.md).
#include "greedy_common.cuh"

namespace {

using namespace kg;

constexpr int kWarps = 4;  // reads a block

struct Level : Params {
    int form, level;
    int* state;        // [B, kStateInts]
    const int* voff;   // [B + 1]: the reads' first variants (forms 1, 2)
    int* counts;       // [B]: the fan-out's counts (form 1, voff null)
    int* var;          // [V, kVarInts]
    const int* vout;   // [V, 3]: X's n0, n1, i
    const int* vnid;   // [V]: the ids of Y's switched variants, or null
    const int* vids;   // [V, kSwWcap]: their ids in SA order
    int* sw_ids;       // [B, T, kSwWcap]: the virtual tie rows' ids
};

// A warp's shared memory: E's Head, and a source group's code and
// fragment start a lane (the fan-out); U stages no read (its positions stay
// in global memory), so E's staging arrays are not reserved.
struct Sm : Head {
    int src[32][2];
};

__global__ void __launch_bounds__(kWarps * 32) greedy_levels_kernel(Level a) {
    __shared__ Sm s_warp[kWarps];
    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarps + w;
    if (b >= a.B) return;  // whole warps leave together
    Sm& sm = s_warp[w];
    bool staged;
    int total;
    const int nfr = read_views(a, sm, b, lane, false, &staged, &total);
    int* st = a.state + (size_t)b * kStateInts;
    int* g0 = a.g_s0 + (size_t)b * a.T;
    int* g1 = a.g_s1 + (size_t)b * a.T;
    int* src = a.src + (size_t)b * 2 * a.vcap * kSrcInts;

    if (a.form == 0) {
        const Views v{a.li, a.pincl, a.node, a.flat};
        level0_nodes(a, sm, v, nfr, lane);
        Ties ties{0, 0, a.T, g0, g1, nullptr, 0};
        const int nsrc = level0_events(a, sm, v, nfr, ties, src, lane);
        const bool over = a.mismatches > 0 && nsrc > a.vcap;
        __syncwarp();
        if (lane == 0) {
            st[0] = ties.best;
            st[1] = ties.cnt;
            st[2] = a.mismatches > 0 ? nsrc : 0;
            st[3] = over;
        }
        if (a.mismatches == 0) finish_read(a, ties, over, b, lane);
        return;
    }

    const int best = st[0], cnt = st[1], nsrc = st[2];
    const bool over = st[3] != 0;
    const bool last = a.level == a.mismatches;
    if (a.form == 1) {
        const int* X = src + (size_t)((a.level - 1) & 1) * a.vcap * kSrcInts;
        int* out = a.voff ? a.var + (size_t)a.voff[b] * kVarInts : nullptr;
        const int thr = max(best, a.min_score);
        int done = 0;  // the read's variants so far
        for (int g = 0; g < (over ? 0 : nsrc); g += 32) {
            // a source a lane, and how many of its substitutions are kept
            // (a prefix: the columns descend in score)
            const int s = g + lane;
            const int* e = X + (size_t)min(s, nsrc - 1) * kSrcInts;
            int nk = 0, oc = 0, fb = 0;
            if (s < nsrc && e[1] > 0 && e[2] >= a.mfl) {
                fb = sm.base[e[0]];
                oc = a.flat[fb + e[1] - 1] & 31;
                const int basev =
                    max(pref(a.pincl + fb, e[2]) + e[5] + e[6], 0) -
                    __ldg(a.diag + oc);
                for (int c = 0; c < kNSub; ++c)
                    nk += basev + __ldg(a.submat + oc * kNSub + c) >= thr;
            }
            const int inc = warp_incl_sum(nk, lane);
            const int tot = __shfl_sync(kFull, inc, 31);
            if (out != nullptr && tot > 0) {
                // the group's variants a lane each, in (source, column)
                // order, so that neighbouring lanes write neighbouring
                // records: variant v belongs to the last source whose
                // first variant is at or before v (E's windows)
                sm.exc[lane] = inc - nk;
                sm.src[lane][0] = oc;
                sm.src[lane][1] = fb;
                __syncwarp();
                for (int v = lane; v < tot; v += 32) {
                    int sl = 0;
                    for (int step = 16; step > 0; step >>= 1)
                        if (sm.exc[sl + step] <= v) sl += step;
                    const int* se = X + (size_t)(g + sl) * kSrcInts;
                    const int so = sm.src[sl][0];
                    const int x = so * kNSub + v - sm.exc[sl];
                    int* o = out + (size_t)(done + v) * kVarInts;
                    o[0] = __ldg(a.subcode + x) | (se[1] - 1) << 8;
                    o[1] = se[3];
                    o[2] = se[4];
                    o[3] = sm.src[sl][1];
                    o[4] = last ? a.mfl : se[7] + 1;
                    o[5] = se[5] + __ldg(a.subdiag + x) - __ldg(a.diag + so);
                    o[6] = se[6] + __ldg(a.submat + x) - __ldg(a.subdiag + x);
                    o[7] = se[0] | se[2] << 8;
                }
                __syncwarp();  // the next group rewrites exc and res
            }
            done += tot;
        }
        if (out == nullptr && lane == 0) a.counts[b] = done;
        return;
    }

    // form 2: the settle, in list order (E's ordered part)
    const int slot0 = b * a.T * kt::kSwWcap;
    Ties ties{best, cnt, a.T, g0, g1,
              a.sw_ids != nullptr ? a.sw_ids + slot0 : nullptr, slot0};
    int* Xn = src + (size_t)(a.level & 1) * a.vcap * kSrcInts;
    int nnext = 0;
    const int v1 = a.voff[b + 1];
    for (int w0 = a.voff[b]; w0 < v1; w0 += 32) {
        const int v = w0 + lane;
        int r[kWinInts] = {0, 0, 0, 0, 0, 0, 0, 0};
        int nid = 0;
        if (v < v1) {
            const int* e = a.var + (size_t)v * kVarInts;
            const int* o = a.vout + (size_t)v * 3;
            r[5] = e[5];
            r[6] = e[6];
            r[7] = e[7];
            if (a.vnid != nullptr) nid = a.vnid[v];
            settle(a, a.pincl + sm.base[r[7] & 255], r, o[0], o[1], o[2], e[4],
                   nid);
        }
        const bool has_si = r[4] & 1, ev = (r[4] >> 1) & 1;
        ties.add(ev, r[0], r[1], r[2], lane,
                 nid > 0 ? a.vids + (size_t)v * kt::kSwWcap : nullptr, nid);
        if (!last)
            nnext = push_src(Xn, nnext, a.vcap, has_si, lane, r[7] & 255, r[3],
                             r[7] >> 8, r[1], r[2], r[5], r[6],
                             (r[7] >> 8) - r[3]);
    }
    __syncwarp();
    if (lane == 0) {
        st[0] = ties.best;
        st[1] = ties.cnt;
        if (!last && !over) {
            st[2] = nnext;
            st[3] = nnext > a.vcap;
        }
    }
    if (last) finish_read(a, ties, over, b, lane);
}

}  // namespace

// Kernel U: form 0 (level 0), 1 (fan-out of `level`: counts, or the list
// at voff) or 2 (settle of `level`), see above.
KT_EXPORT int kt_greedy_levels(
    int form, int level, const int* li, const int* ls0, const int* ls1,
    const uint8_t* flat, const int* frag_off, const int* rf_rows, int B,
    int S, const int* diag, const int* submat, const int* subcode,
    const int* subdiag, int Lmap, int mfl, int min_score, int mismatches,
    int T, int vcap, uint8_t* node, int* pincl, int* src, int* state,
    const int* voff, int* counts, int* var, const int* vout,
    const int* vnid, const int* vids, int* sw_ids, int* best, int* flags,
    int* g_s0, int* g_s1, cudaStream_t stream) {
    const Level a{{li, ls0, ls1, flat, frag_off, rf_rows, B, S, diag, submat,
                   subcode, subdiag, Lmap, mfl, min_score, mismatches, T,
                   vcap, node, pincl, src, best, flags, g_s0, g_s1},
                  form, level, state, voff, counts, var, vout, vnid, vids,
                  sw_ids};
    const int blocks = (B + kWarps - 1) / kWarps;
    greedy_levels_kernel<<<blocks, kWarps * 32, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}
