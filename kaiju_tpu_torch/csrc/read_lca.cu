// Kernel D: per-read MEM classification from per-fragment statistics:
// (lca, score, flags, n_ids) for each read.
//
// Replaces kaiju_tpu/ops/fused_classify.py:classify_tail (K11 in its slot
// form): the read's longest match over its S pop-order slots (rf_rows,
// -1 = pad) and the slots that reach it; their tie ranges, in slot order
// then tie order (T ties a slot), go through the shared tail
// kt::ranges_lca_warp (lca_common.cuh: SA walks, capped id set, LCA).
// sw_ids (null: none) holds the ids of kernel G's virtual tie rows.
// flags: 1 = a contributing fragment had more than T ties, 2 = the R
// positions ran out before the id cap.  The host replays flagged reads
// exactly.
//
// Bound: bytes, the SA walks' random 256-byte record rows plus the
// statistics rows the reads touch, at 3.35 TB/s; and the chain of
// dependent loads of the slowest read (lca_common.cuh), at the L2's
// latency.  Design: one warp per read.  The slots come 32 at a time, one
// a lane: their longest, then a ballot of the slots that reach it, whose
// fragment rows are listed in shared memory, so that only their ties are
// loaded (T a slot); the tail kt::ranges_lca_warp (lca_common.cuh) takes
// the rest.
//
// kt_read_lca_sharded runs the same on an index split into shards
// (kt::ShardIx): the classify_tail of K16e,
// kaiju_tpu/parallel/sharded_fused.py:make_sharded_mem_classify
// (:178-275), whose SA walks are _make_walk's (:78-150).
//
// Kernel W (kt_read_lca_hosts) is D split around its SA walks, for a
// group of processes on several hosts, where a walk's rows may lie on
// another host and kernel Q (walk_hosts.cu) walks them in rounds.  Form 0
// (list) runs D's slots and step 1 (kt::list_positions): the first R
// positions of the read's contributing ties, in slot order then tie
// order, into pos [B, R] (-1 past them) and info [B, 4] = (positions,
// total, longest, tie_over).  Form 1 (resolved) runs D's steps 2-4
// (kt::lca_of_positions) with each position's sequence from seq [B, R],
// which Q resolved, and writes (lca, n_ids, need_more, tie_order), from
// which the host side makes D's row; V's reads take the same form.  With
// sw_ids (the hybrid across hosts: kernel Y's virtual rows in G's layout)
// form 0 also writes each listed position's sequence where it is a
// virtual row (kt::listed_id, D's own rule) into seq [B, R], -1 elsewhere,
// and only the other positions go to Q.  D stops walking once the capped
// set is full; W lists all R positions, which changes work, never a
// result.  Bound: bytes, the statistics rows
// the reads touch, pos, seq and the rows written, and the longest chain
// of parent loads (the LCA); design: D's warp a read, without the walks.
#include "lca_common.cuh"

namespace {

constexpr int kWarps = 4;  // reads a block

// Tie t of the c-th slot that reaches the read's longest (g = c * T + t);
// rows: those slots' fragment rows, in slot order.
struct SlotTies {
    const int *rows, *tie_s0, *tie_s1;
    int T;
    __device__ void operator()(int g, int& a, int& size) const {
        const size_t i = (size_t)rows[g / T] * T + g % T;
        a = __ldg(tie_s0 + i);
        size = __ldg(tie_s1 + i) - a;
    }
};

// D's first part, every lane: the read's longest over its slots, its
// contributing slots' fragment rows (in slot order) into rows, and
// whether one of them had more than T ties.
__device__ __forceinline__ int contributing(
    const int* __restrict__ maxl, const int* __restrict__ tie_cnt, int T,
    const int* rf, int S, int lane, int* rows, int* nc_out, int* over_out) {
    int longest = 0;
    for (int s = lane; s < S; s += 32) {
        const int r = __ldg(rf + s);
        if (r >= 0) longest = max(longest, __ldg(maxl + r));
    }
    longest = kt::warp_max(longest);
    int nc = 0, over = 0;
    for (int s0 = 0; s0 < S && longest > 0; s0 += 32) {
        const int r = s0 + lane < S ? __ldg(rf + s0 + lane) : -1;
        const bool c = r >= 0 && __ldg(maxl + r) == longest;
        const unsigned cm = __ballot_sync(kt::kFullMask, c);
        if (c) {
            rows[nc + __popc(cm & kt::lanes_below(lane))] = r;
            over |= __ldg(tie_cnt + r) > T;
        }
        nc += __popc(cm);
    }
    __syncwarp();
    *nc_out = nc;
    *over_out = __any_sync(kt::kFullMask, over);
    return longest;
}

template <class Ix>
__global__ void read_lca_kernel(
    const int* __restrict__ maxl, const int* __restrict__ tie_cnt,
    const int* __restrict__ tie_s0, const int* __restrict__ tie_s1, int T,
    const int* __restrict__ rf_rows, int B, int S, const Ix ix,
    const int* __restrict__ C, const int* __restrict__ seq_tax, int ntax,
    const int* __restrict__ parent, const int* __restrict__ depth,
    int maxtax, int R, int cap, int nseq, int chpt_exp,
    const int* __restrict__ sw_ids, int nsw, int* __restrict__ out) {
    extern __shared__ int smem[];
    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarps + w;
    if (b >= B) return;  // whole warps leave together
    int* sh = smem + w * (kt::lca_warp_ints(R) + S);
    int* rows = sh + kt::lca_warp_ints(R);  // the contributing slots' rows
    int nc, tie_over;
    const int longest = contributing(maxl, tie_cnt, T, rf_rows + (size_t)b * S,
                                     S, lane, rows, &nc, &tie_over);
    const kt::LcaResult res = kt::ranges_lca_warp(
        SlotTies{rows, tie_s0, tie_s1, T}, nc * T, sh, ix, C, seq_tax, ntax,
        parent, depth, maxtax, R, cap, nseq, chpt_exp, sw_ids, nsw);
    if (lane != 0) return;
    int* o = out + (size_t)b * 4;
    o[0] = longest > 0 ? res.lca : 0;
    o[1] = longest;
    o[2] = tie_over * 1 + res.need_more * 2;
    o[3] = res.n_ids;
}

__global__ void read_lca_list_kernel(
    const int* __restrict__ maxl, const int* __restrict__ tie_cnt,
    const int* __restrict__ tie_s0, const int* __restrict__ tie_s1, int T,
    const int* __restrict__ rf_rows, int B, int S, int R,
    const int* __restrict__ sw_ids, int nsw, int* __restrict__ pos,
    int* __restrict__ info, int* __restrict__ seq) {
    extern __shared__ int smem[];
    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarps + w;
    if (b >= B) return;  // whole warps leave together
    int* sh = smem + w * (R + S);
    int* rows = sh + R;
    int nc, over;
    const int longest = contributing(maxl, tie_cnt, T, rf_rows + (size_t)b * S,
                                     S, lane, rows, &nc, &over);
    int total, n_ranges;
    kt::list_positions(SlotTies{rows, tie_s0, tie_s1, T}, nc * T, sh, R,
                       &total, &n_ranges);
    const int n = min(total, R);
    int* o = pos + (size_t)b * R;
    for (int r = lane; r < R; r += 32) o[r] = r < n ? sh[r] : -1;
    for (int r = lane; seq != nullptr && r < R; r += 32)
        seq[(size_t)b * R + r] = r < n ? kt::listed_id(sh[r], sw_ids, nsw)
                                       : -1;
    if (lane == 0) {
        int* f = info + (size_t)b * 4;
        f[0] = n;
        f[1] = total;
        f[2] = longest;
        f[3] = over;
    }
}

// The resolved form that W and V share (ranges_lca.cu lists V's
// positions): steps 2-4 (kt::lca_of_positions) from info [B, 4] =
// (positions, total, then the list form's own two) and each position's
// sequence seq [B, R], which Q resolved, into out [4, B] = (lca, n_ids,
// need_more, tie_order).  With ranges (V), info[2] counts the read's
// non-empty ranges and tie_order is F's (more than one and the cut); W's
// info[2] and info[3] (longest, tie_over) go into D's row on the host side.
__global__ void lca_resolved_kernel(
    const int* __restrict__ info, const int* __restrict__ seq, int B,
    const int* __restrict__ seq_tax, int ntax,
    const int* __restrict__ parent, const int* __restrict__ depth,
    int maxtax, int R, int cap, int ranges, int* __restrict__ out) {
    extern __shared__ int smem[];
    const int w = threadIdx.x >> 5;
    const int b = blockIdx.x * kWarps + w;
    if (b >= B) return;  // whole warps leave together
    const int* f = info + (size_t)b * 4;
    const kt::LcaResult res = kt::lca_of_positions(
        kt::TableTaxa{seq + (size_t)b * R, seq_tax, ntax}, __ldg(f),
        __ldg(f + 1), ranges ? __ldg(f + 2) : 0,
        smem + w * kt::lca_warp_ints(R), parent, depth, maxtax, R, cap);
    if ((threadIdx.x & 31) != 0) return;
    out[b] = res.lca;
    out[(size_t)B + b] = res.n_ids;
    out[2 * (size_t)B + b] = res.need_more;
    out[3 * (size_t)B + b] = res.n_ranges > 1 && res.cut;
}

template <class Ix>
int launch(const int* maxl, const int* tie_cnt, const int* tie_s0,
           const int* tie_s1, int T, const int* rf_rows, int B, int S,
           const Ix& ix, const int* C, const int* seq_tax, int ntax,
           const int* parent, const int* depth, int maxtax, int R, int cap,
           int nseq, int chpt_exp, const int* sw_ids, int nsw, int* out,
           cudaStream_t stream) {
    const size_t shmem =
        (size_t)kWarps * (kt::lca_warp_ints(R) + S) * sizeof(int);
    const int blocks = (B + kWarps - 1) / kWarps;
    read_lca_kernel<<<blocks, kWarps * 32, shmem, stream>>>(
        maxl, tie_cnt, tie_s0, tie_s1, T, rf_rows, B, S, ix, C, seq_tax, ntax,
        parent, depth, maxtax, R, cap, nseq, chpt_exp, sw_ids, nsw, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

KT_EXPORT int kt_read_lca(const int* maxl, const int* tie_cnt,
                          const int* tie_s0, const int* tie_s1, int T,
                          const int* rf_rows, int B, int S, const int* rec,
                          int nb1, const int* C, const int* sa_seq, int nsamp,
                          const int* seq_tax, int ntax, const int* parent,
                          const int* depth, int maxtax, int R, int cap,
                          int nseq, int chpt_exp, const int* sw_ids,
                          int nsw, int* out, cudaStream_t stream) {
    return launch(maxl, tie_cnt, tie_s0, tie_s1, T, rf_rows, B, S,
                  kt::FlatIx{rec, nb1, sa_seq, nullptr, nsamp, nullptr}, C,
                  seq_tax, ntax, parent, depth, maxtax, R, cap, nseq,
                  chpt_exp, sw_ids, nsw, out, stream);
}

KT_EXPORT int kt_read_lca_sharded(
    const int* maxl, const int* tie_cnt, const int* tie_s0,
    const int* tie_s1, int T, const int* rf_rows, int B, int S,
    KT_SHARD_PARAMS, const int* C, const int* seq_tax, int ntax,
    const int* parent, const int* depth, int maxtax, int R, int cap,
    int nseq, int chpt_exp, const int* sw_ids, int nsw, int* out,
    cudaStream_t stream) {
    return launch(maxl, tie_cnt, tie_s0, tie_s1, T, rf_rows, B, S,
                  KT_SHARD_IX, C, seq_tax, ntax, parent, depth, maxtax, R,
                  cap, nseq, chpt_exp, sw_ids, nsw, out, stream);
}

// Kernel W: form 0 lists each read's positions (pos, info; with sw_ids
// the virtual rows' ids into seq), form 1 finishes W's or V's reads
// (ranges) from the resolved sequences seq [B, R] (out [4, B]).
KT_EXPORT int kt_read_lca_hosts(
    int form, const int* maxl, const int* tie_cnt, const int* tie_s0,
    const int* tie_s1, int T, const int* rf_rows, int B, int S, int* seq,
    const int* seq_tax, int ntax, const int* parent, const int* depth,
    int maxtax, int R, int cap, int ranges, const int* sw_ids, int nsw,
    int* pos, int* info, int* out, cudaStream_t stream) {
    const int blocks = (B + kWarps - 1) / kWarps;
    if (form == 0) {
        const size_t shmem = (size_t)kWarps * (R + S) * sizeof(int);
        read_lca_list_kernel<<<blocks, kWarps * 32, shmem, stream>>>(
            maxl, tie_cnt, tie_s0, tie_s1, T, rf_rows, B, S, R, sw_ids, nsw,
            pos, info, sw_ids != nullptr ? seq : nullptr);
    } else {
        const size_t shmem = (size_t)kWarps * kt::lca_warp_ints(R) * sizeof(int);
        lca_resolved_kernel<<<blocks, kWarps * 32, shmem, stream>>>(
            info, seq, B, seq_tax, ntax, parent, depth, maxtax, R, cap,
            ranges, out);
    }
    return static_cast<int>(cudaGetLastError());
}
