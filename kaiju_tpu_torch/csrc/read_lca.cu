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
    const int* rf = rf_rows + (size_t)b * S;
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
    const int tie_over = __any_sync(kt::kFullMask, over);
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
