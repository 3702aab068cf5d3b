// Kernel F: per-read (lca, n_ids, need_more, tie_order) from per-read SA
// ranges g_s0, g_s1 int32 [B, G]; range g contributes when g_s1 > g_s0.
// tie_order: more than one range contributes and the id cap may have cut
// the read's taxa, so that the result depends on the order of the ranges
// (the host replays such reads: the JAX tie order is not the reference's,
// ROADMAP.md queue 3).
//
// Replaces kaiju_tpu/ops/fused_classify.py:ranges_lca (K11 in its per-read
// range form, the tail of the fused Greedy program) with the SA walk
// _sa_walk_local (K4) under it, through the tail that kernel D shares
// (lca_common.cuh).  sw_ids (null: none) holds the ids of kernel E's
// virtual tie rows, those of the last level's text-compare hybrid.
//
// Bound: bytes, the SA walks' random 256-byte record rows plus the
// ranges in and 16 bytes a read out, at 3.35 TB/s; and the chain of
// dependent loads of the slowest read (lca_common.cuh), at the L2's
// latency.  Design: one warp per read (see lca_common.cuh).
//
// kt_ranges_lca_sharded runs the same on an index split into shards
// (kt::ShardIx): the tail of K16f, kaiju_tpu/parallel/sharded_fused.py:
// make_sharded_greedy_classify (:278-390), whose SA walks are
// _make_walk's (:78-150).  A virtual row (kt::kVBase and up) takes its id
// from sw_ids and never goes through the owner rule.
//
// Kernel V (kt_ranges_lca_hosts) is F split around its SA walks, for a
// group of processes on several hosts, where a walk's rows may lie on
// another host and kernel Q (walk_hosts.cu) walks them in rounds, as
// kernel W splits D (read_lca.cu).  V runs step 1 (kt::list_positions):
// the first R positions of the read's ranges, in range order, into pos
// [B, R] (-1 past them) and info [B, 4] = (positions, total, non-empty
// ranges, 0).  Steps 2-4 are W's resolved form (kt_read_lca_hosts form 1
// with ranges), which writes F's four outputs from info and each
// position's sequence, which Q resolved.  F stops walking once the capped
// set is full; V lists all R positions, which changes work, never a
// result.  With sw_ids (the hybrid across hosts: kernel U's virtual tie
// rows, kernel Y's ids) V also writes each listed position's sequence
// where it is a virtual row (kt::listed_id, F's own rule) into seq [B, R],
// -1 elsewhere, and only the other positions go to Q.  Bound: bytes, the
// ranges in, pos, info (and seq) out, and one dependent load; design: F's
// warp a read, without the walks.
#include "lca_common.cuh"

namespace {

constexpr int kWarps = 4;  // reads a block

struct ReadRanges {
    const int *s0, *s1;
    __device__ void operator()(int g, int& a, int& size) const {
        a = __ldg(s0 + g);
        size = max(__ldg(s1 + g) - a, 0);
    }
};

template <class Ix>
__global__ void ranges_lca_kernel(
    const int* __restrict__ g_s0, const int* __restrict__ g_s1, int B, int G,
    const Ix ix, const int* __restrict__ C, const int* __restrict__ seq_tax,
    int ntax, const int* __restrict__ parent, const int* __restrict__ depth,
    int maxtax, int R, int cap, int nseq, int chpt_exp,
    const int* __restrict__ sw_ids, int nsw, int* __restrict__ out_lca,
    int* __restrict__ out_n_ids, int* __restrict__ out_need_more,
    int* __restrict__ out_tie_order) {
    extern __shared__ int smem[];
    const int w = threadIdx.x >> 5;
    const int b = blockIdx.x * kWarps + w;
    if (b >= B) return;  // whole warps leave together
    const ReadRanges ranges{g_s0 + (size_t)b * G, g_s1 + (size_t)b * G};
    const kt::LcaResult res = kt::ranges_lca_warp(
        ranges, G, smem + w * kt::lca_warp_ints(R), ix, C, seq_tax, ntax,
        parent, depth, maxtax, R, cap, nseq, chpt_exp, sw_ids, nsw);
    if ((threadIdx.x & 31) != 0) return;
    out_lca[b] = res.lca;
    out_n_ids[b] = res.n_ids;
    out_need_more[b] = res.need_more;
    out_tie_order[b] = res.n_ranges > 1 && res.cut;
}

__global__ void ranges_lca_list_kernel(const int* __restrict__ g_s0,
                                       const int* __restrict__ g_s1, int B,
                                       int G, int R,
                                       const int* __restrict__ sw_ids,
                                       int nsw, int* __restrict__ pos,
                                       int* __restrict__ info,
                                       int* __restrict__ seq) {
    extern __shared__ int smem[];
    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarps + w;
    if (b >= B) return;  // whole warps leave together
    int* sh = smem + w * R;
    int total, n_ranges;
    kt::list_positions(ReadRanges{g_s0 + (size_t)b * G, g_s1 + (size_t)b * G},
                       G, sh, R, &total, &n_ranges);
    const int n = min(total, R);
    int* o = pos + (size_t)b * R;
    for (int r = lane; r < R; r += 32) o[r] = r < n ? sh[r] : -1;
    for (int r = lane; sw_ids != nullptr && r < R; r += 32)
        seq[(size_t)b * R + r] = r < n ? kt::listed_id(sh[r], sw_ids, nsw)
                                       : -1;
    if (lane == 0) {
        int* f = info + (size_t)b * 4;
        f[0] = n;
        f[1] = total;
        f[2] = n_ranges;
        f[3] = 0;
    }
}

template <class Ix>
int launch(const int* g_s0, const int* g_s1, int B, int G, const Ix& ix,
           const int* C, const int* seq_tax, int ntax, const int* parent,
           const int* depth, int maxtax, int R, int cap, int nseq,
           int chpt_exp, const int* sw_ids, int nsw, int* out_lca,
           int* out_n_ids, int* out_need_more, int* out_tie_order,
           cudaStream_t stream) {
    const size_t shmem = (size_t)kWarps * kt::lca_warp_ints(R) * sizeof(int);
    const int blocks = (B + kWarps - 1) / kWarps;
    ranges_lca_kernel<<<blocks, kWarps * 32, shmem, stream>>>(
        g_s0, g_s1, B, G, ix, C, seq_tax, ntax, parent, depth, maxtax, R,
        cap, nseq, chpt_exp, sw_ids, nsw, out_lca, out_n_ids, out_need_more,
        out_tie_order);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

KT_EXPORT int kt_ranges_lca(const int* g_s0, const int* g_s1, int B, int G,
                            const int* rec, int nb1, const int* C,
                            const int* sa_seq, int nsamp, const int* seq_tax,
                            int ntax, const int* parent, const int* depth,
                            int maxtax, int R, int cap, int nseq, int chpt_exp,
                            const int* sw_ids, int nsw, int* out_lca,
                            int* out_n_ids, int* out_need_more,
                            int* out_tie_order, cudaStream_t stream) {
    return launch(g_s0, g_s1, B, G,
                  kt::FlatIx{rec, nb1, sa_seq, nullptr, nsamp, nullptr}, C,
                  seq_tax, ntax, parent, depth, maxtax, R, cap, nseq,
                  chpt_exp, sw_ids, nsw, out_lca, out_n_ids, out_need_more,
                  out_tie_order, stream);
}

KT_EXPORT int kt_ranges_lca_sharded(
    const int* g_s0, const int* g_s1, int B, int G, KT_SHARD_PARAMS,
    const int* C, const int* seq_tax, int ntax, const int* parent,
    const int* depth, int maxtax, int R, int cap, int nseq, int chpt_exp,
    const int* sw_ids, int nsw, int* out_lca, int* out_n_ids,
    int* out_need_more, int* out_tie_order, cudaStream_t stream) {
    return launch(g_s0, g_s1, B, G, KT_SHARD_IX, C, seq_tax, ntax, parent,
                  depth, maxtax, R, cap, nseq, chpt_exp, sw_ids, nsw,
                  out_lca, out_n_ids, out_need_more, out_tie_order, stream);
}

// Kernel V: lists each read's positions (pos, info; with sw_ids the
// virtual rows' ids into seq); W's resolved form (kt_read_lca_hosts form
// 1, ranges) finishes the reads.
KT_EXPORT int kt_ranges_lca_hosts(const int* g_s0, const int* g_s1, int B,
                                  int G, int R, const int* sw_ids, int nsw,
                                  int* pos, int* info, int* seq,
                                  cudaStream_t stream) {
    ranges_lca_list_kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32,
                             (size_t)kWarps * R * sizeof(int), stream>>>(
        g_s0, g_s1, B, G, R, sw_ids, nsw, pos, info, seq);
    return static_cast<int>(cudaGetLastError());
}
