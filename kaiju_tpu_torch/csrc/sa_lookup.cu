// Kernel H: batched get_suffix (bwt.c:105-121), an SA position to the
// content rank of its sequence and the offset in it.
//
// Replaces kaiju_tpu/ops/device_index.py:sa_lookup_fused (K4, :411-463):
// the SA walks of SaResolveMixin._resolve_ids, which resolves the tie
// intervals of MEM -v and Greedy -v to sequence names.  Each position k
// LF-walks over the fused records until a sampled slot (k divisible by
// 2^chpt_exp), which gives (sa_seq[idx], sa_off[idx] + steps) with idx
// clipped into the samples, or a terminator, where the LF result itself
// is the content rank and the offset the steps taken (kt::walk_group).
//
// Bound: one random 256-byte record row per LF step plus the sample read
// and 12 bytes a position in and out; device-memory bytes at 3.35 TB/s.
// But a walk is a chain of dependent row reads, geometric in length (one
// slot in 2^chpt_exp sampled: ~60 steps for the longest of 2,930), so a
// launch lasts as long as its longest walk.  The first design walked a
// position on one thread, each LF step 4-5 device-memory latencies (the
// letter's load, then the rank's loads one after another).  Design: a
// group of 8 lanes a position (kt::walk_group: the group reads a step's
// row as one coalesced line, so a step costs one memory latency).
//
// kt_sa_lookup_sharded walks an index split into shards (kt::ShardIx):
// K16c, kaiju_tpu/parallel/sharded_index.py:make_sharded_sa_lookup
// (:185-270), whose BWT byte, rank and SA sample come from their owner.
#include "text_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kG = 8;  // lanes a position

template <class Ix>
__global__ void __launch_bounds__(kThreads) sa_lookup_kernel(
    const Ix ix, const int* __restrict__ C, int nseq, int chpt_exp,
    const int* __restrict__ k, int n, int* __restrict__ iseq,
    int* __restrict__ pos) {
    const int x = (blockIdx.x * kThreads + threadIdx.x) / kG;
    if (x >= n) return;  // a group leaves whole
    const int gl = threadIdx.x & (kG - 1);
    const kt::WalkPos w = kt::walk_group<kG>(
        ix, C, nseq, chpt_exp, __ldg(k + x), gl,
        kt::group_mask<kG>(threadIdx.x & 31));
    if (gl == 0) {
        iseq[x] = w.iseq;
        pos[x] = w.pos;
    }
}

template <class Ix>
int launch(const Ix& ix, const int* C, int nseq, int chpt_exp, const int* k,
           int n, int* iseq, int* pos, cudaStream_t stream) {
    const long long threads = (long long)n * kG;
    sa_lookup_kernel<<<(int)((threads + kThreads - 1) / kThreads), kThreads,
                       0, stream>>>(ix, C, nseq, chpt_exp, k, n, iseq, pos);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

KT_EXPORT int kt_sa_lookup(const int* rec, int nb1, const int* C,
                           const int* sa_seq, const int* sa_off, int nsamp,
                           int nseq, int chpt_exp, const int* k, int n,
                           int* iseq, int* pos, cudaStream_t stream) {
    return launch(kt::FlatIx{rec, nb1, sa_seq, sa_off, nsamp, nullptr}, C,
                  nseq, chpt_exp, k, n, iseq, pos, stream);
}

KT_EXPORT int kt_sa_lookup_sharded(KT_SHARD_PARAMS, const int* C, int nseq,
                                   int chpt_exp, const int* k, int n,
                                   int* iseq, int* pos, cudaStream_t stream) {
    return launch(KT_SHARD_IX, C, nseq, chpt_exp, k, n, iseq, pos, stream);
}
