// Kernel H: batched get_suffix (bwt.c:105-121), an SA position to the
// content rank of its sequence and the offset in it.
//
// Replaces kaiju_tpu/ops/device_index.py:sa_lookup_fused (K4, :411-463):
// the SA walks of SaResolveMixin._resolve_ids, which resolves the tie
// intervals of MEM -v and Greedy -v to sequence names.  Each position k
// LF-walks over the fused records until a sampled slot (k divisible by
// 2^chpt_exp), which gives (sa_seq[idx], sa_off[idx] + steps) with idx
// clipped into the samples, or a terminator, where the LF result itself
// is the content rank and the offset the steps taken (kt::walk_pos).
//
// Bound: one random 256-byte record row per LF step (2^chpt_exp - 1 at
// most, half that on average) plus the sample read and 12 bytes a
// position in and out; device-memory bytes at 3.35 TB/s.  Design: one
// thread per position; the walks are chains of dependent row reads, so
// the card hides their latency with many positions in flight, not within
// one.
//
// kt_sa_lookup_sharded walks an index split into shards (kt::ShardIx):
// K16c, kaiju_tpu/parallel/sharded_index.py:make_sharded_sa_lookup
// (:185-270), whose BWT byte, rank and SA sample come from their owner.
#include "text_common.cuh"

namespace {

template <class Ix>
__global__ void sa_lookup_kernel(const Ix ix, const int* __restrict__ C,
                                 int nseq, int chpt_exp,
                                 const int* __restrict__ k, int n,
                                 int* __restrict__ iseq,
                                 int* __restrict__ pos) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n) return;
    const kt::WalkPos w = kt::walk_pos(ix, C, nseq, chpt_exp, k[t]);
    iseq[t] = w.iseq;
    pos[t] = w.pos;
}

template <class Ix>
int launch(const Ix& ix, const int* C, int nseq, int chpt_exp, const int* k,
           int n, int* iseq, int* pos, cudaStream_t stream) {
    const int threads = 256;
    sa_lookup_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
        ix, C, nseq, chpt_exp, k, n, iseq, pos);
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
