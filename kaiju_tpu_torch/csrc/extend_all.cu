// Kernel J: the maximal backward extension of every (fragment, end j)
// lane of a padded code matrix (bwt.c:265-293).
//
// Replaces kaiju_tpu/ops/device_index.py:extend_all (K2, :216-266), which
// MEM -v runs for the fragments with more than TIE_CAP ties
// (engine/mem_fast.py:_full_maps).  codes is uint8 [F, L] (0-padded),
// flen int32 [F].  A valid lane (j < flen[f]) starts from the interval of
// its own letter, [C[c_j], C[c_j + 1]) with i = j, and extends through
// kt::extend_back; it returns (start, si0, si1) = the final (i, s0, s1).
// An invalid lane returns (j, 0, 0), as the JAX program leaves it.  The
// JAX program reads the unfused blocks/occ arrays; this kernel reads the
// fused records, which give the same ranks.
//
// Bound: two random 256-byte record rows per step taken, the codes read
// once and 12 bytes a lane written; device-memory bytes at 3.35 TB/s.
// Design: one thread per lane, the lanes of a fragment side by side in a
// warp, so neighbouring threads read neighbouring code bytes.
//
// kt_extend_all_sharded runs the same on an index split into shards
// (kt::ShardIx): K16b, kaiju_tpu/parallel/sharded_index.py:
// make_sharded_extend_all (:123-182), K2 on the owner-computes rank.
#include "extend_common.cuh"

namespace {

template <class Ix>
__global__ void extend_all_kernel(const Ix ix, const int* __restrict__ C,
                                  const uint8_t* __restrict__ codes,
                                  const int* __restrict__ flen, int F, int L,
                                  int* __restrict__ start,
                                  int* __restrict__ si0,
                                  int* __restrict__ si1) {
    const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= (int64_t)F * L) return;
    const int f = (int)(lane / L);
    const int j = (int)(lane % L);
    kt::Ext e{j, 0, 0};
    if (j < __ldg(flen + f)) {
        const int c = __ldg(codes + lane);
        e = kt::extend_back(ix, C, codes, (int64_t)f * L, -1, 0, j,
                            __ldg(C + c), __ldg(C + c + 1));
    }
    start[lane] = e.i;
    si0[lane] = e.s0;
    si1[lane] = e.s1;
}

template <class Ix>
int launch(const Ix& ix, const int* C, const uint8_t* codes, const int* flen,
           int F, int L, int* start, int* si0, int* si1, cudaStream_t stream) {
    const int threads = 256;
    const int64_t n = (int64_t)F * L;
    extend_all_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        stream>>>(ix, C, codes, flen, F, L, start, si0, si1);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

KT_EXPORT int kt_extend_all(const int* rec, int nb1, const int* C,
                            const uint8_t* codes, const int* flen, int F,
                            int L, int* start, int* si0, int* si1,
                            cudaStream_t stream) {
    return launch(kt::FlatIx{rec, nb1, nullptr, nullptr, 0, nullptr}, C,
                  codes, flen, F, L, start, si0, si1, stream);
}

KT_EXPORT int kt_extend_all_sharded(KT_SHARD_PARAMS, const int* C,
                                    const uint8_t* codes, const int* flen,
                                    int F, int L, int* start, int* si0,
                                    int* si1, cudaStream_t stream) {
    return launch(KT_SHARD_IX, C, codes, flen, F, L, start, si0, si1, stream);
}
