// Kernels L and M: the int64 owner-computes MEM step over an index of
// more than 2^31 letters (K17), on the shards of kt::BigShardIx.
//
// Replaces scripts/big_classify_demo.py:make_mesh_mem_step (:253-420), a
// jitted shard_map whose every FM step assembles the owner's count with a
// psum over the index axis and steps all lanes in lockstep.  On one card
// each lane reads its owner's row directly and runs on its own; the
// outputs are the same, lane for lane.
//
// L (kt_big_extend_all, :296-329): for every lane (r, j) of read codes
// uint8 [R, L], the maximal backward extension of the match ending at j:
// a lane on letter c0 > 0 starts from [C[c0], C[c0 + 1]) with i = j and
// extends one letter a step while i > 0, the letter before is not 0 and
// the interval stays non-empty.  A lane on code 0 keeps i = j and the
// interval of letter 1, [C[1], C[2]), as the JAX program leaves it.
// Out: i int32, s0 and s1 int64 [R, L].
//
// M (kt_big_sa_walk, :332-406): for every SA row kf int64 [n] (-1: no
// walk) the content-rank sequence id int64 [n] of kt::sa_walk64, -1 where
// kf < 0.
//
// Bound: L reads two random 256-byte record rows a step taken, M one a
// LF step; both read their lanes and write their outputs once.  Device-
// memory bytes at 3.35 TB/s; the walks are chains of dependent row
// reads.  Design: one thread a lane (the lanes of a read side by side in
// a warp, so neighbouring threads read neighbouring code bytes), many
// lanes in flight to hide the latency of each chain.
#include "big_common.cuh"

namespace {

__global__ void big_extend_all_kernel(const kt::BigShardIx ix,
                                      const uint8_t* __restrict__ codes,
                                      int R, int L, int* __restrict__ out_i,
                                      int64_t* __restrict__ out_s0,
                                      int64_t* __restrict__ out_s1) {
    const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= (int64_t)R * L) return;
    const int j = (int)(lane % L);
    const uint8_t* row = codes + (lane - j);
    const int c0 = __ldg(row + j);
    const int c = c0 > 0 ? c0 : 1;
    int64_t s0 = kt::ldg64(ix.C + c);
    int64_t s1 = kt::ldg64(ix.C + c + 1);
    int i = j;
    if (c0 > 0) {
        while (i > 0) {
            const int x = __ldg(row + i - 1);
            if (x == 0) break;
            const int64_t n0 = kt::rank64(ix, x, s0);
            const int64_t n1 = kt::rank64(ix, x, s1);
            if (n0 >= n1) break;
            s0 = n0;
            s1 = n1;
            --i;
        }
    }
    out_i[lane] = i;
    out_s0[lane] = s0;
    out_s1[lane] = s1;
}

__global__ void big_sa_walk_kernel(const kt::BigShardIx ix,
                                   const int64_t* __restrict__ kf, int64_t n,
                                   int64_t* __restrict__ ids) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n) return;
    const int64_t k = kt::ldg64(kf + t);
    ids[t] = k < 0 ? -1 : kt::sa_walk64(ix, k);
}

constexpr int kThreads = 256;

unsigned blocks_for(int64_t n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// The arguments that describe the big index: rec_tab (device array of S
// shard pointers) nb_s S C base alen.
KT_EXPORT int kt_big_extend_all(const int* const* rec_tab, int nb_s, int S,
                                const int64_t* C, const int64_t* base,
                                int alen, const uint8_t* codes, int R, int L,
                                int* out_i, int64_t* out_s0, int64_t* out_s1,
                                cudaStream_t stream) {
    const kt::BigShardIx ix{rec_tab, nb_s, S, C, base, alen,
                            nullptr, 0, 0, 0};
    big_extend_all_kernel<<<blocks_for((int64_t)R * L), kThreads, 0,
                            stream>>>(ix, codes, R, L, out_i, out_s0, out_s1);
    return static_cast<int>(cudaGetLastError());
}

KT_EXPORT int kt_big_sa_walk(const int* const* rec_tab, int nb_s, int S,
                             const int64_t* C, const int64_t* base, int alen,
                             const int* const* seq_tab, int ns_s,
                             int64_t first, int e, const int64_t* kf,
                             int64_t n, int64_t* ids, cudaStream_t stream) {
    const kt::BigShardIx ix{rec_tab, nb_s, S, C, base, alen,
                            seq_tab, ns_s, first, e};
    big_sa_walk_kernel<<<blocks_for(n), kThreads, 0, stream>>>(ix, kf, n,
                                                               ids);
    return static_cast<int>(cudaGetLastError());
}
