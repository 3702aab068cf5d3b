// Kernel B: the maximal backward extension (i, s0, s1) of every lane
// (fragment, end position j) of a batch of fragments.
//
// Replaces kaiju_tpu/ops/fused_mem2.py:_search_phases (K6: lanes, K-mer
// ids and the Bloom screen, _bloom_hash and its probes at :728-737,
// :781-791, :851-859) and _staged_extend (K7: seed, burn-in and
// completion), with the rank of K1.  The JAX program compacts lanes
// through a capacity ladder because TPU gathers are row-rate bound; here
// each lane is one thread that runs its own data-dependent loop, so there
// are no capacities and no retry.
//
// Contract (kept exactly, mem_stats and greedy_search read it): a lane
// with j >= j0 and j < flen is usable.  With a bitmap (words, m, lb), a
// usable lane whose trailing m codes hash to a clear bit is not evaluated:
// h = sum_t flat[p - t] * A^t over t < m (uint32 wrap, A = 0x01000193),
// bit (h * 0x9E3779B1) >> (32 - lb), as native/bloom.cpp fills it.  An
// evaluated lane seeds from the K-mer tables with the id of the K codes
// ending at j (rightmost code weight 1); d = the depth reached.  It gets
// i = j - d + 1 (i = j when d == 0) and the table interval; a lane with
// d == K and i > 0 then steps backward, one rank pair per code, until the
// interval empties or i reaches 0.  With sw_steps > 0 (the text-compare
// hybrid) a lane whose interval holds at most kSwWcap occurrences after
// exactly sw_steps steps, with i > 0, stops there: kernel G finishes it.
// The match spans [i, j].  Lanes that are not evaluated return
// (j + 1, 0, 0), a length-0 result.
//
// Bound: two random 256-byte record rows per FM step, plus the flat codes
// and the seed rows; device-memory bytes at 3.35 TB/s.  Design: one
// thread per flat position; the owning fragment comes from a binary
// search over frag_off, which stays in L1/L2; the bitmap probe is one
// random 4-byte read that ends most junk lanes before their seed.
//
// kt_mem_extend_sharded runs the same on an index split into shards
// (kt::ShardIx): the search phases of K16e,
// kaiju_tpu/parallel/sharded_fused.py:make_sharded_mem_classify
// (:178-275), on the owner-computes rank of _make_rank1 (:52-75).
#include "text_common.cuh"

namespace {

template <class Ix>
__global__ void mem_extend_kernel(
    const Ix ix, const int* __restrict__ C,
    const int* __restrict__ seed_s0, const int* __restrict__ seed_s1,
    const int8_t* __restrict__ seed_d, int nseed,
    const uint8_t* __restrict__ flat, int P,
    const int* __restrict__ frag_off, int F, int K, int j0,
    const unsigned* __restrict__ words, int m, int lb, int sw_steps,
    int* __restrict__ out_i, int* __restrict__ out_s0,
    int* __restrict__ out_s1) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    // owning fragment: the largest f < F with frag_off[f] <= p (an empty
    // fragment shares its start with the next one, which owns it)
    int lo = 0, hi = F - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (__ldg(frag_off + mid) <= p) lo = mid; else hi = mid - 1;
    }
    const int base = __ldg(frag_off + lo);
    const int j = p - base;
    const int flen = __ldg(frag_off + lo + 1) - base;
    int i = j + 1, a0 = 0, a1 = 0;
    bool eval = j >= j0 && j < flen;
    if (eval && words != nullptr) {
        unsigned h = 0, at = 1;
        for (int t = 0; t < m; ++t) {
            h += (unsigned)flat[p - t] * at;
            at *= 0x01000193u;
        }
        const unsigned bit = (h * 0x9E3779B1u) >> (32 - lb);
        eval = (__ldg(words + (bit >> 5)) >> (bit & 31)) & 1u;
    }
    if (eval) {
        int kid = 0, mul = 1;
        for (int t = 0; t < K; ++t) {
            kid += ((int)flat[p - t] - 1) * mul;
            mul *= 20;
        }
        kid = min(max(kid, 0), nseed - 1);
        const int d = seed_d[kid];
        a0 = seed_s0[kid];
        a1 = seed_s1[kid];
        i = d > 0 ? j - d + 1 : j;
        if (d == K) {
            for (int steps = 1; i > 0; ++steps) {
                const int c = flat[base + i - 1];
                const int n0 = kt::rank(ix, C, c, a0);
                const int n1 = kt::rank(ix, C, c, a1);
                if (n0 >= n1) break;
                a0 = n0;
                a1 = n1;
                --i;
                if (steps == sw_steps && i > 0 && a1 - a0 <= kt::kSwWcap)
                    break;
            }
        }
    }
    out_i[p] = i;
    out_s0[p] = a0;
    out_s1[p] = a1;
}

template <class Ix>
int launch(const Ix& ix, const int* C, const int* seed_s0,
           const int* seed_s1, const int8_t* seed_d, int nseed,
           const uint8_t* flat, int P, const int* frag_off, int F, int K,
           int j0, const unsigned* words, int m, int lb, int sw_steps,
           int* out_i, int* out_s0, int* out_s1, cudaStream_t stream) {
    const int threads = 256;
    mem_extend_kernel<<<(P + threads - 1) / threads, threads, 0, stream>>>(
        ix, C, seed_s0, seed_s1, seed_d, nseed, flat, P, frag_off, F, K, j0,
        words, m, lb, sw_steps, out_i, out_s0, out_s1);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

KT_EXPORT int kt_mem_extend(const int* rec, int nb1, const int* C,
                            const int* seed_s0, const int* seed_s1,
                            const int8_t* seed_d, int nseed,
                            const uint8_t* flat, int P, const int* frag_off,
                            int F, int K, int j0, const unsigned* words,
                            int m, int lb, int sw_steps, int* out_i,
                            int* out_s0, int* out_s1, cudaStream_t stream) {
    return launch(kt::FlatIx{rec, nb1, nullptr, nullptr, 0, nullptr}, C,
                  seed_s0, seed_s1, seed_d, nseed, flat, P, frag_off, F, K,
                  j0, words, m, lb, sw_steps, out_i, out_s0, out_s1, stream);
}

KT_EXPORT int kt_mem_extend_sharded(
    KT_SHARD_PARAMS, const int* C, const int* seed_s0, const int* seed_s1,
    const int8_t* seed_d, int nseed, const uint8_t* flat, int P,
    const int* frag_off, int F, int K, int j0, const unsigned* words, int m,
    int lb, int sw_steps, int* out_i, int* out_s0, int* out_s1,
    cudaStream_t stream) {
    return launch(KT_SHARD_IX, C, seed_s0, seed_s1, seed_d, nseed, flat, P,
                  frag_off, F, K, j0, words, m, lb, sw_steps, out_i, out_s0,
                  out_s1, stream);
}
