// Kernel B: the maximal backward extension (i, s0, s1) of every lane
// (fragment, end position j) of a batch of fragments.
//
// Replaces kaiju_tpu/ops/fused_mem2.py:_search_phases (K6: lanes and
// K-mer ids; its Bloom stage is not on this path) and _staged_extend
// (K7: seed, burn-in and completion), with the rank of K1.  The JAX
// program compacts lanes through a capacity ladder because TPU gathers
// are row-rate bound; here each lane is one thread that runs its own
// data-dependent loop, so there are no capacities and no retry.
//
// Contract (kept exactly, mem_stats reads it): a lane with j >= j0 and
// j < flen seeds from the K-mer tables with the id of the K codes ending
// at j (rightmost code weight 1); d = the depth reached.  It gets
// i = j - d + 1 (i = j when d == 0) and the table interval; a lane with
// d == K and i > 0 then steps backward, one rank pair per code, until the
// interval empties or i reaches 0.  The match spans [i, j].  Lanes that
// are not evaluated return (j + 1, 0, 0), a length-0 result.
//
// Bound: two random 256-byte record rows per FM step, plus the flat codes
// and the seed rows; device-memory bytes at 3.35 TB/s.  Design: one
// thread per flat position; the owning fragment comes from a binary
// search over frag_off, which stays in L1/L2.
#include "fm_common.cuh"

namespace {

__global__ void mem_extend_kernel(
    const int* __restrict__ rec, int nb1, const int* __restrict__ C,
    const int* __restrict__ seed_s0, const int* __restrict__ seed_s1,
    const int8_t* __restrict__ seed_d, int nseed,
    const uint8_t* __restrict__ flat, int P,
    const int* __restrict__ frag_off, int F, int K, int j0,
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
    if (j >= j0 && j < flen) {
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
            while (i > 0) {
                const int c = flat[base + i - 1];
                const int n0 = kt::rank(rec, nb1, C, c, a0);
                const int n1 = kt::rank(rec, nb1, C, c, a1);
                if (n0 >= n1) break;
                a0 = n0;
                a1 = n1;
                --i;
            }
        }
    }
    out_i[p] = i;
    out_s0[p] = a0;
    out_s1[p] = a1;
}

}  // namespace

KT_EXPORT int kt_mem_extend(const int* rec, int nb1, const int* C,
                            const int* seed_s0, const int* seed_s1,
                            const int8_t* seed_d, int nseed,
                            const uint8_t* flat, int P, const int* frag_off,
                            int F, int K, int j0, int* out_i, int* out_s0,
                            int* out_s1, cudaStream_t stream) {
    const int threads = 256;
    mem_extend_kernel<<<(P + threads - 1) / threads, threads, 0, stream>>>(
        rec, nb1, C, seed_s0, seed_s1, seed_d, nseed, flat, P, frag_off, F,
        K, j0, out_i, out_s0, out_s1);
    return static_cast<int>(cudaGetLastError());
}
