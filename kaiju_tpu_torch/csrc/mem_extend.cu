// Kernel B: the maximal backward extension (i, s0, s1) of every lane
// (fragment, end position j) of a batch of fragments.
//
// Replaces kaiju_tpu/ops/fused_mem2.py:_search_phases (K6: lanes, K-mer
// ids and the Bloom screen, _bloom_hash and its probes at :728-737,
// :781-791, :851-859) and _staged_extend (K7: seed, burn-in and
// completion), with the paired rank of K1 (fused_greedy.py:_paired_rank2).
// The JAX program compacts lanes through a capacity ladder because TPU
// gathers are row-rate bound; here a block compacts its own lanes in
// shared memory, so there are no capacities and no retry.
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
// and the seed rows; device-memory bytes at 3.35 TB/s.  But a lane's steps
// are a chain of dependent row reads (up to a read's length), and the
// rows of a 64 Maa index (128 MB) do not fit the L2: the kernel is bound
// by how many steps' random row sectors the memory system serves.  The
// first design (one thread per position) spent a 15-load dependent
// binary search over frag_off before any work, kept the warps of screened
// or seed-ended lanes mostly idle, waited in every warp for its slowest
// lane, and scanned both ends of a step with a thread's own loads, up to
// 9 scattered loads a rank.
// Design: a block takes kPos positions.  Two threads find the owners of
// its first and last position; the fragment starts between them are
// staged in shared memory, where each position's owner is searched.  Pass
// 1, a position a thread: the screen, the seed, and every lane that ends
// there is written; a lane that steps is appended to the block's list in
// shared memory (a ballot and one shared atomic a warp).  Pass 2: each
// group of kG = 4 threads takes the next listed lane as soon as its own
// ends and runs its FM steps through kt::rank2<4>: one row for both ends
// when they share a block, each thread loading one or two of its 16-byte
// groups, so that a step reads whole sectors in one memory latency; the
// warps stay full until the list drains.  Nothing is allocated: the list
// is the block's.
//
// kt_mem_extend_sharded runs the same on an index split into shards
// (kt::ShardIx): the search phases of K16e,
// kaiju_tpu/parallel/sharded_fused.py:make_sharded_mem_classify
// (:178-275), on the owner-computes rank of _make_rank1 (:52-75).
#include "text_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 2;     // positions a thread in pass 1
constexpr int kG = 4;       // threads sharing a listed lane's rank pair
constexpr int kPos = kThreads * kPer;   // positions a block
constexpr int kOffCap = 512;            // fragment starts staged a block

// The owning fragment of position p: the largest f < F with frag_off[f]
// <= p (an empty fragment shares its start with the next one, which owns
// it).
__device__ __forceinline__ int owner(const int* __restrict__ frag_off,
                                     int lo, int hi, int p) {
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (frag_off[mid] <= p) lo = mid; else hi = mid - 1;
    }
    return lo;
}

template <class Ix>
__global__ void __launch_bounds__(kThreads) mem_extend_kernel(
    const Ix ix, const int* __restrict__ C,
    const int* __restrict__ seed_s0, const int* __restrict__ seed_s1,
    const int8_t* __restrict__ seed_d, int nseed,
    const uint8_t* __restrict__ flat, int P,
    const int* __restrict__ frag_off, int F, int K, int j0,
    const unsigned* __restrict__ words, int m, int lb, int sw_steps,
    int* __restrict__ out_i, int* __restrict__ out_s0,
    int* __restrict__ out_s1) {
    __shared__ int s_off[kOffCap + 1];
    __shared__ int4 s_item[kPos];  // a listed lane: p, i, s0, s1
    __shared__ int s_f0, s_f1, s_n, s_next;
    const int tid = threadIdx.x, lane = tid & 31;
    const int p0 = blockIdx.x * kPos;
    if (tid == 0) {
        s_f0 = owner(frag_off, 0, F - 1, p0);
        s_n = 0;
        s_next = 0;
    } else if (tid == 32) {
        s_f1 = owner(frag_off, 0, F - 1, min(p0 + kPos, P) - 1);
    }
    __syncthreads();
    const int f0 = s_f0, nf = s_f1 - s_f0 + 1;  // fragments owning a lane
    const bool staged = nf <= kOffCap;
    if (staged)
        for (int t = tid; t <= nf; t += kThreads) s_off[t] = frag_off[f0 + t];
    __syncthreads();

    // ---- pass 1: screen and seed every position, list the lanes that step
    for (int r = 0; r < kPer; ++r) {
        const int p = p0 + r * kThreads + tid;
        bool listed = false;
        int i = 0, a0 = 0, a1 = 0;
        if (p < P) {
            int base, flen;
            if (staged) {
                const int t = owner(s_off, 0, nf - 1, p);
                base = s_off[t];
                flen = s_off[t + 1] - base;
            } else {
                const int f = owner(frag_off, s_f0, s_f1, p);
                base = __ldg(frag_off + f);
                flen = __ldg(frag_off + f + 1) - base;
            }
            const int j = p - base;
            i = j + 1;
            bool eval = j >= j0 && j < flen;
            if (eval && words != nullptr) {
                unsigned h = 0, at = 1;
                for (int t = 0; t < m; ++t) {
                    h += (unsigned)__ldg(flat + p - t) * at;
                    at *= 0x01000193u;
                }
                const unsigned bit = (h * 0x9E3779B1u) >> (32 - lb);
                eval = (__ldg(words + (bit >> 5)) >> (bit & 31)) & 1u;
            }
            if (eval) {
                int kid = 0, mul = 1;
                for (int t = 0; t < K; ++t) {
                    kid += ((int)__ldg(flat + p - t) - 1) * mul;
                    mul *= 20;
                }
                kid = min(max(kid, 0), nseed - 1);
                const int d = __ldg(seed_d + kid);
                a0 = __ldg(seed_s0 + kid);
                a1 = __ldg(seed_s1 + kid);
                i = d > 0 ? j - d + 1 : j;
                listed = d == K && i > 0;
            }
            if (!listed) {
                out_i[p] = i;
                out_s0[p] = a0;
                out_s1[p] = a1;
            }
        }
        const unsigned bal = __ballot_sync(kt::kFullMask, listed);
        int slot = 0;
        if (lane == 0 && bal) slot = atomicAdd(&s_n, __popc(bal));
        slot = __shfl_sync(kt::kFullMask, slot, 0) +
               __popc(bal & kt::lanes_below(lane));
        if (listed) s_item[slot] = make_int4(p, i, a0, a1);
    }
    __syncthreads();

    // ---- pass 2: the listed lanes, each group of kG threads taking the
    // next one as soon as its own ends
    constexpr int G = kG;
    const int n = s_n, gl = lane % G;
    const unsigned gmask = kt::group_mask<G>(lane);
    int idx = gl == 0 ? atomicAdd(&s_next, 1) : 0;
    idx = __shfl_sync(gmask, idx, 0, G);
    int p = 0, i = 0, a0 = 0, a1 = 0, q = 0, steps = 0;
    if (idx < n) {
        const int4 it = s_item[idx];
        p = it.x, i = it.y, a0 = it.z, a1 = it.w;
        q = p - K;  // flat index of the code before i: base + i - 1
    }
    while (idx < n) {
        int n0, n1;
        kt::rank2<G>(ix, C, __ldg(flat + q), a0, a1, gl, gmask, &n0, &n1);
        bool done = n0 >= n1;
        if (!done) {
            a0 = n0;
            a1 = n1;
            --i;
            --q;
            ++steps;
            done = i == 0 ||
                   (steps == sw_steps && a1 - a0 <= kt::kSwWcap);
        }
        if (done) {
            if (gl == 0) {
                out_i[p] = i;
                out_s0[p] = a0;
                out_s1[p] = a1;
                idx = atomicAdd(&s_next, 1);
            }
            idx = __shfl_sync(gmask, idx, 0, G);
            if (idx < n) {
                const int4 it = s_item[idx];
                p = it.x, i = it.y, a0 = it.z, a1 = it.w;
                q = p - K;
                steps = 0;
            }
        }
    }
}

template <class Ix>
int launch(const Ix& ix, const int* C, const int* seed_s0,
           const int* seed_s1, const int8_t* seed_d, int nseed,
           const uint8_t* flat, int P, const int* frag_off, int F, int K,
           int j0, const unsigned* words, int m, int lb, int sw_steps,
           int* out_i, int* out_s0, int* out_s1, cudaStream_t stream) {
    mem_extend_kernel<<<(P + kPos - 1) / kPos, kThreads, 0, stream>>>(
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
