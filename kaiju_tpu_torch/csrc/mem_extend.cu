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
//
// Kernel O (kt_mem_extend_hosts) is B for a group of processes on several
// hosts (kt::HostIx): the same pass 1 (seed_and_list), then each listed
// lane steps while both rows of its step lie on this host; at a row that
// no process of the host holds it parks with its rank-pair queries, which
// the owners answer (kernel N, fm_serve.cu) in rounds
// (parallel/exchange.py), and the resume form applies the answers and
// steps on.  With sw_steps > 0 (the hybrid across hosts) a lane stops as
// B stops it, after exactly sw_steps steps with at most kSwWcap
// occurrences and i > 0, and kernel Y (switch_hosts.cu) finishes it; its
// step count needs no room in the parked record: a lane at flat position
// p whose next code is at q has taken p - K - q steps.  Its lanes' final
// (i, s0, s1) are B's.  Bound: B's, plus one row a parked step at its
// owner.  Design: B's block list in the start form; a parked lane carries
// q in its record (p, i, s0, s1, q; the record stays in the process, only
// the queries travel), so the resume form starts stepping at once, with
// no search over frag_off for the lane's fragment, and a group of kG
// threads takes one parked lane, from its first step until it ends or
// parks again; one global atomic a parked lane.
#include "text_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 2;     // positions a thread in pass 1
constexpr int kG = 4;       // threads sharing a listed lane's rank pair
constexpr int kPos = kThreads * kPer;   // positions a block
constexpr int kOffCap = 512;            // fragment starts staged a block
constexpr int kParked = 5;  // kernel O's parked record: p, i, s0, s1, q

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

// The block's share of the positions, [p0, p0 + kPos): its fragment
// starts staged in shared memory, then pass 1 (a position a thread): the
// screen, the seed, and every lane that ends there written; a lane that
// steps is appended to the block's list s_item (a ballot and one shared
// atomic a warp).  Returns the list's length, after a barrier.
__device__ __forceinline__ int seed_and_list(
    const int* __restrict__ seed_s0, const int* __restrict__ seed_s1,
    const int8_t* __restrict__ seed_d, int nseed,
    const uint8_t* __restrict__ flat, int P,
    const int* __restrict__ frag_off, int F, int K, int j0,
    const unsigned* __restrict__ words, int m, int lb,
    int* __restrict__ out_i, int* __restrict__ out_s0,
    int* __restrict__ out_s1, int* s_off, int4* s_item, int& s_f0,
    int& s_f1, int& s_n, int& s_next) {
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
    return s_n;
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
    const int lane = threadIdx.x & 31;
    const int n = seed_and_list(seed_s0, seed_s1, seed_d, nseed, flat, P,
                                frag_off, F, K, j0, words, m, lb, out_i,
                                out_s0, out_s1, s_off, s_item, s_f0, s_f1,
                                s_n, s_next);

    // ---- pass 2: the listed lanes, each group of kG threads taking the
    // next one as soon as its own ends
    constexpr int G = kG;
    const int gl = lane % G;
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

// ---- kernel O: B over the shards of a group on several hosts -----------

// A's lane p at (i, a0, a1), q = the flat index of the code before i,
// stepped by a group of kG threads through kt::rank2 while both rows lie
// on this host (i > 0 on entry), and, with sw_steps > 0, until B's
// hybrid stop after sw_steps steps (p - K - q of them taken); then its
// result is written, or, at a row of a remote shard, the lane parks: (p,
// i, a0, a1, q) to park [*n_park] with its rank-pair queries (kQRank c,
// a0), (kQRank c, a1) to qry, its state written as its result for now.
__device__ __forceinline__ void run_lane(
    const kt::HostIx& ix, const int* __restrict__ C,
    const uint8_t* __restrict__ flat, int K, int sw_steps, int p, int i,
    int a0, int a1, int q, int gl, unsigned gmask, int* __restrict__ out_i,
    int* __restrict__ out_s0, int* __restrict__ out_s1,
    int* __restrict__ park, int* __restrict__ qry, int* __restrict__ n_park) {
    while (i > 0) {
        if (sw_steps > 0 && p - K - q == sw_steps &&
            a1 - a0 <= kt::kSwWcap)
            break;  // the hybrid's stop: kernel Y finishes the lane
        const int c = __ldg(flat + q);
        if (!ix.row_here(a0 >> 7) || !ix.row_here(a1 >> 7)) {
            if (gl == 0) {
                const int s = atomicAdd(n_park, 1);
                int* rec = park + kParked * (size_t)s;
                rec[0] = p;
                rec[1] = i;
                rec[2] = a0;
                rec[3] = a1;
                rec[4] = q;
                reinterpret_cast<int4*>(qry)[s] = make_int4(
                    kt::kQRank << 8 | c, a0, kt::kQRank << 8 | c, a1);
            }
            break;
        }
        int n0, n1;
        kt::rank2<kG>(ix, C, c, a0, a1, gl, gmask, &n0, &n1);
        if (n0 >= n1) break;
        a0 = n0;
        a1 = n1;
        --i;
        --q;
    }
    if (gl == 0) {
        out_i[p] = i;
        out_s0[p] = a0;
        out_s1[p] = a1;
    }
}

__global__ void __launch_bounds__(kThreads) mem_extend_hosts_kernel(
    const kt::HostIx ix, const int* __restrict__ C,
    const int* __restrict__ seed_s0, const int* __restrict__ seed_s1,
    const int8_t* __restrict__ seed_d, int nseed,
    const uint8_t* __restrict__ flat, int P,
    const int* __restrict__ frag_off, int F, int K, int j0,
    const unsigned* __restrict__ words, int m, int lb, int sw_steps,
    int* __restrict__ out_i, int* __restrict__ out_s0,
    int* __restrict__ out_s1, int* __restrict__ park,
    int* __restrict__ qry, int* __restrict__ n_park) {
    __shared__ int s_off[kOffCap + 1];
    __shared__ int4 s_item[kPos];  // a listed lane: p, i, s0, s1
    __shared__ int s_f0, s_f1, s_n, s_next;
    const int lane = threadIdx.x & 31, gl = lane % kG;
    const unsigned gmask = kt::group_mask<kG>(lane);
    const int n = seed_and_list(seed_s0, seed_s1, seed_d, nseed, flat, P,
                                frag_off, F, K, j0, words, m, lb, out_i,
                                out_s0, out_s1, s_off, s_item, s_f0, s_f1,
                                s_n, s_next);
    for (;;) {  // each group takes the next listed lane
        int idx = gl == 0 ? atomicAdd(&s_next, 1) : 0;
        idx = __shfl_sync(gmask, idx, 0, kG);
        if (idx >= n) return;
        const int4 it = s_item[idx];
        run_lane(ix, C, flat, K, sw_steps, it.x, it.y, it.z, it.w, it.x - K,
                 gl, gmask, out_i, out_s0, out_s1, park, qry, n_park);
    }
}

// The parked lanes park_in [L, kParked] with their answers ans_in [L, 2]
// (the rank pair), a group of kG threads a lane: the step applied as B
// applies it, then run_lane on from the parked q, less one.
__global__ void __launch_bounds__(kThreads) mem_extend_resume_kernel(
    const kt::HostIx ix, const int* __restrict__ C,
    const uint8_t* __restrict__ flat, int K, int sw_steps,
    const int* __restrict__ park_in, const int* __restrict__ ans_in, int L,
    int* __restrict__ out_i, int* __restrict__ out_s0,
    int* __restrict__ out_s1, int* __restrict__ park,
    int* __restrict__ qry, int* __restrict__ n_park) {
    const int t = (blockIdx.x * kThreads + threadIdx.x) / kG;
    if (t >= L) return;  // whole groups leave together
    const int lane = threadIdx.x & 31, gl = lane % kG;
    const unsigned gmask = kt::group_mask<kG>(lane);
    const int* rec = park_in + kParked * (size_t)t;
    const int p = __ldg(rec), n0 = __ldg(ans_in + 2 * (size_t)t),
              n1 = __ldg(ans_in + 2 * (size_t)t + 1);
    int i = __ldg(rec + 1), a0 = __ldg(rec + 2), a1 = __ldg(rec + 3);
    const bool stepped = n0 < n1;  // else the interval emptied: it ends
    if (stepped) {
        a0 = n0;
        a1 = n1;
        --i;
    }
    if (stepped && i > 0) {
        run_lane(ix, C, flat, K, sw_steps, p, i, a0, a1, __ldg(rec + 4) - 1,
                 gl, gmask, out_i, out_s0, out_s1, park, qry, n_park);
    } else if (gl == 0) {
        out_i[p] = i;
        out_s0[p] = a0;
        out_s1[p] = a1;
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

// Kernel O: the start form (park_in null) runs B's pass 1 and then pass 2
// on kt::HostIx, parking the lanes that need a remote row; the resume form
// takes the parked lanes park_in [L, 5] and their answers ans_in [L, 2]
// (frag_off unread: a parked lane carries its q).  Both append to park_out
// [*n_park, 5] and q_out [*n_park, 2, 2].  sw_steps: 0, or the steps
// after which the hybrid's narrow lanes stop.
KT_EXPORT int kt_mem_extend_hosts(
    KT_SHARD_PARAMS, const int* C, const int* seed_s0, const int* seed_s1,
    const int8_t* seed_d, int nseed, const uint8_t* flat, int P,
    const int* frag_off, int F, int K, int j0, const unsigned* words, int m,
    int lb, int sw_steps, const int* park_in, const int* ans_in, int L,
    int* out_i,
    int* out_s0, int* out_s1, int* park_out, int* q_out, int* n_park,
    cudaStream_t stream) {
    if (park_in == nullptr) {
        mem_extend_hosts_kernel<<<(P + kPos - 1) / kPos, kThreads, 0,
                                  stream>>>(
            KT_HOST_IX, C, seed_s0, seed_s1, seed_d, nseed, flat, P,
            frag_off, F, K, j0, words, m, lb, sw_steps, out_i, out_s0,
            out_s1, park_out, q_out, n_park);
    } else if (L > 0) {
        const long long threads = (long long)L * kG;
        mem_extend_resume_kernel<<<(int)((threads + kThreads - 1) / kThreads),
                                   kThreads, 0, stream>>>(
            KT_HOST_IX, C, flat, K, sw_steps, park_in, ans_in, L, out_i,
            out_s0, out_s1, park_out, q_out, n_park);
    }
    return static_cast<int>(cudaGetLastError());
}
