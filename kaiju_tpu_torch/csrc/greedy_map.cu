// Kernel K: the Greedy engine's level-0 candidate map from kernel B's
// lanes (maxMatches with max_matches = 0, bwt.c:261-296).
//
// Replaces kaiju_tpu/ops/fused_mem2.py:fused_greedy_map (K10, :1011-1065),
// whose funnel is kernel B.  For each fragment f of frag_off, jstop = the
// largest j whose extension reaches i <= 1 (-1 if none; the rule of
// kernel C), and a row (f, j, i, s0, s1) goes out for every lane with
// j >= jstop and j - i + 1 >= lmap.  The rows come in ascending (f, j),
// the plain version's order.  rows must hold P rows (P = lanes, the most
// there can be); n_rows (one int32) receives the count, written by the
// kernel itself, so the caller zeroes nothing.  B evaluates every usable
// lane and a lane it screens out has length 0, so this is the JAX
// program's row set without its capacities (Mout, M2, Ms) and their retry.
//
// Bound: i of every lane (4 bytes a position), frag_off, and for each row
// its lane's s0 and s1 read and 20 bytes written; device-memory bytes at
// 3.35 TB/s.  A fragment's chain is frag_off, then its i, then its rows'
// offset, then the rows' s0 and s1.
//
// Design.  The first design gave a warp to each fragment (eight a block),
// read i in three strided passes (jstop, a ballot count, a ballot write)
// and reserved each fragment's rows with one atomicAdd on n_rows, a
// same-address atomic a fragment that the L2 serializes; the caller
// zeroed n_rows with a second launch.  Here, as in kernel C, a group of
// kG lanes takes a fragment (32 a block), each lane loading its
// positions' i once into kR registers for the jstop maximum, the row
// count and the row ranks (width-kG shuffles and ballots); a fragment
// longer than kG * kR loops over chunks, reading i again from the
// caches.  The offsets of the rows come from a scan: warp 0 scans the
// block's 32 counts, then finds the rows of the blocks before it by a
// decoupled look-back over a status word a block (its count, then its
// inclusive prefix), the warp reading 32 predecessors at a time.  The
// status words carry the launch's epoch, so the words of an earlier
// launch read as not yet written and the buffer is zeroed once, when it
// is allocated, not before each launch; the last block writes n_rows.
// Only the lanes that make a row load their s0 and s1.  Timed and not
// kept (PERF.md §6): the first design with one atomic a block; this
// layout with one atomic a block, n zeroed by a fill launch ahead of it;
// blocks of 1,024 threads; s0 and s1 loaded before the scan; groups of
// 4 lanes; kR = 8.
#include "fm_common.cuh"

namespace {

constexpr int kThreads = 256;  // the most threads a block
constexpr int kG = 8;  // lanes a fragment
// positions a lane holds in registers: 80 a fragment, past the Greedy
// -v batch's longest (73), so that a fragment's i is loaded once
constexpr int kR = 10;
constexpr int kChunk = kG * kR;  // positions of a fragment held at once
constexpr int kFrags = kThreads / kG;  // fragments a block: warp 0's lanes
static_assert(kFrags == 32, "warp 0 scans a fragment a lane");
// blocks an SM holds: registers capped at 42 a thread, so that the
// Greedy -v batch's ~740 blocks run in one wave of 792 (at 8 blocks and
// 32 registers kR = 10 was slower than kR = 8)
constexpr int kBlocksPerSm = 6;
// a block's status word: the launch's epoch (bits 33-63), the flag of an
// inclusive prefix (bit 32) and the count (bits 0-31); epoch 0 never
// launches, so a zeroed word reads as not written
constexpr unsigned long long kIncl = 1ull << 32;

__device__ __forceinline__ unsigned long long status(unsigned epoch,
                                                     bool incl, unsigned v) {
    return ((unsigned long long)epoch << 33) | (incl ? kIncl : 0ull) | v;
}

__device__ __forceinline__ void put(unsigned long long* p,
                                    unsigned long long w) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w)
                 : "memory");
}

__device__ __forceinline__ unsigned long long get(
    const unsigned long long* p) {
    unsigned long long w;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(w)
                 : "l"(p)
                 : "memory");
    return w;
}

// The rows of blocks 0..b-1 (b >= 1), by warp 0 of block b: each lane
// reads one predecessor's status, nearest first, until every lane's is
// of this launch; the sum runs to the nearest inclusive prefix, or over
// all 32 and on to the 32 before.
__device__ unsigned look_back(const unsigned long long* state, int b,
                              unsigned epoch, int lane) {
    unsigned prefix = 0;
    for (int w = b - 1;; w -= 32) {
        const int p = w - lane;
        unsigned long long s = p >= 0 ? get(state + p) : status(epoch, true, 0);
        while (__any_sync(kt::kFullMask, (unsigned)(s >> 33) != epoch))
            if ((unsigned)(s >> 33) != epoch) s = get(state + p);
        const unsigned incl = __ballot_sync(kt::kFullMask, (s & kIncl) != 0);
        const int k = incl ? __ffs(incl) - 1 : 31;  // the nearest prefix
        prefix += __reduce_add_sync(kt::kFullMask,
                                    lane <= k ? (unsigned)s : 0u);
        if (incl) return prefix;
    }
}

__device__ __forceinline__ int group_max(int v, unsigned gmask) {
#pragma unroll
    for (int o = kG / 2; o > 0; o >>= 1)
        v = max(v, __shfl_xor_sync(gmask, v, o, kG));
    return v;
}

__device__ __forceinline__ int group_sum(int v, unsigned gmask) {
#pragma unroll
    for (int o = kG / 2; o > 0; o >>= 1)
        v += __shfl_xor_sync(gmask, v, o, kG);
    return v;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) greedy_map_kernel(
    const int* __restrict__ li, const int* __restrict__ ls0,
    const int* __restrict__ ls1, const int* __restrict__ frag_off, int F,
    int lmap, int* __restrict__ rows, int* __restrict__ n_rows,
    unsigned long long* __restrict__ state, unsigned epoch) {
    __shared__ int s_off[kFrags];  // the group's count, then its offset
    const int nf = blockDim.x / kG;  // fragments of this block
    const int fb = threadIdx.x / kG;
    const int f = blockIdx.x * nf + fb;
    const int lane = threadIdx.x & 31;
    const int gl = lane & (kG - 1);
    const unsigned gmask = kt::group_mask<kG>(lane);
    // a group past F has no position and joins the block's scan with 0
    int st = 0, n = 0;
    if (f < F) {
        st = __ldg(frag_off + f);
        n = __ldg(frag_off + f + 1) - st;
    }
    const bool held = n <= kChunk;  // the whole fragment in registers
    // position c0 + gl + kG * r of the fragment in slot r: j ascends with
    // the lane within a slot and with the slot
    int v[kR];
    auto load = [&](int c0) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
            const int j = c0 + gl + kG * r;
            v[r] = j < n ? __ldg(li + st + j) : 0;
        }
    };

    load(0);
    int jstop = -1;
    for (int c0 = 0; c0 < n; c0 += kChunk) {
        if (c0) load(c0);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
            const int j = c0 + gl + kG * r;
            if (j < n && v[r] <= 1) jstop = j;
        }
    }
    const int j0 = max(group_max(jstop, gmask), 0);
    const int c_first = j0 - j0 % kChunk;
    auto emits = [&](int c0, int r) {
        const int j = c0 + gl + kG * r;
        return j >= j0 && j < n && j - v[r] + 1 >= lmap;
    };

    int cnt = 0;
    for (int c0 = c_first; c0 < n; c0 += kChunk) {
        if (!held) load(c0);
#pragma unroll
        for (int r = 0; r < kR; ++r) cnt += emits(c0, r);
    }
    cnt = group_sum(cnt, gmask);
    if (gl == 0) s_off[fb] = cnt;
    __syncthreads();
    if (threadIdx.x < 32) {
        const int c = lane < nf ? s_off[lane] : 0;
        const int incl = kt::warp_incl_sum(c, lane);
        const unsigned total = __shfl_sync(kt::kFullMask, incl, 31);
        unsigned base = 0;
        if (blockIdx.x == 0) {
            if (lane == 0) put(state, status(epoch, true, total));
        } else {
            if (lane == 0) put(state + blockIdx.x, status(epoch, false, total));
            base = look_back(state, blockIdx.x, epoch, lane);
            if (lane == 0)
                put(state + blockIdx.x, status(epoch, true, base + total));
        }
        if (lane < nf) s_off[lane] = (int)base + incl - c;
        if (lane == 0 && blockIdx.x == gridDim.x - 1)
            *n_rows = (int)(base + total);
    }
    __syncthreads();
    if (cnt == 0) return;  // uniform in the group

    int slot = s_off[fb];
    for (int c0 = c_first; c0 < n; c0 += kChunk) {
        if (!held) load(c0);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
            if (c0 + kG * r >= n) break;  // uniform in the group
            const int j = c0 + gl + kG * r;
            const bool e = emits(c0, r);
            const unsigned m = __ballot_sync(gmask, e) & gmask;
            if (e) {
                int* row = rows + (size_t)(slot + __popc(
                                               m & kt::lanes_below(lane))) * 5;
                row[0] = f;
                row[1] = j;
                row[2] = v[r];
                row[3] = __ldg(ls0 + st + j);
                row[4] = __ldg(ls1 + st + j);
            }
            slot += __popc(m);
        }
    }
}

}  // namespace

// state: the look-back's status words, state_len of them (at least the
// grid's blocks, ceil(F * kG / kThreads)), zeroed when allocated and
// kept for the next launch on the same stream; epoch: this launch's,
// 1..2^31 - 1 and not that of the launch before it on the buffer.
KT_EXPORT int kt_greedy_map(const int* li, const int* ls0, const int* ls1,
                            const int* frag_off, int F, int lmap, int* rows,
                            int* n_rows, unsigned long long* state,
                            int state_len, int epoch, cudaStream_t stream) {
    const long long lanes = (long long)F * kG;
    // one small block for a few fragments (the lazy one-fragment launch)
    const int threads =
        lanes < kThreads ? (int)((lanes + 31) / 32 * 32) : kThreads;
    const long long blocks = (lanes + threads - 1) / threads;
    if (F <= 0 || blocks > state_len || epoch <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    greedy_map_kernel<<<(int)blocks, threads, 0, stream>>>(
        li, ls0, ls1, frag_off, F, lmap, rows, n_rows, state,
        (unsigned)epoch);
    return static_cast<int>(cudaGetLastError());
}
