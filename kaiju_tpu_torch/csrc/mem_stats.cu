// Kernel C: per-fragment greedyExact statistics from the lanes' maximal
// extensions (ConsumerThread.cpp:543-628, bwt.c:347-380).
//
// Replaces kaiju_tpu/ops/fused_mem2.py:_mem_stats (K9): rows 0..F-1 of
// fused_mem_search2's packed output.  With jstop = the largest j whose
// extension reaches query position i <= 1 (-1 if none), maxl = the largest
// l_j = j - i_j + 1 over j >= jstop with l_j >= min_len (0 if none), and
// the ties are the j >= jstop with l_j == maxl > 0, in ascending j.  The
// first T ties are stored (tie_j = -1 and a zero interval past them);
// tie_cnt is not capped.  The scan order the reference uses does not
// matter (kaiju_tpu/engine/mem_fast.py:1-17), so every lane is read.
//
// Bound: one pass over the lanes' i (4 bytes a position), the (s0, s1) of
// the stored ties and the outputs; device-memory bytes at 3.35 TB/s.  A
// fragment's chain is frag_off, then its i, then the ties' (s0, s1): three
// dependent loads.  The first design gave a warp to each fragment (about
// 25 positions on the MEM path, so most lanes idle) and read i in three
// strided passes; ~4 waves of warps each waited that chain.  Design: a
// group of kG lanes a fragment (four fragments a warp), each lane loading
// its positions' i once into registers, kR of them, and keeping them for
// the three reductions (width-kG shuffles); a fragment longer than the
// group's kG * kR registers loops over chunks, reading i again from the
// caches.  A tie's rank is its group's running count plus the ties of the
// lanes below in a ballot of one register slot, so the ties stay in
// ascending j; only the first T ties load their (s0, s1).
#include "fm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kG = 8;  // lanes a fragment
constexpr int kR = 8;  // positions a lane holds in registers
constexpr int kChunk = kG * kR;  // positions of a fragment held at once
// blocks an SM holds: registers capped at 32 a thread, so that the MEM
// batch's ~850 blocks run in one wave (48 registers held five an SM)
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ int group_max(int v, unsigned gmask) {
#pragma unroll
    for (int o = kG / 2; o > 0; o >>= 1)
        v = max(v, __shfl_xor_sync(gmask, v, o, kG));
    return v;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) mem_stats_kernel(
    const int* __restrict__ li, const int* __restrict__ ls0,
    const int* __restrict__ ls1, const int* __restrict__ frag_off, int F,
    int min_len, int T, int* __restrict__ maxl, int* __restrict__ tie_cnt,
    int* __restrict__ tie_j, int* __restrict__ tie_s0,
    int* __restrict__ tie_s1) {
    const int f = (blockIdx.x * kThreads + threadIdx.x) / kG;
    if (f >= F) return;  // a group leaves whole
    const int lane = threadIdx.x & 31;
    const int gl = lane & (kG - 1);
    const unsigned gmask = kt::group_mask<kG>(lane);
    const int st = __ldg(frag_off + f);
    const int n = __ldg(frag_off + f + 1) - st;
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
    jstop = group_max(jstop, gmask);

    const int j0 = max(jstop, 0);
    const int c_first = j0 - j0 % kChunk;
    int best = 0;
    for (int c0 = c_first; c0 < n; c0 += kChunk) {
        if (!held) load(c0);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
            const int j = c0 + gl + kG * r;
            const int len = j - v[r] + 1;
            if (j >= j0 && j < n && len >= min_len) best = max(best, len);
        }
    }
    best = group_max(best, gmask);

    const size_t row = (size_t)f * T;
    int cnt = 0;
    if (best > 0) {
        for (int c0 = c_first; c0 < n; c0 += kChunk) {
            if (!held) load(c0);
#pragma unroll
            for (int r = 0; r < kR; ++r) {
                if (c0 + kG * r >= n) break;  // uniform in the group
                const int j = c0 + gl + kG * r;
                const bool tie = j >= j0 && j < n && j - v[r] + 1 == best;
                const unsigned m = __ballot_sync(gmask, tie) & gmask;
                const int t = cnt + __popc(m & kt::lanes_below(lane));
                if (tie && t < T) {
                    tie_j[row + t] = j;
                    tie_s0[row + t] = __ldg(ls0 + st + j);
                    tie_s1[row + t] = __ldg(ls1 + st + j);
                }
                cnt += __popc(m);
            }
        }
    }
    for (int t = cnt + gl; t < T; t += kG) {
        tie_j[row + t] = -1;
        tie_s0[row + t] = 0;
        tie_s1[row + t] = 0;
    }
    if (gl == 0) {
        maxl[f] = best;
        tie_cnt[f] = cnt;
    }
}

}  // namespace

KT_EXPORT int kt_mem_stats(const int* li, const int* ls0, const int* ls1,
                           const int* frag_off, int F, int min_len, int T,
                           int* maxl, int* tie_cnt, int* tie_j, int* tie_s0,
                           int* tie_s1, cudaStream_t stream) {
    const long long threads = (long long)F * kG;
    mem_stats_kernel<<<(int)((threads + kThreads - 1) / kThreads), kThreads,
                       0, stream>>>(li, ls0, ls1, frag_off, F, min_len, T,
                                    maxl, tie_cnt, tie_j, tie_s0, tie_s1);
    return static_cast<int>(cudaGetLastError());
}
