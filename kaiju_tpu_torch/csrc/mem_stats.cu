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
// Bound: one pass over the lanes' (i, s0, s1) (12 bytes a position) plus
// the outputs; device-memory bytes at 3.35 TB/s.  Design: one warp per
// fragment, three strided passes (jstop, maxl, ties) with warp
// reductions; the ties are ranked with a ballot so they stay ascending.
#include "fm_common.cuh"

namespace {

using kt::warp_max;

__global__ void mem_stats_kernel(const int* __restrict__ li,
                                 const int* __restrict__ ls0,
                                 const int* __restrict__ ls1,
                                 const int* __restrict__ frag_off, int F,
                                 int min_len, int T, int* __restrict__ maxl,
                                 int* __restrict__ tie_cnt,
                                 int* __restrict__ tie_j,
                                 int* __restrict__ tie_s0,
                                 int* __restrict__ tie_s1) {
    const int f = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (f >= F) return;  // whole warps leave together
    const int st = frag_off[f];
    const int n = frag_off[f + 1] - st;

    int jstop = -1;
    for (int j = lane; j < n; j += 32)
        if (li[st + j] <= 1) jstop = j;  // j ascends per lane
    jstop = warp_max(jstop);

    int best = 0;
    for (int j = max(jstop, 0) + lane; j < n; j += 32) {
        const int len = j - li[st + j] + 1;
        if (len >= min_len) best = max(best, len);
    }
    best = warp_max(best);

    int cnt = 0;
    if (best > 0) {
        for (int j0 = max(jstop, 0); j0 < n; j0 += 32) {
            const int j = j0 + lane;
            const bool tie = j < n && j - li[st + j] + 1 == best;
            const unsigned mask = __ballot_sync(0xffffffffu, tie);
            const int r = cnt + __popc(mask & ((1u << lane) - 1u));
            if (tie && r < T) {
                tie_j[(size_t)f * T + r] = j;
                tie_s0[(size_t)f * T + r] = ls0[st + j];
                tie_s1[(size_t)f * T + r] = ls1[st + j];
            }
            cnt += __popc(mask);
        }
    }
    for (int t = cnt + lane; t < T; t += 32) {
        tie_j[(size_t)f * T + t] = -1;
        tie_s0[(size_t)f * T + t] = 0;
        tie_s1[(size_t)f * T + t] = 0;
    }
    if (lane == 0) {
        maxl[f] = best;
        tie_cnt[f] = cnt;
    }
}

}  // namespace

KT_EXPORT int kt_mem_stats(const int* li, const int* ls0, const int* ls1,
                           const int* frag_off, int F, int min_len, int T,
                           int* maxl, int* tie_cnt, int* tie_j, int* tie_s0,
                           int* tie_s1, cudaStream_t stream) {
    const int threads = 256;  // 8 fragments a block
    const int blocks = (F + threads / 32 - 1) / (threads / 32);
    mem_stats_kernel<<<blocks, threads, 0, stream>>>(
        li, ls0, ls1, frag_off, F, min_len, T, maxl, tie_cnt, tie_j, tie_s0,
        tie_s1);
    return static_cast<int>(cudaGetLastError());
}
