// Kernel K: the Greedy engine's level-0 candidate map from kernel B's
// lanes (maxMatches with max_matches = 0, bwt.c:261-296).
//
// Replaces kaiju_tpu/ops/fused_mem2.py:fused_greedy_map (K10, :1011-1065),
// whose funnel is kernel B.  For each fragment f of frag_off, jstop = the
// largest j whose extension reaches i <= 1 (-1 if none; the rule of
// kernel C), and a row (f, j, i, s0, s1) goes out for every lane with
// j >= jstop and j - i + 1 >= lmap.  Rows of one fragment are written
// together in ascending j; the fragments' blocks of rows come in no fixed
// order (the caller sorts them).  rows must hold P rows (P = lanes, the
// most there can be); n_rows (one int32, zeroed by the caller) receives
// the count.  B evaluates every usable lane and a lane it screens out has
// length 0, so this is the JAX program's row set without its capacities
// (Mout, M2, Ms) and their retry.
//
// Bound: i of every lane (4 bytes a position), frag_off, and for each row
// its lane's s0 and s1 read and 20 bytes written; device-memory bytes at
// 3.35 TB/s.
// Design: one warp per fragment, as in kernel C: a strided pass for
// jstop (warp max), a ballot pass that counts the rows, one atomicAdd by
// lane 0 that reserves them, and a ballot pass that writes them in order.
#include "fm_common.cuh"

namespace {

using kt::warp_max;

__global__ void greedy_map_kernel(const int* __restrict__ li,
                                  const int* __restrict__ ls0,
                                  const int* __restrict__ ls1,
                                  const int* __restrict__ frag_off, int F,
                                  int lmap, int* __restrict__ rows,
                                  int* __restrict__ n_rows) {
    const int f = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (f >= F) return;  // whole warps leave together
    const int st = frag_off[f];
    const int n = frag_off[f + 1] - st;

    int jstop = -1;
    for (int j = lane; j < n; j += 32)
        if (li[st + j] <= 1) jstop = j;  // j ascends per lane
    const int lo = max(warp_max(jstop), 0);

    int total = 0;
    for (int j0 = lo; j0 < n; j0 += 32) {
        const int j = j0 + lane;
        total += __popc(__ballot_sync(kt::kFullMask,
                                      j < n && j - li[st + j] + 1 >= lmap));
    }
    if (total == 0) return;
    int base = 0;
    if (lane == 0) base = atomicAdd(n_rows, total);
    base = __shfl_sync(kt::kFullMask, base, 0);

    for (int j0 = lo; j0 < n; j0 += 32) {
        const int j = j0 + lane;
        const int i = j < n ? li[st + j] : 0;
        const bool emit = j < n && j - i + 1 >= lmap;
        const unsigned mask = __ballot_sync(kt::kFullMask, emit);
        if (emit) {
            const int slot = base + __popc(mask & kt::lanes_below(lane));
            int* r = rows + (size_t)slot * 5;
            r[0] = f;
            r[1] = j;
            r[2] = i;
            r[3] = ls0[st + j];
            r[4] = ls1[st + j];
        }
        base += __popc(mask);
    }
}

}  // namespace

KT_EXPORT int kt_greedy_map(const int* li, const int* ls0, const int* ls1,
                            const int* frag_off, int F, int lmap, int* rows,
                            int* n_rows, cudaStream_t stream) {
    const int threads = 256;  // 8 fragments a block
    const int blocks = (F + threads / 32 - 1) / (threads / 32);
    greedy_map_kernel<<<blocks, threads, 0, stream>>>(
        li, ls0, ls1, frag_off, F, lmap, rows, n_rows);
    return static_cast<int>(cudaGetLastError());
}
