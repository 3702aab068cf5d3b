// Kernel I: resumed backward extension of a batch of lanes
// (maxMatches_withStart, bwt.c:298-336).
//
// Replaces kaiju_tpu/ops/device_index.py:extend_from_flat (K5, :348-394)
// and extend_from_rec (:397-408, through fused_mem2._extend_paired): the
// Greedy -v co-simulation's variant extensions and the replay's cache
// misses.  Lane t reads its letters from flat[base[t] + x], with subcode[t]
// in place of the letter at x == pos[t] (pos = -1: none; the rec form is
// base = row * L, pos = -1).  An active lane extends [s0, s1) from
// start_i while the interval stays non-empty and i > 0 and returns the
// last (i, s0, s1); an inactive lane returns its inputs unchanged.
//
// Bound: two random 256-byte record rows per step taken, the lanes'
// letters and the 29 bytes of a lane in and 12 out; device-memory bytes
// at 3.35 TB/s.  Design: one thread per lane through the shared
// kt::extend_back; the JAX program's paired rows (rec2) and their
// two-gather fallback are XLA:TPU devices and have no counterpart: each
// end reads its own row, which L2 serves when the interval is narrow.
#include "extend_common.cuh"

namespace {

__global__ void extend_from_kernel(const int* __restrict__ rec, int nb1,
                                   const int* __restrict__ C,
                                   const uint8_t* __restrict__ flat,
                                   const int* __restrict__ base,
                                   const int* __restrict__ pos,
                                   const int* __restrict__ sub,
                                   const int* __restrict__ start_i,
                                   const int* __restrict__ s0,
                                   const int* __restrict__ s1,
                                   const uint8_t* __restrict__ act, int n,
                                   int* __restrict__ out_i,
                                   int* __restrict__ out_s0,
                                   int* __restrict__ out_s1) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n) return;
    const kt::FlatIx ix{rec, nb1, nullptr, nullptr, 0, nullptr};
    kt::Ext e{start_i[t], s0[t], s1[t]};
    if (act[t])
        e = kt::extend_back(ix, C, flat, base[t], pos[t], sub[t], e.i, e.s0,
                            e.s1);
    out_i[t] = e.i;
    out_s0[t] = e.s0;
    out_s1[t] = e.s1;
}

}  // namespace

KT_EXPORT int kt_extend_from(const int* rec, int nb1, const int* C,
                             const uint8_t* flat, const int* base,
                             const int* pos, const int* sub,
                             const int* start_i, const int* s0, const int* s1,
                             const uint8_t* act, int n, int* out_i,
                             int* out_s0, int* out_s1, cudaStream_t stream) {
    const int threads = 256;
    extend_from_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
        rec, nb1, C, flat, base, pos, sub, start_i, s0, s1, act, n, out_i,
        out_s0, out_s1);
    return static_cast<int>(cudaGetLastError());
}
