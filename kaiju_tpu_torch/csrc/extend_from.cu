// Kernel I: resumed backward extension of a batch of lanes
// (maxMatches_withStart, bwt.c:298-336).
//
// Replaces kaiju_tpu/ops/device_index.py:extend_from_flat (K5, :348-394)
// and extend_from_rec (:397-408, through fused_mem2._extend_paired): the
// Greedy -v co-simulation's variant extensions, the replay's cache misses
// and BatchRunner's ExtendFrom rounds (extend_rows).  Lane t reads its
// letters from flat[base[t] + x], with subcode[t] in place of the letter
// at x == pos[t] (pos = -1: none; the rec form is base = row * L, pos =
// -1).  An active lane extends [s0, s1) from start_i one letter a step
// while the interval stays non-empty and i > 0 and returns the last (i,
// s0, s1); an inactive lane returns its inputs unchanged.
//
// Bound: two random 256-byte record rows per step taken, the lanes'
// letters and the 29 bytes of a lane in and 12 out; device-memory bytes
// at 3.35 TB/s.  A launch holds a few thousand lanes, all on the card at
// once, so its time is its longest lane's chain of dependent row reads
// times the time of a step.  The first design ran a lane on one thread:
// a step loaded its letter, then each end's occ word and BWT bytes one
// load after another.
//
// Design: a group of kG threads a lane.  A step's loads are issued
// together through kt::rank2_on (one memory latency a step; one row for
// both ends once the interval is narrow), with the letter of the next step
// loaded beside them, so that a step waits for its rows alone.  The groups
// of a warp step in the same iteration: a group whose lane has ended
// takes the shuffles with its loads off, as kernels L and M do (groups of
// one warp looping apart waited for their loads one path after the
// other).  Groups of 8 threads beat groups of 4 by 1.3x; blocks of 64
// threads let a round of a few hundred lanes spread over the SMs (within
// 2 % of blocks of 256 on the shapes timed; PERF.md, section 6).
// Nothing is shared between lanes: on the
// first Greedy -v round of chip_smoke.py's phase 3 no lane of 4,274
// reaches a (fragment, position, interval) that another lane reached
// (its note on I counts them), where J's lanes merge.  The JAX program's
// paired rows (rec2) and their two-gather fallback are XLA:TPU devices
// and have no counterpart.
#include "fm_common.cuh"

namespace {

constexpr int kG = 8;        // threads a lane
constexpr int kThreads = 64;  // small blocks: few lanes spread over the card

__global__ void __launch_bounds__(kThreads) extend_from_kernel(
    const int* __restrict__ rec, int nb1, const int* __restrict__ C,
    const uint8_t* __restrict__ flat, const int* __restrict__ base,
    const int* __restrict__ pos, const int* __restrict__ sub,
    const int* __restrict__ start_i, const int* __restrict__ s0,
    const int* __restrict__ s1, const uint8_t* __restrict__ act, int n,
    int* __restrict__ out_i, int* __restrict__ out_s0,
    int* __restrict__ out_s1) {
    // no thread leaves early: the warp's shuffles take every lane
    const int t = (int)(((int64_t)blockIdx.x * kThreads + threadIdx.x) / kG);
    const int gl = threadIdx.x & (kG - 1);
    const unsigned gmask = kt::group_mask<kG>(threadIdx.x & 31);
    const kt::FlatIx ix{rec, nb1, nullptr, nullptr, 0, nullptr};
    const bool live = t < n;
    int i = 0, a0 = 0, a1 = 0, p = -1, sc = 0;
    const uint8_t* row = flat;
    bool active = false;
    if (live) {
        i = __ldg(start_i + t);
        a0 = __ldg(s0 + t);
        a1 = __ldg(s1 + t);
        p = __ldg(pos + t);
        sc = __ldg(sub + t);
        row = flat + __ldg(base + t);
        active = __ldg(act + t) != 0;
    }
    // c: the letter at i - 1, the next step's
    int c = active && i > 0 ? (i - 1 == p ? sc : __ldg(row + i - 1)) : 0;
    while (__any_sync(kt::kFullMask, active)) {
        const bool go = active && i > 0;
        const int cn = go && i > 1 ? (i - 2 == p ? sc : __ldg(row + i - 2))
                                   : 0;
        int n0, n1;
        kt::rank2_on<kG>(ix, C, go, c, a0, a1, gl, gmask, &n0, &n1);
        if (go && n0 < n1) {
            a0 = n0;
            a1 = n1;
            --i;
            c = cn;
        } else {
            active = false;
        }
    }
    if (live && gl == 0) {
        out_i[t] = i;
        out_s0[t] = a0;
        out_s1[t] = a1;
    }
}

}  // namespace

KT_EXPORT int kt_extend_from(const int* rec, int nb1, const int* C,
                             const uint8_t* flat, const int* base,
                             const int* pos, const int* sub,
                             const int* start_i, const int* s0, const int* s1,
                             const uint8_t* act, int n, int* out_i,
                             int* out_s0, int* out_s1, cudaStream_t stream) {
    const int64_t threads = (int64_t)n * kG;
    extend_from_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(
        rec, nb1, C, flat, base, pos, sub, start_i, s0, s1, act, n, out_i,
        out_s0, out_s1);
    return static_cast<int>(cudaGetLastError());
}
