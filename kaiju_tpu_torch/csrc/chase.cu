// A dependent-load chase that measures the card's memory latency (no
// kernel of a path; chip_smoke.py reads it for the latency floors of
// kernels B and E, whose FM steps are chains of dependent row reads).
//
// One thread follows next[] from `start` for `steps` loads, each address
// the value of the load before it, so no two loads overlap: the time over
// the steps is one load's latency.  A table far larger than the 50 MB L2
// gives device-memory latency; one that fits it, after a warm-up walk,
// the L2's.  Loads bypass L1 (ld.global.cg), as the row reads of B and E
// mostly miss it.
#include "fm_common.cuh"

namespace {

__global__ void chase_kernel(const int* __restrict__ next, int start,
                             int steps, int* __restrict__ out) {
    int k = start;
    for (int s = 0; s < steps; ++s) k = __ldcg(next + k);
    *out = k;
}

}  // namespace

KT_EXPORT int kt_chase(const int* next, int start, int steps, int* out,
                       cudaStream_t stream) {
    chase_kernel<<<1, 1, 0, stream>>>(next, start, steps, out);
    return static_cast<int>(cudaGetLastError());
}
