// Kernel A: batched UpdateSI, (n0, n1, ok) = (FMindex(c, s0),
// FMindex(c, s1), n0 < n1) (bwt.c:160-173).
//
// Replaces kaiju_tpu/ops/device_index.py:probe_updates / probe_updates_rec
// (K3), whose rank is device_index.rank_row / rank_fused (K1).  On the
// main path it builds the K-mer seed tables (kaiju_tpu/ops/kmer.py
// KmerTables.build_device, K15): 20 * 20^(d-1) probes per depth d.
//
// Bound: two random 256-byte record rows per probe (plus 12 bytes of
// probe in, 9 bytes out), so device-memory bytes at 3.35 TB/s.
// Design: one thread per probe, one row read per end through the shared
// kt::rank; neighbouring probes share previous-depth intervals, so rows
// are often reused through L2.
#include "fm_common.cuh"

namespace {

__global__ void update_si_kernel(const int* __restrict__ rec, int nb1,
                                 const int* __restrict__ C,
                                 const int* __restrict__ c,
                                 const int* __restrict__ s0,
                                 const int* __restrict__ s1, int n,
                                 int* __restrict__ n0, int* __restrict__ n1,
                                 uint8_t* __restrict__ ok) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n) return;
    const int cc = c[t];
    const int a = kt::rank(rec, nb1, C, cc, s0[t]);
    const int b = kt::rank(rec, nb1, C, cc, s1[t]);
    n0[t] = a;
    n1[t] = b;
    ok[t] = a < b;
}

}  // namespace

KT_EXPORT int kt_update_si(const int* rec, int nb1, const int* C,
                           const int* c, const int* s0, const int* s1, int n,
                           int* n0, int* n1, uint8_t* ok,
                           cudaStream_t stream) {
    const int threads = 256;
    update_si_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
        rec, nb1, C, c, s0, s1, n, n0, n1, ok);
    return static_cast<int>(cudaGetLastError());
}
