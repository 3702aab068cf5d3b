// Kernels P1 (gather_rows) and P2 (gather_sum): random 512-byte row reads.
//
// Replace bench_pallas_gather.py:dma_gather (P1, pallas_call :75) and
// dma_rank (P2, pallas_call :125), the DMA rank experiment of ROOFLINE.md
// §1.  tab is int32 [NB, 128] (512-byte rows), idx int32 [N] with every
// entry in [0, NB) (the wrapper checks it).  P1 writes out[i] = tab[idx[i]]
// (int32 [N, 128]); P2 writes out[i] = the sum of the 128 words of
// tab[idx[i]] with int32 wrap (int32 [N]), as jnp.sum wraps.
//
// The TPU kernels issue CH row DMAs into VMEM and drain their semaphore, a
// grid step of CH rows at a time; the schedule is XLA:TPU's and not part of
// the contract, and any N works here.  Bound: the bytes, each moved once
// (P1 reads and writes every row, P2 reads it and writes 4 bytes); tab is
// larger than the 50 MB L2 at the bench's size, so the rows come from
// device memory.  Design: one warp a row, each lane one 16-byte load, so a
// row is one 512-byte coalesced read; P2 sums the lane's four words and
// reduces over the warp with __shfl_xor_sync in unsigned arithmetic (the
// wrap of int32 without signed overflow).  Every warp takes kRows rows and
// issues their loads before it uses any, so more reads are in flight than
// warps resident.
#include "fm_common.cuh"

namespace {

constexpr int kRows = 4;       // rows a warp
constexpr int kThreads = 256;  // 8 warps a block

__global__ void gather_rows_kernel(const uint4* __restrict__ tab,
                                   const int* __restrict__ idx, int n,
                                   uint4* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int64_t row0 =
        ((int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * kRows;
    uint4 v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
        if (row0 + r < n)
            v[r] = __ldg(tab + (int64_t)__ldg(idx + row0 + r) * 32 + lane);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
        if (row0 + r < n) out[(row0 + r) * 32 + lane] = v[r];
}

__global__ void gather_sum_kernel(const uint4* __restrict__ tab,
                                  const int* __restrict__ idx, int n,
                                  int* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int64_t row0 =
        ((int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * kRows;
    uint4 v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
        if (row0 + r < n)
            v[r] = __ldg(tab + (int64_t)__ldg(idx + row0 + r) * 32 + lane);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (row0 + r >= n) break;  // the same for every lane of the warp
        unsigned s = v[r].x + v[r].y + v[r].z + v[r].w;
        for (int o = 16; o > 0; o >>= 1)
            s += __shfl_xor_sync(kt::kFullMask, s, o);
        if (lane == 0) out[row0 + r] = (int)s;
    }
}

unsigned blocks_for(int n) {
    const int64_t warps = ((int64_t)n + kRows - 1) / kRows;
    return (unsigned)((warps + kThreads / 32 - 1) / (kThreads / 32));
}

}  // namespace

KT_EXPORT int kt_gather_rows(const int* tab, const int* idx, int n, int* out,
                             cudaStream_t stream) {
    gather_rows_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        reinterpret_cast<const uint4*>(tab), idx, n,
        reinterpret_cast<uint4*>(out));
    return static_cast<int>(cudaGetLastError());
}

KT_EXPORT int kt_gather_sum(const int* tab, const int* idx, int n, int* out,
                            cudaStream_t stream) {
    gather_sum_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        reinterpret_cast<const uint4*>(tab), idx, n, out);
    return static_cast<int>(cudaGetLastError());
}
