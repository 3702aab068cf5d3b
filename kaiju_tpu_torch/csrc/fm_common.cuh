// Shared device functions of the port's FM-index kernels (sm_90a).
//
// The index lives on the card as fused rank records: rec is int32
// [nb + 1, 64], one 256-byte row per 128-character BWT block.  Words
// 0..31 hold the occ checkpoint row (occ[b][c] = #c in bwt[0, 128 b)),
// words 32..63 the block's 128 BWT bytes packed four to a word, little
// endian.  Row nb is a pad row (end counts, bytes = 31) that serves
// k == length at a block boundary.  All arithmetic is int32: an index
// shard keeps its SA positions below 2^31.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define KT_EXPORT extern "C" __attribute__((visibility("default")))

namespace kt {

// Bytes of x equal to the byte in every lane of pat, among the first
// nbytes (0..4) bytes of the word.
__device__ __forceinline__ int count_eq_bytes(unsigned x, unsigned pat,
                                              int nbytes) {
    if (nbytes <= 0) return 0;
    unsigned eq = __vcmpeq4(x, pat);  // 0xff in every equal byte lane
    if (nbytes < 4) eq &= (1u << (8 * nbytes)) - 1u;
    return __popc(eq) >> 3;
}

// FMindex(c, k) = C[c] + #c in bwt[0, k): the reference's rank with the
// count excluding k (compactfmi.c:4-19).  One record row: the occ word
// of c, then a packed-byte compare over the first k & 127 bytes with
// 16-byte loads.
__device__ __forceinline__ int rank(const int* __restrict__ rec, int nb1,
                                    const int* __restrict__ C, int c,
                                    int k) {
    const int* row = rec + (size_t)min(k >> 7, nb1 - 1) * 64;
    const int off = k & 127;
    const unsigned pat = 0x01010101u * (unsigned)c;
    const uint4* w4 = reinterpret_cast<const uint4*>(row + 32);
    int cnt = 0;
    for (int q = 0; q * 16 < off; ++q) {
        const uint4 v = __ldg(w4 + q);
        const int b = off - q * 16;  // bytes of this 16-byte group to count
        cnt += count_eq_bytes(v.x, pat, b);
        cnt += count_eq_bytes(v.y, pat, b - 4);
        cnt += count_eq_bytes(v.z, pat, b - 8);
        cnt += count_eq_bytes(v.w, pat, b - 12);
    }
    return __ldg(C + c) + __ldg(row + c) + cnt;
}

// get_suffix (bwt.c:105-121) reduced to the sequence index: LF-walk from
// SA position k until a sampled slot (k divisible by 2^chpt_exp) or a
// terminator.  At a terminator (c == 0) the LF result itself is the
// content rank of the sequence.
__device__ __forceinline__ int sa_walk(const int* __restrict__ rec, int nb1,
                                       const int* __restrict__ C,
                                       const int* __restrict__ sa_seq,
                                       int nsamp, int nseq, int chpt_exp,
                                       int k) {
    const int check = (1 << chpt_exp) - 1;
    while (k & check) {
        const int* row = rec + (size_t)min(k >> 7, nb1 - 1) * 64;
        const int off = k & 127;
        const int c = (__ldg(row + 32 + (off >> 2)) >> ((off & 3) * 8)) & 255;
        const int kn = rank(rec, nb1, C, c, k);
        if (c == 0) return kn;
        k = kn;
    }
    int idx = (k >> chpt_exp) - ((nseq - 1) >> chpt_exp) - 1;
    idx = min(max(idx, 0), nsamp - 1);
    return __ldg(sa_seq + idx);
}

}  // namespace kt

// Error text for a code returned by an entry point (each library has its
// own copy).
KT_EXPORT const char* kt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
