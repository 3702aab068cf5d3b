// The index above 2^31 letters (K17): positions, intervals and sequence
// ids in int64 over S shards whose own counts stay int32.
//
// Shard o holds the rank records of BWT blocks [o nb_s, (o + 1) nb_s) as
// int32 [nb_s + 1, 64] rows: words 0..31 the shard's LOCAL occ checkpoint
// (#c in the shard's blocks before this one), words 32..63 the block's
// 128 BWT bytes, four to a word, little endian; row nb_s is the end row
// (the shard's end counts, bytes 255), which serves k at the end of the
// shard.  The global count comes from the int64 tables beside them:
//
//   FMindex(c, k) = C[c] + base[o][c] + occ_local[o][b - o nb_s][c]
//                   + #c in block b before k & 127,
//   b = k >> 7, o = min(b / nb_s, S - 1)
//
// (scripts/big_classify_demo.py:rank1, :272-288; that program clips the
// local block to nb_s - 1, so it loses the last block's counts at
// k = N = 128 S nb_s; the end row does not).  A shard keeps fewer than
// 2^31 positions (parallel/big_index.py refuses more), so the local
// arithmetic is int32 and only the block index, the bases and the
// positions are int64.  The int32 policies and functions of
// fm_common.cuh are not touched.
#pragma once

#include "fm_common.cuh"

namespace kt {

__device__ __forceinline__ int64_t ldg64(const int64_t* p) {
    return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}

struct BigShardIx {
    const int* const* rec;  // [S] shards of [nb_s + 1, 64]
    int nb_s;
    int S;
    const int64_t* C;     // [alen + 1]
    const int64_t* base;  // [S, alen]: the counts of the shards before o
    int alen;
    const int* const* sa_seq;  // [S] shards of [ns_s]; null for extension
    int ns_s;
    int64_t first;  // the first sampled SA row, a multiple of 2^e
    int e;

    __device__ __forceinline__ int owner(int64_t b) const {
        const int64_t o = b / nb_s;
        return o < S - 1 ? (int)o : S - 1;
    }
    // The owner's row of block b (its end row for b = (o + 1) nb_s).
    __device__ __forceinline__ const int* row(int o, int64_t b) const {
        return rec[o] + (size_t)(b - (int64_t)o * nb_s) * 64;
    }
    // The sequence of sample slot idx, clipped into the S ns_s slots as
    // the JAX program clips it (:335).
    __device__ __forceinline__ int64_t seq(int64_t idx) const {
        const int64_t last = (int64_t)S * ns_s - 1;
        idx = idx < 0 ? 0 : (idx > last ? last : idx);
        const int64_t o64 = idx / ns_s;
        const int o = o64 < S - 1 ? (int)o64 : S - 1;
        return __ldg(sa_seq[o] + (idx - (int64_t)o * ns_s));
    }
};

// #c among the first off (0..127) BWT bytes of a record row: a
// packed-byte compare with 16-byte loads, as kt::rank counts.
__device__ __forceinline__ int count_below(const int* row, int c, int off) {
    const unsigned pat = 0x01010101u * (unsigned)c;
    const uint4* w4 = reinterpret_cast<const uint4*>(row + 32);
    int cnt = 0;
    for (int q = 0; q * 16 < off; ++q) {
        const uint4 v = __ldg(w4 + q);
        const int b = off - q * 16;
        cnt += count_eq_bytes(v.x, pat, b);
        cnt += count_eq_bytes(v.y, pat, b - 4);
        cnt += count_eq_bytes(v.z, pat, b - 8);
        cnt += count_eq_bytes(v.w, pat, b - 12);
    }
    return cnt;
}

// FMindex(c, k) on the owner's row o of block b = k >> 7.
__device__ __forceinline__ int64_t rank_on(const BigShardIx& ix,
                                           const int* row, int o, int c,
                                           int64_t k) {
    const int local = __ldg(row + c) + count_below(row, c, (int)(k & 127));
    return ldg64(ix.C + c) + ldg64(ix.base + (size_t)o * ix.alen + c) +
           (int64_t)local;
}

__device__ __forceinline__ int64_t rank64(const BigShardIx& ix, int c,
                                          int64_t k) {
    const int64_t b = k >> 7;
    const int o = ix.owner(b);
    return rank_on(ix, ix.row(o, b), o, c, k);
}

// get_suffix reduced to the sequence id, in int64: LF-walk from SA row k
// until a sampled row (k >= first and (k - first) divisible by 2^e: the
// sample of slot (k - first) >> e) or a terminator, where the LF result
// itself is the content rank of the sequence (:332-406; kt::sa_walk).
// The byte and the rank of a step read the same row.
__device__ __forceinline__ int64_t sa_walk64(const BigShardIx& ix,
                                             int64_t k) {
    const int64_t check = ((int64_t)1 << ix.e) - 1;
    for (;;) {
        if (k >= ix.first && ((k - ix.first) & check) == 0)
            return ix.seq((k - ix.first) >> ix.e);
        const int64_t b = k >> 7;
        const int o = ix.owner(b);
        const int* row = ix.row(o, b);
        const int c = bwt_byte(row, (int)(k & 127));
        const int64_t kn = rank_on(ix, row, o, c, k);
        if (c == 0) return kn;
        k = kn;
    }
}

}  // namespace kt
