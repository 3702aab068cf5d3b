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
// arithmetic is int32; so is the block number b, for an index under 2^38
// letters (BigIndex refuses more).  Only the bases and the positions are
// int64.  The int32 policies and functions of fm_common.cuh are not
// touched; the step functions here follow kt::rank2 and kt::lf_group
// (lf_group64 loads the letter's occ word after the letter).
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

    // The owner of block b = k >> 7, in 32-bit arithmetic.
    __device__ __forceinline__ int owner(int b) const {
        return min(b / nb_s, S - 1);
    }
    // The owner's row of block b (its end row for b = (o + 1) nb_s).
    __device__ __forceinline__ const int* row(int o, int b) const {
        return rec[o] + (size_t)(b - o * nb_s) * 64;
    }
    // C[c] + base[o][c]: the count of c before shard o.
    __device__ __forceinline__ int64_t before(int o, int c) const {
        return ldg64(C + c) + ldg64(base + (size_t)o * alen + c);
    }
    // The sequence of sample slot idx, clipped into the S ns_s slots as
    // the JAX program clips it (:335); once a walk, at its end.
    __device__ __forceinline__ int64_t seq(int64_t idx) const {
        const int64_t last = (int64_t)S * ns_s - 1;
        idx = idx < 0 ? 0 : (idx > last ? last : idx);
        const int64_t o64 = idx / ns_s;
        const int o = o64 < S - 1 ? (int)o64 : S - 1;
        return __ldg(sa_seq[o] + (idx - (int64_t)o * ns_s));
    }
};

// The rank pair of one FM step on the big index, *n0 = FMindex(c, k0) and
// *n1 = FMindex(c, k1), computed by a group of G threads (2, 4 or 8; gl:
// the thread's place in it, gmask: the group's lanes), every thread of
// which gets both: kt::rank2 with the owner's int64 count before its
// shard added.  Thread gl loads the BWT bytes' 16-byte groups gl, gl + G,
// ... of each row, and the occ words, C and base beside them, so that all
// of a step's sectors are in flight at once: one memory latency a step.
// When both ends lie in one block (a narrow interval) one row serves
// both, its bytes loaded once.  on = false: a group with no step to take
// loads no row and gets no result, but takes part in the warp's
// shuffles, so that the groups of a warp step together (the loads are
// selected, not branched around: groups of one warp on two paths would
// wait for their loads one path after the other).
template <int G>
__device__ __forceinline__ void rank2_64(const BigShardIx& ix, bool on,
                                         int c, int64_t k0, int64_t k1,
                                         int gl, unsigned gmask, int64_t* n0,
                                         int64_t* n1) {
    if (!on) c = 0, k0 = k1 = 0;
    const int b0 = (int)(k0 >> 7), b1 = (int)(k1 >> 7);
    const bool one = b0 == b1;
    const int o0 = ix.owner(b0), o1 = one ? o0 : ix.owner(b1);
    const int64_t base0 = ix.before(o0, c);
    const int64_t base1 = one ? base0 : ix.before(o1, c);
    const int* r0 = ix.row(o0, b0);
    const int* r1 = one ? r0 : ix.row(o1, b1);
    const int f0 = (int)(k0 & 127), f1 = (int)(k1 & 127);
    const int h0 = one ? max(f0, f1) : f0;  // the bytes of r0 to load
    const unsigned pat = 0x01010101u * (unsigned)c;
    const uint4* w0 = reinterpret_cast<const uint4*>(r0 + 32);
    const uint4* w1 = reinterpret_cast<const uint4*>(r1 + 32);
    const uint4 zero = make_uint4(0, 0, 0, 0);
    uint4 v0[8 / G], v1[8 / G];
#pragma unroll
    for (int t = 0; t < 8 / G; ++t) {
        const int q = gl + t * G;
        v0[t] = q * 16 < h0 ? __ldg(w0 + q) : zero;
        v1[t] = !one && q * 16 < f1 ? __ldg(w1 + q) : zero;
    }
    int a = on && gl == 0 ? __ldg(r0 + c) : 0;
    int b = on && gl == 0 ? __ldg(r1 + c) : 0;
#pragma unroll
    for (int t = 0; t < 8 / G; ++t) {
        const int q = gl + t * G;
        a += count_eq16(v0[t], pat, f0 - 16 * q);
        b += count_eq16(one ? v0[t] : v1[t], pat, f1 - 16 * q);
    }
#pragma unroll
    for (int m = G / 2; m > 0; m >>= 1) {
        a += __shfl_xor_sync(gmask, a, m, G);
        b += __shfl_xor_sync(gmask, b, m, G);
    }
    *n0 = base0 + a;
    *n1 = base1 + b;
}

// One LF step of an SA walk on the big index by a group of G (2, 4 or 8)
// lanes: *c = the BWT letter at k and the result FMindex(*c, k) to every
// lane.  Lane gl loads the row's 16-byte groups gl, gl + G, ... of the
// BWT bytes up to k, the letter comes by shuffle from the lane that holds
// it, and lane 0 then loads the letter's occ word: two memory latencies
// and about 3.25 sectors a step, where kt::lf_group's step, which loads
// the occ words with the bytes, takes one latency and about 5.25 sectors
// (below alen).  On phase 4g's index the two tie at 1,024 reads and this
// one is faster at 65,536 (PERF.md, section 6, NVIDIA H100 80GB HBM3,
// 700.00 W).  on = false,
// as for rank2_64: no loads, no result (*c = 0), the shuffles taken.
template <int G>
__device__ __forceinline__ int64_t lf_group64(const BigShardIx& ix, bool on,
                                              int64_t k, int gl,
                                              unsigned gmask, int* c) {
    if (!on) k = 0;
    const int blk = (int)(k >> 7);
    const int o = ix.owner(blk);
    const int* row = ix.row(o, blk);
    const int off = (int)(k & 127), qb = off >> 4;
    const uint4* bw = reinterpret_cast<const uint4*>(row + 32);
    const uint4 zero = make_uint4(0, 0, 0, 0);
    uint4 v[8 / G];
#pragma unroll
    for (int t = 0; t < 8 / G; ++t) {
        const int q = gl + t * G;
        v[t] = on && q <= qb ? __ldg(bw + q) : zero;
    }
    // the letter at off: group qb, held by lane qb % G
    uint4 g = v[0];
#pragma unroll
    for (int t = 1; t < 8 / G; ++t)
        if (t == qb / G) g = v[t];
    const int b = off & 15;
    const unsigned word = b < 4 ? g.x : b < 8 ? g.y : b < 12 ? g.z : g.w;
    const int letter = __shfl_sync(gmask, (int)(word >> ((b & 3) * 8)) & 255,
                                   qb % G, G);
    const unsigned pat = 0x01010101u * (unsigned)letter;
    int cnt = on && gl == 0 ? __ldg(row + letter) : 0;
#pragma unroll
    for (int t = 0; t < 8 / G; ++t)
        cnt += count_eq16(v[t], pat, off - 16 * (gl + t * G));
#pragma unroll
    for (int m = G / 2; m > 0; m >>= 1)
        cnt += __shfl_xor_sync(gmask, cnt, m, G);
    *c = letter;
    return ix.before(o, letter) + cnt;
}

}  // namespace kt
