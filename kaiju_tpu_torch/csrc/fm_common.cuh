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

// The index as the kernels read it: the rank record rows, the SA samples
// and, for the text-compare hybrid, the text.  FlatIx holds one tensor of
// each.  ShardIx holds the same arrays split into S contiguous shards,
// each its own allocation, reached through small device tables of shard
// pointers (K16, kaiju_tpu/parallel/sharded_index.py): the owner of block
// b is min(b / nb_s, S - 1) and it holds the row at b - owner * nb_s
// (its nb_s rows, then an end row; the last shard is padded with the end
// row); SA samples go by slot over ns_s, text bytes over nt_s.  The JAX
// program assembles each owner's value with a psum over the index axis;
// on one card the owner's row is read directly.  Both give the same rows.
struct FlatIx {
    const int* rec;  // [nb1, 64]
    int nb1;
    const int* sa_seq;  // [nsamp]; null where the kernel walks no SA
    const int* sa_off;  // [nsamp]; null where no position is needed
    int nsamp;
    const uint8_t* text;  // [N]; null without the hybrid

    __device__ __forceinline__ const int* row(int b) const {
        return rec + (size_t)min(b, nb1 - 1) * 64;
    }
    __device__ __forceinline__ int seq(int idx) const {
        return __ldg(sa_seq + idx);
    }
    __device__ __forceinline__ int off(int idx) const {
        return __ldg(sa_off + idx);
    }
    __device__ __forceinline__ int letter(int t) const {
        return __ldg(text + t);
    }
};

struct ShardIx {
    const int* const* rec;  // [S] shards of [nb_s + 1, 64]
    int nb_s;
    const int* const* sa_seq;  // [S] shards of [ns_s]
    const int* const* sa_off;
    int ns_s;
    int nsamp;  // the samples of all shards
    const uint8_t* const* text;  // [S] shards of [nt_s] bytes
    int nt_s;
    int S;

    __device__ __forceinline__ const int* row(int b) const {
        const int o = min(b / nb_s, S - 1);
        return rec[o] + (size_t)min(b - o * nb_s, nb_s) * 64;
    }
    __device__ __forceinline__ int seq(int idx) const {
        const int o = min(idx / ns_s, S - 1);
        return __ldg(sa_seq[o] + (idx - o * ns_s));
    }
    __device__ __forceinline__ int off(int idx) const {
        const int o = min(idx / ns_s, S - 1);
        return __ldg(sa_off[o] + (idx - o * ns_s));
    }
    __device__ __forceinline__ int letter(int t) const {
        const int o = min(t / nt_s, S - 1);
        return __ldg(text[o] + (t - o * nt_s));
    }
};

// The BWT byte at offset off (0..127) of a record row.
__device__ __forceinline__ int bwt_byte(const int* row, int off) {
    return (__ldg(row + 32 + (off >> 2)) >> ((off & 3) * 8)) & 255;
}

// FMindex(c, k) = C[c] + #c in bwt[0, k): the reference's rank with the
// count excluding k (compactfmi.c:4-19).  One record row: the occ word
// of c, then a packed-byte compare over the first k & 127 bytes with
// 16-byte loads.
template <class Ix>
__device__ __forceinline__ int rank(const Ix& ix, const int* __restrict__ C,
                                    int c, int k) {
    const int* row = ix.row(k >> 7);
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

// Bytes equal to the byte in every lane of pat among the first nbytes
// (any int: <= 0 counts none, >= 16 all) of a 16-byte group.
__device__ __forceinline__ int count_eq16(const uint4& v, unsigned pat,
                                          int nbytes) {
    return count_eq_bytes(v.x, pat, nbytes) +
           count_eq_bytes(v.y, pat, nbytes - 4) +
           count_eq_bytes(v.z, pat, nbytes - 8) +
           count_eq_bytes(v.w, pat, nbytes - 12);
}

// The bytes equal to c among the first o0 (*a) and the first o1 (*b) BWT
// bytes of a record row, its 16-byte loads issued four at a time before
// they are counted: at most two memory latencies, where rank()'s loop may
// wait for each of its loads in turn, and 16 registers of loads in
// flight.
__device__ __forceinline__ void count_row(const int* row, int c, int o0,
                                          int o1, int* a, int* b) {
    const unsigned pat = 0x01010101u * (unsigned)c;
    const uint4* w4 = reinterpret_cast<const uint4*>(row + 32);
    const int hi = max(o0, o1);
    int x = 0, y = 0;
    for (int h = 0; h < 8 && h * 16 < hi; h += 4) {
        uint4 v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
            v[q] = (h + q) * 16 < hi ? __ldg(w4 + h + q)
                                     : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            x += count_eq16(v[q], pat, o0 - 16 * (h + q));
            y += count_eq16(v[q], pat, o1 - 16 * (h + q));
        }
    }
    *a = x;
    *b = y;
}

// rank() through count_row's loads.
template <class Ix>
__device__ __forceinline__ int rank1(const Ix& ix, const int* __restrict__ C,
                                     int c, int k) {
    const int* row = ix.row(k >> 7);
    int a, b;
    count_row(row, c, k & 127, k & 127, &a, &b);
    return __ldg(C + c) + __ldg(row + c) + a;
}

// The rank pair of one FM step, *n0 = FMindex(c, k0) and *n1 =
// FMindex(c, k1), as rank() gives each (fused_greedy.py:_paired_rank2),
// computed by a group of G threads (1, 2, 4 or 8; gl: the thread's place
// in it, gmask: the group's lanes), every thread of which gets both.
// Thread gl loads the row's 16-byte groups gl, gl + G, ..., so a group of
// 8 reads the 128 BWT bytes as one coalesced line, and a shuffle sums the
// counts; one thread (G = 1) issues its loads four at a time.  Both
// ends usually lie in one 128-character block once the interval is
// narrow: then one row serves both, its bytes loaded once.
template <int G, class Ix>
__device__ __forceinline__ void rank2(const Ix& ix,
                                      const int* __restrict__ C, int c,
                                      int k0, int k1, int gl, unsigned gmask,
                                      int* n0, int* n1) {
    const bool one = k0 >> 7 == k1 >> 7;
    if constexpr (G == 1) {  // one thread: count_row's loads
        if (!one) {
            *n0 = rank1(ix, C, c, k0);
            *n1 = rank1(ix, C, c, k1);
            return;
        }
        const int* row = ix.row(k0 >> 7);
        int a, b;
        count_row(row, c, k0 & 127, k1 & 127, &a, &b);
        const int base = __ldg(C + c) + __ldg(row + c);
        *n0 = base + a;
        *n1 = base + b;
        return;
    }
    const int* r0 = ix.row(k0 >> 7);
    const int* r1 = one ? r0 : ix.row(k1 >> 7);
    const int o0 = k0 & 127, o1 = k1 & 127;
    const unsigned pat = 0x01010101u * (unsigned)c;
    const uint4* w0 = reinterpret_cast<const uint4*>(r0 + 32);
    const uint4* w1 = reinterpret_cast<const uint4*>(r1 + 32);
    int a = 0, b = 0;
#pragma unroll
    for (int t = 0; t < 8 / G; ++t) {
        const int q = gl + t * G;
        if (one) {
            if (q * 16 < max(o0, o1)) {
                const uint4 v = __ldg(w0 + q);
                a += count_eq16(v, pat, o0 - 16 * q);
                b += count_eq16(v, pat, o1 - 16 * q);
            }
        } else {
            if (q * 16 < o0) a += count_eq16(__ldg(w0 + q), pat, o0 - 16 * q);
            if (q * 16 < o1) b += count_eq16(__ldg(w1 + q), pat, o1 - 16 * q);
        }
    }
    if (gl == 0) {
        const int cc = __ldg(C + c);
        a += cc + __ldg(r0 + c);
        b += cc + __ldg(r1 + c);
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
        a += __shfl_xor_sync(gmask, a, o, G);
        b += __shfl_xor_sync(gmask, b, o, G);
    }
    *n0 = a;
    *n1 = b;
}

// The lanes of the aligned group of G (1, 2, 4 or 8) threads that holds
// `lane`.
template <int G>
__device__ __forceinline__ unsigned group_mask(int lane) {
    return ((1u << G) - 1u) << (lane & ~(G - 1));
}

// get_suffix (bwt.c:105-121) reduced to the sequence index: LF-walk from
// SA position k until a sampled slot (k divisible by 2^chpt_exp) or a
// terminator.  At a terminator (c == 0) the LF result itself is the
// content rank of the sequence.
template <class Ix>
__device__ __forceinline__ int sa_walk(const Ix& ix,
                                       const int* __restrict__ C, int nseq,
                                       int chpt_exp, int k) {
    const int check = (1 << chpt_exp) - 1;
    while (k & check) {
        const int c = bwt_byte(ix.row(k >> 7), k & 127);
        const int kn = rank(ix, C, c, k);
        if (c == 0) return kn;
        k = kn;
    }
    int idx = (k >> chpt_exp) - ((nseq - 1) >> chpt_exp) - 1;
    idx = min(max(idx, 0), ix.nsamp - 1);
    return ix.seq(idx);
}

// Warp helpers: every lane of the warp calls them.
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int warp_max(int v) {
    for (int o = 16; o > 0; o >>= 1)
        v = max(v, __shfl_xor_sync(kFullMask, v, o));
    return v;
}

// Inclusive prefix sum over the lanes (lane 0 first).
__device__ __forceinline__ int warp_incl_sum(int v, int lane) {
    for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFullMask, v, o);
        if (lane >= o) v += u;
    }
    return v;
}

// Inclusive prefix minimum over the lanes (lane 0 first).
__device__ __forceinline__ int warp_incl_min(int v, int lane) {
    for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFullMask, v, o);
        if (lane >= o) v = min(v, u);
    }
    return v;
}

// The lanes below this one, as a ballot mask.
__device__ __forceinline__ unsigned lanes_below(int lane) {
    return (1u << lane) - 1u;
}

}  // namespace kt

// The arguments of a sharded entry point that describe the shards (each
// table a device array of S pointers), and the kt::ShardIx they make.
#define KT_SHARD_PARAMS                                                  \
    const int* const* rec_tab, int nb_s, const int* const* seq_tab,      \
        const int* const* off_tab, int ns_s, int nsamp,                  \
        const uint8_t* const* text_tab, int nt_s, int nshards
#define KT_SHARD_IX                                                      \
    kt::ShardIx {                                                        \
        rec_tab, nb_s, seq_tab, off_tab, ns_s, nsamp, text_tab, nt_s,    \
            nshards                                                      \
    }

// Error text for a code returned by an entry point (each library has its
// own copy).
KT_EXPORT const char* kt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
