// Kernel A: batched UpdateSI, (n0, n1, ok) = (FMindex(c, s0),
// FMindex(c, s1), n0 < n1) (bwt.c:160-173), in two forms.
//
// Replaces kaiju_tpu/ops/device_index.py:probe_updates / probe_updates_rec
// (K3), whose rank is device_index.rank_row / rank_fused (K1), and the
// seed-table build that sends them, kaiju_tpu/ops/kmer.py
// KmerTables.build_device (K15): 20 * 20^(d-1) probes at depth d, every
// (letter, previous k-mer) pair.
//
// The letters form (kt_update_si_letters) builds the seed tables: for each
// previous interval (s0, s1) and every letter c = 1..20, (FMindex(c, s0),
// FMindex(c, s1)) where the interval is alive (s0 < s1) and the new one
// non-empty, else (0, 0), stored c-major ([20, n]).  The 20 letters of an
// interval read the same one or two record rows, so a probe a letter
// reads each row 20 times.  Bound: the distinct rows, 8 bytes in and 160
// out an interval, at 3.35 TB/s; two dependent loads (the interval, its
// rows).  Design: a warp serves kPer intervals, loading the rows of all
// of them before it counts any, so that each warp keeps kPer intervals'
// loads in flight (one interval a warp waited its two loads in turn, ~20
// waves of them at depth 5).  Lane l loads the 32-bit word l of the BWT
// bytes of each row an interval needs (one coalesced line a row, only
// the words below its offset), and lane c - 1 the occ word of letter c;
// each lane counts its four bytes into packed counters (letter c in byte
// (c - 1) % 4 of word (c - 1) / 4: at most 128 a byte), five words a row
// end, summed over the warp with __reduce_add_sync, and lane c - 1 takes
// letter c's count.  A dead interval reads no row.  A block of kSpan
// intervals stages its results in shared memory, so each letter's row of
// the output is stored as whole 128-byte lines.
//
// The probe form (kt_update_si) serves probes of mixed letters
// (BatchRunner's Probes, Greedy -v's co-simulation): a group of kG lanes
// a probe through kt::rank2, which reads a row's BWT bytes as one
// coalesced line (one memory latency) and one row for both ends when they
// share a block.  Bound: the distinct rows plus 12 bytes in and 9 out a
// probe; two dependent loads.  A group of 8 lanes beat one lane a probe
// (kt::rank2<1>) on BatchRunner's rounds, this form's traffic; on the
// 3.2 M repeated probes of a seed-table depth, which no path sends since
// the letters form, fewer lanes a probe were faster.
//
// The _sharded entry points run the same on an index split into shards
// (kt::ShardIx, K16a: kaiju_tpu/parallel/sharded_index.py:_sharded_fmindex):
// the seed tables and probes of the index-sharded paths.
#include "fm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kG = 8;  // lanes a probe (probe form)
constexpr int kPer = 4;  // intervals a warp (letters form)
constexpr int kSpan = kThreads / 32 * kPer;  // intervals a block
constexpr int kLetters = 20;  // letter codes 1..20

template <class Ix>
__global__ void __launch_bounds__(kThreads) update_si_kernel(
    const Ix ix, const int* __restrict__ C, const int* __restrict__ c,
    const int* __restrict__ s0, const int* __restrict__ s1, int n,
    int* __restrict__ n0, int* __restrict__ n1, uint8_t* __restrict__ ok) {
    const int t = (blockIdx.x * kThreads + threadIdx.x) / kG;
    if (t >= n) return;  // a group leaves whole
    const int gl = threadIdx.x & (kG - 1);
    int a, b;
    kt::rank2<kG>(ix, C, __ldg(c + t), __ldg(s0 + t), __ldg(s1 + t), gl,
                  kt::group_mask<kG>(threadIdx.x & 31), &a, &b);
    if (gl == 0) {
        n0[t] = a;
        n1[t] = b;
        ok[t] = a < b;
    }
}

// Adds one to letter b's packed counter (b outside 1..20 counts nowhere).
__device__ __forceinline__ void count_letter(unsigned (&h)[5], int b) {
    const unsigned inc =
        b >= 1 && b <= kLetters ? 1u << (8 * ((b - 1) & 3)) : 0u;
    const int w = (b - 1) >> 2;
#pragma unroll
    for (int q = 0; q < 5; ++q) h[q] += w == q ? inc : 0u;
}

// Letter (lane + 1)'s count from the warp's summed packed counters.
__device__ __forceinline__ int letter_count(const unsigned (&h)[5],
                                            int lane) {
    const int w = lane >> 2;
    unsigned x = h[0];
#pragma unroll
    for (int q = 1; q < 5; ++q)
        if (w == q) x = h[q];
    return (int)((x >> (8 * (lane & 3))) & 255u);
}

template <class Ix>
__global__ void __launch_bounds__(kThreads) update_si_letters_kernel(
    const Ix ix, const int* __restrict__ C, const int* __restrict__ s0,
    const int* __restrict__ s1, int n, int* __restrict__ n0,
    int* __restrict__ n1) {
    __shared__ int res[2][kLetters][kSpan + 1];  // rows a bank apart
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int base = blockIdx.x * kSpan;
    const int x0 = base + w * kPer;
    const bool letter = lane < kLetters;
    const int at = 4 * lane;  // this lane's first BWT byte of a row
    int k0[kPer], k1[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
        const int x = x0 + q;
        k0[q] = x < n ? __ldg(s0 + x) : 0;
        k1[q] = x < n ? __ldg(s1 + x) : 0;
    }
    // the words of every row of the warp's intervals, loaded before any
    // is counted; a dead interval (uniform in the warp) loads none
    unsigned w0[kPer], w1[kPer];
    int occ0[kPer], occ1[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
        w0[q] = w1[q] = 0u;
        occ0[q] = occ1[q] = 0;
        if (k0[q] < k1[q]) {
            const bool one = k0[q] >> 7 == k1[q] >> 7;
            const int* r0 = ix.row(k0[q] >> 7);
            const int* r1 = one ? r0 : ix.row(k1[q] >> 7);
            const int o0 = k0[q] & 127, o1 = k1[q] & 127;
            if (at < (one ? max(o0, o1) : o0))
                w0[q] = (unsigned)__ldg(r0 + 32 + lane);
            if (!one && at < o1) w1[q] = (unsigned)__ldg(r1 + 32 + lane);
            if (letter) {
                occ0[q] = __ldg(r0 + lane + 1);
                occ1[q] = one ? occ0[q] : __ldg(r1 + lane + 1);
            }
            if (one) w1[q] = w0[q];
        }
    }
    const int base_c = letter ? __ldg(C + lane + 1) : 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
        int a = 0, b = 0;  // letter lane + 1's pair
        if (k0[q] < k1[q]) {
            const int o0 = k0[q] & 127, o1 = k1[q] & 127;
            unsigned h0[5] = {0u, 0u, 0u, 0u, 0u};
            unsigned h1[5] = {0u, 0u, 0u, 0u, 0u};
#pragma unroll
            for (int y = 0; y < 4; ++y) {
                if (at + y < o0) count_letter(h0, (w0[q] >> (8 * y)) & 255u);
                if (at + y < o1) count_letter(h1, (w1[q] >> (8 * y)) & 255u);
            }
#pragma unroll
            for (int y = 0; y < 5; ++y) {
                h0[y] = __reduce_add_sync(kt::kFullMask, h0[y]);
                h1[y] = __reduce_add_sync(kt::kFullMask, h1[y]);
            }
            a = base_c + occ0[q] + letter_count(h0, lane);
            b = base_c + occ1[q] + letter_count(h1, lane);
            if (!(a < b)) a = b = 0;
        }
        if (letter) {
            res[0][lane][w * kPer + q] = a;
            res[1][lane][w * kPer + q] = b;
        }
    }
    __syncthreads();
    // letter c's results of the block's intervals: kSpan words in a row
    for (int t = threadIdx.x; t < 2 * kLetters * kSpan; t += kThreads) {
        const int h = t / (kLetters * kSpan);
        const int c = t / kSpan % kLetters, xs = t % kSpan;
        if (base + xs < n)
            (h ? n1 : n0)[(size_t)c * n + base + xs] = res[h][c][xs];
    }
}

template <class Ix>
int launch(const Ix& ix, const int* C, const int* c, const int* s0,
           const int* s1, int n, int* n0, int* n1, uint8_t* ok,
           cudaStream_t stream) {
    const long long threads = (long long)n * kG;
    update_si_kernel<<<(int)((threads + kThreads - 1) / kThreads), kThreads,
                       0, stream>>>(ix, C, c, s0, s1, n, n0, n1, ok);
    return static_cast<int>(cudaGetLastError());
}

template <class Ix>
int launch_letters(const Ix& ix, const int* C, const int* s0, const int* s1,
                   int n, int* n0, int* n1, cudaStream_t stream) {
    update_si_letters_kernel<<<(n + kSpan - 1) / kSpan, kThreads, 0,
                               stream>>>(ix, C, s0, s1, n, n0, n1);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

KT_EXPORT int kt_update_si(const int* rec, int nb1, const int* C,
                           const int* c, const int* s0, const int* s1, int n,
                           int* n0, int* n1, uint8_t* ok,
                           cudaStream_t stream) {
    return launch(kt::FlatIx{rec, nb1, nullptr, nullptr, 0, nullptr}, C, c,
                  s0, s1, n, n0, n1, ok, stream);
}

KT_EXPORT int kt_update_si_sharded(KT_SHARD_PARAMS, const int* C,
                                   const int* c, const int* s0,
                                   const int* s1, int n, int* n0, int* n1,
                                   uint8_t* ok, cudaStream_t stream) {
    return launch(KT_SHARD_IX, C, c, s0, s1, n, n0, n1, ok, stream);
}

KT_EXPORT int kt_update_si_letters(const int* rec, int nb1, const int* C,
                                   const int* s0, const int* s1, int n,
                                   int* n0, int* n1, cudaStream_t stream) {
    return launch_letters(kt::FlatIx{rec, nb1, nullptr, nullptr, 0, nullptr},
                          C, s0, s1, n, n0, n1, stream);
}

KT_EXPORT int kt_update_si_letters_sharded(KT_SHARD_PARAMS, const int* C,
                                           const int* s0, const int* s1,
                                           int n, int* n0, int* n1,
                                           cudaStream_t stream) {
    return launch_letters(KT_SHARD_IX, C, s0, s1, n, n0, n1, stream);
}
