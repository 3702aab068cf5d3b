// Kernel N: a round's queries to the index shards this process reads,
// answered for the processes of a group on several hosts (the owner's half
// of a step whose row lies on another host; parallel/exchange.py).
//
// Replaces the owner's half of kaiju_tpu's owner-computes steps, which
// every shard computes and a psum over the index axis assembles: the rank
// of _sharded_fmindex (kaiju_tpu/parallel/sharded_index.py:102-120) and
// _make_rank1 (kaiju_tpu/parallel/sharded_fused.py:52-75), and the LF step
// and sample of _make_walk (sample and body, :91-140).  Here only the
// owner is asked, and only for the lanes that need it.
//
// Contract: query t of q [Q] int32 (op, x), op = kind << 8 | letter
// (fm_common.cuh kQRank ...), its answer the W ints at ans + t W:
//   RANK (c, k): FMindex(c, k) = C[c] + #c in bwt[0, k);
//   ROW k: FMindex(c, k) for c = 1..20 in ans[0..19] (W >= 20), the
//     seed-table build's step (update_si_letters reads a row once for the
//     20 letters too);
//   LF k: kn = FMindex(c, k) for the BWT letter c at k, or ~kn at a
//     terminator (c == 0), where kn is the sequence's content rank
//     (kt::sa_walk's step);
//   SAMPLE slot: sa_seq[slot], and sa_off[slot] in ans[1] (W >= 2);
//   TEXT bt: the text bytes [128 bt, 128 bt + 128) as 32 words in
//     ans[0..31] (W >= 32), the hybrid's text row (kernel Y,
//     switch_hosts.cu), the counterpart of kaiju_tpu's _make_hyb.text_row
//     (kaiju_tpu/parallel/sharded_fused.py:153-175), owner-computed and
//     psum'd there like a rank.
// The words of an answer that its kind does not write are 0.  A query
// whose row, slot or text row lies in a shard that this process does not
// read, an unknown kind, a ROW with W < 20 or a TEXT with W < 32 counts in
// *bad (the exchange raises) and leaves its answer 0.
//
// Bound: one 256-byte record row (or one sample, or one 128-byte text row)
// a query, random rows of an index larger than the L2: the bytes of one
// row a query at 3.35 TB/s, and one dependent load (the row's words come
// in one round of loads).
// Design, by the round's width, which its kinds need:
// - W < 20, the rounds of RANK, LF and SAMPLE (the extension's, the
//   switch's and the walks'): a thread a query, its row's 16-byte groups
//   loaded together (kt::rank1), as many queries in flight as the card
//   holds threads; a parked lane's two ranks sit in neighbouring threads
//   (the exchange's sort is stable), where one load instruction serves
//   both where they read one row.  A group of 8 lanes a query ran these
//   rounds up to 1.5x slower (PERF.md section 6, row N): a random row
//   read wants many rows in flight, not one row's bytes in one line.
// - W >= 20, the seed tables' ROW rounds and the hybrid's TEXT rows: a
//   group of kG = 8 lanes takes two neighbouring queries.  Lane l loads
//   16-byte group l of each query's row, so a row's 128 BWT bytes come
//   as one coalesced line and a shuffle sums the counts; the two
//   queries' loads are issued together, one memory latency for both, and
//   where both read one row that row is loaded once.  LF takes the letter
//   and its occ word by shuffle from the lanes that hold them
//   (kt::lf_group's way); ROW counts the 20 letters from the same line,
//   each lane writing every 8th answer word; TEXT copies its row as 8
//   coalesced 16-byte loads and stores; SAMPLE is one lane's load.
// Only the words that a kind does not write are zeroed.
#include "fm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kG = 8;                    // lanes a group
constexpr int kGroups = kThreads / kG;   // groups a block
constexpr int kLetters = 20;

// A query as its group reads it.
struct Query {
    int kind, c, x;
    bool good;       // answered here (else it counts in bad)
    bool rowed;      // RANK, LF or ROW: reads the record row of x >> 7
    const int* row;  // that row
    int need;        // the row's BWT bytes it counts (LF: through x)
};

__device__ __forceinline__ Query take(const kt::HostIx& ix,
                                      const int* __restrict__ q, int W) {
    Query r;
    const int op = __ldg(q), x = __ldg(q + 1);
    r.kind = op >> 8;
    r.c = op & 255;
    r.x = x;
    r.rowed = false;
    r.row = nullptr;
    r.need = 0;
    if (r.kind == kt::kQSample) {
        r.good = x >= 0 && x < ix.nsamp && ix.slot_here(x);
    } else if (r.kind == kt::kQText) {
        const int ntb = ix.nt_s >> 7;  // text rows a shard
        r.good = x >= 0 && ix.text != nullptr && ntb >= 1 && W >= 32 &&
                 x < ix.S * ntb && ix.text_here(x);
    } else {
        r.good = x >= 0 && ix.row_here(x >> 7) &&
                 (r.kind == kt::kQRank || r.kind == kt::kQLf ||
                  (r.kind == kt::kQRow && W >= kLetters));
        r.rowed = r.good;
        if (r.good) {
            r.row = ix.row(x >> 7);
            r.need = (x & 127) + (r.kind == kt::kQLf ? 1 : 0);
        }
    }
    return r;
}

// What a lane loads for a query: v its 16-byte group of the BWT bytes (or
// of a TEXT row), o its group of the occ words (LF), h the head words
// (RANK: C[c] + occ[c] on lane 0; ROW: C[l] + occ[l] for l = gl + 1 + 8 j;
// SAMPLE: the sample and its offset on lane 0).
struct Got {
    uint4 v, o;
    int h[3];
};

// The words of a row-reading query beside the row's bytes: LF's occ
// group, RANK's head, ROW's three heads.
__device__ __forceinline__ void load_heads(const int* __restrict__ C,
                                           const Query& r, int gl, Got& g) {
    if (r.kind == kt::kQLf) {
        g.o = __ldg(reinterpret_cast<const uint4*>(r.row) + gl);
    } else if (r.kind == kt::kQRank) {
        if (gl == 0) g.h[0] = __ldg(C + r.c) + __ldg(r.row + r.c);
    } else {  // ROW
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const int l = gl + 1 + kG * j;
            if (l <= kLetters) g.h[j] = __ldg(C + l) + __ldg(r.row + l);
        }
    }
}

// What lane gl loads for query r; a row-reading query's BWT bytes
// through `need` (its own, or the further of a pair's on one row).
__device__ __forceinline__ Got load(const kt::HostIx& ix,
                                    const int* __restrict__ C,
                                    const Query& r, int need, int gl,
                                    int W) {
    Got g;
    g.v = g.o = make_uint4(0, 0, 0, 0);
    g.h[0] = g.h[1] = g.h[2] = 0;
    if (!r.good) return g;
    if (r.rowed) {
        if (gl * 16 < need)
            g.v = __ldg(reinterpret_cast<const uint4*>(r.row + 32) + gl);
        load_heads(C, r, gl, g);
    } else if (r.kind == kt::kQText) {
        const int ntb = ix.nt_s >> 7;
        const int o = ix.text_shard(r.x);
        g.v = __ldg(reinterpret_cast<const uint4*>(
                        ix.text[o] + (size_t)(r.x - o * ntb) * 128) + gl);
    } else if (gl == 0) {  // SAMPLE
        g.h[0] = ix.seq(r.x);
        if (W > 1) g.h[1] = ix.off(r.x);
    }
    return g;
}

__device__ __forceinline__ int group_sum(int v, unsigned gmask) {
#pragma unroll
    for (int o = kG / 2; o > 0; o >>= 1) v += __shfl_xor_sync(gmask, v, o, kG);
    return v;
}

// Words [from, W) of answer a set to 0 by the group's lanes.
__device__ __forceinline__ void zero_from(int* a, int from, int W, int gl) {
    for (int w = from + gl; w < W; w += kG) a[w] = 0;
}

// Query r answered from what its lanes loaded (g) into a [W].
__device__ __forceinline__ void answer(const int* __restrict__ C,
                                       const Query& r, const Got& g, int* a,
                                       int W, int gl, unsigned gmask,
                                       int* __restrict__ bad) {
    if (!r.good) {
        zero_from(a, 0, W, gl);
        if (gl == 0) atomicAdd(bad, 1);
        return;
    }
    const int o = r.x & 127;
    if (r.kind == kt::kQRank) {
        const unsigned pat = 0x01010101u * (unsigned)r.c;
        const int n = group_sum(kt::count_eq16(g.v, pat, o - 16 * gl) + g.h[0],
                                gmask);
        if (gl == 0) a[0] = n;
        zero_from(a, 1, W, gl);
    } else if (r.kind == kt::kQLf) {
        // the letter at o: its 16-byte group o >> 4 is lane (o >> 4)'s
        const int b = o & 15;
        const unsigned word = b < 4 ? g.v.x : b < 8 ? g.v.y
                              : b < 12 ? g.v.z : g.v.w;
        const int letter = __shfl_sync(
            gmask, (int)(word >> ((b & 3) * 8)) & 255, o >> 4, kG);
        // its occ word: group letter >> 2, lane (letter >> 2)'s
        const int e = letter & 3;
        const int occ = __shfl_sync(
            gmask, (int)(e == 0 ? g.o.x : e == 1 ? g.o.y : e == 2 ? g.o.z
                                                                  : g.o.w),
            letter >> 2, kG);
        const unsigned pat = 0x01010101u * (unsigned)letter;
        const int kn = __ldg(C + letter) + occ +
                       group_sum(kt::count_eq16(g.v, pat, o - 16 * gl), gmask);
        if (gl == 0) a[0] = letter == 0 ? ~kn : kn;
        zero_from(a, 1, W, gl);
    } else if (r.kind == kt::kQRow) {
#pragma unroll
        for (int l = 1; l <= kLetters; ++l) {
            const int n = group_sum(
                kt::count_eq16(g.v, 0x01010101u * (unsigned)l, o - 16 * gl),
                gmask);
            if (((l - 1) & (kG - 1)) == gl) a[l - 1] = g.h[(l - 1) / kG] + n;
        }
        zero_from(a, kLetters, W, gl);
    } else if (r.kind == kt::kQText) {
        if ((W & 3) == 0) {
            reinterpret_cast<uint4*>(a)[gl] = g.v;
        } else {
            a[4 * gl] = (int)g.v.x;
            a[4 * gl + 1] = (int)g.v.y;
            a[4 * gl + 2] = (int)g.v.z;
            a[4 * gl + 3] = (int)g.v.w;
        }
        zero_from(a, 32, W, gl);
    } else {  // SAMPLE
        if (gl == 0) {
            a[0] = g.h[0];
            if (W > 1) a[1] = g.h[1];
        }
        zero_from(a, 2, W, gl);
    }
}

// The rounds of width W >= kLetters: a group of kG lanes takes two
// neighbouring queries.
__global__ void __launch_bounds__(kThreads) fm_serve_kernel(
    const kt::HostIx ix, const int* __restrict__ C,
    const int* __restrict__ q, int Q, int W, int* __restrict__ ans,
    int* __restrict__ bad) {
    const int t = 2 * (blockIdx.x * kGroups + threadIdx.x / kG);
    if (t >= Q) return;  // whole groups leave together
    const int gl = threadIdx.x & (kG - 1);
    const unsigned gmask = kt::group_mask<kG>(threadIdx.x & 31);
    // queries t and t + 1
    const bool two = t + 1 < Q;
    const Query r0 = take(ix, q + 2 * (size_t)t, W);
    Query r1 = r0;
    if (two) r1 = take(ix, q + 2 * (size_t)t + 2, W);
    // one row for both where both read it: loaded once, through the
    // further of their offsets
    const bool share = two && r0.rowed && r1.rowed && r0.row == r1.row;
    const Got g0 = load(ix, C, r0, share ? max(r0.need, r1.need) : r0.need,
                        gl, W);
    Got g1 = g0;
    if (share) {  // the row's bytes are g0's
        g1.o = make_uint4(0, 0, 0, 0);
        g1.h[0] = g1.h[1] = g1.h[2] = 0;
        load_heads(C, r1, gl, g1);
    } else if (two) {
        g1 = load(ix, C, r1, r1.need, gl, W);
    }
    answer(C, r0, g0, ans + (size_t)t * W, W, gl, gmask, bad);
    if (two) answer(C, r1, g1, ans + (size_t)(t + 1) * W, W, gl, gmask, bad);
}

// The rounds of width W < kLetters: a thread a query.  ROW and TEXT need
// a wider answer, so here they count in bad.
__global__ void __launch_bounds__(kThreads) fm_serve_thread_kernel(
    const kt::HostIx ix, const int* __restrict__ C,
    const int* __restrict__ q, int Q, int W, int* __restrict__ ans,
    int* __restrict__ bad) {
    const int t = blockIdx.x * kThreads + threadIdx.x;
    if (t >= Q) return;
    const int op = __ldg(q + 2 * (size_t)t), x = __ldg(q + 2 * (size_t)t + 1);
    const int kind = op >> 8;
    int v0 = 0, v1 = 0;
    if (kind == kt::kQSample && x >= 0 && x < ix.nsamp && ix.slot_here(x)) {
        v0 = ix.seq(x);
        if (W > 1) v1 = ix.off(x);
    } else if ((kind == kt::kQRank || kind == kt::kQLf) && x >= 0 &&
               ix.row_here(x >> 7)) {
        const int c = kind == kt::kQRank
                          ? op & 255
                          : kt::bwt_byte(ix.row(x >> 7), x & 127);
        const int kn = kt::rank1(ix, C, c, x);
        v0 = kind == kt::kQLf && c == 0 ? ~kn : kn;
    } else {
        atomicAdd(bad, 1);
    }
    int* a = ans + (size_t)t * W;
    a[0] = v0;
    if (W > 1) a[1] = v1;
    for (int w = 2; w < W; ++w) a[w] = 0;
}

}  // namespace

// Kernel N: q [Q] answered into ans [Q, W]; bad counts the queries it
// cannot answer.
KT_EXPORT int kt_fm_serve(KT_SHARD_PARAMS, const int* C, const int* q, int Q,
                          int W, int* ans, int* bad, cudaStream_t stream) {
    if (Q == 0) return 0;
    if (W < kLetters) {
        fm_serve_thread_kernel<<<(Q + kThreads - 1) / kThreads, kThreads, 0,
                                 stream>>>(KT_HOST_IX, C, q, Q, W, ans, bad);
        return static_cast<int>(cudaGetLastError());
    }
    const long long groups = ((long long)Q + 1) / 2;
    fm_serve_kernel<<<(int)((groups + kGroups - 1) / kGroups), kThreads, 0,
                      stream>>>(KT_HOST_IX, C, q, Q, W, ans, bad);
    return static_cast<int>(cudaGetLastError());
}
