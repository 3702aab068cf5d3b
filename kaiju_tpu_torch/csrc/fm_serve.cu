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
// Contract: query t is int32 (op, x), op = kind << 8 | letter
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
// A query whose row, slot or text row lies in a shard that this process
// does not read, an unknown kind, a ROW with W < 20 or a TEXT with W < 32
// counts in *bad (the exchange raises) and leaves its answer 0.
//
// Bound: one 256-byte record row (or one sample, or one 128-byte text row)
// a query, random rows of an index larger than the L2: the bytes of one
// row a query at 3.35 TB/s, and one dependent load (the row's words come
// in one round of loads).  Design: a thread a query, its row's 16-byte
// groups loaded together; ROW loads the row's bytes once and counts them
// for all 20 letters.
#include "fm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLetters = 20;

__global__ void __launch_bounds__(kThreads) fm_serve_kernel(
    const kt::HostIx ix, const int* __restrict__ C,
    const int* __restrict__ q, int Q, int W, int* __restrict__ ans,
    int* __restrict__ bad) {
    const int t = blockIdx.x * kThreads + threadIdx.x;
    if (t >= Q) return;
    const int op = __ldg(q + 2 * (size_t)t), x = __ldg(q + 2 * (size_t)t + 1);
    const int kind = op >> 8, c = op & 255;
    int* a = ans + (size_t)t * W;
    for (int w = 0; w < W; ++w) a[w] = 0;
    if (kind == kt::kQSample) {
        if (x < 0 || x >= ix.nsamp || !ix.slot_here(x)) {
            atomicAdd(bad, 1);
            return;
        }
        a[0] = ix.seq(x);
        if (W > 1) a[1] = ix.off(x);
        return;
    }
    if (kind == kt::kQText) {
        const int ntb = ix.nt_s >> 7;  // text rows a shard
        if (x < 0 || ix.text == nullptr || ntb < 1 || W < 32 ||
            x >= ix.S * ntb || !ix.text_here(x)) {
            atomicAdd(bad, 1);
            return;
        }
        const int o = ix.text_shard(x);
        const uint4* row = reinterpret_cast<const uint4*>(
            ix.text[o] + (size_t)(x - o * ntb) * 128);
        uint4 v[8];
#pragma unroll
        for (int h = 0; h < 8; ++h) v[h] = __ldg(row + h);
#pragma unroll
        for (int h = 0; h < 8; ++h) {
            a[4 * h] = (int)v[h].x;
            a[4 * h + 1] = (int)v[h].y;
            a[4 * h + 2] = (int)v[h].z;
            a[4 * h + 3] = (int)v[h].w;
        }
        return;
    }
    if (x < 0 || !ix.row_here(x >> 7) ||
        (kind != kt::kQRank && kind != kt::kQLf && kind != kt::kQRow) ||
        (kind == kt::kQRow && W < kLetters)) {
        atomicAdd(bad, 1);
        return;
    }
    if (kind == kt::kQRank) {
        a[0] = kt::rank1(ix, C, c, x);
    } else if (kind == kt::kQLf) {
        const int letter = kt::bwt_byte(ix.row(x >> 7), x & 127);
        const int kn = kt::rank1(ix, C, letter, x);
        a[0] = letter == 0 ? ~kn : kn;
    } else {  // ROW: the row's bytes before x once, counted for each letter
        const int* row = ix.row(x >> 7);
        const int o = x & 127;
        const uint4* w4 = reinterpret_cast<const uint4*>(row + 32);
        uint4 v[8];
#pragma unroll
        for (int h = 0; h < 8; ++h)
            v[h] = h * 16 < o ? __ldg(w4 + h) : make_uint4(0, 0, 0, 0);
        for (int l = 1; l <= kLetters; ++l) {
            const unsigned pat = 0x01010101u * (unsigned)l;
            int cnt = 0;
#pragma unroll
            for (int h = 0; h < 8; ++h)
                cnt += kt::count_eq16(v[h], pat, o - 16 * h);
            a[l - 1] = __ldg(C + l) + __ldg(row + l) + cnt;
        }
    }
}

}  // namespace

KT_EXPORT int kt_fm_serve(KT_SHARD_PARAMS, const int* C, const int* q, int Q,
                          int W, int* ans, int* bad, cudaStream_t stream) {
    fm_serve_kernel<<<(Q + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        KT_HOST_IX, C, q, Q, W, ans, bad);
    return static_cast<int>(cudaGetLastError());
}
