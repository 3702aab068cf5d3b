// Kernel G: the text-compare finish of kernel B's narrow lanes (the MEM
// funnel of a text-carrying index).
//
// Replaces kaiju_tpu/ops/fused_mem2.py:_switch_pool (K8, :426-525) with
// _text_extend (:228-274) and K4's _walk_pos (:345-416) under it.  The JAX
// pool compacts one slot per occurrence into a capacity, aligns 128-byte
// text and query windows with shift ladders (_align_rev, build_flatp) and
// retries when the pool overflows: all XLA:TPU devices.  Here each
// switched lane is one thread, which reads the flat text and query
// directly.
//
// Contract: a lane p (fragment f, end j) of B's output (i, s0, s1) is
// switched when i > 0, j - i + 1 == sw_len (B stopped it after the seed
// and its burn-in steps) and 1 <= s1 - s0 <= kSwWcap.  Each occurrence
// s0 + q is walked to its sequence and offset, p_t = rank_start[iseq] +
// pos, and compared backwards with the query from qg = frag_off[f] + i,
// with i letters left (kt::text_extend).  The lane's result is
// (i - maxext, kVBase + 8 p, kVBase + 8 p + n), where the n occurrences
// reaching maxext leave their sequence ids, in SA order, in
// sw_ids[8 p, 8 p + n): exactly the interval the FM steps would end on.
// Other lanes pass through unchanged.
//
// Bound: one random 256-byte record row per LF step of the walks, the
// text and query bytes compared, plus B's lanes read once and written
// once; device-memory bytes at 3.35 TB/s.  Design: a thread a lane, as in
// kernel B: it finds its fragment, tests the switch, and runs the switch
// of its own interval (kt::switch_serial: the walks of its occurrences
// one after the other, each a chain of dependent row reads, then the text
// comparison 8 bytes a load round).  A long match switches at every one
// of its end positions, so switched lanes come in runs; a thread a lane
// runs a run's switches side by side, where a warp per switched lane (a
// lane of it per occurrence) would take a run of 32 one after another
// (5.6x slower on the 64 Maa DB, whose intervals here hold one
// occurrence; PERF.md).
//
// kt_text_extend_sharded runs the same on an index split into shards
// (kt::ShardIx): the hybrid of K16d, kaiju_tpu/parallel/sharded_fused.py:
// _make_walk with want_pos (:78-150) and _make_hyb.text_row (:153-175),
// whose text rows are owned by the row ranges that match the BWT shards.
#include "text_common.cuh"

namespace {

template <class Ix>
__global__ void text_extend_kernel(
    const Ix ix, const int* __restrict__ C, int nseq, int chpt_exp,
    const int* __restrict__ rank_start, const uint8_t* __restrict__ flat,
    int P, const int* __restrict__ frag_off, int F, int sw_len,
    const int* __restrict__ in_i, const int* __restrict__ in_s0,
    const int* __restrict__ in_s1, int* __restrict__ out_i,
    int* __restrict__ out_s0, int* __restrict__ out_s1,
    int* __restrict__ sw_ids) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    int i = in_i[p], a0 = in_s0[p], a1 = in_s1[p];
    int lo = 0, hi = F - 1;  // owning fragment, as in kernel B
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (__ldg(frag_off + mid) <= p) lo = mid; else hi = mid - 1;
    }
    const int base = __ldg(frag_off + lo);
    if (i > 0 && p - base - i + 1 == sw_len && a1 > a0 &&
        a1 - a0 <= kt::kSwWcap) {
        int ids[kt::kSwWcap], n = 0;
        i -= kt::switch_serial(ix, C, nseq, chpt_exp, rank_start, flat, a0,
                               a1, base + i, i, ids, &n);
        const size_t slot = (size_t)kt::kSwWcap * p;
        for (int q = 0; q < n; ++q) sw_ids[slot + q] = ids[q];
        a0 = kt::kVBase + (int)slot;
        a1 = a0 + n;
    }
    out_i[p] = i;
    out_s0[p] = a0;
    out_s1[p] = a1;
}

template <class Ix>
int launch(const Ix& ix, const int* C, int nseq, int chpt_exp,
           const int* rank_start, const uint8_t* flat, int P,
           const int* frag_off, int F, int sw_len, const int* in_i,
           const int* in_s0, const int* in_s1, int* out_i, int* out_s0,
           int* out_s1, int* sw_ids, cudaStream_t stream) {
    const int threads = 128;
    text_extend_kernel<<<(P + threads - 1) / threads, threads, 0, stream>>>(
        ix, C, nseq, chpt_exp, rank_start, flat, P, frag_off, F, sw_len,
        in_i, in_s0, in_s1, out_i, out_s0, out_s1, sw_ids);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

KT_EXPORT int kt_text_extend(const int* rec, int nb1, const int* C,
                             const int* sa_seq, const int* sa_off, int nsamp,
                             int nseq, int chpt_exp, const uint8_t* text,
                             const int* rank_start, const uint8_t* flat, int P,
                             const int* frag_off, int F, int sw_len,
                             const int* in_i, const int* in_s0,
                             const int* in_s1, int* out_i, int* out_s0,
                             int* out_s1, int* sw_ids, cudaStream_t stream) {
    return launch(kt::FlatIx{rec, nb1, sa_seq, sa_off, nsamp, text}, C, nseq,
                  chpt_exp, rank_start, flat, P, frag_off, F, sw_len, in_i,
                  in_s0, in_s1, out_i, out_s0, out_s1, sw_ids, stream);
}

KT_EXPORT int kt_text_extend_sharded(
    KT_SHARD_PARAMS, const int* C, int nseq, int chpt_exp,
    const int* rank_start, const uint8_t* flat, int P, const int* frag_off,
    int F, int sw_len, const int* in_i, const int* in_s0, const int* in_s1,
    int* out_i, int* out_s0, int* out_s1, int* sw_ids, cudaStream_t stream) {
    return launch(KT_SHARD_IX, C, nseq, chpt_exp, rank_start, flat, P,
                  frag_off, F, sw_len, in_i, in_s0, in_s1, out_i, out_s0,
                  out_s1, sw_ids, stream);
}
