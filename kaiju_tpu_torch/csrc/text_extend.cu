// Kernel G: the text-compare finish of kernel B's narrow lanes (the MEM
// funnel of a text-carrying index).
//
// Replaces kaiju_tpu/ops/fused_mem2.py:_switch_pool (K8, :426-525) with
// _text_extend (:228-274) and K4's _walk_pos (:345-416) under it.  The JAX
// pool compacts one slot per occurrence into a capacity, aligns 128-byte
// text and query windows with shift ladders (_align_rev, build_flatp) and
// retries when the pool overflows: all XLA:TPU devices.  Here the
// switched lanes' occurrences go to one list sized to the batch, and
// groups of lanes read the flat text and query directly.
//
// Contract: a lane p (fragment f, end j) of B's output (i, s0, s1) is
// switched when i > 0, j - i + 1 == sw_len (B stopped it after the seed
// and its burn-in steps) and 1 <= s1 - s0 <= kSwWcap.  Each occurrence
// s0 + q is walked to its sequence and offset, p_t = rank_start[iseq] +
// pos, and compared backwards with the query from qg = frag_off[f] + i,
// with i letters left (kt::text_extend_group).  The lane's result is
// (i - maxext, kVBase + 8 p, kVBase + 8 p + n), where the n occurrences
// reaching maxext leave their sequence ids, in SA order, in
// sw_ids[8 p, 8 p + n): exactly the interval the FM steps would end on.
// Other lanes pass through unchanged.
//
// Bound: one random 256-byte record row per LF step of the walks, the
// text and query bytes compared, plus B's lanes read once and written
// once; device-memory bytes at 3.35 TB/s.  But an occurrence's walk is a
// chain of dependent row reads (a geometric count of LF steps, one slot in
// 2^chpt_exp sampled: 63 for the longest of phase 3's 47,608), and its
// compare a chain of letter rounds, so a launch lasts at least as long as
// the longest walk and its compare; and with all walks under way the
// steps' row sectors load the memory system.  The first design ran each
// switched lane on one thread, its occurrences one after another, every
// LF step 4-5 device-memory latencies (the letter's load, then the rank's
// loads one after another).  A warp per switched lane (a lane of it per
// occurrence) was slower still (5.6x on the 64 Maa DB): a long match
// switches at every one of its end positions, so switched lanes come in
// runs, and a warp ran a run's 32 switches one after another.  Lists kept
// by each block of 256 positions, as kernel B keeps its lanes, held a
// block on its SM until its longest walk ended, so later blocks started
// late; groups narrower than 8 lanes split a row's loads over more
// instructions (PERF.md, section 6).
// Design: three passes, launched in turn on the stream after the lists'
// counters are zeroed.  Pass 1 (text_extend_list, a thread a position) writes
// the lanes that do not switch through; a switched lane takes its place in a
// list of lanes and its occurrences theirs, in SA order, in a list of
// occurrences, both in the wrapper's scratch (a warp's lanes reserve their
// places with one atomic; a warp with a narrow lane finds its fragments with a
// 32-way search).  Pass 2 (text_extend_switch), as many blocks as the card
// holds at once: each occurrence taken by a group of 8 lanes, each group
// taking the next as soon as its own ends: the walk to the text position
// (kt::walk_group: a group's LF step reads its row as one coalesced line in
// one memory latency) and the backward compare (kt::text_extend_group: 64
// letters a round), its reach to the list and its id to the lane's slot.  So
// every walk starts at once, none waits for another's block.  Pass 3
// (text_extend_keep, a thread a listed lane) keeps the occurrences that reach
// the longest extension, in list order, which is SA order.
//
// kt_text_extend_sharded runs the same on an index split into shards
// (kt::ShardIx): the hybrid of K16d, kaiju_tpu/parallel/sharded_fused.py:
// _make_walk with want_pos (:78-150) and _make_hyb.text_row (:153-175),
// whose text rows are owned by the row ranges that match the BWT shards.
#include "text_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kG = 8;  // lanes a group of pass 2

// The wrapper's int32 scratch of 4 + 14 P words: the counters, then the
// two lists.
struct Lists {
    unsigned long long* count;  // occurrences listed (low word), lanes (high)
    int* next;  // pass 2's occurrences taken past each group's first
    int4* lane;  // [P] a switched lane: p, s0, query end, letters left
    int2* span;  // [P] its first occurrence in occ, its occurrences
    int* occ;    // [8 P] an occurrence: lane << 3 | q, then its reach

    Lists(int* scratch, int P)
        : count(reinterpret_cast<unsigned long long*>(scratch)),
          next(scratch + 2),
          lane(reinterpret_cast<int4*>(scratch + 4)),
          span(reinterpret_cast<int2*>(scratch + 4 + 4 * (size_t)P)),
          occ(scratch + 4 + 6 * (size_t)P) {}
};

// The owning fragment of position p among fragments lo..hi: the largest
// f <= hi with frag_off[f] <= p (an empty fragment shares its start with
// the next one, which owns it), given frag_off[lo] <= p.
__device__ __forceinline__ int owner(const int* __restrict__ frag_off,
                                     int lo, int hi, int p) {
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (__ldg(frag_off + mid) <= p) lo = mid; else hi = mid - 1;
    }
    return lo;
}

// owner(frag_off, 0, F - 1, p) by the whole warp, every lane with the same
// p: each round loads 32 evenly spaced starts at once and narrows the
// range 32-fold, so the search takes ~log32 F loads one after another,
// not log2 F.
__device__ __forceinline__ int warp_owner(const int* __restrict__ frag_off,
                                          int F, int p, int lane) {
    int lo = 0, hi = F - 1;
    while (lo < hi) {
        const int step = (hi - lo + 32) / 32;
        const int idx = lo + lane * step;
        const bool le = idx <= hi && __ldg(frag_off + idx) <= p;
        lo += (31 - __clz(__ballot_sync(kt::kFullMask, le))) * step;
        hi = min(hi, lo + step - 1);
    }
    return lo;
}

// Pass 1: a thread a position.  A warp with a narrow lane finds the owner
// of its first position (warp_owner) and loads the next 32 fragment
// starts; a lane's owner is the last of those at or before it (past 32
// starts, a rarity of empty fragments, a binary search from there).
__global__ void __launch_bounds__(kThreads) text_extend_list(
    int P, const int* __restrict__ frag_off, int F, int sw_len,
    const int* __restrict__ in_i, const int* __restrict__ in_s0,
    const int* __restrict__ in_s1, int* __restrict__ out_i,
    int* __restrict__ out_s0, int* __restrict__ out_s1, Lists L) {
    const int p = blockIdx.x * kThreads + threadIdx.x;
    const int lane = threadIdx.x & 31;
    int i = 0, a0 = 0, a1 = 0, n = 0, qg = 0;
    if (p < P) {
        i = __ldg(in_i + p);
        a0 = __ldg(in_s0 + p);
        a1 = __ldg(in_s1 + p);
    }
    const bool narrow =
        p < P && i > 0 && a1 > a0 && a1 - a0 <= kt::kSwWcap;
    if (__ballot_sync(kt::kFullMask, narrow)) {
        const int f0 = warp_owner(frag_off, F, p - lane, lane);
        const int nx = f0 + 1 + lane;
        const int start0 = __ldg(frag_off + f0);
        const int next = nx < F ? __ldg(frag_off + nx) : 0x7fffffff;
        int k = 0;  // the next starts at or before p
        for (int l = 0; l < 32; ++l)
            k += __shfl_sync(kt::kFullMask, next, l) <= p;
        int base = __shfl_sync(kt::kFullMask, next, max(k - 1, 0));
        if (k == 0) base = start0;
        if (k == 32 && narrow)
            base = __ldg(frag_off + owner(frag_off, f0 + 32, F - 1, p));
        if (narrow && p - base - i + 1 == sw_len) {
            n = a1 - a0;
            qg = base + i;
        }
    }
    if (p < P && n == 0) {
        out_i[p] = i;
        out_s0[p] = a0;
        out_s1[p] = a1;
    }
    const unsigned bal = __ballot_sync(kt::kFullMask, n > 0);
    if (bal == 0) return;  // the whole warp
    // a warp's switched lanes take their places in both lists with one
    // atomic
    const int incl = kt::warp_incl_sum(n, lane);
    unsigned long long at = 0;
    if (lane == 31)
        at = atomicAdd(L.count, (unsigned long long)__popc(bal) << 32 |
                                    (unsigned)incl);
    at = __shfl_sync(kt::kFullMask, at, 31);
    if (n == 0) return;
    const int ln = (int)(at >> 32) + __popc(bal & kt::lanes_below(lane));
    const int first = (int)(unsigned)at + incl - n;
    L.lane[ln] = make_int4(p, a0, qg, i);
    L.span[ln] = make_int2(first, n);
    for (int q = 0; q < n; ++q) L.occ[first + q] = ln << 3 | q;
}

// Pass 2, as many blocks as the card holds at once: group g of kG lanes
// takes occurrence g, then the next of the list's as soon as its own ends.
template <class Ix>
__global__ void __launch_bounds__(kThreads) text_extend_switch(
    const Ix ix, const int* __restrict__ C, int nseq, int chpt_exp,
    const int* __restrict__ rank_start, const uint8_t* __restrict__ flat,
    Lists L, int* __restrict__ sw_ids) {
    const int total = (int)(unsigned)*L.count;
    const int lane = threadIdx.x & 31, gl = lane & (kG - 1);
    const unsigned gmask = kt::group_mask<kG>(lane);
    const int groups = gridDim.x * (kThreads / kG);
    int o = (blockIdx.x * kThreads + threadIdx.x) / kG;
    while (o < total) {
        const int item = L.occ[o];
        const int4 ln = L.lane[item >> 3];
        __syncwarp(gmask);  // read by the whole group before it is reused
        const kt::WalkPos w = kt::walk_group<kG>(
            ix, C, nseq, chpt_exp, ln.y + (item & 7), gl, gmask);
        const int p =
            __ldg(rank_start + min(max(w.iseq, 0), nseq - 1)) + w.pos;
        const int e =
            kt::text_extend_group<kG>(ix, flat, p, ln.z, ln.w, gl, gmask);
        if (gl == 0) {
            L.occ[o] = e;
            sw_ids[kt::kSwWcap * ln.x + (item & 7)] = w.iseq;
            o = groups + atomicAdd(L.next, 1);
        }
        o = __shfl_sync(gmask, o, 0, kG);
    }
}

// Pass 3: a thread a listed lane keeps its occurrences that reach the
// longest extension, their ids moved down in its slots and the rest
// zeroed.
__global__ void __launch_bounds__(kThreads) text_extend_keep(
    Lists L, int* __restrict__ out_i, int* __restrict__ out_s0,
    int* __restrict__ out_s1, int* __restrict__ sw_ids) {
    const int lanes = (int)(*L.count >> 32);
    for (int t = blockIdx.x * kThreads + threadIdx.x; t < lanes;
         t += gridDim.x * kThreads) {
        const int4 ln = L.lane[t];
        const int2 sp = L.span[t];
        int* ids = sw_ids + kt::kSwWcap * ln.x;
        int ext[kt::kSwWcap], id[kt::kSwWcap];
        int best = 0;
#pragma unroll
        for (int q = 0; q < kt::kSwWcap; ++q) {
            ext[q] = q < sp.y ? L.occ[sp.x + q] : -1;
            id[q] = q < sp.y ? ids[q] : 0;
            best = max(best, ext[q]);
        }
        int nid = 0;
#pragma unroll
        for (int q = 0; q < kt::kSwWcap; ++q)
            if (ext[q] == best) ids[nid++] = id[q];
        for (int q = nid; q < sp.y; ++q) ids[q] = 0;
        out_i[ln.x] = ln.w - best;
        out_s0[ln.x] = kt::kVBase + kt::kSwWcap * ln.x;
        out_s1[ln.x] = kt::kVBase + kt::kSwWcap * ln.x + nid;
    }
}

// The blocks of `kernel` the current card holds at once, into *blocks.
template <class K>
cudaError_t resident(K kernel, int* blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    *blocks = max(1, sms * per_sm);
    return e;
}

template <class Ix>
int launch(const Ix& ix, const int* C, int nseq, int chpt_exp,
           const int* rank_start, const uint8_t* flat, int P,
           const int* frag_off, int F, int sw_len, const int* in_i,
           const int* in_s0, const int* in_s1, int* out_i, int* out_s0,
           int* out_s1, int* sw_ids, int* scratch, cudaStream_t stream) {
    int grid = 0;
    const cudaError_t e = resident(text_extend_switch<Ix>, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    const Lists L(scratch, P);
    cudaMemsetAsync(scratch, 0, 4 * sizeof(int), stream);
    text_extend_list<<<(P + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        P, frag_off, F, sw_len, in_i, in_s0, in_s1, out_i, out_s0, out_s1,
        L);
    text_extend_switch<Ix><<<grid, kThreads, 0, stream>>>(
        ix, C, nseq, chpt_exp, rank_start, flat, L, sw_ids);
    text_extend_keep<<<grid, kThreads, 0, stream>>>(L, out_i, out_s0,
                                                     out_s1, sw_ids);
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
                             int* out_s1, int* sw_ids, int* scratch,
                             cudaStream_t stream) {
    return launch(kt::FlatIx{rec, nb1, sa_seq, sa_off, nsamp, text}, C, nseq,
                  chpt_exp, rank_start, flat, P, frag_off, F, sw_len, in_i,
                  in_s0, in_s1, out_i, out_s0, out_s1, sw_ids, scratch,
                  stream);
}

KT_EXPORT int kt_text_extend_sharded(
    KT_SHARD_PARAMS, const int* C, int nseq, int chpt_exp,
    const int* rank_start, const uint8_t* flat, int P, const int* frag_off,
    int F, int sw_len, const int* in_i, const int* in_s0, const int* in_s1,
    int* out_i, int* out_s0, int* out_s1, int* sw_ids, int* scratch,
    cudaStream_t stream) {
    return launch(KT_SHARD_IX, C, nseq, chpt_exp, rank_start, flat, P,
                  frag_off, F, sw_len, in_i, in_s0, in_s1, out_i, out_s0,
                  out_s1, sw_ids, scratch, stream);
}
