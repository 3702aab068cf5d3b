// Kernel Y: the text-compare hybrid's switch over the shards of a group of
// processes on several hosts (kt::HostIx), an occurrence whose walk step,
// SA sample or text row lies on another host parking with its query for
// the owner (kernel N, fm_serve.cu; parallel/exchange.py runs the rounds,
// stage "switch" for the walks, then stage "text" for the text rows).
//
// Replaces, for kaiju_tpu's sharded paths over a mesh of hosts, K8's
// _switch_pool (kaiju_tpu/ops/fused_mem2.py:426-525) and _text_extend
// (:228-274) on _make_walk's walks with positions (want_pos,
// kaiju_tpu/parallel/sharded_fused.py:78-150) and _make_hyb.text_row
// (:153-175), whose rows every shard computes and a psum assembles.  It is
// the hosts counterpart of ops/hybrid.py switch_plain, which kernel G (the
// MEM funnel) and kernel E's last level share on one host, so the MEM and
// the Greedy hosts paths share it too.
//
// Contract: n intervals [s0, s1) of 1 to kSwWcap occurrences, interval r
// with its query end qg[r] (a flat index) and avail[r] letters left.
// Occurrence o = 8 r + q (q < s1 - s0) walks from SA row s0 + q to its
// sequence iseq and offset pos as kt::walk_group does (an LF step,
// kt::lf_group, while the row is not sampled; a terminator ends the walk
// with the content rank and the steps taken; a sample gives sa_seq and
// sa_off + steps), then compares the text backward from p = rank_start
// [iseq] + pos with the query from qg (kt::match_back, G's compare: the
// longest u with text[p-1-t] == flat[qg-1-t] for t < u, stopping at
// min(avail, p) and at a text code of 0).  Its reach goes to ext[o] and
// iseq to ids[o]; the start form sets ext -1 and ids 0 for q >= s1 - s0.
// A step whose row, a sample whose slot or a compare whose text row lies
// in a remote shard parks the occurrence: (o, kind, a, b) to park_out
// [*n_park, 4], kind 0 a walk at SA row a after b steps, with its query
// (kQLf a) or (kQSample slot); kind 1 a compare at text position a with
// b letters matched, with (kQText row), the row of text byte a - 1 - b.
// The resume form (park_in [L, 4], ans_in [L, W]: W = 2 for walks, 32 for
// text rows) applies each answer (LF: the next row, or ~content rank at a
// terminator; SAMPLE: sa_seq, sa_off; TEXT: the row's 128 bytes, compared
// up to the row's start) and goes on; a compare may cross into the row
// before, which may lie on another shard, and park again.  The finish form
// (a thread an interval) gives (maxext, n_ach, ids[8]): the longest
// reach, how many occurrences reach it and their ids in SA order, zeros
// after them, bit for bit switch_plain's.
//
// Bound: a chain of dependent row reads an occurrence (its walk, one
// 256-byte record row a step, then the compare's text rows, 128 bytes
// each, one round of loads each); the longest at the L2's latency.
// Design: a group of kG = 8 lanes an occurrence, as G's pass 2: a walk
// step's row read as one coalesced line in one memory latency
// (kt::lf_group), the compare 64 letters a round (kt::match_back), one
// global atomic a parked occurrence.  A simple kernel: every occurrence
// of the start form is a group of its own, none waits for another's.
#include "text_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kG = 8;  // lanes an occurrence
constexpr int kWalk = 0, kText = 1;  // the kinds of a parked occurrence

struct Args {
    kt::HostIx ix;
    const int* C;
    int nseq, chpt_exp;
    const int* rank_start;
    const uint8_t* flat;
    const int *qg, *avail;  // [n]
    int* ext;               // [n, 8]
    int* ids;               // [n, 8]
    int* park_out;          // [*, 4]
    int* q_out;             // [*, 2]
    int* n_park;
};

__device__ __forceinline__ void park(const Args& a, int o, int kind, int x,
                                     int y, int qkind, int qx) {
    const int s = atomicAdd(a.n_park, 1);
    reinterpret_cast<int4*>(a.park_out)[s] = make_int4(o, kind, x, y);
    reinterpret_cast<int2*>(a.q_out)[s] = make_int2(qkind << 8, qx);
}

// Byte x of a text row answered by kernel N (32 words from byte lo).
struct RowLetter {
    const int* w;
    int lo;
    __device__ __forceinline__ int operator()(int x) const {
        const int b = x - lo;
        return (__ldg(w + (b >> 2)) >> ((b & 3) * 8)) & 255;
    }
};

// The compare of occurrence o from u letters matched at text position p,
// on this host's text rows; at a remote row it parks.
__device__ __forceinline__ void compare(const Args& a, int o, int p, int u,
                                        int gl, unsigned gmask) {
    const int r = o >> 3, qg = __ldg(a.qg + r);
    const int lim = min(__ldg(a.avail + r), p);
    while (u < lim) {
        const int bt = (p - 1 - u) >> 7;
        if (!a.ix.text_here(bt)) {
            if (gl == 0) park(a, o, kText, p, u, kt::kQText, bt);
            return;
        }
        const int end = min(lim, p - (bt << 7));  // this row's letters
        const int e = kt::match_back<kG>(kt::IxLetter<kt::HostIx>{a.ix},
                                         a.flat, p, qg, u, end, gl, gmask);
        u = e;
        if (e < end) break;
    }
    if (gl == 0) a.ext[o] = u;
}

// The walk of occurrence o from SA row k after `steps` steps, on this
// host's rows, then its compare; at a remote row or slot it parks.
__device__ __forceinline__ void walk(const Args& a, int o, int k, int steps,
                                     int gl, unsigned gmask) {
    const int check = (1 << a.chpt_exp) - 1;
    int iseq, pos;
    for (;;) {
        if (k & check) {
            if (!a.ix.row_here(k >> 7)) {
                if (gl == 0) park(a, o, kWalk, k, steps, kt::kQLf, k);
                return;
            }
            int c;
            const int kn = kt::lf_group<kG>(a.ix, a.C, k, gl, gmask, &c);
            if (c == 0) {  // a terminator: the content rank
                iseq = kn;
                pos = steps;
                break;
            }
            k = kn;
            ++steps;
            continue;
        }
        const int slot = kt::sample_slot(k, a.nseq, a.chpt_exp, a.ix.nsamp);
        if (!a.ix.slot_here(slot)) {
            if (gl == 0) park(a, o, kWalk, k, steps, kt::kQSample, slot);
            return;
        }
        iseq = a.ix.seq(slot);
        pos = a.ix.off(slot) + steps;
        break;
    }
    if (gl == 0) a.ids[o] = iseq;
    const int p =
        __ldg(a.rank_start + min(max(iseq, 0), a.nseq - 1)) + pos;
    compare(a, o, p, 0, gl, gmask);
}

// The start form: group g takes occurrence g of n intervals.
__global__ void __launch_bounds__(kThreads) switch_start_kernel(
    const Args a, const int* __restrict__ s0, const int* __restrict__ s1,
    int n) {
    const int o = (blockIdx.x * kThreads + threadIdx.x) / kG;
    if (o >= n * kt::kSwWcap) return;  // whole groups leave together
    const int lane = threadIdx.x & 31, gl = lane % kG;
    const unsigned gmask = kt::group_mask<kG>(lane);
    const int r = o >> 3, q = o & 7;
    const int a0 = __ldg(s0 + r);
    if (gl == 0) {
        a.ext[o] = -1;
        a.ids[o] = 0;
    }
    if (q >= __ldg(s1 + r) - a0) return;
    walk(a, o, a0 + q, 0, gl, gmask);
}

// The resume form: group g applies parked occurrence g's answer (W words
// a row) and goes on.
__global__ void __launch_bounds__(kThreads) switch_resume_kernel(
    const Args a, const int* __restrict__ park_in,
    const int* __restrict__ ans_in, int L, int W) {
    const int g = (blockIdx.x * kThreads + threadIdx.x) / kG;
    if (g >= L) return;  // whole groups leave together
    const int lane = threadIdx.x & 31, gl = lane % kG;
    const unsigned gmask = kt::group_mask<kG>(lane);
    const int4 pk = reinterpret_cast<const int4*>(park_in)[g];
    const int o = pk.x;
    const int* ans = ans_in + (size_t)g * W;
    if (pk.y == kText) {
        const int p = pk.z, r = o >> 3;
        const int lim = min(__ldg(a.avail + r), p);
        const int lo = ((p - 1 - pk.w) >> 7) << 7;
        const int end = min(lim, p - lo);
        const int e = kt::match_back<kG>(RowLetter{ans, lo}, a.flat, p,
                                         __ldg(a.qg + r), pk.w, end, gl,
                                         gmask);
        if (e < end) {
            if (gl == 0) a.ext[o] = e;
            return;
        }
        compare(a, o, p, e, gl, gmask);
        return;
    }
    const int check = (1 << a.chpt_exp) - 1;
    const int k = pk.z, steps = pk.w, v = __ldg(ans);
    int iseq, pos;
    if (k & check) {  // an LF step: the next row, or a terminator
        if (v >= 0) {
            walk(a, o, v, steps + 1, gl, gmask);
            return;
        }
        iseq = ~v;
        pos = steps;
    } else {  // a sample
        iseq = v;
        pos = __ldg(ans + 1) + steps;
    }
    if (gl == 0) a.ids[o] = iseq;
    const int p =
        __ldg(a.rank_start + min(max(iseq, 0), a.nseq - 1)) + pos;
    compare(a, o, p, 0, gl, gmask);
}

// The finish form: a thread an interval, its occurrences' reaches and ids
// to (maxext, n_ach, ids in SA order, zeros after them).
__global__ void __launch_bounds__(kThreads) switch_finish_kernel(
    const int* __restrict__ ext, const int* __restrict__ ids, int n,
    int* __restrict__ maxext, int* __restrict__ n_ach,
    int* __restrict__ out_ids) {
    const int r = blockIdx.x * kThreads + threadIdx.x;
    if (r >= n) return;
    int e[kt::kSwWcap], id[kt::kSwWcap];
    int best = -1;
#pragma unroll
    for (int q = 0; q < kt::kSwWcap; ++q) {
        e[q] = __ldg(ext + (size_t)r * kt::kSwWcap + q);
        id[q] = __ldg(ids + (size_t)r * kt::kSwWcap + q);
        best = max(best, e[q]);
    }
    int nid = 0;
    int* o = out_ids + (size_t)r * kt::kSwWcap;
#pragma unroll
    for (int q = 0; q < kt::kSwWcap; ++q)
        if (e[q] == best) o[nid++] = id[q];
    for (int q = nid; q < kt::kSwWcap; ++q) o[q] = 0;
    maxext[r] = best;
    n_ach[r] = nid;
}

}  // namespace

// Kernel Y: form 0 starts the n intervals (s0, s1) [n], form 1 resumes
// the parked occurrences park_in [L, 4] with their answers ans_in [L, W],
// both appending to park_out [*n_park, 4] and q_out [*n_park, 1, 2];
// form 2 finishes the n intervals into maxext, n_ach [n] and out_ids
// [n, 8].  qg, avail [n]; ext, ids [n, 8] the occurrences' state.
KT_EXPORT int kt_switch_hosts(
    int form, KT_SHARD_PARAMS, const int* C, int nseq, int chpt_exp,
    const int* rank_start, const uint8_t* flat, const int* qg,
    const int* avail, int n, const int* s0, const int* s1,
    const int* park_in, const int* ans_in, int L, int W, int* ext, int* ids,
    int* park_out, int* q_out, int* n_park, int* maxext, int* n_ach,
    int* out_ids, cudaStream_t stream) {
    const Args a{KT_HOST_IX, C,  nseq,     chpt_exp, rank_start, flat,
                 qg,         avail, ext, ids,      park_out,   q_out,
                 n_park};
    if (form == 0) {
        const long long threads = (long long)n * kt::kSwWcap * kG;
        switch_start_kernel<<<(int)((threads + kThreads - 1) / kThreads),
                              kThreads, 0, stream>>>(a, s0, s1, n);
    } else if (form == 1) {
        const long long threads = (long long)L * kG;
        switch_resume_kernel<<<(int)((threads + kThreads - 1) / kThreads),
                               kThreads, 0, stream>>>(a, park_in, ans_in, L,
                                                      W);
    } else {
        switch_finish_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                               stream>>>(ext, ids, n, maxext, n_ach,
                                         out_ids);
    }
    return static_cast<int>(cudaGetLastError());
}
