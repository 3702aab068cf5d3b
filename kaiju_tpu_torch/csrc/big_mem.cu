// Kernels L and M: the int64 owner-computes MEM step over an index of
// more than 2^31 letters (K17), on the shards of kt::BigShardIx.
//
// Replaces scripts/big_classify_demo.py:make_mesh_mem_step (:253-420), a
// jitted shard_map whose every FM step assembles the owner's count with a
// psum over the index axis and steps all lanes in lockstep.  On one card
// each lane reads its owner's row directly and runs on its own; the
// outputs are the same, lane for lane.
//
// L (kt_big_extend_all, :296-329): for every lane (r, j) of read codes
// uint8 [R, L], the maximal backward extension of the match ending at j:
// a lane on letter c0 > 0 starts from [C[c0], C[c0 + 1]) with i = j and
// extends one letter a step while i > 0, the letter before is not 0 and
// the interval stays non-empty.  A lane on code 0 keeps i = j and the
// interval of letter 1, [C[1], C[2]), as the JAX program leaves it.
// Out: i int32, s0 and s1 int64 [R, L].
//
// M (kt_big_sa_walk, :332-406): for every SA row kf int64 [n] (-1: no
// walk) the content-rank sequence id int64 [n], -1 where kf < 0: get_suffix
// reduced to the sequence id, an LF walk from kf until a sampled row (k >=
// first and (k - first) divisible by 2^e: the sample of slot (k - first)
// >> e, clipped into the slots as BigShardIx::seq clips it) or a
// terminator, where the LF result itself is the content rank of the
// sequence (as kt::sa_walk).
//
// Bound: L reads two random 256-byte record rows a step taken, M one a
// LF step; both read their lanes and write their outputs once.  Device-
// memory bytes at 3.35 TB/s; the walks are chains of dependent row
// reads.  The first design ran a lane on one thread: each FM step waited
// for several device-memory latencies in a row (the occ word, then the
// BWT bytes' 16-byte loads one after another; in M the letter first),
// and a warp of one-thread walks lasted as long as its longest.
//
// Design of L: a block a tile of kLanes lanes (whole reads when L <=
// kLanes), a group of kGL threads a lane, each step's loads issued
// together through kt::rank2_64 (one latency a step), every lane of the
// tile stepping in the same iteration.  Lanes of one read revisit each
// other's intervals: the lanes of an exact substring of the DB all end on
// the row of its start, each after j steps, so most of their steps (and
// the longest chain, 63 steps for 64 letters) repeat a neighbour's.  A
// lane that reaches position i with the interval that a lane to its left
// had at i extends from there exactly as that lane did: it stops and
// takes that lane's result.  Each lane writes its interval at each
// position to the tile's shared table; the lane one to its right reaches
// the same position one iteration later and compares.  An exact read's
// lanes merge once their match is unique, after ~9 steps.
//
// Design of M: lanes with equal kf get the same id, and equal kf lie next
// to each other (the lanes of one match, a read's lanes on code 0), so
// only the head of each run is walked.  Pass 1 (big_sa_walk_list, a
// thread a lane) cuts the lanes into warp-aligned windows of 32: a lane
// is a head when kf >= 0 and it is its window's first lane or its kf
// differs from the lane before; its run reaches to the next head or
// kf < 0 of the window (a ballot and a find-first-set).  A warp's heads
// take their places in a card-wide list in the wrapper's scratch with one
// atomic.  Pass 2 (big_sa_walk_run), as many blocks as the card holds at
// once: a group of kGM lanes walks a head (kt::lf_group64, the letter's
// row bytes, then its occ word) and writes its id to every lane of the
// run, then takes the next heads, a chunk at a time, as soon as its walk
// ends.
//
// In both, the groups of a warp take their steps in the same iteration
// (kt::rank2_64 and kt::lf_group64 take a flag for a group with no step):
// groups of one warp on diverged paths waited for their loads one path
// after the other (PERF.md, section 6).
#include "big_common.cuh"

namespace {

constexpr int kLanes = 64;  // lanes a block of L
constexpr int kGL = 4;      // threads a lane of L
constexpr int kThreadsL = kLanes * kGL;
constexpr int kThreads = 256;  // threads a block of M
constexpr int kGM = 8;         // lanes a walk of M
static_assert(kGL >= 4, "L's group writes i, s0 and s1 from three lanes");

// Kernel L: a block a tile of `per` lanes (whole reads when L <= kLanes).
__global__ void __launch_bounds__(kThreadsL) big_extend_all_kernel(
    const kt::BigShardIx ix, const uint8_t* __restrict__ codes, int R,
    int L, int per, int* __restrict__ out_i, int64_t* __restrict__ out_s0,
    int64_t* __restrict__ out_s1) {
    // by tile slot of a read's position: the interval a lane had there
    // and the lane (who, -1: none); by lane: the lane it merged into
    // (link, itself: none) and the result of a lane that ended
    __shared__ int64_t t_s0[kLanes], t_s1[kLanes], f_s0[kLanes],
        f_s1[kLanes];
    __shared__ int t_who[kLanes], link[kLanes], f_i[kLanes];
    const int slot = threadIdx.x / kGL, gl = threadIdx.x & (kGL - 1);
    const unsigned gmask = kt::group_mask<kGL>(threadIdx.x & 31);
    const int64_t flat = (int64_t)blockIdx.x * per + slot;
    const bool live = slot < per && flat < (int64_t)R * L;
    const int64_t r = live ? flat / L : 0;
    const int j = (int)(flat - r * L);
    const uint8_t* row = codes + r * L;
    // the lane: its match [i, j], interval [s0, s1) and x, the letter
    // before the match to extend with (0: the lane ends)
    int i = j, x = 0;
    int64_t s0 = 0, s1 = 0;
    bool active = live;
    if (gl == 0) {
        t_who[slot] = -1;
        link[slot] = slot;
    }
    if (live) {
        const int c0 = __ldg(row + j);
        const int c = c0 > 0 ? c0 : 1;
        s0 = kt::ldg64(ix.C + c);
        s1 = kt::ldg64(ix.C + c + 1);
        x = c0 > 0 && j > 0 ? __ldg(row + j - 1) : 0;
    }
    __syncthreads();
    if (x != 0 && gl == 0) {
        t_s0[slot] = s0;
        t_s1[slot] = s1;
        t_who[slot] = slot;
    }
    while (__syncthreads_or(active)) {
        const bool go = active && x != 0;
        const int xn = go && i > 1 ? __ldg(row + i - 2) : 0;
        int64_t n0, n1;
        kt::rank2_64<kGL>(ix, go, x, s0, s1, gl, gmask, &n0, &n1);
        const bool ok = go && n0 < n1;
        if (active && !ok) {  // the lane ends here
            active = false;
            if (gl == 0) {
                f_i[slot] = i;
                f_s0[slot] = s0;
                f_s1[slot] = s1;
            }
        }
        if (ok) {
            s0 = n0;
            s1 = n1;
            --i;
            x = xn;
        }
        const int ps = slot - (j - i);  // the slot of position i
        __syncthreads();
        // a lane to the left had this interval at this position: from
        // here on the two extend alike, to the same result
        bool merged = false;
        if (ok && ps >= 0) {
            const int who = t_who[ps];
            merged = who >= 0 && t_s0[ps] == s0 && t_s1[ps] == s1;
            if (merged) {
                active = false;
                if (gl == 0) link[slot] = who;
            }
        }
        __syncthreads();
        if (ok && !merged && ps >= 0 && gl == 0) {
            t_s0[ps] = s0;
            t_s1[ps] = s1;
            t_who[ps] = slot;
        }
    }
    if (!live) return;
    int k = slot;  // links lead to lanes further left: no cycle
    while (link[k] != k) k = link[k];
    if (gl == 0) out_i[flat] = f_i[k];
    if (gl == 1) out_s0[flat] = f_s0[k];
    if (gl == 2) out_s1[flat] = f_s1[k];
}

// The wrapper's int64 scratch of 2 + 2 n words: the counters, then the
// list of heads, each (kf, lane << 6 | run length).
struct Heads {
    unsigned long long* count;  // heads listed
    unsigned long long* next;   // pass 2's heads taken past the first wave
    longlong2* item;            // [n]

    Heads(int64_t* scratch)
        : count(reinterpret_cast<unsigned long long*>(scratch)),
          next(reinterpret_cast<unsigned long long*>(scratch + 1)),
          item(reinterpret_cast<longlong2*>(scratch + 2)) {}
};

// Pass 1: a thread a lane.  Lanes with kf < 0 get -1 here; a head lists
// its run for pass 2.
__global__ void __launch_bounds__(kThreads) big_sa_walk_list(
    const int64_t* __restrict__ kf, int64_t n, int64_t* __restrict__ ids,
    Heads H) {
    const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const int64_t k = t < n ? kt::ldg64(kf + t) : -1;
    const int64_t prev = __shfl_up_sync(kt::kFullMask, (long long)k, 1);
    const bool head = k >= 0 && (lane == 0 || k != prev);
    const unsigned heads = __ballot_sync(kt::kFullMask, head);
    const unsigned stops = __ballot_sync(kt::kFullMask, head || k < 0);
    if (t < n && k < 0) ids[t] = -1;
    if (heads == 0) return;  // the whole warp
    unsigned long long at = 0;
    if (lane == 0) at = atomicAdd(H.count, (unsigned long long)__popc(heads));
    at = __shfl_sync(kt::kFullMask, at, 0);
    if (!head) return;
    const unsigned after = stops & ~(kt::lanes_below(lane) | (1u << lane));
    const int len = (after ? __ffs(after) - 1 : 32) - lane;
    H.item[at + __popc(heads & kt::lanes_below(lane))] =
        make_longlong2(k, t << 6 | len);
}

// Pass 2, as many blocks as the card holds at once: group g of kGM lanes
// walks head g, then the heads of the chunks of `chunk` it takes from the
// list as soon as its own walks end (the groups of a warp that need a
// chunk take theirs with one atomic).  The groups of a warp take their
// steps in the same iteration: a group at a sampled row reads its sample
// where the others read their rows.
__global__ void __launch_bounds__(kThreads) big_sa_walk_run(
    const kt::BigShardIx ix, int64_t* __restrict__ ids, Heads H) {
    const int64_t total = (int64_t)*H.count;
    const int lane = threadIdx.x & 31, gl = lane & (kGM - 1);
    const unsigned gmask = kt::group_mask<kGM>(lane);
    const int64_t groups = (int64_t)gridDim.x * (kThreads / kGM);
    // a chunk of about an eighth of a group's share, at most 8 heads, so
    // that the atomics stay few and the groups end together
    const int64_t share = total / groups / 8;
    const int chunk = share < 1 ? 1 : (share > 8 ? 8 : (int)share);
    const int64_t check = ((int64_t)1 << ix.e) - 1;
    int64_t o = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / kGM;
    int64_t end = o + 1, k = 0, t = 0;
    int len = 0;
    bool have = o < total;  // the group walks a head
    if (have) {
        const longlong2 it = H.item[o];
        k = it.x;
        t = it.y >> 6;
        len = (int)(it.y & 63);
    }
    while (__any_sync(kt::kFullMask, have)) {
        const bool at = have && k >= ix.first && ((k - ix.first) & check) == 0;
        const int64_t sample = at ? ix.seq((k - ix.first) >> ix.e) : 0;
        int c;
        const int64_t kn =
            kt::lf_group64<kGM>(ix, have && !at, k, gl, gmask, &c);
        const bool done = at || (have && c == 0);
        if (have && !done) k = kn;
        if (done) {  // the id of the head's run: the sample or the LF result
            const int64_t id = at ? sample : kn;
            for (int q = gl; q < len; q += kGM) ids[t + q] = id;
            ++o;
        }
        const bool need = done && o == end;
        const unsigned needs = __ballot_sync(kt::kFullMask, need && gl == 0);
        if (needs) {
            const int lead = __ffs(needs) - 1;
            unsigned long long taken = 0;
            if (lane == lead)
                taken = atomicAdd(H.next, (unsigned long long)__popc(needs) *
                                              chunk);
            taken = __shfl_sync(kt::kFullMask, taken, lead);
            if (need) {
                const unsigned before =
                    needs & kt::lanes_below(lane & ~(kGM - 1));
                o = groups + (int64_t)(taken + __popc(before) * chunk);
                end = o + chunk;
            }
        }
        if (done) {
            have = o < total;
            if (have) {
                const longlong2 it = H.item[o];
                k = it.x;
                t = it.y >> 6;
                len = (int)(it.y & 63);
            }
        }
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

unsigned blocks_for(int64_t n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// The arguments that describe the big index: rec_tab (device array of S
// shard pointers) nb_s S C base alen.
KT_EXPORT int kt_big_extend_all(const int* const* rec_tab, int nb_s, int S,
                                const int64_t* C, const int64_t* base,
                                int alen, const uint8_t* codes, int R, int L,
                                int* out_i, int64_t* out_s0, int64_t* out_s1,
                                cudaStream_t stream) {
    const kt::BigShardIx ix{rec_tab, nb_s, S, C, base, alen,
                            nullptr, 0, 0, 0};
    const int per = L <= kLanes ? kLanes / L * L : kLanes;
    big_extend_all_kernel<<<(unsigned)(((int64_t)R * L + per - 1) / per),
                            kThreadsL, 0, stream>>>(ix, codes, R, L, per,
                                                    out_i, out_s0, out_s1);
    return static_cast<int>(cudaGetLastError());
}

// scratch: int64 [2 + 2 n], the heads' counters and list.
KT_EXPORT int kt_big_sa_walk(const int* const* rec_tab, int nb_s, int S,
                             const int64_t* C, const int64_t* base, int alen,
                             const int* const* seq_tab, int ns_s,
                             int64_t first, int e, const int64_t* kf,
                             int64_t n, int64_t* ids, int64_t* scratch,
                             cudaStream_t stream) {
    const kt::BigShardIx ix{rec_tab, nb_s, S, C, base, alen,
                            seq_tab, ns_s, first, e};
    int grid = 0;
    const cudaError_t err = resident(big_sa_walk_run, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Heads H(scratch);
    cudaMemsetAsync(scratch, 0, 2 * sizeof(int64_t), stream);
    big_sa_walk_list<<<blocks_for(n), kThreads, 0, stream>>>(kf, n, ids, H);
    big_sa_walk_run<<<grid, kThreads, 0, stream>>>(ix, ids, H);
    return static_cast<int>(cudaGetLastError());
}
