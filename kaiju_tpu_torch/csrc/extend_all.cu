// Kernel J: the maximal backward extension of every (fragment, end j)
// lane of a padded code matrix (bwt.c:265-293).
//
// Replaces kaiju_tpu/ops/device_index.py:extend_all (K2, :216-266), which
// MEM -v runs for the fragments with more than TIE_CAP ties
// (engine/mem_fast.py:_full_maps) and BatchRunner for its ExtendAll
// requests.  codes is uint8 [F, L] (0-padded), flen int32 [F].  A valid
// lane (j < flen[f]) starts from the interval of its own letter,
// [C[c_j], C[c_j + 1]) with i = j, and extends one letter a step (a letter
// 0 too) while i > 0 and the interval stays non-empty; it returns (start,
// si0, si1) = the last (i, s0, s1).  An invalid lane returns (j, 0, 0), as
// the JAX program leaves it.  The JAX program reads the unfused
// blocks/occ arrays; this kernel reads the fused records, which give the
// same ranks.
//
// Bound: two random 256-byte record rows per step taken, the codes read
// once and 12 bytes a lane written; device-memory bytes at 3.35 TB/s.
// The steps of a lane are a chain of dependent row reads, but a launch
// holds 10^5-10^6 lanes, and it is bound by the rate at which the card
// serves its steps' row sectors from device memory, which the first
// design (a lane on one thread, a step several device-memory latencies
// in a row) nearly reached: so this design cuts the steps that repeat a
// neighbour's.  More lanes in flight (groups of 2) did not raise the
// rate, nor did counting from the nearer end of a block; tables of the
// letter pairs' and triples' intervals saved only steps on rows the L2
// holds (PERF.md, section 6).
//
// Design (kernel L's, csrc/big_mem.cu, in int32): a block takes `per`
// fragments and packs their valid lanes into tiles of kLanes lanes, whole
// fragments while they fit (a longer fragment in pieces of kLanes), one
// tile after another; the padding lanes it writes apart.  A group of kG
// threads runs each lane of a tile, its step's loads issued together
// through kt::rank2_on with the next letter loaded beside them (one
// latency a step), and every lane of the tile steps in the same iteration
// (a group with no step takes the shuffles with its loads off).  Lanes of one
// fragment revisit each other's intervals: the lanes of an exact DB
// substring all end on the row of its start.  Each lane writes its
// interval at each position to the tile's shared table; the lane one to
// its right reaches that position an iteration later, and where its
// interval is equal it stops and takes that lane's result (equal
// intervals at one position extend alike).  The grid holds kWaves blocks
// for each block the card runs at once, or one a fragment when there are
// fewer.
//
// kt_extend_all_sharded runs the same on an index split into shards
// (kt::ShardIx): K16b, kaiju_tpu/parallel/sharded_index.py:
// make_sharded_extend_all (:123-182), K2 on the owner-computes rank.
#include "fm_common.cuh"

namespace {

constexpr int kLanes = 64;  // lanes a tile
constexpr int kG = 4;       // threads a lane
constexpr int kThreads = kLanes * kG;
constexpr int kFrags = 64;  // fragments a block at most
constexpr int kWaves = 4;   // blocks a resident slot takes in turn
static_assert(kFrags == 64, "the lengths' scan runs on two warps");

template <class Ix>
__global__ void __launch_bounds__(kThreads) extend_all_kernel(
    const Ix ix, const int* __restrict__ C, const uint8_t* __restrict__ codes,
    const int* __restrict__ flen, int F, int L, int per,
    int* __restrict__ start, int* __restrict__ si0, int* __restrict__ si1) {
    // first[q]: the block's lane where fragment f0 + q begins (its valid
    // lanes packed); by tile slot of a fragment's position: the interval a
    // lane had there and the lane (who, -1: none); by slot: the lane it
    // merged into (link, itself: none) and the result of a lane that ended
    __shared__ int first[kFrags + 1];
    __shared__ int t_s0[kLanes], t_s1[kLanes], t_who[kLanes], link[kLanes],
        f_i[kLanes], f_s0[kLanes], f_s1[kLanes];
    __shared__ int tile[2];  // the current tile's lanes [tile[0], tile[1])
    const int f0 = blockIdx.x * per;
    const int nf = min(per, F - f0);
    const int slot = threadIdx.x / kG, gl = threadIdx.x & (kG - 1);
    const unsigned gmask = kt::group_mask<kG>(threadIdx.x & 31);

    // the fragments' valid lengths, scanned (two warps), and the padding
    if (threadIdx.x < kFrags) {
        const int q = threadIdx.x;
        const int len = q < nf ? min(max(__ldg(flen + f0 + q), 0), L) : 0;
        first[q + 1] = kt::warp_incl_sum(len, q & 31);
    }
    if (threadIdx.x == 0) first[0] = 0;
    __syncthreads();
    if (threadIdx.x >= 32 && threadIdx.x < kFrags)
        first[threadIdx.x + 1] += first[32];
    for (int t = threadIdx.x; t < nf * L; t += kThreads) {
        const int q = t / L, j = t - q * L;
        if (j >= min(max(__ldg(flen + f0 + q), 0), L)) {
            const int64_t o = (int64_t)(f0 + q) * L + j;
            start[o] = j;
            si0[o] = 0;
            si1[o] = 0;
        }
    }
    __syncthreads();
    const int total = first[nf];
    int q = 0;  // thread 0: the fragment that holds lane tile[1]
    if (threadIdx.x == 0) tile[1] = 0;
    while (true) {
        // thread 0 cuts the next tile: whole fragments while they fit,
        // else kLanes lanes of the fragment that holds its first lane
        if (threadIdx.x == 0) {
            const int at = tile[1];
            while (q < nf && first[q + 1] <= at) ++q;
            int e = q;
            while (e < nf && first[e + 1] - at <= kLanes) ++e;
            tile[0] = at;
            tile[1] = e > q ? first[e] : min(at + kLanes, total);
        }
        __syncthreads();
        const int lo = tile[0], hi = tile[1];
        if (lo >= total) break;  // the whole block
        const int t = lo + slot;
        const bool live = t < hi;
        int p = 0;  // the fragment of lane t: the last p with first[p] <= t
        for (int h = nf; h - p > 1;) {
            const int m = (p + h) >> 1;
            if (first[m] <= t) p = m; else h = m;
        }
        const int j = t - first[p];
        const uint8_t* row = codes + (int64_t)(f0 + p) * L;
        // the lane: its match [i, j], interval [s0, s1) and x, the letter
        // before the match to extend with
        int i = j, s0 = 0, s1 = 0, x = 0;
        if (live) {
            const int c = __ldg(row + j);
            s0 = __ldg(C + c);
            s1 = __ldg(C + c + 1);
            x = j > 0 ? __ldg(row + j - 1) : 0;
        }
        if (gl == 0) {
            link[slot] = slot;
            t_who[slot] = live ? slot : -1;
            t_s0[slot] = s0;
            t_s1[slot] = s1;
        }
        bool active = live;
        while (__syncthreads_or(active)) {
            const bool go = active && i > 0;
            const int xn = go && i > 1 ? __ldg(row + i - 2) : 0;
            int n0, n1;
            kt::rank2_on<kG>(ix, C, go, x, s0, s1, gl, gmask, &n0, &n1);
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
            // the slot of position i, in this tile when >= 0.  A lane
            // that steps in iteration k stands at i = j - k - 1, so the
            // lanes of an iteration read and write distinct slots, each
            // its own, which the lanes to their left wrote in earlier
            // iterations: the barrier at the loop's head orders them.
            const int ps = slot - (j - i);
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
            __syncwarp();  // the group's reads of the slot before its write
            if (ok && !merged && ps >= 0 && gl == 0) {
                t_s0[ps] = s0;
                t_s1[ps] = s1;
                t_who[ps] = slot;
            }
        }
        if (live) {
            int k = slot;  // links lead to lanes further left: no cycle
            while (link[k] != k) k = link[k];
            const int64_t o = (int64_t)(f0 + p) * L + j;
            if (gl == 0) {
                start[o] = f_i[k];
                si0[o] = f_s0[k];
                si1[o] = f_s1[k];
            }
        }
        __syncthreads();  // the tables read before the next tile's
    }
}

template <class Ix>
int launch(const Ix& ix, const int* C, const uint8_t* codes, const int* flen,
           int F, int L, int* start, int* si0, int* si1, cudaStream_t stream) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, extend_all_kernel<Ix>, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    // kWaves blocks a resident slot, each with an equal share of the
    // fragments: a slot that drew short tiles takes the next block
    const int slots = kWaves * max(1, sms * per_sm);
    const int per = max(1, min(kFrags, (F + slots - 1) / slots));
    extend_all_kernel<<<(F + per - 1) / per, kThreads, 0, stream>>>(
        ix, C, codes, flen, F, L, per, start, si0, si1);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

KT_EXPORT int kt_extend_all(const int* rec, int nb1, const int* C,
                            const uint8_t* codes, const int* flen, int F,
                            int L, int* start, int* si0, int* si1,
                            cudaStream_t stream) {
    return launch(kt::FlatIx{rec, nb1, nullptr, nullptr, 0, nullptr}, C,
                  codes, flen, F, L, start, si0, si1, stream);
}

KT_EXPORT int kt_extend_all_sharded(KT_SHARD_PARAMS, const int* C,
                                    const uint8_t* codes, const int* flen,
                                    int F, int L, int* start, int* si0,
                                    int* si1, cudaStream_t stream) {
    return launch(KT_SHARD_IX, C, codes, flen, F, L, start, si0, si1, stream);
}
