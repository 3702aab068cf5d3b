// Kernel D: per-read MEM classification from per-fragment statistics:
// (lca, score, flags, n_ids) for each read.
//
// Replaces kaiju_tpu/ops/fused_classify.py:classify_tail / ranges_lca
// (K11) and the SA walk _sa_walk_local (K4) under them:
//   * the read's longest match over its S pop-order slots (rf_rows, -1 =
//     pad) and the slots that reach it;
//   * the first R SA positions of the contributing slots' tie ranges, in
//     slot order then tie order (T ties a slot);
//   * one SA walk per position to its sequence, seq_tax to its taxon;
//   * the capped unique set: a taxon is kept when it is new and fewer than
//     cap + 1 new taxa came before it (ConsumerThread.cpp:799-845);
//   * the LCA (util.cpp:194-263): one kept taxon is returned as it is;
//     otherwise taxa absent from the tree (depth 0) are dropped, the rest
//     lifted to the shallowest depth and climbed in lock step.
// flags: 1 = a contributing fragment had more than T ties, 2 = the R
// positions ran out before the id cap (total > R and at most cap unique
// taxa among them).  The host replays flagged reads exactly.
//
// Bound: the SA walks, one random 256-byte record row per LF step, plus
// the statistics rows the reads touch; device-memory bytes at 3.35 TB/s.
// Design: one warp per read.  Lane 0 expands the ranges into positions in
// shared memory, the 32 lanes walk the positions in parallel (the walks
// are the latency-bound part), then the lanes mark first occurrences and
// lane 0 runs the short sequential cap and LCA logic.
#include "fm_common.cuh"

namespace {

constexpr int kWarps = 4;  // reads a block

__global__ void read_lca_kernel(
    const int* __restrict__ maxl, const int* __restrict__ tie_cnt,
    const int* __restrict__ tie_s0, const int* __restrict__ tie_s1, int T,
    const int* __restrict__ rf_rows, int B, int S,
    const int* __restrict__ rec, int nb1, const int* __restrict__ C,
    const int* __restrict__ sa_seq, int nsamp,
    const int* __restrict__ seq_tax, int ntax,
    const int* __restrict__ parent, const int* __restrict__ depth,
    int maxtax, int R, int cap, int nseq, int chpt_exp,
    int* __restrict__ out) {
    extern __shared__ int smem[];
    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarps + w;
    if (b >= B) return;  // whole warps leave together
    int* pos = smem + w * 2 * R;  // positions, then taxa, then lifted ids
    int* first = pos + R;         // 1 where a taxon is new

    const int* rf = rf_rows + (size_t)b * S;
    int longest = 0, n = 0, total = 0, tie_over = 0;
    if (lane == 0) {
        for (int s = 0; s < S; ++s)
            if (rf[s] >= 0) longest = max(longest, maxl[rf[s]]);
        if (longest > 0) {
            for (int s = 0; s < S; ++s) {
                const int r = rf[s];
                if (r < 0 || maxl[r] != longest) continue;
                tie_over |= tie_cnt[r] > T;
                for (int t = 0; t < T; ++t) {
                    const int a = tie_s0[(size_t)r * T + t];
                    const int size = tie_s1[(size_t)r * T + t] - a;
                    for (int x = 0; x < size && n < R; ++x) pos[n++] = a + x;
                    total += size;
                }
            }
        }
    }
    __syncwarp();  // lane 0's positions are visible to the warp
    n = __shfl_sync(0xffffffffu, n, 0);

    for (int r = lane; r < n; r += 32) {
        const int iseq = kt::sa_walk(rec, nb1, C, sa_seq, nsamp, nseq,
                                     chpt_exp, pos[r]);
        pos[r] = seq_tax[min(max(iseq, 0), ntax - 1)];
    }
    __syncwarp();
    for (int r = lane; r < n; r += 32) {
        int is_first = 1;
        for (int q = 0; q < r && is_first; ++q) is_first = pos[q] != pos[r];
        first[r] = is_first;
    }
    __syncwarp();
    if (lane != 0) return;

    // kept taxa: new ones while at most cap new ones came before; the ones
    // present in the tree are compacted, lifted, into pos[0, m)
    int n_ids = 0, n_uniq = 0, first_id = 0, m = 0, dmin = 0x7fffffff;
    for (int r = 0; r < n; ++r) {
        if (!first[r]) continue;
        const int tax = pos[r];
        if (n_uniq++ > cap) continue;
        if (n_ids++ == 0) first_id = tax;
        if (tax >= 0 && tax < maxtax && depth[tax] > 0) {
            dmin = min(dmin, depth[tax]);
            pos[m++] = tax;
        }
    }
    int lca = 0;
    if (n_ids == 1) {
        lca = first_id;
    } else if (m > 0) {
        for (int x = 0; x < m; ++x)
            for (int up = depth[pos[x]] - dmin; up > 0; --up)
                pos[x] = parent[pos[x]];
        // all lifted taxa reach depth 1 after dmin - 1 steps; a forest with
        // several roots never meets, so the climb is bounded
        for (int step = 0; step < dmin; ++step) {
            bool same = true;
            for (int x = 1; x < m && same; ++x) same = pos[x] == pos[0];
            if (same) break;
            for (int x = 0; x < m; ++x) pos[x] = parent[pos[x]];
        }
        lca = pos[0];
    }
    const int need_more = total > R && n_uniq <= cap;
    int* o = out + (size_t)b * 4;
    o[0] = longest > 0 ? lca : 0;
    o[1] = longest;
    o[2] = tie_over * 1 + need_more * 2;
    o[3] = n_ids;
}

}  // namespace

KT_EXPORT int kt_read_lca(const int* maxl, const int* tie_cnt,
                          const int* tie_s0, const int* tie_s1, int T,
                          const int* rf_rows, int B, int S, const int* rec,
                          int nb1, const int* C, const int* sa_seq, int nsamp,
                          const int* seq_tax, int ntax, const int* parent,
                          const int* depth, int maxtax, int R, int cap,
                          int nseq, int chpt_exp, int* out,
                          cudaStream_t stream) {
    const size_t shmem = (size_t)kWarps * 2 * R * sizeof(int);
    const int blocks = (B + kWarps - 1) / kWarps;
    read_lca_kernel<<<blocks, kWarps * 32, shmem, stream>>>(
        maxl, tie_cnt, tie_s0, tie_s1, T, rf_rows, B, S, rec, nb1, C, sa_seq,
        nsamp, seq_tax, ntax, parent, depth, maxtax, R, cap, nseq, chpt_exp,
        out);
    return static_cast<int>(cudaGetLastError());
}
