// Kernel X: the FM steps of one Greedy level's variants over the shards of
// a group of processes on several hosts (kt::HostIx), a variant whose next
// rank pair needs a row that no process of this host holds parking with
// its query for the owner (kernel N, fm_serve.cu; parallel/exchange.py
// runs the rounds).  Kernel U (greedy_levels.cu) lists the variants before
// and settles them after.
//
// Replaces, for kaiju_tpu's sharded Greedy over a mesh of hosts (K16f,
// kaiju_tpu/parallel/sharded_fused.py:make_sharded_greedy_classify,
// :278-390, whose rank pairs are _make_rank1's psum over the index axis),
// the UpdateSI probe (K3, fused_greedy.py:476) and the resumed extension
// (K14, _extend_two_stage, :103-215) of kernel E (greedy_search.cu's probe
// and extend_groups), step for step.
//
// Contract: variant v of var [V, kVarInts] (greedy_common.cuh) starts at
// i = pos + 1 on its source's interval (s0, s1).  A step reads the letter
// at y = i - 1 (the substituted code at y = pos, the probe; else the flat
// code of its fragment) and takes the rank pair (n0, n1) of it: the probe
// takes it, empty or not; a resumed step only a non-empty one.  A taken
// step decrements i.  The variant ends at an empty pair or at i = 0, and
// writes (n0, n1, i) of its last interval to out [V, 3], what E's window
// slot holds before its settle.  A step whose rank pair needs a remote row
// parks the variant: (v, i, s0, s1) to park_out [*n_park, 4] and its
// queries (kQRank c, s0), (kQRank c, s1) to q_out.  The resume form
// (park_in [L, 4] with ans_in [L, 2]) applies each answer as the step and
// goes on.  Parked variants come out in no fixed order.  With sw (the
// last level with the text-compare hybrid, across hosts) a variant whose
// probe leaves 1 to kSwWcap occurrences with i = pos > 0 letters before
// it stops there, as E's last level switches it (fused_greedy.py:488-505,
// ops/greedy.py greedy_search_plain): its out row (n0, n1, pos) goes to
// kernel Y (switch_hosts.cu), whose reach finishes it.
//
// Bound: a chain of dependent row reads a variant (its probe and its
// extension), one 256-byte row a step.  Design: a group of 4 lanes a
// variant, each step's rank pair in one memory latency (kt::rank2<4>), as
// kernel O steps its lanes.
#include "greedy_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kG = 4;  // lanes a variant

__global__ void __launch_bounds__(kThreads) greedy_variants_kernel(
    const kt::HostIx ix, const int* __restrict__ C,
    const uint8_t* __restrict__ flat, const int* __restrict__ var, int V,
    const int* __restrict__ park_in, const int* __restrict__ ans_in, int L,
    int sw, int* __restrict__ out, int* __restrict__ park_out,
    int* __restrict__ q_out, int* __restrict__ n_park) {
    const int g = (blockIdx.x * kThreads + threadIdx.x) / kG;
    if (g >= (park_in == nullptr ? V : L)) return;  // whole groups leave
    const int lane = threadIdx.x & 31, gl = lane % kG;
    const unsigned gmask = kt::group_mask<kG>(lane);
    int v, i, a0, a1, n0 = 0, n1 = 0;
    bool answered = park_in != nullptr;  // the step's pair is given
    if (answered) {
        const int4 p = reinterpret_cast<const int4*>(park_in)[g];
        v = p.x;
        i = p.y;
        a0 = p.z;
        a1 = p.w;
        n0 = __ldg(ans_in + 2 * (size_t)g);
        n1 = __ldg(ans_in + 2 * (size_t)g + 1);
    } else {
        v = g;
        i = (__ldg(var + (size_t)v * kg::kVarInts) >> 8) + 1;
        a0 = __ldg(var + (size_t)v * kg::kVarInts + 1);
        a1 = __ldg(var + (size_t)v * kg::kVarInts + 2);
    }
    const int* e = var + (size_t)v * kg::kVarInts;
    const int code = __ldg(e) & 255, pos = __ldg(e) >> 8, base = __ldg(e + 3);
    for (;;) {
        const int y = i - 1;
        if (!answered) {
            const int c = y == pos ? code : __ldg(flat + base + y);
            if (!ix.row_here(a0 >> 7) || !ix.row_here(a1 >> 7)) {
                if (gl == 0) {  // park: the owners answer this step
                    const int s = atomicAdd(n_park, 1);
                    reinterpret_cast<int4*>(park_out)[s] =
                        make_int4(v, i, a0, a1);
                    reinterpret_cast<int4*>(q_out)[s] = make_int4(
                        kt::kQRank << 8 | c, a0, kt::kQRank << 8 | c, a1);
                }
                return;
            }
            kt::rank2<kG>(ix, C, c, a0, a1, gl, gmask, &n0, &n1);
        }
        answered = false;
        const bool ok = n0 < n1;
        if (ok || y == pos) {  // the probe takes its pair, empty or not
            a0 = n0;
            a1 = n1;
            --i;
        }
        if (!ok || i <= 0) break;
        if (sw && y == pos && a1 - a0 <= kt::kSwWcap) break;  // kernel Y's
    }
    if (gl == 0) {
        out[3 * (size_t)v] = a0;
        out[3 * (size_t)v + 1] = a1;
        out[3 * (size_t)v + 2] = i;
    }
}

}  // namespace

// Kernel X: the start form (park_in null) runs every variant of var; the
// resume form the parked variants park_in [L, 4] with their answers
// ans_in [L, 2].  Both append to park_out [*n_park, 4] and q_out
// [*n_park, 2, 2].  sw: 1 where the hybrid's narrow probes stop.
KT_EXPORT int kt_greedy_variants_hosts(
    KT_SHARD_PARAMS, const int* C, const uint8_t* flat, const int* var,
    int V, const int* park_in, const int* ans_in, int L, int sw, int* out,
    int* park_out, int* q_out, int* n_park, cudaStream_t stream) {
    const long long threads = (long long)(park_in == nullptr ? V : L) * kG;
    greedy_variants_kernel<<<(int)((threads + kThreads - 1) / kThreads),
                             kThreads, 0, stream>>>(
        KT_HOST_IX, C, flat, var, V, park_in, ans_in, L, sw, out, park_out,
        q_out, n_park);
    return static_cast<int>(cudaGetLastError());
}
