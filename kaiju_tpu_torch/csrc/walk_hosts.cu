// Kernel Q: SA walks of a list of rows to their sequence ids over the
// shards of a group of processes on several hosts (kt::HostIx), a walk
// whose next step lies on another host parking with its query for the
// owner (kernel N, fm_serve.cu; parallel/exchange.py runs the rounds).
//
// Replaces kaiju_tpu's _make_walk (kaiju_tpu/parallel/sharded_fused.py:
// 78-150), K4's SA walk with each LF step and sample from the owner
// shard, which every shard computes and a psum assembles.
//
// Contract: walk w starts at SA row rows[w] (start form: park_in null)
// and steps as kt::sa_walk does, through the same kt::lf_step: while k is
// not sampled, the LF step from k (a terminator ends the walk with its LF
// result, the content rank), then the sample of k's slot.  A step whose
// row, or a sample whose slot, lies in a shard that no process of this
// host holds parks the walk: (w, k) goes to park_out [*n_park, 2] and its
// query to q_out (kQLf k, or kQSample slot), and seq[w] = -1.  The resume
// form (park_in [L, 2] with ans_in [L]) applies each parked walk's answer
// (LF: k = the answer, or the end at ~answer < 0; SAMPLE: the id) and
// walks on.  Parked walks come out in no fixed order.
//
// Bound: a chain of dependent row reads a walk (up to 2^chpt_exp steps),
// one 256-byte row a step; the longest walk at the L2's latency.  Design:
// a group of 4 lanes a walk, a step in one memory latency (kt::lf_group).
#include "fm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kG = 4;  // lanes a walk

__global__ void __launch_bounds__(kThreads) walk_hosts_kernel(
    const kt::HostIx ix, const int* __restrict__ C, int nseq, int chpt_exp,
    const int* __restrict__ rows, int n, const int* __restrict__ park_in,
    const int* __restrict__ ans_in, int* __restrict__ seq,
    int* __restrict__ park_out, int* __restrict__ q_out,
    int* __restrict__ n_park) {
    const int g = (blockIdx.x * kThreads + threadIdx.x) / kG;
    if (g >= n) return;  // whole groups leave together
    const int lane = threadIdx.x & 31, gl = lane % kG;
    const unsigned gmask = kt::group_mask<kG>(lane);
    const int check = (1 << chpt_exp) - 1;
    int w, k;
    if (park_in == nullptr) {
        w = g;
        k = __ldg(rows + g);
    } else {
        w = __ldg(park_in + 2 * (size_t)g);
        k = __ldg(park_in + 2 * (size_t)g + 1);
        const int a = __ldg(ans_in + g);
        if (!(k & check) || a < 0) {  // a sample's id, or a terminator
            if (gl == 0) seq[w] = (k & check) ? ~a : a;
            return;
        }
        k = a;
    }
    for (;;) {
        int kind = kt::kQLf, x = k;
        if (k & check) {
            if (ix.row_here(k >> 7)) {
                int c;
                const int kn = kt::lf_step<kG>(ix, C, k, gl, gmask, &c);
                if (c == 0) {
                    if (gl == 0) seq[w] = kn;
                    return;
                }
                k = kn;
                continue;
            }
        } else {
            kind = kt::kQSample;
            x = kt::sample_slot(k, nseq, chpt_exp, ix.nsamp);
            if (ix.slot_here(x)) {
                if (gl == 0) seq[w] = ix.seq(x);
                return;
            }
        }
        if (gl == 0) {  // park: the owner answers this step
            const int s = atomicAdd(n_park, 1);
            park_out[2 * (size_t)s] = w;
            park_out[2 * (size_t)s + 1] = k;
            q_out[2 * (size_t)s] = kind << 8;
            q_out[2 * (size_t)s + 1] = x;
            seq[w] = -1;
        }
        return;
    }
}

}  // namespace

KT_EXPORT int kt_walk_hosts(KT_SHARD_PARAMS, const int* C, int nseq,
                            int chpt_exp, const int* rows, int W,
                            const int* park_in, const int* ans_in, int L,
                            int* seq, int* park_out, int* q_out, int* n_park,
                            cudaStream_t stream) {
    const int n = park_in == nullptr ? W : L;
    const long long threads = (long long)n * kG;
    walk_hosts_kernel<<<(int)((threads + kThreads - 1) / kThreads), kThreads,
                        0, stream>>>(KT_HOST_IX, C, nseq, chpt_exp, rows, n,
                                     park_in, ans_in, seq, park_out, q_out,
                                     n_park);
    return static_cast<int>(cudaGetLastError());
}
