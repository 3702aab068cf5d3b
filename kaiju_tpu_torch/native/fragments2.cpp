// Batched read -> fragment pipeline v2: feeds the fused device classifier
// directly.  Differences from kt_fragment_batch (fragments.cpp):
//
//   * emits TRANSLATED letter codes (index alphabet, 1..20) straight into
//     the caller's flat device-upload buffer — no Python string round trip
//   * no cross-read fragment interning (the fused classifier recomputes
//     per batch anyway; the hash map was ~30% of v1's time)
//   * fills the per-read pop-order slot table (rf_rows) natively
//   * multi-threaded over reads (per-thread arenas, serial stitch)
//
// Fragment semantics are identical to v1 (reference:
// src/ConsumerThread.cpp:190-270 getAllFragmentsBits, 272-342
// getNextFragment + SEG requeueing, 659-695 protein splitting).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <vector>

extern "C" int kt_seg_intervals(const int8_t* seq, int len, int32_t* out,
                                int cap);

namespace {

const char* AA_ORDER = "ARNDCQEGHILKMFPSTWYV";
const int DIAG[20] = {4, 5, 6, 6, 9, 5, 5, 6, 8, 4,
                      4, 5, 5, 6, 7, 4, 5, 11, 7, 4};
// index alphabet "*ACDEFGHIKLMNPQRSTVWYX": letter codes 1..20
const char* CODE_ORDER = "ACDEFGHIKLMNPQRSTVWY";

struct Tables2 {
    uint8_t nuc2int[256];
    uint8_t compnuc2int[256];
    uint8_t codon2code[64];   // 0 = stop
    int diag_by_code[21];
    uint8_t char2code[256];   // 0 = not one of the 20 AAs
    Tables2() {
        for (int i = 0; i < 256; ++i) {
            nuc2int[i] = 255;
            compnuc2int[i] = 255;
            char2code[i] = 0;
        }
        const char* nucs = "ACGTU";
        const int vals[5] = {0, 1, 2, 3, 3};
        for (int i = 0; i < 5; ++i) {
            char lo = (char)(nucs[i] + 32);
            nuc2int[(int)nucs[i]] = (uint8_t)vals[i];
            nuc2int[(int)lo] = (uint8_t)vals[i];
            compnuc2int[(int)nucs[i]] = (uint8_t)(3 - vals[i]);
            compnuc2int[(int)lo] = (uint8_t)(3 - vals[i]);
        }
        for (int i = 0; i < 20; ++i) char2code[(int)CODE_ORDER[i]] = (uint8_t)(i + 1);
        // lowercase protein input is uppercased before lookup by add_protein
        struct CA { const char* c; char a; };
        static const CA TAB[] = {
            {"TTT",'F'},{"TTC",'F'},{"TTA",'L'},{"TTG",'L'},
            {"CTT",'L'},{"CTC",'L'},{"CTA",'L'},{"CTG",'L'},
            {"ATT",'I'},{"ATC",'I'},{"ATA",'I'},{"ATG",'M'},
            {"GTT",'V'},{"GTC",'V'},{"GTA",'V'},{"GTG",'V'},
            {"TCT",'S'},{"TCC",'S'},{"TCA",'S'},{"TCG",'S'},
            {"CCT",'P'},{"CCC",'P'},{"CCA",'P'},{"CCG",'P'},
            {"ACT",'T'},{"ACC",'T'},{"ACA",'T'},{"ACG",'T'},
            {"GCT",'A'},{"GCC",'A'},{"GCA",'A'},{"GCG",'A'},
            {"TAT",'Y'},{"TAC",'Y'},{"TAA",'*'},{"TAG",'*'},
            {"CAT",'H'},{"CAC",'H'},{"CAA",'Q'},{"CAG",'Q'},
            {"AAT",'N'},{"AAC",'N'},{"AAA",'K'},{"AAG",'K'},
            {"GAT",'D'},{"GAC",'D'},{"GAA",'E'},{"GAG",'E'},
            {"TGT",'C'},{"TGC",'C'},{"TGA",'*'},{"TGG",'W'},
            {"CGT",'R'},{"CGC",'R'},{"CGA",'R'},{"CGG",'R'},
            {"AGT",'S'},{"AGC",'S'},{"AGA",'R'},{"AGG",'R'},
            {"GGT",'G'},{"GGC",'G'},{"GGA",'G'},{"GGG",'G'},
        };
        auto n2i = [](char c) {
            switch (c) { case 'A': return 0; case 'C': return 1;
                         case 'G': return 2; default: return 3; }
        };
        for (int i = 0; i < 64; ++i) codon2code[i] = 0;
        for (const CA& e : TAB) {
            int idx = (n2i(e.c[0]) << 4) | (n2i(e.c[1]) << 2) | n2i(e.c[2]);
            codon2code[idx] = (e.a == '*') ? 0 : char2code[(int)e.a];
        }
        int diag_by_char[256];
        for (int i = 0; i < 256; ++i) diag_by_char[i] = DIAG[0];
        for (int i = 0; i < 20; ++i) diag_by_char[(int)AA_ORDER[i]] = DIAG[i];
        diag_by_code[0] = DIAG[0];
        for (int i = 0; i < 20; ++i)
            diag_by_code[i + 1] = diag_by_char[(int)CODE_ORDER[i]];
    }
};
const Tables2 T2;

struct Frag2 {
    int64_t start;  // into the arena codes
    int32_t len;
};

struct Q2 {
    int64_t key;
    int64_t seq;
    int32_t idx;  // into the per-read frag pool
    bool checked;
};
struct Q2Cmp {
    bool operator()(const Q2& a, const Q2& b) const {
        if (a.key != b.key) return a.key < b.key;
        return a.seq > b.seq;
    }
};

struct Arena {
    std::vector<uint8_t> codes;       // fragment codes, concatenated
    std::vector<int32_t> frag_len;    // per emitted fragment
    std::vector<int64_t> frag_key;
    std::vector<int32_t> read_nfrags; // per read in this arena's range
    std::vector<int32_t> slots;       // concatenated per-read frag indices
                                      // (arena-local)
};

struct Ctx {
    const char* seqs;
    const int64_t* off1;
    const char* seqs2;
    const int64_t* off2;
    int is_protein, greedy, min_len, min_score, use_seg, S;
};

// translate one frame pass, splitting at stops; emits (start,len) pieces
// into scratch 'pool' with codes appended to 'buf'
struct ReadScratch {
    std::vector<uint8_t> buf;    // translated codes of candidate fragments
    std::vector<Frag2> pool;
    std::vector<std::pair<int64_t, int32_t>> items;  // (key, pool idx)
    std::vector<int8_t> segcodes;
    std::vector<int32_t> segbuf;
};

int64_t key_of(const uint8_t* c, int32_t len, bool greedy) {
    if (!greedy) return len;
    int64_t s = 0;
    for (int32_t t = 0; t < len; ++t) s += T2.diag_by_code[c[t]];
    return s;
}

void emit2(ReadScratch& rs, int64_t start, int32_t len, const Ctx& cx) {
    if (len < cx.min_len) return;
    int64_t key = key_of(rs.buf.data() + start, len, cx.greedy != 0);
    if (cx.greedy && key < cx.min_score) return;
    rs.pool.push_back(Frag2{start, len});
    rs.items.emplace_back(key, (int32_t)(rs.pool.size() - 1));
}

// six-frame scan (reference: ConsumerThread.cpp:190-270)
void add_dna2(ReadScratch& rs, const char* s, int64_t n, const Ctx& cx) {
    if (n < 3) return;
    // per-frame contiguous accumulators (frames interleave codon-wise)
    std::vector<uint8_t> acc[3];
    for (int64_t count = 0; count + 2 < n; ++count) {
        uint8_t a = T2.nuc2int[(uint8_t)s[count]];
        uint8_t b = T2.nuc2int[(uint8_t)s[count + 1]];
        uint8_t c = T2.nuc2int[(uint8_t)s[count + 2]];
        uint8_t code = (a < 4 && b < 4 && c < 4)
                           ? T2.codon2code[(a << 4) | (b << 2) | c]
                           : 0;
        int f = (int)(count % 3);
        if (code == 0) {
            if (!acc[f].empty()) {
                int64_t st = (int64_t)rs.buf.size();
                rs.buf.insert(rs.buf.end(), acc[f].begin(), acc[f].end());
                emit2(rs, st, (int32_t)acc[f].size(), cx);
                acc[f].clear();
            }
        } else {
            acc[f].push_back(code);
        }
    }
    for (int f = 0; f < 3; ++f) {
        if (!acc[f].empty()) {
            int64_t st = (int64_t)rs.buf.size();
            rs.buf.insert(rs.buf.end(), acc[f].begin(), acc[f].end());
            emit2(rs, st, (int32_t)acc[f].size(), cx);
            acc[f].clear();
        }
    }
    for (int64_t count = n - 2; count >= 0; --count) {
        uint8_t code;
        if (count == n - 2) {
            code = 0;
        } else {
            uint8_t a = T2.compnuc2int[(uint8_t)s[count + 2]];
            uint8_t b = T2.compnuc2int[(uint8_t)s[count + 1]];
            uint8_t c = T2.compnuc2int[(uint8_t)s[count]];
            code = (a < 4 && b < 4 && c < 4)
                       ? T2.codon2code[(a << 4) | (b << 2) | c]
                       : 0;
        }
        int f = (int)(count % 3);
        if (code == 0) {
            if (!acc[f].empty()) {
                int64_t st = (int64_t)rs.buf.size();
                rs.buf.insert(rs.buf.end(), acc[f].begin(), acc[f].end());
                emit2(rs, st, (int32_t)acc[f].size(), cx);
                acc[f].clear();
            }
        } else {
            acc[f].push_back(code);
        }
    }
    for (int f = 0; f < 3; ++f) {
        if (!acc[f].empty()) {
            int64_t st = (int64_t)rs.buf.size();
            rs.buf.insert(rs.buf.end(), acc[f].begin(), acc[f].end());
            emit2(rs, st, (int32_t)acc[f].size(), cx);
            acc[f].clear();
        }
    }
}

// protein splitting (reference: ConsumerThread.cpp:659-695)
void add_protein2(ReadScratch& rs, const char* s, int64_t n, const Ctx& cx) {
    int64_t st = -1;
    for (int64_t pos = 0; pos <= n; ++pos) {
        uint8_t code = 0;
        if (pos < n) {
            char c = s[pos];
            if (c >= 'a' && c <= 'z') c = (char)(c - 32);
            code = T2.char2code[(uint8_t)c];
        }
        if (code == 0) {
            if (st >= 0 && pos - st >= cx.min_len) {
                int64_t bs = (int64_t)rs.buf.size();
                for (int64_t p = st; p < pos; ++p) {
                    char c = s[p];
                    if (c >= 'a' && c <= 'z') c = (char)(c - 32);
                    rs.buf.push_back(T2.char2code[(uint8_t)c]);
                }
                emit2(rs, bs, (int32_t)(pos - st), cx);
            }
            st = -1;
        } else if (st < 0) {
            st = pos;
        }
    }
}

void run_read(ReadScratch& rs, Arena& ar, const Ctx& cx, const char* s1,
              int64_t n1, const char* s2, int64_t n2) {
    rs.buf.clear();
    rs.pool.clear();
    rs.items.clear();

    int64_t mfl3 = (int64_t)cx.min_len * 3;
    if (cx.is_protein) {
        if (n1 >= cx.min_len) add_protein2(rs, s1, n1, cx);
    } else {
        if (n1 >= mfl3) add_dna2(rs, s1, n1, cx);
        if (s2 != nullptr && n2 >= mfl3) add_dna2(rs, s2, n2, cx);
    }

    std::priority_queue<Q2, std::vector<Q2>, Q2Cmp> q;
    int64_t seq_no = 0;
    for (auto& kv : rs.items)
        q.push(Q2{kv.first, seq_no++, kv.second, cx.use_seg == 0});

    int32_t nfr = 0;
    while (!q.empty()) {
        Q2 e = q.top();
        q.pop();
        Frag2 fr = rs.pool[e.idx];
        if (!e.checked) {
            rs.segcodes.resize(fr.len);
            const uint8_t* c = rs.buf.data() + fr.start;
            for (int32_t t = 0; t < fr.len; ++t)
                rs.segcodes[t] = (int8_t)(c[t] - 1);
            if (rs.segbuf.size() < 4096) rs.segbuf.resize(4096);
            int nseg = kt_seg_intervals(rs.segcodes.data(), fr.len,
                                        rs.segbuf.data(),
                                        (int)rs.segbuf.size() / 2);
            if (nseg != 0) {
                // split at masked intervals; pieces must be STRICTLY
                // longer than min_len (reference: ConsumerThread.cpp:298-322)
                int64_t start = 0;
                auto requeue = [&](int64_t st, int64_t len) {
                    if (len > cx.min_len) {
                        int64_t key = key_of(rs.buf.data() + fr.start + st,
                                             (int32_t)len, cx.greedy != 0);
                        if (cx.greedy && key < cx.min_score) return;
                        rs.pool.push_back(
                            Frag2{fr.start + st, (int32_t)len});
                        q.push(Q2{key, seq_no++,
                                  (int32_t)(rs.pool.size() - 1), true});
                    }
                };
                for (int t = 0; t < nseg; ++t) {
                    int64_t left = rs.segbuf[2 * t];
                    int64_t right = rs.segbuf[2 * t + 1];
                    requeue(start, left - start);
                    start = right + 1;
                }
                requeue(start, (int64_t)fr.len - start);
                continue;
            }
        }
        // emit in pop order
        int32_t fi = (int32_t)ar.frag_len.size();
        ar.codes.insert(ar.codes.end(), rs.buf.begin() + fr.start,
                        rs.buf.begin() + fr.start + fr.len);
        ar.frag_len.push_back(fr.len);
        ar.frag_key.push_back(e.key);
        ar.slots.push_back(fi);
        ++nfr;
    }
    ar.read_nfrags.push_back(nfr);
}

}  // namespace

extern "C" {

// Returns 0 on success, -1 on output-capacity overflow (flat_cap or
// frag_cap too small — caller doubles and retries).
// Outputs:
//   flat_codes[chars]  translated fragment codes, 1..20, pop order per read
//   frag_off[0..F]     offsets (frag_off[F] = chars); rows F.. untouched
//   frag_keys[F]       queue key per fragment
//   rf_rows[n_reads*S] fragment row per (read, pop slot), -1 = pad;
//                      reads with > S fragments: first S filled,
//                      overflow_flags[read] = 1
//   counts_out         [0] = F, [1] = chars
int kt_fragment_batch2(
    const char* seqs, const int64_t* seq_off, int64_t n_reads,
    const char* seqs2, const int64_t* seq2_off,
    int32_t is_protein, int32_t greedy, int32_t min_frag_len,
    int32_t min_score, int32_t use_seg, int32_t n_threads, int32_t S,
    uint8_t* flat_codes, int64_t flat_cap,
    int32_t* frag_off_out, int64_t frag_cap,
    int64_t* frag_keys_out,
    int32_t* rf_rows, uint8_t* overflow_flags,
    int64_t* counts_out) {
    Ctx cx{seqs, seq_off, seqs2, seq2_off, is_protein, greedy,
           min_frag_len, min_score, use_seg, S};

    int T = n_threads < 1 ? 1 : (n_threads > 8 ? 8 : n_threads);
    if (n_reads < 256) T = 1;
    std::vector<Arena> arenas((size_t)T);
    std::vector<std::thread> threads;
    int64_t chunk = (n_reads + T - 1) / T;

    auto work = [&](int t) {
        Arena& ar = arenas[(size_t)t];
        ReadScratch rs;
        int64_t lo = t * chunk;
        int64_t hi = std::min(n_reads, lo + chunk);
        for (int64_t r = lo; r < hi; ++r) {
            const char* s1 = seqs + seq_off[r];
            int64_t n1 = seq_off[r + 1] - seq_off[r];
            const char* s2 = nullptr;
            int64_t n2 = 0;
            if (seqs2 != nullptr) {
                s2 = seqs2 + seq2_off[r];
                n2 = seq2_off[r + 1] - seq2_off[r];
            }
            run_read(rs, ar, cx, s1, n1, s2, n2);
        }
    };
    if (T == 1) {
        work(0);
    } else {
        for (int t = 0; t < T; ++t) threads.emplace_back(work, t);
        for (auto& th : threads) th.join();
    }

    // serial stitch
    int64_t F = 0, chars = 0;
    for (auto& ar : arenas) {
        F += (int64_t)ar.frag_len.size();
        chars += (int64_t)ar.codes.size();
    }
    if (F > frag_cap || chars > flat_cap) return -1;

    int64_t fbase = 0, cbase = 0, r = 0;
    for (auto& ar : arenas) {
        if (!ar.codes.empty())
            std::memcpy(flat_codes + cbase, ar.codes.data(),
                        ar.codes.size());
        int64_t off = cbase;
        for (size_t i = 0; i < ar.frag_len.size(); ++i) {
            frag_off_out[fbase + (int64_t)i] = (int32_t)off;
            frag_keys_out[fbase + (int64_t)i] = ar.frag_key[i];
            off += ar.frag_len[i];
        }
        int64_t spos = 0;
        for (size_t i = 0; i < ar.read_nfrags.size(); ++i, ++r) {
            int32_t nfr = ar.read_nfrags[i];
            overflow_flags[r] = nfr > S ? 1 : 0;
            int32_t lim = nfr > S ? S : nfr;
            for (int32_t k = 0; k < lim; ++k)
                rf_rows[r * S + k] =
                    (int32_t)(fbase + ar.slots[(size_t)(spos + k)]);
            spos += nfr;
        }
        fbase += (int64_t)ar.frag_len.size();
        cbase += (int64_t)ar.codes.size();
    }
    frag_off_out[F] = (int32_t)chars;
    counts_out[0] = F;
    counts_out[1] = chars;
    return 0;
}

}  // extern "C"
