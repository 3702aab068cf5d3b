// The backward-extension loop shared by kernel I (extend_from.cu) and
// kernel J (extend_all.cu): the reference's maxMatches_withStart loop
// (bwt.c:298-336), one rank pair per letter.
#pragma once

#include "fm_common.cuh"

namespace kt {

struct Ext {
    int i, s0, s1;
};

// Extend the SA interval [s0, s1) of a match that begins at query
// position i backwards, one letter a step: the letter at x = i - 1 is
// `sub` where x == pos and codes[base + x] elsewhere (pos = -1: no
// substitution).  Stops at i == 0 or where the next interval would be
// empty, and returns the last non-empty one with its start.
template <class Ix>
__device__ __forceinline__ Ext extend_back(const Ix& ix,
                                           const int* __restrict__ C,
                                           const uint8_t* __restrict__ codes,
                                           int64_t base, int pos, int sub,
                                           int i, int s0, int s1) {
    while (i > 0) {
        const int x = i - 1;
        const int c = x == pos ? sub : (int)__ldg(codes + base + x);
        const int n0 = rank(ix, C, c, s0);
        const int n1 = rank(ix, C, c, s1);
        if (n0 >= n1) break;
        s0 = n0;
        s1 = n1;
        i = x;
    }
    return {i, s0, s1};
}

}  // namespace kt
