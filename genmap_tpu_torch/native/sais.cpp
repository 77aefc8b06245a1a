// Clean-room SA-IS suffix array construction (induced sorting).
//
// Fills the role of the reference's vendored libdivsufsort
// (GenMap include/libdivsufsort/divsufsort.hpp, entry point used at
// GenMap src/seqan_libdivsufsort.h:96) with an independent
// implementation of the SA-IS algorithm (Nong, Zhang & Chan, DCC 2009),
// tuned for multi-gigabase DNA inputs:
//
//   * the suffix type bit is fused into the character value (TT = c<<1 | t):
//     L-type suffixes of a character sort strictly before S-type suffixes of
//     the same character, so bucketing directly by the fused value is
//     order-correct and every induce step needs ONE memory load per suffix
//     instead of three (char, type, bucket)
//   * software prefetch hides the random-access latency of the induce loops
//     (the dominant cost at out-of-cache sizes)
//   * index type variants: uint32 (inputs < 2^32-1, half the memory traffic
//     of int64) and int64
//
// Contract: T[n-1] must be a unique smallest character (the caller appends a
// 0 terminal after shifting the alphabet up by one).  SA receives the suffix
// array of T.

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int PF = 48;  // prefetch distance (iterations)

// Build the fused text TT[i] = T[i]*2 + t[i] (t: 1 = S-type, 0 = L-type).
// C is the input character type (uint8_t at the top level, I at recursion
// levels); F is the fused output type.
template <typename C, typename F, typename I>
void build_fused(const C* T, F* TT, I n) {
    // T[n-1] is the unique smallest character: S-type by convention
    TT[n - 1] = static_cast<F>(T[n - 1]) * 2 + 1;
    uint8_t t_next = 1;
    for (I i = n - 1; i > 0; --i) {
        C a = T[i - 1], b = T[i];
        uint8_t t = (a < b || (a == b && t_next)) ? 1 : 0;
        TT[i - 1] = static_cast<F>(a) * 2 + t;
        t_next = t;
    }
}

// LMS test on the fused text: position i is LMS iff TT[i] is S-type and
// TT[i-1] is L-type.
template <typename F, typename I>
inline bool is_lms(const F* TT, I i) {
    return i > 0 && (TT[i] & 1) && !(TT[i - 1] & 1);
}

// Bucket boundaries over fused values 0..K2-1.  end=false: bucket heads
// (L-side insert points); end=true: bucket tails.
template <typename F, typename I>
void fused_buckets(const F* TT, I n, std::vector<I>& bkt, bool end) {
    std::fill(bkt.begin(), bkt.end(), I(0));
    for (I i = 0; i < n; ++i) ++bkt[static_cast<size_t>(TT[i])];
    I sum = 0;
    for (size_t c = 0; c < bkt.size(); ++c) {
        I cnt = bkt[c];
        sum += cnt;
        bkt[c] = end ? sum : sum - cnt;
    }
}

// Induced sort: from sorted LMS positions (or LMS entry points) already
// placed in SA, induce L-type suffixes left-to-right, then S-type
// right-to-left.  EMPTY slots are the max value of I's unsigned view.
template <typename F, typename I>
void induce(const F* TT, I* SA, I n, std::vector<I>& bkt, I EMPTY) {
    // L pass: for SA[i] = j with TT[j-1] L-type, place j-1 at the head of
    // its (fused) bucket.  Fused L buckets (even values) fill left-to-right.
    fused_buckets(TT, n, bkt, false);
    for (I i = 0; i < n; ++i) {
        if (i + PF < n) {
            I jp = SA[i + PF];
            // harmless over-prefetch on EMPTY/0: clamp into range
            I addr = (jp == EMPTY || jp == 0) ? 0 : jp - 1;
            __builtin_prefetch(&TT[addr], 0, 1);
        }
        I j = SA[i];
        if (j != EMPTY && j > 0) {
            F f = TT[j - 1];
            if (!(f & 1)) SA[bkt[static_cast<size_t>(f)]++] = j - 1;
        }
    }
    // S pass: right-to-left, place at bucket tails (odd fused values).
    fused_buckets(TT, n, bkt, true);
    for (I i = n; i-- > 0;) {
        if (i >= I(PF)) {
            I jp = SA[i - PF];
            I addr = (jp == EMPTY || jp == 0) ? 0 : jp - 1;
            __builtin_prefetch(&TT[addr], 0, 1);
        }
        I j = SA[i];
        if (j != EMPTY && j > 0) {
            F f = TT[j - 1];
            if (f & 1) SA[--bkt[static_cast<size_t>(f)]] = j - 1;
        }
    }
}

// Core recursion on a fused text TT with values < K2 (= 2 * alphabet).
template <typename F, typename I>
void sais_fused(const F* TT, I* SA, I n, size_t K2) {
    const I EMPTY = std::numeric_limits<I>::max();
    if (n == 0) return;
    if (n == 1) { SA[0] = 0; return; }

    std::vector<I> bkt(K2);

    // ---- stage 1: sort the LMS substrings ------------------------------
    std::fill(SA, SA + n, EMPTY);
    fused_buckets(TT, n, bkt, true);
    for (I i = n - 1; i > 0; --i)
        if (is_lms(TT, i)) SA[--bkt[static_cast<size_t>(TT[i])]] = i;
    induce(TT, SA, n, bkt, EMPTY);

    // compact the now-sorted LMS positions to the front
    I n1 = 0;
    for (I i = 0; i < n; ++i) {
        I j = SA[i];
        if (j != EMPTY && is_lms(TT, j)) SA[n1++] = j;
    }

    // ---- stage 2: name LMS substrings ----------------------------------
    std::fill(SA + n1, SA + n, EMPTY);
    I name = 0, prev = EMPTY;
    for (I i = 0; i < n1; ++i) {
        I pos = SA[i];
        bool diff = false;
        if (prev == EMPTY) {
            diff = true;
        } else {
            for (I d = 0;; ++d) {
                if (TT[pos + d] != TT[prev + d]) { diff = true; break; }
                if (d > 0 && (is_lms(TT, pos + d) || is_lms(TT, prev + d))) {
                    // fused values equal, so both-LMS iff either-LMS here
                    diff = !(is_lms(TT, pos + d) && is_lms(TT, prev + d));
                    break;
                }
            }
        }
        if (diff) { ++name; prev = pos; }
        SA[n1 + pos / 2] = name - 1;
    }
    // compact names (text order of LMS positions) to the tail of SA
    for (I i = n - 1, j = n - 1;; --i) {
        if (SA[i] != EMPTY) SA[j--] = SA[i];
        if (i == n1) break;
    }

    // ---- stage 3: recurse if names are not unique ----------------------
    I* SA1 = SA;
    I* s1 = SA + n - n1;  // the named reduced string, in text order
    if (name < n1) {
        // fuse the reduced string (fused values 2*name+1 <= n < EMPTY fit in
        // the index type, which recursion levels use as the character type)
        std::vector<I> TT1(n1);
        build_fused<I, I, I>(s1, TT1.data(), n1);
        sais_fused<I, I>(TT1.data(), SA1, n1, static_cast<size_t>(name) * 2);
    } else {
        for (I i = 0; i < n1; ++i) SA1[s1[i]] = i;
    }

    // map the recursion result back to LMS positions (in text order)
    {
        I j = 0;
        for (I i = 1; i < n; ++i)
            if (is_lms(TT, i)) s1[j++] = i;
        for (I i = 0; i < n1; ++i) SA1[i] = s1[SA1[i]];
    }

    // ---- stage 4: final induced sort from sorted LMS suffixes ----------
    std::fill(SA + n1, SA + n, EMPTY);
    fused_buckets(TT, n, bkt, true);
    for (I i = n1; i-- > 0;) {
        I j = SA[i];
        SA[i] = EMPTY;
        SA[--bkt[static_cast<size_t>(TT[j])]] = j;
    }
    induce(TT, SA, n, bkt, EMPTY);
}

template <typename I>
int sais_entry(const uint8_t* T, I* SA, I n, I K) {
    if (n <= 0 || K < 0 || K > 254) return -1;
    if (n == 1) { SA[0] = 0; return 0; }
    std::vector<uint8_t> TT(static_cast<size_t>(n));
    build_fused<uint8_t, uint8_t, I>(T, TT.data(), n);
    sais_fused<uint8_t, I>(TT.data(), SA, n, (static_cast<size_t>(K) + 1) * 2);
    return 0;
}

// uint32 variant: n may be up to 2^32 - 2 (EMPTY reserves the max value).
int sais_entry_u32(const uint8_t* T, uint32_t* SA, uint64_t n, uint32_t K) {
    if (n == 0 || K > 254 || n >= std::numeric_limits<uint32_t>::max()) return -1;
    if (n == 1) { SA[0] = 0; return 0; }
    std::vector<uint8_t> TT(static_cast<size_t>(n));
    build_fused<uint8_t, uint8_t, uint32_t>(T, TT.data(), static_cast<uint32_t>(n));
    sais_fused<uint8_t, uint32_t>(
        TT.data(), SA, static_cast<uint32_t>(n), (static_cast<size_t>(K) + 1) * 2);
    return 0;
}

}  // namespace

extern "C" {

int genmap_sais_u8_i32(const uint8_t* T, int32_t* SA, int32_t n, int32_t K) {
    // delegate to the uint32 variant; results are identical for n < 2^31
    if (n <= 0) return -1;
    return sais_entry_u32(T, reinterpret_cast<uint32_t*>(SA),
                          static_cast<uint64_t>(n), static_cast<uint32_t>(K));
}

int genmap_sais_u8_u32(const uint8_t* T, uint32_t* SA, uint64_t n, uint32_t K) {
    return sais_entry_u32(T, SA, n, K);
}

int genmap_sais_u8_i64(const uint8_t* T, int64_t* SA, int64_t n, int64_t K) {
    if (n <= 0 || K < 0) return -1;
    if (static_cast<uint64_t>(n) < std::numeric_limits<uint32_t>::max()) {
        // build with the half-width index type, then widen
        std::vector<uint32_t> sa32(static_cast<size_t>(n));
        int rc = sais_entry_u32(T, sa32.data(), static_cast<uint64_t>(n),
                                static_cast<uint32_t>(K));
        if (rc != 0) return rc;
        for (int64_t i = 0; i < n; ++i) SA[i] = sa32[static_cast<size_t>(i)];
        return 0;
    }
    return sais_entry<int64_t>(T, SA, n, K);
}

}  // extern "C"
