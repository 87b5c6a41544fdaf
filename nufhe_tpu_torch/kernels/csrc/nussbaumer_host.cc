// Host numerics of the bootstrap key's preparation, in C++: the exact
// Nussbaumer forward transform over Z/2^64 and the two-sided limb split
// mod 2^38 (vlo + 4 balanced radix-2^8 digits of vhi; 4 digits of the
// rounded value in the rounded-key form), std::thread across polynomials.
//
// The port's own copy of the JAX package's csrc/nussbaumer_host.cc: the
// same arithmetic, with std::thread in place of OpenMP, whose runtime
// (libgomp) not every toolchain ships.  It mirrors ref/transform_ref.forward and
// ops/transform.key_limbs_host bit for bit: N = 1024 = 32 x 32, L = 64,
// S' = Z[Y]/(Y^32 + 1), twiddles are negacyclic shifts (pure data
// movement), u64 wraparound arithmetic.
//
// Built at first use by nufhe_tpu_torch/native.py with the system C++
// compiler and loaded with ctypes; the numpy oracle is the fallback where
// no compiler exists.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// f(i) for i in [0, n), in contiguous ranges over the host's cores (at
// least 16 items a thread)
template <typename F>
void parallel_for(long n, F f) {
    const long hw = std::max(1u, std::thread::hardware_concurrency());
    const long workers = std::max(1L, std::min(hw, n / 16));
    if (workers == 1) {
        for (long i = 0; i < n; ++i) f(i);
        return;
    }
    const long chunk = (n + workers - 1) / workers;
    std::vector<std::thread> pool;
    for (long lo = 0; lo < n; lo += chunk) {
        const long hi = std::min(n, lo + chunk);
        pool.emplace_back([lo, hi, &f] {
            for (long i = lo; i < hi; ++i) f(i);
        });
    }
    for (auto& t : pool) t.join();
}

constexpr int N = 1024;
constexpr int M = 32;
constexpr int R = 32;
constexpr int L = 64;
constexpr int LOG_L = 6;

// rev[t] = 6-bit reversal of t
int bitrev6(int t) {
    int out = 0;
    for (int b = 0; b < LOG_L; ++b) out |= ((t >> b) & 1) << (LOG_L - 1 - b);
    return out;
}

// dst = Y^e * src in S' (negacyclic rotate right by e with sign wrap)
inline void yshift(const uint64_t* src, uint64_t* dst, int e) {
    e = ((e % (2 * R)) + 2 * R) % (2 * R);
    bool neg = e >= R;
    e %= R;
    for (int k = 0; k < R; ++k) {
        int src_idx = k - e;
        uint64_t v;
        if (src_idx >= 0) v = src[src_idx];
        else v = ~src[src_idx + R] + 1;  // negate (u64 wrap)
        dst[k] = neg ? (~v + 1) : v;
    }
}

// one polynomial: (N,) int32 -> (L, R) uint64, forward DFT over S'
void forward_one(const int32_t* a, uint64_t* out) {
    uint64_t data[L][R];
    // strided split A_j[i] = a[i*M + j], zero-padded to L slots, then the
    // initial bit-reversal of the DIT dataflow
    uint64_t padded[L][R];
    for (int j = 0; j < M; ++j)
        for (int i = 0; i < R; ++i)
            padded[j][i] = (uint64_t)(int64_t)a[i * M + j];
    std::memset(padded[M], 0, sizeof(uint64_t) * (L - M) * R);
    for (int t = 0; t < L; ++t)
        std::memcpy(data[t], padded[bitrev6(t)], sizeof(uint64_t) * R);

    uint64_t temp[R];
    for (int stage = 0; stage < LOG_L; ++stage) {
        int mmax = 1 << stage;
        int istep = mmax * 2;
        for (int m = 0; m < mmax; ++m) {
            int tw = m * (1 << (LOG_L - stage - 1));
            for (int i = m; i < L; i += istep) {
                int j = i + mmax;
                yshift(data[j], temp, tw);
                for (int k = 0; k < R; ++k) {
                    uint64_t lo = data[i][k];
                    data[i][k] = lo + temp[k];
                    data[j][k] = lo - temp[k];
                }
            }
        }
    }
    std::memcpy(out, data, sizeof(uint64_t) * L * R);
}

}  // namespace

extern "C" {

// in:  (n_polys, 1024) int32 contiguous
// out: (n_polys, 64, 32) uint64 contiguous
void nussbaumer_forward_u64(const int32_t* in, uint64_t* out, long n_polys) {
    parallel_for(n_polys, [=](long p) {
        forward_one(in + p * N, out + p * (long)(L * R));
    });
}

namespace {

// A/B split of a centered mod-2^38 value (see ops/transform.py
// _limb_split_38): limb 0 is vlo = balanced(v mod 64) in [-32, 31];
// limbs 1..4 are balanced radix-2^8 digits of vhi = (v - vlo) >> 6,
// valid mod 2^32 (the top digit is truncated — the A channel wraps
// freely).  Out stride 2 (interleaved with the other side's split).
inline void split_one(int64_t v, int8_t* o) {
    int64_t vlo = ((v + 32) & 63) - 32;
    o[0] = (int8_t)vlo;
    v = (v - vlo) >> 6;
    for (int j = 1; j < 5; ++j) {
        int64_t l0 = ((v + 128) & 255) - 128;
        o[j * 2] = (int8_t)l0;
        v = (v - l0) >> 8;
    }
}

// rounded-key ('FFT') variant: vlo is dropped (v rounded to the nearest
// multiple of 64; the remainder becomes key noise) and only the 4 vhi
// radix-2^8 digits are emitted.
inline void split_one_rounded(int64_t v, int8_t* o) {
    v = (v + 32) >> 6;
    for (int j = 0; j < 4; ++j) {
        int64_t l0 = ((v + 128) & 255) - 128;
        o[j * 2] = (int8_t)l0;
        v = (v - l0) >> 8;
    }
}

inline int64_t center38(uint64_t r) {
    int64_t v = (int64_t)(r & ((1ull << 38) - 1));
    return v - ((v >> 37) << 38);  // center into [-2^37, 2^37)
}

}  // namespace

// residues mod 2^64 -> two-sided 5-limb A/B splits of the mod-2^38
// value: limbs of +v and of (-v mod 2^38).  Storing both plain
// decompositions lets the device bake the negacyclic signs into the int8
// MAC rhs without ever negating a limb (-128 has no int8 negation).
// in:  (count,) uint64;  out: (count, 5, 2) int8
void limb_split_38(const uint64_t* in, int8_t* out, long count) {
    parallel_for(count, [=](long idx) {
        split_one(center38(in[idx]), out + idx * 10);
        split_one(center38((uint64_t)0 - in[idx]), out + idx * 10 + 1);
    });
}

// fused: (n_polys, 1024) int32 -> (n_polys, 64, 32, KL, 2) int8 key limbs;
// exact != 0 -> KL = 5 (A/B split), exact == 0 -> KL = 4 (rounded key)
void bootstrap_key_limbs(const int32_t* in, int8_t* out, long n_polys,
                         int exact) {
    const long kl = exact ? 5 : 4;
    parallel_for(n_polys, [=](long p) {
        uint64_t buf[L * R];
        forward_one(in + p * N, buf);
        int8_t* o = out + p * (long)(L * R * 2 * kl);
        for (long idx = 0; idx < L * R; ++idx) {
            if (exact) {
                split_one(center38(buf[idx]), o + idx * 2 * kl);
                split_one(center38((uint64_t)0 - buf[idx]),
                          o + idx * 2 * kl + 1);
            } else {
                split_one_rounded(center38(buf[idx]), o + idx * 2 * kl);
                split_one_rounded(center38((uint64_t)0 - buf[idx]),
                                  o + idx * 2 * kl + 1);
            }
        }
    });
}

}  // extern "C"
