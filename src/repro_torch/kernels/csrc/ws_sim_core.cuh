// The model-independent part of the work-stealing event loop on the card:
// int32 wrapping arithmetic, the xorshift32 PRNG lanes, a division-free
// n % d, distance and victim selection (four strategies). Shared by every
// task-model body of ws_sim.cu; the plain version of each function is its
// namesake in repro_torch/core/engine.py.
//
// Every function here is called by all 32 lanes of the warp that owns one
// scenario; each lane returns the same (uniform) value.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ws {

constexpr int ACTIVE = 0;
constexpr int REQ_FLIGHT = 1;
constexpr int ANS_FLIGHT = 2;

constexpr int EV_IDLE = 0;
constexpr int EV_REQ_FAIL = 1;
constexpr int EV_REQ_OK = 2;
constexpr int EV_ANS_FAIL = 3;
constexpr int EV_ANS_OK = 4;

constexpr int UNIFORM = 0;
constexpr int LOCAL_FIRST = 1;
constexpr int INV_DISTANCE = 2;
constexpr int ROUND_ROBIN = 3;

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int addw(int a, int b) {
    return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int subw(int a, int b) {
    return (int)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int mulw(int a, int b) {
    return (int)((uint32_t)a * (uint32_t)b);
}
// Python / JAX integer division: rounds toward minus infinity (C's `/`
// truncates toward zero). b != 0.
__device__ __forceinline__ int floordiv(int a, int b) {
    int q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
    return q;
}

__device__ __forceinline__ uint32_t xorshift32(uint32_t s) {
    s ^= s << 13;
    s ^= s >> 17;
    s ^= s << 5;
    return s;
}

__device__ __forceinline__ uint32_t seed_state(uint32_t seed, uint32_t i) {
    uint32_t x = seed * 0x9E3779B9u + i * 0x85EBCA6Bu + 1u;
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
    x ^= x >> 16;
    return x | 1u;
}

// n % d for every uint32 n without a division: enc = d | s1 << 16 | s2 << 20
// and m are the wrapper's divisor_magic(d) (Granlund and Montgomery's
// round-up method: q = (t + ((n - t) >> s1)) >> s2 with t = umulhi(n, m)).
__device__ __forceinline__ uint32_t magic_mod(uint32_t n, int enc, int m) {
    const uint32_t d = (uint32_t)enc & 0xFFFFu;
    const uint32_t s1 = ((uint32_t)enc >> 16) & 0xFu;
    const uint32_t s2 = ((uint32_t)enc >> 20) & 0xFu;
    const uint32_t t = __umulhi(n, (uint32_t)m);
    const uint32_t q = (t + ((n - t) >> s1)) >> s2;
    return n - q * d;
}

struct Row {
    int p;
    int strategy;
    int lam_local;
    int lam_remote;
    uint32_t remote_prob;
    const int* hops;                // global, [p, p]
    const int* cid;                 // shared, [p]
    float* scratch;                 // shared, [p]
    const int4* lf;                 // shared, [p]: LOCAL_FIRST counts, divisors
    int uni_div, uni_magic;         // the divisor p - 1 (UNIFORM)
};

__device__ __forceinline__ int dist(const Row& r, int i, int j) {
    if (i == j) return 0;
    if (r.cid[i] == r.cid[j]) return r.lam_local;
    return mulw(r.lam_remote, __ldg(r.hops + (size_t)i * r.p + j));
}

// INV_DISTANCE: P(j) proportional to 1 / max(d(i, j), 1), drawn by a strictly
// sequential float32 prefix sum over r.scratch (every lane the same).
__device__ int inv_distance_victim(const Row& r, int i, int lane,
                                   uint32_t& rng) {
    const int p = r.p;
    for (int j = lane; j < p; j += 32) {
        int d;
        if (r.cid[j] == r.cid[i]) d = r.lam_local;
        else d = mulw(r.lam_remote, __ldg(r.hops + (size_t)i * p + j));
        const float df = __int2float_rn(d);
        r.scratch[j] = (j == i) ? 0.0f : __fdiv_rn(1.0f, fmaxf(df, 1.0f));
    }
    __syncwarp();
    float total = 0.0f;
    for (int j = 0; j < p; ++j) total = __fadd_rn(total, r.scratch[j]);
    rng = xorshift32(rng);
    const float u = __fmul_rn(
        __fdiv_rn(__uint2float_rn(rng), 4294967296.0f), total);
    int v = 0;                          // no c[j] > u at all: index 0
    float c = 0.0f;
    for (int j = 0; j < p; ++j) {
        c = __fadd_rn(c, r.scratch[j]);
        if (c > u) { v = j; break; }
    }
    if (v == i) v = (i + 1) % p;
    __syncwarp();                       // scratch is rewritten by the next call
    return v;
}

// Victim selection for thief i (engine select_victim), with no division in
// the chain: UNIFORM takes p - 1's multiply-high divisor; ROUND_ROBIN wraps
// its cursor (0 <= rr < p, kept in `rng`) by a compare; LOCAL_FIRST reads
// i's candidate counts and their divisors from r.lf and reaches the k-th
// candidate, in index order, with __fns. `cid_chunk[c]` holds
// cid[32 c + lane] (CHUNKS >= ceil(p / 32)). Called by all 32 lanes; every
// lane returns the same (v, rng).
template <int CHUNKS>
__device__ __forceinline__ int select_victim(
        const Row& r, const int (&cid_chunk)[CHUNKS], int i, int lane,
        uint32_t& rng) {
    const int p = r.p;
    if (r.strategy == UNIFORM) {
        rng = xorshift32(rng);
        const int v = (int)magic_mod(rng, r.uni_div, r.uni_magic);
        return v + (v >= i ? 1 : 0);
    }
    if (r.strategy == ROUND_ROBIN) {     // rng holds the cursor here
        int nxt = (int)rng + 1;
        if (nxt == p) nxt = 0;
        if (nxt == i && ++nxt == p) nxt = 0;
        rng = (uint32_t)nxt;
        return nxt;
    }
    if (r.strategy == LOCAL_FIRST) {
        rng = xorshift32(rng);
        const bool go_remote = rng < r.remote_prob;
        rng = xorshift32(rng);
        const int my = r.cid[i];
        const int4 lf = r.lf[i];
        uint32_t k = go_remote ? magic_mod(rng, lf.z, lf.w)
                               : magic_mod(rng, lf.x, lf.y);
        int v = 0;                      // no candidate at all: index 0
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) {
            const int j = 32 * c + lane;
            const bool in = j < p && (go_remote ? cid_chunk[c] != my
                                                : (cid_chunk[c] == my && j != i));
            const uint32_t bal = __ballot_sync(FULL, in);
            const uint32_t cnt = __popc(bal);
            if (k < cnt) {
                v = 32 * c + (int)__fns(bal, 0, (int)k + 1);
                break;
            }
            k -= cnt;
        }
        if (v == i) v = (i + 1 == p) ? 0 : i + 1;   // only if both sets are empty
        return v;
    }
    return inv_distance_victim(r, i, lane, rng);
}


}  // namespace ws
