// The model-independent part of the work-stealing event loop on the card:
// int32 wrapping arithmetic, the xorshift32 PRNG lanes, the (time, lane)
// argmin, distance, victim selection (four strategies) and the start of a
// steal. Shared by every task-model body of ws_sim.cu; the plain version of
// each function is its namesake in repro_torch/core/engine.py.
//
// Every function here is called by all 32 lanes of the warp that owns one
// scenario; each lane returns the same (uniform) value. Stores to the shared
// state vectors are made by lane 0 only, after a __syncwarp that ends the
// phase in which the other lanes read them.
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

__device__ __forceinline__ unsigned long long warp_min_u64(unsigned long long v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        unsigned long long o = __shfl_xor_sync(FULL, v, off);
        v = o < v ? o : v;
    }
    return v;
}

// Lexicographic (time, lane) minimum of ev_time: ties go to the lowest lane
// by construction. Returns the lane; *t gets its time.
__device__ __forceinline__ int next_event(const int* ev_time, int p, int lane,
                                          int* t) {
    unsigned long long best = ~0ull;
    for (int j = lane; j < p; j += 32) {
        const unsigned long long key =
            ((unsigned long long)((uint32_t)ev_time[j] ^ 0x80000000u) << 32)
            | (uint32_t)j;
        best = key < best ? key : best;
    }
    best = warp_min_u64(best);
    *t = (int)((uint32_t)(best >> 32) ^ 0x80000000u);
    return (int)(uint32_t)best;
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
};

__device__ __forceinline__ int dist(const Row& r, int i, int j) {
    if (i == j) return 0;
    if (r.cid[i] == r.cid[j]) return r.lam_local;
    return mulw(r.lam_remote, __ldg(r.hops + (size_t)i * r.p + j));
}

// Victim selection for thief i; every lane returns the same (v, rng, rr).
// Called by all 32 lanes together (it uses warp collectives).
__device__ int select_victim(const Row& r, int i, int lane, uint32_t& rng,
                             int& rr) {
    const int p = r.p;
    if (r.strategy == UNIFORM) {
        rng = xorshift32(rng);
        int v = (int)(rng % (uint32_t)(p - 1));
        return v + (v >= i ? 1 : 0);
    }
    if (r.strategy == ROUND_ROBIN) {
        int nxt = (rr + 1) % p;
        if (nxt == i) nxt = (nxt + 1) % p;
        rr = nxt;
        return nxt;
    }
    if (r.strategy == LOCAL_FIRST) {
        rng = xorshift32(rng);
        const bool go_remote = rng < r.remote_prob;
        rng = xorshift32(rng);
        const int my = r.cid[i];
        // candidates in lane order: remote = other clusters, local = own
        // cluster without i
        uint32_t n = 0;
        for (int base = 0; base < p; base += 32) {
            const int j = base + lane;
            const bool in = j < p && (go_remote ? r.cid[j] != my
                                                : (r.cid[j] == my && j != i));
            n += __popc(__ballot_sync(FULL, in));
        }
        if (n == 0) n = 1;
        uint32_t k = rng % n;           // the k-th candidate, 0-based
        int v = 0;                      // no candidate at all: index 0
        for (int base = 0; base < p; base += 32) {
            const int j = base + lane;
            const bool in = j < p && (go_remote ? r.cid[j] != my
                                                : (r.cid[j] == my && j != i));
            uint32_t bal = __ballot_sync(FULL, in);
            const uint32_t cnt = __popc(bal);
            if (k < cnt) {
                for (uint32_t q = 0; q < k; ++q) bal &= bal - 1;
                v = base + __ffs(bal) - 1;
                break;
            }
            k -= cnt;
        }
        if (v == i) v = (i + 1) % p;    // only if both masks are empty
        return v;
    }
    // INV_DISTANCE: P(j) proportional to 1 / max(d(i, j), 1).
    for (int j = lane; j < p; j += 32) {
        int d;
        if (r.cid[j] == r.cid[i]) d = r.lam_local;
        else d = mulw(r.lam_remote, __ldg(r.hops + (size_t)i * p + j));
        const float df = __int2float_rn(d);
        r.scratch[j] = (j == i) ? 0.0f : __fdiv_rn(1.0f, fmaxf(df, 1.0f));
    }
    __syncwarp();
    // strictly sequential float32 prefix sums, every lane the same
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

// The per-processor state vectors every model keeps in shared memory.
struct Core {
    int* state;
    int* idle_at;
    int* ev_time;
    int* victim;
    int* stolen;
    int* busy_until;
    int* rr_aux;
    int* idle_since;
    int* executed;
    uint32_t* rng;
};

// processor engine start_stealing(): pick a victim for thief i and put its
// request in flight. Ends the read phase of the event (one __syncwarp), so
// every lane must have read what it needs before the call. Returns v.
__device__ __forceinline__ int start_stealing(const Row& r, const Core& c,
                                              int i, int t, int lane) {
    uint32_t rg = c.rng[i];
    int rr = c.rr_aux[i];
    const int v = select_victim(r, i, lane, rg, rr);
    const int d = dist(r, i, v);
    __syncwarp();
    if (lane == 0) {
        c.state[i] = REQ_FLIGHT;
        c.victim[i] = v;
        c.ev_time[i] = addw(t, d);
        c.rng[i] = rg;
        c.rr_aux[i] = rr;
    }
    return v;
}

}  // namespace ws
