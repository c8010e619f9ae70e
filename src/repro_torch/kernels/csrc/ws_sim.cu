// Batched work-stealing simulation, divisible-load task model: one whole
// discrete-event simulation per scenario, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` / `ws_sim_pallas` of
// src/repro/kernels/ws_sim.py under `DivisibleModel`: build the engine state,
// run `while (!done && n_events < budget) { i = argmin(ev_time); switch
// (state[i]) -> on_idle / on_request / on_answer }`, write one row of every
// result leaf. Its plain version is `repro_torch.core.engine.run_loop`; the two
// are held leaf for leaf, bit for bit.
//
// What bounds it. Neither bytes nor arithmetic: a scenario reads eight scalars
// and writes p + 9 integers (+ its trace), and an event is a few dozen integer
// operations. The loop is a chain of *dependent* shared-memory reads — the
// argmin must finish before state[i] can be read, state[i] before the handler
// runs, the handler's stores before the next argmin — so the time of a row is
// (events) x (latency of that chain), and the card is filled by running many
// rows at once, not by making one row wide.
//
// Design for that:
//  * one warp per scenario, one warp per block: rows are independent and their
//    event counts ragged, so each row simply ends when it ends; a block holds
//    13 * p * 4 bytes of shared memory (state vectors, cluster ids, a float
//    scratch row), so tens of rows are resident on every SM and their chains
//    overlap;
//  * the eleven per-processor state vectors live in shared memory for the whole
//    loop; the scalar counters live in registers, replicated in every lane;
//    global memory is touched for the scenario row in, the result row out, the
//    trace rows, and single elements (or one row) of hops[p, p], which stays in
//    L2;
//  * argmin over the (time, lane) pair packed into one 64-bit key, so ties
//    break to the lowest lane by construction: p/32 shared loads per lane, then
//    five shuffles;
//  * every lane computes the (uniform) scalars of a handler redundantly, which
//    costs nothing in a latency-bound loop and needs no broadcast; only lane 0
//    stores. Each event is: read phase, __syncwarp, lane-0 write phase,
//    __syncwarp — no lane reads a location in the same phase lane 0 writes it;
//  * x.at[i].set(v) of the reference body is a plain store here.
//
// All counters are int32 that wrap: arithmetic is done in uint32 and cast, so
// there is no signed overflow. PRNG lanes, seeds and the remote_prob threshold
// are uint32 natively; they cross the C interface as int64 holding 0..2^32-1.
// INV_DISTANCE is the one float path: true IEEE division, a strictly
// left-to-right float32 sum, round-to-nearest conversions, no contraction.
//
// Plain C interface (loaded with ctypes): the launcher returns the CUDA error
// code of the launch, 0 on success. It launches on the stream it is given, does
// not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
constexpr int N_VEC = 13;      // shared int32/uint32/float rows of length p
constexpr int N_SCALAR_OUT = 9;

__device__ __forceinline__ int addw(int a, int b) {
    return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int subw(int a, int b) {
    return (int)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int mulw(int a, int b) {
    return (int)((uint32_t)a * (uint32_t)b);
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

__global__ void __launch_bounds__(32)
ws_sim_divisible_kernel(
    const int* __restrict__ cid_g, const int* __restrict__ hops,
    const int* __restrict__ W_g, const long long* __restrict__ seed_g,
    const int* __restrict__ lam_local_g, const int* __restrict__ lam_remote_g,
    const int* __restrict__ theta_static_g, const int* __restrict__ theta_comm_g,
    const long long* __restrict__ remote_prob_g,
    const int* __restrict__ max_events_g,
    int* __restrict__ out_scalars,   // [N_SCALAR_OUT, G]
    int* __restrict__ out_executed,  // [G, p]
    int* __restrict__ out_trace,     // [G, trace_rows, 4]
    int G, int p, int strategy, int mwt, int model_max_events,
    int log_trace, int max_trace, int trace_rows)
{
    extern __shared__ int smem[];
    const int g = blockIdx.x;
    const int lane = threadIdx.x;

    int* state = smem;
    int* idle_at = state + p;
    int* ev_time = idle_at + p;
    int* victim = ev_time + p;
    int* stolen = victim + p;
    int* busy_until = stolen + p;
    int* rr_aux = busy_until + p;
    int* idle_since = rr_aux + p;
    int* executed = idle_since + p;
    int* cid = executed + p;
    uint32_t* rng = reinterpret_cast<uint32_t*>(cid + p);
    float* scratch = reinterpret_cast<float*>(rng + p);
    // (the thirteenth row keeps the float scratch 4-byte aligned and separate)

    const int W = W_g[g];
    const uint32_t seed = (uint32_t)seed_g[g];
    const int theta_static = theta_static_g[g];
    const int theta_comm = theta_comm_g[g];

    Row r;
    r.p = p;
    r.strategy = strategy;
    r.lam_local = lam_local_g[g];
    r.lam_remote = lam_remote_g[g];
    r.remote_prob = (uint32_t)remote_prob_g[g];
    r.hops = hops;
    r.cid = cid;
    r.scratch = scratch;

    for (int j = lane; j < p; j += 32) {
        const int w0 = (j == 0) ? W : 0;
        state[j] = ACTIVE;
        idle_at[j] = w0;
        ev_time[j] = w0;      // everyone's first event is its idle event
        victim[j] = 0;
        stolen[j] = 0;
        busy_until[j] = 0;
        rr_aux[j] = j;
        idle_since[j] = 0;
        executed[j] = w0;
        cid[j] = cid_g[j];
        rng[j] = seed_state(seed, (uint32_t)j);
    }
    int* trace = out_trace + (size_t)g * trace_rows * 4;
    for (int k = lane; k < trace_rows * 4; k += 32) trace[k] = 0;
    __syncwarp();

    int active_count = p;
    int n_events = 0, n_requests = 0, n_success = 0, n_fail = 0;
    int total_idle = 0, startup_end = -1, makespan = -1, n_trace = 0;
    bool done = false;

    int budget = max_events_g[g];
    if (model_max_events < budget) budget = model_max_events;

    while (!done && n_events < budget) {
        // ---- next event: lexicographic (time, lane) minimum ----------------
        unsigned long long best = ~0ull;
        for (int j = lane; j < p; j += 32) {
            const unsigned long long key =
                ((unsigned long long)((uint32_t)ev_time[j] ^ 0x80000000u) << 32)
                | (uint32_t)j;
            best = key < best ? key : best;
        }
        best = warp_min_u64(best);
        const int i = (int)(uint32_t)best;
        const int t = (int)((uint32_t)(best >> 32) ^ 0x80000000u);
        n_events = addw(n_events, 1);
        const int st = state[i];

        int kind, aux;   // the one trace row of this event

        if (st == ACTIVE) {
            // ---- idle event: processor i's running work is exhausted -------
            // Remaining work anywhere (running or in flight) with i taken as
            // not active, and the terminal idle time of every other non-active
            // processor, from the state before anything is changed
            // (idle_since[i] becomes t, so i itself contributes 0).
            uint32_t rem = 0, idle_sum = 0;
            for (int j = lane; j < p; j += 32) {
                if (j == i) continue;
                const int s = state[j];
                if (s == ACTIVE) {
                    rem += (uint32_t)idle_at[j] - (uint32_t)t;
                } else {
                    if (s == ANS_FLIGHT) rem += (uint32_t)stolen[j];
                    idle_sum += (uint32_t)t - (uint32_t)idle_since[j];
                }
            }
            rem = __reduce_add_sync(FULL, rem);
            idle_sum = __reduce_add_sync(FULL, idle_sum);
            active_count = subw(active_count, 1);
            kind = EV_IDLE;
            aux = 0;
            if (rem == 0) {
                done = true;
                makespan = t;
                total_idle = addw(total_idle, (int)idle_sum);
                __syncwarp();
                if (lane == 0) idle_since[i] = t;
            } else {
                uint32_t rg = rng[i];
                int rr = rr_aux[i];
                const int v = select_victim(r, i, lane, rg, rr);
                const int d = dist(r, i, v);
                __syncwarp();
                if (lane == 0) {
                    idle_since[i] = t;
                    state[i] = REQ_FLIGHT;
                    victim[i] = v;
                    ev_time[i] = addw(t, d);
                    rng[i] = rg;
                    rr_aux[i] = rr;
                }
            }
        } else if (st == REQ_FLIGHT) {
            // ---- steal-request event: i's request reaches its victim -------
            const int v = victim[i];
            const int w_v = (state[v] == ACTIVE) ? subw(idle_at[v], t) : 0;
            const int d_vi = dist(r, v, i);
            const int thr = addw(theta_static, mulw(theta_comm, d_vi));
            const bool chan_free = mwt || (t >= busy_until[v]);
            int amt = w_v >> 1;                      // floor(w_v / 2)
            const bool ok = (amt >= 1) && (w_v > thr) && chan_free;
            if (!ok) amt = 0;
            const int exec_v = executed[v];
            __syncwarp();
            if (lane == 0) {
                if (ok) {
                    const int new_idle_v = addw(t, subw(w_v, amt));
                    idle_at[v] = new_idle_v;
                    ev_time[v] = new_idle_v;
                    busy_until[v] = addw(t, d_vi);
                    executed[v] = subw(exec_v, amt);
                }
                stolen[i] = amt;
                state[i] = ANS_FLIGHT;
                ev_time[i] = addw(t, d_vi);
            }
            n_requests = addw(n_requests, 1);
            if (ok) n_success = addw(n_success, 1);
            else n_fail = addw(n_fail, 1);
            kind = ok ? EV_REQ_OK : EV_REQ_FAIL;
            aux = v;
        } else {
            // ---- steal-answer event: the answer reaches thief i ------------
            const int amt = stolen[i];
            if (amt > 0) {
                const int since = idle_since[i];
                const int exec_i = executed[i];
                __syncwarp();
                if (lane == 0) {
                    const int end = addw(t, amt);
                    state[i] = ACTIVE;
                    idle_at[i] = end;
                    ev_time[i] = end;
                    stolen[i] = 0;
                    executed[i] = addw(exec_i, amt);
                }
                active_count = addw(active_count, 1);
                total_idle = addw(total_idle, subw(t, since));
                if (active_count == p && startup_end < 0) startup_end = t;
                kind = EV_ANS_OK;
                aux = amt;
            } else {
                uint32_t rg = rng[i];
                int rr = rr_aux[i];
                const int v = select_victim(r, i, lane, rg, rr);
                const int d = dist(r, i, v);
                __syncwarp();
                if (lane == 0) {
                    state[i] = REQ_FLIGHT;
                    victim[i] = v;
                    ev_time[i] = addw(t, d);
                    rng[i] = rg;
                    rr_aux[i] = rr;
                }
                kind = EV_ANS_FAIL;
                aux = v;                 // the victim chosen just now
            }
        }

        if (log_trace && n_trace < max_trace) {
            if (lane == 0) {
                int* row = trace + (size_t)n_trace * 4;
                row[0] = t;
                row[1] = i;
                row[2] = kind;
                row[3] = aux;
            }
            n_trace += 1;                // saturates at max_trace
        }
        __syncwarp();
    }

    for (int j = lane; j < p; j += 32)
        out_executed[(size_t)g * p + j] = executed[j];
    if (lane == 0) {
        out_scalars[0 * (size_t)G + g] = makespan;
        out_scalars[1 * (size_t)G + g] = n_events;
        out_scalars[2 * (size_t)G + g] = n_requests;
        out_scalars[3 * (size_t)G + g] = n_success;
        out_scalars[4 * (size_t)G + g] = n_fail;
        out_scalars[5 * (size_t)G + g] = total_idle;
        out_scalars[6 * (size_t)G + g] = startup_end;
        out_scalars[7 * (size_t)G + g] = done ? 0 : 1;   // overflow
        out_scalars[8 * (size_t)G + g] = n_trace;
    }
}

}  // namespace

extern "C" int ws_sim_shared_bytes(int p) {
    return N_VEC * p * (int)sizeof(int);
}

extern "C" int ws_sim_scalar_rows() { return N_SCALAR_OUT; }

extern "C" int ws_sim_divisible_launch(
    const int* cid, const int* hops,
    const int* W, const long long* seed,
    const int* lam_local, const int* lam_remote,
    const int* theta_static, const int* theta_comm,
    const long long* remote_prob, const int* max_events,
    int* out_scalars, int* out_executed, int* out_trace,
    int G, int p, int strategy, int mwt, int model_max_events,
    int log_trace, int max_trace, int trace_rows, void* stream)
{
    if (G <= 0) return 0;
    const int smem = ws_sim_shared_bytes(p);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            ws_sim_divisible_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    ws_sim_divisible_kernel<<<G, 32, smem, (cudaStream_t)stream>>>(
        cid, hops, W, seed, lam_local, lam_remote, theta_static, theta_comm,
        remote_prob, max_events, out_scalars, out_executed, out_trace,
        G, p, strategy, mwt, model_max_events, log_trace, max_trace,
        trace_rows);
    return (int)cudaGetLastError();
}

extern "C" const char* ws_sim_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
