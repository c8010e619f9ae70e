// Batched work-stealing simulation: one whole discrete-event simulation per
// scenario, for NVIDIA Hopper (sm_90a), with one body per task model.
//
// Replaces the Pallas kernel `_kernel` / `ws_sim_pallas` of
// src/repro/kernels/ws_sim.py (its `pallas_call` at line 119), whose body is
// `_simulate_impl` of src/repro/core/engine.py under each task model:
//   * DIVISIBLE (core/divisible.py) — W unit tasks, a steal takes half;
//   * DAG       (core/dag.py)       — a static task graph, per-processor
//                                     deques, predecessor counts;
//   * ADAPTIVE  (core/adaptive.py)  — splittable work and a pool of merge
//                                     tasks that join the halves.
// Each body builds the engine state, runs `while (!done && !halt && n_events <
// budget) { i = argmin(ev_time); switch (state[i]) -> on_idle / on_request /
// on_answer }` and writes one row of every result leaf. Its plain version is
// `repro_torch.core.engine.run_loop` under the same model; the two are held
// leaf for leaf, bit for bit. The model-independent machinery (argmin,
// victim selection, distance, the start of a steal) is ws_sim_core.cuh.
//
// What bounds it. Neither bytes nor arithmetic: a scenario reads eight scalars
// (a DAG also its shared CSR arrays, from L2) and writes p + 13 integers (+ its
// trace), and an event is a few dozen integer operations. The loop is a chain
// of *dependent* steps — the argmin must finish before processor i's fields
// can be read, those before the handler runs, the handler's stores before the
// next argmin — so the time of a row is (its events) x (latency of one event),
// and a launch takes as long as its longest row. 256 rows fill the card's 132
// SMs at about two warps an SM, so nothing hides that latency: the design
// shortens the chain. A probe build (-DWS_SIM_PROBE, benchmarks/ws_sim_probe.py)
// stamps clock64() after each phase of an event; on an H100 the kernel this
// one replaced (every field in shared memory, lane-0 stores, a 64-bit shuffle
// argmin) spent 1081 cycles an event (divisible, p = 256): argmin 496, handler
// 335 (its pass over p processors), victim selection 180, commit 57.
//
// Design for that. One warp per scenario, one warp per block: rows are
// independent and their event counts ragged, so each row ends when it ends.
// Lane l holds the event times of processors j = l*K .. l*K + K - 1 in
// registers (K = 1, 2, 4, 8, 16, 32 a template parameter, the least with
// 32 K >= p; no array is indexed at run time, so none goes to local memory,
// and none spills up to K = 32, p = 1024). The argmin is 32-bit warp
// instructions: a tree of strict compares over the lane's K slots, then
// __reduce_min_sync, a ballot of the lanes that hold the minimum and __ffs —
// the lowest such lane holds the lowest index, the tie rule. A new time is a
// select in every slot of every lane, true only in the owner's (a branch that
// one lane takes would split the warp). The other fields stay in shared
// memory, one word each: with one warp an SM sub-partition the loop is bound
// by the instructions it issues as much as by latency, and a field kept in
// registers costs K selects a store and K - 1 selects and a shuffle a read
// (measured slower at K = 8, level at K = 1). Every lane stores what every
// other lane stores; each handler stores only after a __syncwarp() that
// follows its last load. The divisible body keeps three running uint32 sums
// (idle_at over ACTIVE processors, stolen over ANS_FLIGHT ones, idle_since
// over the others), which give the reference's wrapping int32 sums bit for
// bit, instead of a pass over p per idle event. UNIFORM victims take a
// multiply-high divisor of p - 1 made by the wrapper; ROUND_ROBIN wraps by a
// compare; LOCAL_FIRST reads its candidate counts (with their divisors) from
// a host-made table and reaches the k-th candidate with __fns. Measured on an
// H100 (benchmarks/ws_sim_probe.py): 565 cycles an event, 328 ns on the
// longest row (divisible, p = 256, lambda = 482; the old kernel 1092 and
// 619); at p = 1024 (K = 32) 738 cycles and 456 ns (the old kernel 1840 and
// 994), which is why no shared-memory variant is kept for large p.
//
// The model state that grows with the problem lives in a per-row slab of
// global memory that the wrapper allocates and the kernel initialises: DAG
// pred[n] (copied from pred_count) and deques buf[p, cap]; the adaptive task
// pool (one 8-byte entry a task — duration, parent + 1, predecessors,
// is_merge — which L1 holds: a copy in shared memory measured no faster) and
// deques buf[p, deque_cap]. Deque positions never reset (head only grows),
// exactly as in the reference; a push at tail == cap sets halt, which ends
// the row as an overflow. The children of a finished DAG task are
// visited by lane 0 alone, in CSR order, because a child's push position
// depends on the pushes before it.
//
// All counters are int32 that wrap: arithmetic is done in uint32 and cast, so
// there is no signed overflow. PRNG lanes, seeds and the remote_prob threshold
// are uint32 natively; they cross the C interface as int64 holding 0..2^32-1.
// INV_DISTANCE is the one float path: true IEEE division, a strictly
// left-to-right float32 sum, round-to-nearest conversions, no contraction.
// The adaptive merge duration alpha + (s * beta_num) // beta_den is a floor
// division, as in Python.
//
// Plain C interface (loaded with ctypes): each launcher takes a WsParams by
// pointer and the stream, and returns the CUDA error code of the launch, 0 on
// success. It launches on the stream it is given, does not synchronise and
// allocates nothing.

#include "ws_sim_core.cuh"

// Everything a launch needs. It lives at global scope: the extern "C"
// launchers take it by pointer, and a type of the anonymous namespace would
// give them internal linkage (no exported symbol). The 64-bit fields come
// first, so the struct has no padding between fields and the wrapper's
// ctypes.Structure, which lists the same fields in the same order, lays it
// out identically (the wrapper checks sizeof against ws_sim_params_bytes()).
struct WsParams {
    const int* cid;                  // [p]
    const int* hops;                 // [p, p]
    const int* W;                    // scenario leaves, [G] each
    const long long* seed;
    const int* lam_local;
    const int* lam_remote;
    const int* theta_static;
    const int* theta_comm;
    const long long* remote_prob;
    const int* max_events;
    int* out_scalars;                // [N_SCALAR_OUT, G]
    int* out_executed;               // [G, p]
    int* out_tasks_run;              // [G, p] (DAG only)
    int* out_trace;                  // [G, trace_rows, 4]
    const int* dur;                  // DAG: [n]
    const int* child_ptr;            // DAG: [n + 1]
    const int* child_idx;            // DAG: [max(E, 1)]
    const int* pred_count;           // DAG: [n]
    int* slab;                       // DAG, ADAPTIVE: [G, slab_stride]
    const int* lf_div;               // [p, 4] LOCAL_FIRST counts + divisors
    long long* probe;                // WS_SIM_PROBE builds: [G, N_PROBE]
    long long slab_stride;
    int G, p, strategy, mwt, model_max_events, log_trace, max_trace,
        trace_rows;
    int n_tasks, cap, owner_lifo, src;   // DAG (cap: deque capacity)
    int pool_cap, merge_alpha, merge_beta_num, merge_beta_den;  // ADAPTIVE
    int uni_div, uni_magic;          // the divisor p - 1 (UNIFORM)
};

namespace {

using namespace ws;

// Cycle stamps of the phases of an event (a build with -DWS_SIM_PROBE only;
// benchmarks/ws_sim_probe.py reads them): every lane keeps the sums, lane 0
// writes them to P.probe[g] at the end of the row. A phase's cycles are those
// from the mark before it to its own mark.
enum Phase { PH_ARGMIN, PH_DISPATCH, PH_HANDLER, PH_STEAL, PH_COMMIT,
             N_PHASE };
constexpr int N_PROBE = N_PHASE + 1;   // + the cycles of the whole loop
#ifdef WS_SIM_PROBE
#define PROBE_BEGIN                                                         \
    long long pr_acc[N_PHASE] = {};                                         \
    const long long pr_start = clock64();                                   \
    long long pr_t = pr_start;
#define PROBE_MARK(ph)                                                      \
    { const long long pr_n = clock64(); pr_acc[ph] += pr_n - pr_t;          \
      pr_t = pr_n; }
#define PROBE_END(P, g, lane)                                               \
    if (lane == 0 && (P).probe) {                                           \
        for (int q = 0; q < N_PHASE; ++q)                                   \
            (P).probe[(size_t)(g) * N_PROBE + q] = pr_acc[q];               \
        (P).probe[(size_t)(g) * N_PROBE + N_PHASE] = clock64() - pr_start;  \
    }
#else
#define PROBE_BEGIN
#define PROBE_MARK(ph)
#define PROBE_END(P, g, lane)
#endif

enum Model { DIVISIBLE = 0, DAG = 1, ADAPTIVE = 2 };

constexpr int N_SCALAR_OUT = 13;

// Row g of every scalar result leaf.
__device__ __forceinline__ void write_scalars(
        const WsParams& P, int g, int makespan, int n_events, int n_requests,
        int n_success, int n_fail, int total_idle, int startup_end,
        bool overflow, int n_trace, int n_completed, int n_splits,
        int total_merge_work, int n_created) {
    const int v[N_SCALAR_OUT] = {
        makespan, n_events, n_requests, n_success, n_fail, total_idle,
        startup_end, overflow ? 1 : 0, n_trace, n_completed, n_splits,
        total_merge_work, n_created};
#pragma unroll
    for (int k = 0; k < N_SCALAR_OUT; ++k)
        P.out_scalars[(size_t)k * P.G + g] = v[k];
}

// ---------------------------------------------------------------------------
// The kernel: lane l holds the event times of processors j = l*K + k,
// k < K, in its registers (K = 1, 2, 4, 8, 16, 32: p <= 32 K). With that
// layout the lowest lane among the lanes that hold the earliest time holds
// the lowest index, which is the argmin's tie rule; padding processors
// (j >= p) wait at INT32_MAX and lose every tie to a real one. Every other
// field of a processor lives in shared memory, one word each, which every
// lane reads (a broadcast) and every lane stores with the same value: one
// instruction a field, where fields kept in registers too cost K selects a
// store and K - 1 selects and a shuffle a read (measured slower at K = 8).
// ---------------------------------------------------------------------------

// The lane's earliest slot: a tree of strict compares, so the lower slot
// keeps a tie.
template <int K>
__device__ __forceinline__ int lane_argmin(const int (&ev)[K], int& best) {
    int tv[K], tk[K];
#pragma unroll
    for (int q = 0; q < K; ++q) { tv[q] = ev[q]; tk[q] = q; }
#pragma unroll
    for (int w = 1; w < K; w *= 2) {
#pragma unroll
        for (int q = 0; q < K; q += 2 * w) {
            const bool lt = tv[q + w] < tv[q];
            tv[q] = lt ? tv[q + w] : tv[q];
            tk[q] = lt ? tk[q + w] : tk[q];
        }
    }
    best = tv[0];
    return tk[0];
}

// ev[k] = val on the lane that holds processor j = owner*K + k: a select in
// every slot of every lane (a branch that one lane takes would split the
// warp).
template <int K>
__device__ __forceinline__ void set_ev(int (&ev)[K], int j, int lane, int val) {
    const bool own = lane == (int)((unsigned)j / K);
#pragma unroll
    for (int q = 0; q < K; ++q) ev[q] = (own && (j & (K - 1)) == q) ? val : ev[q];
}

// Adaptive task pool entry: x = duration, y = (parent + 1) | predecessors
// still running << 29 (0 .. 2) | is_merge << 31.
__device__ __forceinline__ int pool_parent(uint32_t m) {
    return (int)(m & 0x1FFFFFFFu) - 1;
}
__device__ __forceinline__ int pool_preds(uint32_t m) { return (m >> 29) & 3u; }
__device__ __forceinline__ bool pool_is_merge(uint32_t m) { return m >> 31; }
__device__ __forceinline__ uint32_t pool_meta(int parent, int preds,
                                              bool merge) {
    return (uint32_t)(parent + 1) | ((uint32_t)preds & 3u) << 29
           | (merge ? 1u << 31 : 0u);
}

// The per-processor fields in shared memory, one
// row of p words each (ev mirrors the event times the lanes hold).
constexpr int N_REG_FIELDS = 12;   // st ev victim stolen busy since exec rng
                                   // cur head tail ran
struct Fields {
    int *st, *ev, *victim, *stolen, *busy, *since, *exec;
    uint32_t* rng;                 // xorshift32 lane, or the round-robin cursor
    int *cur, *head, *tail, *ran;  // DAG, ADAPTIVE (ran: DAG)
};

// Bytes of the kernel's dynamic shared memory: per processor its
// LOCAL_FIRST counts (16 bytes), its cluster id, the INV_DISTANCE scratch
// word and its fields.
__host__ __device__ inline size_t shared_bytes(const WsParams& P) {
    return (size_t)P.p * (24 + 4 * N_REG_FIELDS);
}

template <int MODEL, int K>
__global__ void __launch_bounds__(32, 1) ws_sim_reg_kernel(const WsParams P)
{
    extern __shared__ int4 smem4[];
    const int g = blockIdx.x;
    const int lane = threadIdx.x;
    const int p = P.p;
    int4* lf = smem4;
    int* cid = reinterpret_cast<int*>(lf + p);
    float* scratch = reinterpret_cast<float*>(cid + p);
    int* fw = reinterpret_cast<int*>(scratch + p);
    Fields F;
    F.st = fw;
    F.ev = fw + 1 * p;
    F.victim = fw + 2 * p;
    F.stolen = fw + 3 * p;
    F.busy = fw + 4 * p;
    F.since = fw + 5 * p;
    F.exec = fw + 6 * p;
    F.rng = reinterpret_cast<uint32_t*>(fw + 7 * p);
    F.cur = fw + 8 * p;
    F.head = fw + 9 * p;
    F.tail = fw + 10 * p;
    F.ran = fw + 11 * p;

    const int W = P.W[g];
    const uint32_t seed = (uint32_t)P.seed[g];
    const int theta_static = P.theta_static[g];
    const int theta_comm = P.theta_comm[g];

    Row r;
    r.p = p;
    r.strategy = P.strategy;
    r.lam_local = P.lam_local[g];
    r.lam_remote = P.lam_remote[g];
    r.remote_prob = (uint32_t)P.remote_prob[g];
    r.hops = P.hops;
    r.cid = cid;
    r.scratch = scratch;
    r.lf = lf;
    r.uni_div = P.uni_div;
    r.uni_magic = P.uni_magic;

    const int cap = P.cap;
    int* slab = (MODEL == DIVISIBLE) ? nullptr
                                     : P.slab + (size_t)g * (size_t)P.slab_stride;
    // DAG: pred[n], then the deques buf[p, cap]; ADAPTIVE: the task pool of
    // 8-byte entries (L1 holds it: a copy in shared memory measured no
    // faster), then the deques
    int* pred = slab;
    int* buf = (MODEL == DAG) ? slab + P.n_tasks : slab + 2 * (size_t)P.pool_cap;
    uint2* pool = reinterpret_cast<uint2*>(slab);

    for (int j = lane; j < p; j += 32) {
        cid[j] = P.cid[j];
        lf[j] = reinterpret_cast<const int4*>(P.lf_div)[j];
        F.st[j] = ACTIVE;
        F.victim[j] = 0;
        F.busy[j] = 0;
        F.since[j] = 0;
        F.rng[j] = (P.strategy == ROUND_ROBIN) ? (uint32_t)j
                                               : seed_state(seed, (uint32_t)j);
        F.head[j] = 0;
        F.tail[j] = 0;
        F.ran[j] = 0;
        if constexpr (MODEL == DAG) {
            // proc 0 runs the first source; every other proc's first event
            // is an idle event at t = 0
            F.ev[j] = (j == 0) ? __ldg(P.dur + P.src) : 0;
            F.exec[j] = 0;
            F.stolen[j] = -1;
            F.cur[j] = (j == 0) ? P.src : -1;
        } else {
            // all W units start on proc 0
            const int w0 = (j == 0) ? W : 0;
            F.ev[j] = w0;
            F.exec[j] = w0;
            F.stolen[j] = (MODEL == ADAPTIVE) ? -1 : 0;
            F.cur[j] = (j == 0) ? 0 : -1;
        }
    }
    int cid_chunk[K];                  // cid[32 c + lane], for LOCAL_FIRST
#pragma unroll
    for (int c = 0; c < K; ++c) {
        const int j = 32 * c + lane;
        cid_chunk[c] = j < p ? P.cid[j] : -1;
    }
    int ev[K];                         // this lane's processors' event times
#pragma unroll
    for (int q = 0; q < K; ++q) {
        const int j = lane * K + q;
        if (j >= p) ev[q] = 0x7FFFFFFF;          // padding: never the earliest
        else if (MODEL == DAG) ev[q] = (j == 0) ? __ldg(P.dur + P.src) : 0;
        else ev[q] = (j == 0) ? W : 0;
    }
    if constexpr (MODEL == DAG) {
        for (int k = lane; k < P.n_tasks; k += 32) pred[k] = __ldg(P.pred_count + k);
        for (size_t k = lane; k < (size_t)p * cap; k += 32) buf[k] = 0;
    } else if constexpr (MODEL == ADAPTIVE) {
        for (int k = lane; k < P.pool_cap; k += 32)
            pool[k] = make_uint2(k == 0 ? (uint32_t)W : 0u, pool_meta(-1, 0, false));
        for (size_t k = lane; k < (size_t)p * cap; k += 32) buf[k] = 0;
    }
    int* trace = P.out_trace + (size_t)g * P.trace_rows * 4;
    for (int k = lane; k < P.trace_rows * 4; k += 32) trace[k] = 0;
    __syncwarp();

    int active_count = p;
    int n_events = 0, n_requests = 0, n_success = 0, n_fail = 0;
    int total_idle = 0, startup_end = -1, makespan = -1, n_trace = 0;
    bool done = false, halt = false;
    int n_completed = 0, n_created = 1, n_splits = 0, total_merge_work = 0;
    int next_free = 1;
    // DIVISIBLE running sums (uint32, wrapping like the reference's int32
    // sums): idle_at over ACTIVE processors, stolen over ANS_FLIGHT ones,
    // idle_since over the processors that are not ACTIVE
    uint32_t s_active_at = (uint32_t)W, s_flight = 0, s_since = 0;

    int budget = P.max_events[g];
    if (P.model_max_events < budget) budget = P.model_max_events;

    PROBE_BEGIN
    while (!done && !halt && n_events < budget) {
        // ---- argmin: per lane over its K slots, then across the warp ------
        int best;
        const int bk = lane_argmin<K>(ev, best);
        const int t = __reduce_min_sync(FULL, best);
        const int oi = __ffs(__ballot_sync(FULL, best == t)) - 1;
        const int i = oi * K + __shfl_sync(FULL, bk, oi);
        PROBE_MARK(PH_ARGMIN)
        n_events = addw(n_events, 1);
        // processor i's fields; a handler loads nothing else of i. Every
        // lane stores what every other lane stores, so the one hazard is a
        // lane that stores before another has loaded: each handler stores
        // only after a __syncwarp() that follows its last load.
        const int st = F.st[i];
        const int victim_i = F.victim[i];
        const int stolen_i = F.stolen[i];
        const int since_i = F.since[i];
        const int exec_i = F.exec[i];
        const uint32_t rng_i = F.rng[i];
        const int cur_i = (MODEL == DIVISIBLE) ? 0 : F.cur[i];
        const int head_i = (MODEL == DIVISIBLE) ? 0 : F.head[i];
        const int tail_i = (MODEL == DIVISIBLE) ? 0 : F.tail[i];
        const int ran_i = (MODEL == DAG) ? F.ran[i] : 0;
        PROBE_MARK(PH_DISPATCH)

        bool logged = false;   // at most one trace row per event
        int kind = 0, aux = 0;

        // processor j's event time is now val (in its owner's register and
        // in the mirror)
        auto set_time = [&](int j, int val) {
            set_ev<K>(ev, j, lane, val);
            F.ev[j] = val;
        };
        // processor i starts a steal: pick a victim, put its request in
        // flight (engine start_stealing); returns the victim
        auto steal = [&]() -> int {
            PROBE_MARK(PH_HANDLER)
            uint32_t rg = rng_i;
            const int v = select_victim<K>(r, cid_chunk, i, lane, rg);
            const int d = dist(r, i, v);
            F.st[i] = REQ_FLIGHT;
            F.victim[i] = v;
            F.rng[i] = rg;
            set_time(i, addw(t, d));
            PROBE_MARK(PH_STEAL)
            return v;
        };

        if (st == ACTIVE) {
            if constexpr (MODEL == DIVISIBLE) {
                // ---- idle event: processor i's running work is exhausted ---
                // From the running sums: the work left anywhere (running or
                // in flight; i's own term, idle_at - t, is 0) and the idle
                // time of every other processor that is not ACTIVE.
                const uint32_t rem = s_active_at
                    - (uint32_t)active_count * (uint32_t)t + s_flight;
                const uint32_t idle_sum =
                    (uint32_t)(p - active_count) * (uint32_t)t - s_since;
                active_count = subw(active_count, 1);
                s_active_at -= (uint32_t)t;           // i leaves ACTIVE
                s_since += (uint32_t)t;               // with idle_since = t
                logged = true;
                kind = EV_IDLE;
                aux = 0;
                __syncwarp();
                F.since[i] = t;
                if (rem == 0) {
                    done = true;
                    makespan = t;
                    total_idle = addw(total_idle, (int)idle_sum);
                } else {
                    steal();
                }
            } else {
                // ---- idle event: the running task (if any) completes -------
                const int cur = cur_i;
                const int hd = head_i;
                int tl = tail_i;
                bool h = false;
                __syncwarp();
                bool pushed = false;       // ADAPTIVE: the merge readied now
                int par = -1;
                uint2 e_par = make_uint2(0u, 0u);
                if (cur >= 0) {
                    n_completed = addw(n_completed, 1);
                    if constexpr (MODEL == DAG) {
                        // executed grows at completion; the ready children
                        // go to i's own deque, in CSR order (lane 0 alone:
                        // a child's slot depends on the pushes before it)
                        const int dc = __ldg(P.dur + cur);
                        const int k0 = __ldg(P.child_ptr + cur);
                        const int k1 = __ldg(P.child_ptr + cur + 1);
                        F.exec[i] = addw(exec_i, dc);
                        F.ran[i] = addw(ran_i, 1);
                        if (lane == 0) {
                            int* bi = buf + (size_t)i * cap;
                            for (int k = k0; k < k1; ++k) {
                                const int child = __ldg(P.child_idx + k);
                                const int pc = subw(pred[child], 1);
                                pred[child] = pc;
                                if (pc == 0) {
                                    if (tl < cap) bi[tl++] = child;
                                    else h = true;
                                }
                            }
                        }
                        tl = __shfl_sync(FULL, tl, 0);
                        h = __shfl_sync(FULL, h ? 1 : 0, 0) != 0;
                        __syncwarp();        // lane 0's pushes are visible below
                        F.tail[i] = tl;
                    } else {
                        // the merge parent is readied by its second half
                        par = pool_parent(pool[cur].y);
                        int pc = 1;
                        if (par >= 0) {
                            e_par = pool[par];
                            pc = pool_preds(e_par.y) - 1;
                        }
                        const bool ready = par >= 0 && pc == 0;
                        const bool ok = tl < cap;
                        __syncwarp();        // every lane has read the pool
                        if (par >= 0)
                            pool[par].y = pool_meta(pool_parent(e_par.y), pc,
                                                    pool_is_merge(e_par.y));
                        if (ready && ok) buf[(size_t)i * cap + tl] = par;
                        __syncwarp();
                        if (ready) {
                            if (ok) {
                                tl += 1;
                                pushed = true;
                                F.tail[i] = tl;
                            } else {
                                h = true;
                            }
                        }
                    }
                    F.cur[i] = -1;
                }
                halt = halt || h;
                const bool finished = (MODEL == DAG) ? n_completed >= P.n_tasks
                                                     : n_completed >= n_created;
                if (finished) {
                    // terminal idle time of every other proc with no task
                    uint32_t idle_sum = 0;
                    for (int j = lane; j < p; j += 32) {
                        if (j != i && F.cur[j] < 0)
                            idle_sum += (uint32_t)t - (uint32_t)F.since[j];
                    }
                    idle_sum = __reduce_add_sync(FULL, idle_sum);
                    done = true;
                    makespan = t;
                    total_idle = addw(total_idle, (int)idle_sum);
                } else if (hd < tl) {
                    // local pop: no trace row, i stays active
                    const bool lifo = (MODEL == ADAPTIVE) || P.owner_lifo;
                    const int pos = lifo ? tl - 1 : hd;
                    if constexpr (MODEL == DAG) {
                        const int task = buf[(size_t)i * cap + pos];
                        const int dt = __ldg(P.dur + task);
                        if (lifo) F.tail[i] = pos;
                        else F.head[i] = hd + 1;
                        F.cur[i] = task;
                        set_time(i, addw(t, dt));
                    } else {
                        // a merge pushed by this very event is the top
                        const int task = pushed ? par : buf[(size_t)i * cap + pos];
                        const int dt = (int)(pushed ? e_par.x : pool[task].x);
                        F.tail[i] = pos;
                        F.cur[i] = task;
                        F.exec[i] = addw(exec_i, dt);
                        set_time(i, addw(t, dt));
                    }
                } else {
                    // empty deque: go idle and steal
                    active_count = subw(active_count, 1);
                    logged = true;
                    kind = EV_IDLE;
                    aux = 0;
                    F.since[i] = t;
                    steal();
                }
            }
        } else if (st == REQ_FLIGHT) {
            // ---- steal-request event: i's request reaches its victim -------
            const int v = victim_i;
            const int d_vi = dist(r, v, i);
            const bool chan_free = P.mwt || (t >= F.busy[v]);
            bool ok;
            int payload;
            if constexpr (MODEL == DIVISIBLE) {
                const int exec_v = F.exec[v];
                const int w_v = (F.st[v] == ACTIVE) ? subw(F.ev[v], t) : 0;
                const int thr = addw(theta_static, mulw(theta_comm, d_vi));
                int amt = w_v >> 1;                      // floor(w_v / 2)
                ok = (amt >= 1) && (w_v > thr) && chan_free;
                if (!ok) amt = 0;
                __syncwarp();
                if (ok) {
                    F.exec[v] = subw(exec_v, amt);
                    set_time(v, addw(t, subw(w_v, amt)));
                    s_active_at -= (uint32_t)amt;     // v's idle_at drops
                }
                s_flight += (uint32_t)amt;            // i goes ANS_FLIGHT
                payload = amt;
            } else if constexpr (MODEL == DAG) {
                // queue-length threshold; a steal takes the head
                const int hv = F.head[v];
                ok = (subw(F.tail[v], hv) > theta_static) && chan_free;
                payload = ok ? buf[(size_t)v * cap + (hv < cap - 1 ? hv : cap - 1)]
                             : -1;
                __syncwarp();
                if (ok) F.head[v] = hv + 1;
            } else {
                // 1. the head of v's deque; 2. a split of v's running work
                // task; 3. fail
                const int hv = F.head[v];
                const int cv = F.cur[v];
                const int exec_v = F.exec[v];
                const bool can_queue = (subw(F.tail[v], hv) > 0) && chan_free;
                const uint2 e_cv = pool[cv >= 0 ? cv : 0];
                const bool running_work = F.st[v] == ACTIVE && cv >= 0
                                          && !pool_is_merge(e_cv.y);
                const int w_v = running_work ? subw(F.ev[v], t) : 0;
                const int thr = addw(theta_static, mulw(theta_comm, d_vi));
                const int amt = w_v >> 1;                // floor(w_v / 2)
                const bool room = next_free + 2 <= P.pool_cap;
                const bool can_split = running_work && amt >= 1 && w_v > thr
                                       && chan_free && room;
                ok = can_queue || can_split;
                payload = can_queue ? buf[(size_t)v * cap + hv] : -1;
                __syncwarp();            // every lane has read v and the pool
                if (can_queue) {
                    F.head[v] = hv + 1;
                } else if (can_split) {
                    const int m_id = next_free;
                    const int t_id = next_free + 1;
                    const int mdur = addw(P.merge_alpha,
                                          floordiv(mulw(amt, P.merge_beta_num),
                                                   P.merge_beta_den));
                    pool[m_id] = make_uint2((uint32_t)mdur,
                                            pool_meta(pool_parent(e_cv.y), 2, true));
                    pool[t_id] = make_uint2((uint32_t)amt,
                                            pool_meta(m_id, 0, false));
                    pool[cv].y = pool_meta(m_id, pool_preds(e_cv.y), false);
                    F.exec[v] = subw(exec_v, amt);
                    set_time(v, addw(t, subw(w_v, amt)));
                    next_free += 2;
                    n_created = addw(n_created, 2);
                    n_splits = addw(n_splits, 1);
                    total_merge_work = addw(total_merge_work, mdur);
                    payload = t_id;
                }
            }
            if (ok) F.busy[v] = addw(t, d_vi);
            F.stolen[i] = payload;
            F.st[i] = ANS_FLIGHT;
            set_time(i, addw(t, d_vi));
            n_requests = addw(n_requests, 1);
            if (ok) n_success = addw(n_success, 1);
            else n_fail = addw(n_fail, 1);
            logged = true;
            kind = ok ? EV_REQ_OK : EV_REQ_FAIL;
            aux = v;
        } else {
            // ---- steal-answer event: the answer reaches thief i ------------
            const int got = stolen_i;
            const bool ok = (MODEL == DIVISIBLE) ? got > 0 : got >= 0;
            if constexpr (MODEL == DIVISIBLE) s_flight -= (uint32_t)got;
            if (ok) {
                // the new task's length, and what executed[i] gains now
                int len, gain;
                if constexpr (MODEL == DIVISIBLE) { len = got; gain = got; }
                else if constexpr (MODEL == DAG) { len = __ldg(P.dur + got); gain = 0; }
                else { len = (int)pool[got].x; gain = len; }
                const int end = addw(t, len);
                const int since = since_i;
                __syncwarp();
                F.st[i] = ACTIVE;
                F.stolen[i] = (MODEL == DIVISIBLE) ? 0 : -1;
                F.exec[i] = addw(exec_i, gain);
                if constexpr (MODEL != DIVISIBLE) F.cur[i] = got;
                set_time(i, end);
                if constexpr (MODEL == DIVISIBLE) {
                    s_active_at += (uint32_t)end;       // i is ACTIVE again
                    s_since -= (uint32_t)since;
                }
                active_count = addw(active_count, 1);
                total_idle = addw(total_idle, subw(t, since));
                if (active_count == p && startup_end < 0) startup_end = t;
                logged = true;
                kind = EV_ANS_OK;
                aux = got;
            } else {
                logged = true;
                kind = EV_ANS_FAIL;
                __syncwarp();
                aux = steal();                          // the new victim
            }
        }

        PROBE_MARK(PH_HANDLER)
        if (logged && P.log_trace && n_trace < P.max_trace) {
            if (lane == 0) {
                int* row = trace + (size_t)n_trace * 4;
                row[0] = t;
                row[1] = i;
                row[2] = kind;
                row[3] = aux;
            }
            n_trace += 1;                // saturates at max_trace
        }
        // Every lane stored the same values, and read only what it had
        // stored itself; this orders the stores before the next event's
        // reads for the warp as a whole.
        __syncwarp();
        PROBE_MARK(PH_COMMIT)
    }
    PROBE_END(P, g, lane)

    for (int j = lane; j < p; j += 32) {
        P.out_executed[(size_t)g * p + j] = F.exec[j];
        if constexpr (MODEL == DAG) P.out_tasks_run[(size_t)g * p + j] = F.ran[j];
    }
    if (lane == 0)
        write_scalars(P, g, makespan, n_events, n_requests, n_success, n_fail,
                      total_idle, startup_end, !done || halt, n_trace,
                      n_completed, n_splits, total_merge_work, n_created);
}

template <class Kernel>
int launch_kernel(Kernel kernel, const WsParams* P, int smem, void* stream) {
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<P->G, 32, smem, (cudaStream_t)stream>>>(*P);
    return (int)cudaGetLastError();
}

// K: the processors (slots) a lane holds, as the wrapper chose them from p.
template <int MODEL>
int launch(const WsParams* P, int K, void* stream) {
    if (P->G <= 0) return 0;
    if (P->p < 2 || P->p > 32 * K) return (int)cudaErrorInvalidValue;
    const int smem = (int)shared_bytes(*P);
    switch (K) {
        case 1: return launch_kernel(ws_sim_reg_kernel<MODEL, 1>, P, smem, stream);
        case 2: return launch_kernel(ws_sim_reg_kernel<MODEL, 2>, P, smem, stream);
        case 4: return launch_kernel(ws_sim_reg_kernel<MODEL, 4>, P, smem, stream);
        case 8: return launch_kernel(ws_sim_reg_kernel<MODEL, 8>, P, smem, stream);
        case 16: return launch_kernel(ws_sim_reg_kernel<MODEL, 16>, P, smem, stream);
        case 32: return launch_kernel(ws_sim_reg_kernel<MODEL, 32>, P, smem, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" int ws_sim_shared_bytes(const WsParams* P) {
    return (int)shared_bytes(*P);
}

extern "C" int ws_sim_scalar_rows() { return N_SCALAR_OUT; }

extern "C" int ws_sim_params_bytes() { return (int)sizeof(WsParams); }

extern "C" int ws_sim_divisible_launch(const WsParams* P, int K, void* stream) {
    return launch<DIVISIBLE>(P, K, stream);
}

extern "C" int ws_sim_dag_launch(const WsParams* P, int K, void* stream) {
    return launch<DAG>(P, K, stream);
}

extern "C" int ws_sim_adaptive_launch(const WsParams* P, int K, void* stream) {
    return launch<ADAPTIVE>(P, K, stream);
}

extern "C" const char* ws_sim_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
