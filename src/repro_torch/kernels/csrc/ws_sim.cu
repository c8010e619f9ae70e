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
// of *dependent* reads — the argmin must finish before state[i] can be read,
// state[i] before the handler runs, the handler's stores before the next
// argmin — so the time of a row is (events) x (latency of that chain), and the
// card is filled by running many rows at once, not by making one row wide.
// The DAG and adaptive bodies put global-memory reads into that chain (a
// deque slot, a predecessor count, a pool entry), each an L1/L2 round trip;
// making the chain short is later work.
//
// Design for that:
//  * one warp per scenario, one warp per block: rows are independent and their
//    event counts ragged, so each row simply ends when it ends;
//  * the per-processor vectors live in shared memory for the whole loop (13
//    rows of p words; the DAG and adaptive bodies add cur_task, head, tail and
//    tasks_run); the scalar counters live in registers, replicated in every
//    lane;
//  * the model state that grows with the problem lives in a per-row slab of
//    global memory that the wrapper allocates and this kernel initialises:
//    DAG pred[n] (copied from pred_count) and deques buf[p, cap]; adaptive
//    tdur/mpar/tpred/is_merge[pool_cap] and deques buf[p, deque_cap]. Deque
//    positions never reset (head only grows), exactly as in the reference; a
//    push at tail == cap sets halt, which ends the row as an overflow;
//  * argmin over the (time, lane) pair packed into one 64-bit key, so ties
//    break to the lowest lane by construction;
//  * every lane computes the (uniform) scalars of a handler redundantly; only
//    lane 0 stores. Each event is: read phase, __syncwarp, lane-0 write phase,
//    __syncwarp — no lane reads a location in the same phase lane 0 writes it.
//    The children of a finished DAG task are visited by lane 0 alone, in CSR
//    order, because a child's push position depends on the pushes before it.
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
    long long slab_stride;
    int G, p, strategy, mwt, model_max_events, log_trace, max_trace,
        trace_rows;
    int n_tasks, cap, owner_lifo, src;   // DAG (cap: deque capacity)
    int pool_cap, merge_alpha, merge_beta_num, merge_beta_den;  // ADAPTIVE
};

namespace {

using namespace ws;

enum Model { DIVISIBLE = 0, DAG = 1, ADAPTIVE = 2 };

constexpr int N_CORE_VEC = 13;   // shared int32/uint32/float rows of length p
constexpr int N_MODEL_VEC = 4;   // cur_task, head, tail, tasks_run
constexpr int N_SCALAR_OUT = 13;

__host__ __device__ constexpr int n_vec(int model) {
    return model == DIVISIBLE ? N_CORE_VEC : N_CORE_VEC + N_MODEL_VEC;
}

template <int MODEL>
__global__ void __launch_bounds__(32) ws_sim_kernel(const WsParams P)
{
    extern __shared__ int smem[];
    const int g = blockIdx.x;
    const int lane = threadIdx.x;
    const int p = P.p;

    Core c;
    c.state = smem;
    c.idle_at = smem + 1 * p;
    c.ev_time = smem + 2 * p;
    c.victim = smem + 3 * p;
    c.stolen = smem + 4 * p;
    c.busy_until = smem + 5 * p;
    c.rr_aux = smem + 6 * p;
    c.idle_since = smem + 7 * p;
    c.executed = smem + 8 * p;
    int* cid = smem + 9 * p;
    c.rng = reinterpret_cast<uint32_t*>(smem + 10 * p);
    float* scratch = reinterpret_cast<float*>(smem + 11 * p);
    // (row 12 is spare: it keeps the float scratch row apart from the model
    // rows that follow)
    int* cur_task = smem + 13 * p;
    int* head = smem + 14 * p;
    int* tail = smem + 15 * p;
    int* tasks_run = smem + 16 * p;

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

    const int cap = P.cap;
    int* slab = nullptr;
    int *pred = nullptr, *buf = nullptr;                 // DAG, ADAPTIVE
    int *tdur = nullptr, *mpar = nullptr, *tpred = nullptr, *ism = nullptr;
    if constexpr (MODEL == DAG) {
        slab = P.slab + (size_t)g * (size_t)P.slab_stride;
        pred = slab;
        buf = slab + P.n_tasks;
    } else if constexpr (MODEL == ADAPTIVE) {
        slab = P.slab + (size_t)g * (size_t)P.slab_stride;
        tdur = slab;
        mpar = slab + (size_t)P.pool_cap;
        tpred = slab + 2 * (size_t)P.pool_cap;
        ism = slab + 3 * (size_t)P.pool_cap;
        buf = slab + 4 * (size_t)P.pool_cap;
    }

    for (int j = lane; j < p; j += 32) {
        c.state[j] = ACTIVE;
        c.victim[j] = 0;
        c.busy_until[j] = 0;
        c.rr_aux[j] = j;
        c.idle_since[j] = 0;
        cid[j] = P.cid[j];
        c.rng[j] = seed_state(seed, (uint32_t)j);
        if constexpr (MODEL == DAG) {
            // proc 0 runs the first source; every other proc's first event
            // is an idle event at t = 0
            c.idle_at[j] = 0;
            c.ev_time[j] = (j == 0) ? __ldg(P.dur + P.src) : 0;
            c.executed[j] = 0;
            c.stolen[j] = -1;
            cur_task[j] = (j == 0) ? P.src : -1;
        } else {
            // all W units start on proc 0: everyone's first event is its idle
            // event
            const int w0 = (j == 0) ? W : 0;
            c.idle_at[j] = w0;
            c.ev_time[j] = w0;
            c.executed[j] = w0;
            c.stolen[j] = (MODEL == ADAPTIVE) ? -1 : 0;
            if constexpr (MODEL == ADAPTIVE) cur_task[j] = (j == 0) ? 0 : -1;
        }
        if constexpr (MODEL != DIVISIBLE) {
            head[j] = 0;
            tail[j] = 0;
            tasks_run[j] = 0;
        }
    }
    if constexpr (MODEL == DAG) {
        for (int k = lane; k < P.n_tasks; k += 32) pred[k] = __ldg(P.pred_count + k);
        for (size_t k = lane; k < (size_t)p * cap; k += 32) buf[k] = 0;
    } else if constexpr (MODEL == ADAPTIVE) {
        for (int k = lane; k < P.pool_cap; k += 32) {
            tdur[k] = (k == 0) ? W : 0;
            mpar[k] = -1;
            tpred[k] = 0;
            ism[k] = 0;
        }
        for (size_t k = lane; k < (size_t)p * cap; k += 32) buf[k] = 0;
    }
    int* trace = P.out_trace + (size_t)g * P.trace_rows * 4;
    for (int k = lane; k < P.trace_rows * 4; k += 32) trace[k] = 0;
    __syncwarp();

    int active_count = p;
    int n_events = 0, n_requests = 0, n_success = 0, n_fail = 0;
    int total_idle = 0, startup_end = -1, makespan = -1, n_trace = 0;
    bool done = false, halt = false;
    // model counters (DAG: n_completed; ADAPTIVE: all five)
    int n_completed = 0, n_created = 1, n_splits = 0, total_merge_work = 0;
    int next_free = 1;

    int budget = P.max_events[g];
    if (P.model_max_events < budget) budget = P.model_max_events;

    while (!done && !halt && n_events < budget) {
        int t;
        const int i = next_event(c.ev_time, p, lane, &t);
        n_events = addw(n_events, 1);
        const int st = c.state[i];

        bool logged = false;   // at most one trace row per event
        int kind = 0, aux = 0;

        if (st == ACTIVE) {
            if constexpr (MODEL == DIVISIBLE) {
                // ---- idle event: processor i's running work is exhausted ---
                // Remaining work anywhere (running or in flight) with i taken
                // as not active, and the terminal idle time of every other
                // non-active processor, from the state before anything is
                // changed (idle_since[i] becomes t, so i contributes 0).
                uint32_t rem = 0, idle_sum = 0;
                for (int j = lane; j < p; j += 32) {
                    if (j == i) continue;
                    const int s = c.state[j];
                    if (s == ACTIVE) {
                        rem += (uint32_t)c.idle_at[j] - (uint32_t)t;
                    } else {
                        if (s == ANS_FLIGHT) rem += (uint32_t)c.stolen[j];
                        idle_sum += (uint32_t)t - (uint32_t)c.idle_since[j];
                    }
                }
                rem = __reduce_add_sync(FULL, rem);
                idle_sum = __reduce_add_sync(FULL, idle_sum);
                active_count = subw(active_count, 1);
                logged = true;
                kind = EV_IDLE;
                aux = 0;
                if (rem == 0) {
                    done = true;
                    makespan = t;
                    total_idle = addw(total_idle, (int)idle_sum);
                    __syncwarp();
                    if (lane == 0) c.idle_since[i] = t;
                } else {
                    start_stealing(r, c, i, t, lane);
                    if (lane == 0) c.idle_since[i] = t;
                }
            } else {
                // ---- idle event: the running task (if any) completes -------
                const int cur = cur_task[i];
                const int hd = head[i];
                int tl = tail[i];
                bool h = false;
                if (cur >= 0) {
                    n_completed = addw(n_completed, 1);
                    if constexpr (MODEL == DAG) {
                        // executed grows at completion; the ready children
                        // go to i's own deque, in CSR order
                        const int dc = __ldg(P.dur + cur);
                        const int k0 = __ldg(P.child_ptr + cur);
                        const int k1 = __ldg(P.child_ptr + cur + 1);
                        const int exec_i = c.executed[i];
                        const int ran = tasks_run[i];
                        __syncwarp();
                        if (lane == 0) {
                            c.executed[i] = addw(exec_i, dc);
                            tasks_run[i] = addw(ran, 1);
                            cur_task[i] = -1;
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
                            tail[i] = tl;
                        }
                        tl = __shfl_sync(FULL, tl, 0);
                        h = __shfl_sync(FULL, h ? 1 : 0, 0) != 0;
                    } else {
                        // the merge parent is readied by its second half
                        const int par = mpar[cur];
                        const int pc = (par >= 0) ? subw(tpred[par], 1) : 1;
                        const bool ready = par >= 0 && pc == 0;
                        const bool ok = tl < cap;
                        __syncwarp();
                        if (lane == 0) {
                            if (par >= 0) tpred[par] = pc;
                            if (ready && ok) {
                                buf[(size_t)i * cap + tl] = par;
                                tail[i] = tl + 1;
                            }
                            cur_task[i] = -1;
                        }
                        if (ready) {
                            if (ok) tl += 1;
                            else h = true;
                        }
                    }
                    __syncwarp();        // lane 0's pushes are visible below
                }
                halt = halt || h;
                const bool finished = (MODEL == DAG) ? n_completed >= P.n_tasks
                                                     : n_completed >= n_created;
                if (finished) {
                    // terminal idle time of every other proc with no task
                    uint32_t idle_sum = 0;
                    for (int j = lane; j < p; j += 32) {
                        if (j != i && cur_task[j] < 0)
                            idle_sum += (uint32_t)t - (uint32_t)c.idle_since[j];
                    }
                    idle_sum = __reduce_add_sync(FULL, idle_sum);
                    done = true;
                    makespan = t;
                    total_idle = addw(total_idle, (int)idle_sum);
                } else if (hd < tl) {
                    // local pop: no trace row, i stays active
                    const bool lifo = (MODEL == ADAPTIVE) || P.owner_lifo;
                    const int pos = lifo ? tl - 1 : hd;
                    const int task = buf[(size_t)i * cap + pos];
                    if constexpr (MODEL == DAG) {
                        const int dt = __ldg(P.dur + task);
                        __syncwarp();
                        if (lane == 0) {
                            if (lifo) tail[i] = pos;
                            else head[i] = hd + 1;
                            cur_task[i] = task;
                            c.ev_time[i] = addw(t, dt);
                        }
                    } else {
                        const int dt = tdur[task];
                        const int exec_i = c.executed[i];
                        __syncwarp();
                        if (lane == 0) {
                            tail[i] = pos;
                            cur_task[i] = task;
                            c.idle_at[i] = addw(t, dt);
                            c.ev_time[i] = addw(t, dt);
                            c.executed[i] = addw(exec_i, dt);
                        }
                    }
                } else {
                    // empty deque: go idle and steal
                    active_count = subw(active_count, 1);
                    logged = true;
                    kind = EV_IDLE;
                    aux = 0;
                    start_stealing(r, c, i, t, lane);
                    if (lane == 0) c.idle_since[i] = t;
                }
            }
        } else if (st == REQ_FLIGHT) {
            // ---- steal-request event: i's request reaches its victim -------
            const int v = c.victim[i];
            const int d_vi = dist(r, v, i);
            const bool chan_free = P.mwt || (t >= c.busy_until[v]);
            bool ok;
            int payload;
            if constexpr (MODEL == DIVISIBLE) {
                const int w_v = (c.state[v] == ACTIVE) ? subw(c.idle_at[v], t) : 0;
                const int thr = addw(theta_static, mulw(theta_comm, d_vi));
                int amt = w_v >> 1;                      // floor(w_v / 2)
                ok = (amt >= 1) && (w_v > thr) && chan_free;
                if (!ok) amt = 0;
                const int exec_v = c.executed[v];
                __syncwarp();
                if (lane == 0 && ok) {
                    const int new_idle_v = addw(t, subw(w_v, amt));
                    c.idle_at[v] = new_idle_v;
                    c.ev_time[v] = new_idle_v;
                    c.executed[v] = subw(exec_v, amt);
                }
                payload = amt;
            } else if constexpr (MODEL == DAG) {
                // queue-length threshold; a steal takes the head
                const int hv = head[v];
                ok = (subw(tail[v], hv) > theta_static) && chan_free;
                payload = ok ? buf[(size_t)v * cap + (hv < cap - 1 ? hv : cap - 1)]
                             : -1;
                __syncwarp();
                if (lane == 0 && ok) head[v] = hv + 1;
            } else {
                // 1. the head of v's deque; 2. a split of v's running work
                // task; 3. fail
                const int hv = head[v];
                const bool can_queue = (subw(tail[v], hv) > 0) && chan_free;
                const int cv = cur_task[v];
                const bool running_work = c.state[v] == ACTIVE && cv >= 0
                                          && ism[cv >= 0 ? cv : 0] == 0;
                const int w_v = running_work ? subw(c.idle_at[v], t) : 0;
                const int thr = addw(theta_static, mulw(theta_comm, d_vi));
                const int amt = w_v >> 1;                // floor(w_v / 2)
                const bool room = next_free + 2 <= P.pool_cap;
                const bool can_split = running_work && amt >= 1 && w_v > thr
                                       && chan_free && room;
                ok = can_queue || can_split;
                payload = -1;
                if (can_queue) {
                    payload = buf[(size_t)v * cap + hv];
                    __syncwarp();
                    if (lane == 0) head[v] = hv + 1;
                } else if (can_split) {
                    const int m_id = next_free;
                    const int t_id = next_free + 1;
                    const int mdur = addw(P.merge_alpha,
                                          floordiv(mulw(amt, P.merge_beta_num),
                                                   P.merge_beta_den));
                    const int par = mpar[cv];            // read before written
                    const int exec_v = c.executed[v];
                    const int new_idle_v = addw(t, subw(w_v, amt));
                    __syncwarp();
                    if (lane == 0) {
                        tdur[m_id] = mdur;
                        tdur[t_id] = amt;
                        mpar[m_id] = par;
                        mpar[t_id] = m_id;
                        mpar[cv] = m_id;
                        tpred[m_id] = 2;
                        tpred[t_id] = 0;
                        ism[m_id] = 1;
                        ism[t_id] = 0;
                        c.idle_at[v] = new_idle_v;
                        c.ev_time[v] = new_idle_v;
                        c.executed[v] = subw(exec_v, amt);
                    }
                    next_free += 2;
                    n_created = addw(n_created, 2);
                    n_splits = addw(n_splits, 1);
                    total_merge_work = addw(total_merge_work, mdur);
                    payload = t_id;
                } else {
                    __syncwarp();
                }
            }
            if (lane == 0) {
                if (ok) c.busy_until[v] = addw(t, d_vi);
                c.stolen[i] = payload;
                c.state[i] = ANS_FLIGHT;
                c.ev_time[i] = addw(t, d_vi);
            }
            n_requests = addw(n_requests, 1);
            if (ok) n_success = addw(n_success, 1);
            else n_fail = addw(n_fail, 1);
            logged = true;
            kind = ok ? EV_REQ_OK : EV_REQ_FAIL;
            aux = v;
        } else {
            // ---- steal-answer event: the answer reaches thief i ------------
            const int got = c.stolen[i];
            const bool ok = (MODEL == DIVISIBLE) ? got > 0 : got >= 0;
            if (ok) {
                // the new task's length, and what executed[i] gains now
                int len, gain;
                if constexpr (MODEL == DIVISIBLE) { len = got; gain = got; }
                else if constexpr (MODEL == DAG) { len = __ldg(P.dur + got); gain = 0; }
                else { len = tdur[got]; gain = len; }
                const int since = c.idle_since[i];
                const int exec_i = c.executed[i];
                __syncwarp();
                if (lane == 0) {
                    const int end = addw(t, len);
                    c.state[i] = ACTIVE;
                    c.idle_at[i] = end;
                    c.ev_time[i] = end;
                    c.stolen[i] = (MODEL == DIVISIBLE) ? 0 : -1;
                    c.executed[i] = addw(exec_i, gain);
                    if constexpr (MODEL != DIVISIBLE) cur_task[i] = got;
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
                aux = start_stealing(r, c, i, t, lane);  // the new victim
            }
        }

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
        __syncwarp();
    }

    for (int j = lane; j < p; j += 32) {
        P.out_executed[(size_t)g * p + j] = c.executed[j];
        if constexpr (MODEL == DAG) P.out_tasks_run[(size_t)g * p + j] = tasks_run[j];
    }
    if (lane == 0) {
        const int G = P.G;
        int* o = P.out_scalars;
        o[0 * (size_t)G + g] = makespan;
        o[1 * (size_t)G + g] = n_events;
        o[2 * (size_t)G + g] = n_requests;
        o[3 * (size_t)G + g] = n_success;
        o[4 * (size_t)G + g] = n_fail;
        o[5 * (size_t)G + g] = total_idle;
        o[6 * (size_t)G + g] = startup_end;
        o[7 * (size_t)G + g] = (!done || halt) ? 1 : 0;   // overflow
        o[8 * (size_t)G + g] = n_trace;
        o[9 * (size_t)G + g] = n_completed;
        o[10 * (size_t)G + g] = n_splits;
        o[11 * (size_t)G + g] = total_merge_work;
        o[12 * (size_t)G + g] = n_created;
    }
}

template <int MODEL>
int launch(const WsParams* P, void* stream) {
    if (P->G <= 0) return 0;
    const int smem = n_vec(MODEL) * P->p * (int)sizeof(int);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            ws_sim_kernel<MODEL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (e != cudaSuccess) return (int)e;
    }
    ws_sim_kernel<MODEL><<<P->G, 32, smem, (cudaStream_t)stream>>>(*P);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ws_sim_shared_bytes(int model, int p) {
    return n_vec(model) * p * (int)sizeof(int);
}

extern "C" int ws_sim_scalar_rows() { return N_SCALAR_OUT; }

extern "C" int ws_sim_params_bytes() { return (int)sizeof(WsParams); }

extern "C" int ws_sim_divisible_launch(const WsParams* P, void* stream) {
    return launch<DIVISIBLE>(P, stream);
}

extern "C" int ws_sim_dag_launch(const WsParams* P, void* stream) {
    return launch<DAG>(P, stream);
}

extern "C" int ws_sim_adaptive_launch(const WsParams* P, void* stream) {
    return launch<ADAPTIVE>(P, stream);
}

extern "C" const char* ws_sim_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
