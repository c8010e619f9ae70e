// Flash decode for NVIDIA Hopper (sm_90a): one query token per sequence
// against its KV cache, grouped-query, optional sliding window, float32
// online softmax.
//
// Replaces the Pallas kernel `_kernel` / `flash_decode` of
// src/repro/kernels/decode_attention.py (its `pallas_call` at line 85), which
// computes the function `decode_attention` of src/repro/models/attention.py
// (line 125). Its plain version is `decode_attention_ref` in
// repro_torch/kernels/decode_attention.py.
//
// Layout as in the reference: q [B, 1, H, hd], caches [B, Smax, KV, hd],
// out [B, 1, H, hd] of q's dtype. q and the caches may differ in dtype
// (the serving path keeps a bfloat16 cache beside float32 activations):
// everything is computed in float32, q is never cast to the cache's type.
// Query head h reads KV head h / (H / KV). Valid positions: kpos < kv_len
// and, with a window, kpos >= kv_len - window.
//
// kv_len contract. As in the Pallas kernel (its `len_ref`), kv_len may be an
// int32 in device memory, read by the kernel itself; the grid depends only on
// (B, KV, H, Smax, hd), so one launch captured in a CUDA graph serves every
// step of a decode loop. A launch given no device pointer takes the host
// value instead (checked: 1 <= kv_len <= Smax). A device value is clamped to
// [1, Smax] inside the kernel, so no value can read out of bounds; a value
// outside that range is outside the contract (the plain version would mask
// every row, or none).
//
// What bounds it: bytes. Every valid cache row (k and v, hd values each) has
// to be read once, for 2 * G * hd FMAs where G = H / KV query heads share it:
// 2 * G operations a byte in bfloat16 (4 for qwen3-1.7b's G = 2), far under
// the card's ~295, so the least time is the KV bytes / 3.35 TB/s. That also
// keeps it off the tensor cores: `wgmma` needs 64 rows of A, a decode step
// has G. A short cache (the serving path's 24 rows) is bound by latency
// instead: a launch, one round trip for kv_len and q, one for K and V.
//
// Design for that:
// - One block per (sequence, KV head, split of the sequence), four warps. It
//   reads each K and V row once and serves all G query heads of that KV head
//   (up to MAX_HEADS_PER_BLOCK; larger groups take several blocks) from
//   registers: q, the online-softmax state (m, l) and the accumulator of
//   every head live in the registers of the lanes that hold its elements.
// - A row is read with 16-byte loads, hd * sizeof(cache) / 16 lanes a row
//   on neighbouring addresses, in a lane group of L lanes, that count
//   rounded up to a power of two (2 to 32 lanes), so a warp reads 32 / L
//   rows at once; each lane group loads CH rows of K and of V together,
//   all before the first dot product needs them (8 loads in flight a lane).
//   A dot product is summed over the row's L lanes with shuffles. At hd =
//   96 a row is 12 loads in bfloat16 and 24 in float32: the group is 16 or
//   32 lanes, and the lanes past the row's end load nothing, hold zeros and
//   add 0 to every sum (the xor shuffles need a power of two). Padding q and
//   the caches to 128 instead would copy the whole cache every step.
// - Split-K over the sequence: the host picks the number of splits from
//   (B, KV, Smax) and the SM count so that the grid covers the card several
//   times (kernels/decode_attention.py::num_splits). A block whose rows lie
//   outside [max(0, kv_len - window), kv_len) exits as soon as kv_len is read
//   and writes a neutral partial (m = -1e30, l = 0, acc = 0). With one split
//   (the serving path) the block writes the output itself. With more, each
//   block writes its unnormalised (m, l, acc) to a float32 workspace that the
//   wrapper allocates, and a merge kernel combines the splits of each (b, h)
//   in split order: no float atomics, so a result is the same from run to
//   run (greedy tokens depend on that).
// - Inside a block, the lane groups' states are merged by shuffles within
//   each warp (in a fixed pattern), then across the four warps through
//   shared memory in warp order; the result is divided by max(l, 1e-30).
// - When there is no window, the first tile's rows do not depend on kv_len,
//   so its loads are issued before kv_len's value is needed; rows past
//   kv_len in that tile are read (in bounds) and masked. Later tiles read
//   only valid rows.
// The masked value is the reference's finite -1e30 (lm_common.cuh).
//
// Plain C interface (loaded with ctypes): the launcher takes the stream,
// launches on it, does not synchronise, allocates nothing and returns the
// CUDA error code of the launch, 0 on success.

#include "lm_common.cuh"

namespace {

constexpr int NW = 4;                     // warps per block
constexpr int CH = 4;                     // rows a lane group loads a tile
constexpr int MAX_HEADS_PER_BLOCK = 4;    // query heads a block serves
constexpr int MAX_SPLITS = 128;           // splits of the sequence
constexpr int MERGE_THREADS = 128;

// The least power of two >= n (n >= 1).
__host__ __device__ constexpr int pow2_at_least(int n) {
    return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// Query heads a block serves for G = H / KV: 1, 2, else 4 (a third or
// fourth head of a block past G is idle).
__host__ __device__ constexpr int heads_per_block(int G) {
    return G <= 2 ? G : MAX_HEADS_PER_BLOCK;
}

// Rows j0, j0 + NLG, ..., j0 + (CH - 1) NLG of K and V, 16 bytes of each
// from this lane, all loads issued before any is used; rows at or past end
// read as zeros, and so does every row on a lane past the row's end
// (`active` false), which loads nothing.
template <int NLG, class KT>
__device__ __forceinline__ void load_tile(const KT* kb, const KT* vb,
                                          long long stride, int j0, int end,
                                          bool active, uint4 (&kr)[CH],
                                          uint4 (&vr)[CH]) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
        const int j = j0 + c * NLG;
        if (active && j < end) {
            kr[c] = __ldg(reinterpret_cast<const uint4*>(kb + j * stride));
            vr[c] = __ldg(reinterpret_cast<const uint4*>(vb + j * stride));
        } else {
            kr[c] = vr[c] = make_uint4(0u, 0u, 0u, 0u);
        }
    }
}

template <class QT, class KT, int HD, int GB>
__global__ void __launch_bounds__(NW * 32)
decode_split_kernel(const QT* __restrict__ q, const KT* __restrict__ kc,
                    const KT* __restrict__ vc, QT* __restrict__ o,
                    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                    const int* __restrict__ kv_len_dev, int kv_len_arg,
                    int Smax, int H, int KV, int n_split, int rows_per_split,
                    int window, float scale) {
    using V = lm::Vec16<KT>;
    constexpr int VEC = V::N;             // elements a 16-byte load
    constexpr int LOADS = HD / VEC;       // 16-byte loads a row
    constexpr int L = pow2_at_least(LOADS);   // lanes a row
    constexpr int RPW = 32 / L;           // rows a warp reads at once
    constexpr int NLG = NW * RPW;         // lane groups a block
    constexpr int TILE = NLG * CH;        // rows a block reads a tile
    static_assert(L >= 1 && L <= 32 && LOADS * VEC == HD, "hd");
    __shared__ float s_m[NW][GB], s_l[NW][GB], s_acc[NW][GB][HD];

    // kv_len's read goes out first; nothing waits for its value until the
    // q loads (and, without a window, the first tile's) are issued too.
    const int kv_raw = kv_len_dev ? __ldg(kv_len_dev) : kv_len_arg;
    const int split = blockIdx.x;
    const int G = H / KV;
    const int n_hg = (G + GB - 1) / GB;
    const int kvh = blockIdx.y / n_hg;
    const int g0 = (blockIdx.y % n_hg) * GB;    // first head of the group
    const int b = blockIdx.z;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int lg = warp * RPW + lane / L;       // this lane's group
    const int d0 = (lane % L) * VEC;            // its elements of a row
    // false on the lanes past the row's end (hd not a power-of-two number
    // of loads): they load nothing and keep zeros
    const bool active = L == LOADS || d0 < HD;
    const int row_begin = split * rows_per_split;
    const int row_end = min(Smax, row_begin + rows_per_split);
    const long long stride = (long long)KV * HD;
    const KT* kb = kc + ((long long)b * Smax * KV + kvh) * HD + d0;
    const KT* vb = vc + ((long long)b * Smax * KV + kvh) * HD + d0;
    const long long bh0 = (long long)b * H + (long long)kvh * G + g0;

    float qv[GB][VEC];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qv[g][e] = 0.f;
        if (active && g0 + g < G)
            lm::load_vec<QT, VEC>(q + (bh0 + g) * HD + d0, qv[g]);
    }
    // Without a window the first tile starts at row_begin whatever kv_len
    // is: its loads are guarded by the split's end, not by kv_len.
    uint4 kr[CH], vr[CH];
    if (window <= 0)
        load_tile<NLG>(kb, vb, stride, row_begin + lg, row_end, active,
                       kr, vr);

    const int kv_len = min(max(kv_raw, 1), Smax);
    const int lo = window > 0 ? max(max(0, kv_len - window), row_begin)
                              : row_begin;
    const int hi = min(kv_len, row_end);
    int base = lo;
    if (window > 0 && lo < hi)
        load_tile<NLG>(kb, vb, stride, lo + lg, hi, active, kr, vr);
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qv[g][e] *= scale;
    }

    if (lo >= hi) {             // no valid row in this split: neutral partial
        for (int i = threadIdx.x; i < GB * HD; i += NW * 32) {
            const int g = i / HD, d = i % HD;
            if (g0 + g >= G) continue;
            const long long p = (bh0 + g) * n_split + split;
            ws_acc[p * HD + d] = 0.f;
            if (d == 0) {
                ws_ml[2 * p] = lm::NEG_INF;
                ws_ml[2 * p + 1] = 0.f;
            }
        }
        return;
    }

    float m[GB], l[GB], acc[GB][VEC];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
        m[g] = lm::NEG_INF;
        l[g] = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
    }

    while (true) {
        bool ok[CH];
        float s[CH][GB];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            const int j = base + c * NLG + lg;
            ok[c] = j >= lo && j < hi;
            float kf[VEC];
            V::unpack(kr[c], kf);
#pragma unroll
            for (int g = 0; g < GB; ++g) {
                float dot = 0.f;
#pragma unroll
                for (int e = 0; e < VEC; ++e) dot += qv[g][e] * kf[e];
#pragma unroll
                for (int off = L / 2; off > 0; off >>= 1)
                    dot += __shfl_xor_sync(0xffffffffu, dot, off);
                s[c][g] = dot;
            }
        }
#pragma unroll
        for (int g = 0; g < GB; ++g) {
            float mx = lm::NEG_INF;
#pragma unroll
            for (int c = 0; c < CH; ++c)
                if (ok[c]) mx = fmaxf(mx, s[c][g]);
            const float m_new = fmaxf(m[g], mx);
            const float corr = expf(m[g] - m_new);
            float psum = 0.f;
#pragma unroll
            for (int c = 0; c < CH; ++c) {
                s[c][g] = ok[c] ? expf(s[c][g] - m_new) : 0.f;   // now p
                psum += s[c][g];
            }
            l[g] = l[g] * corr + psum;
            m[g] = m_new;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[g][e] *= corr;
        }
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            float vf[VEC];
            V::unpack(vr[c], vf);
#pragma unroll
            for (int g = 0; g < GB; ++g) {
#pragma unroll
                for (int e = 0; e < VEC; ++e) acc[g][e] += s[c][g] * vf[e];
            }
        }
        base += TILE;
        if (base >= hi) break;
        load_tile<NLG>(kb, vb, stride, base + lg, hi, active, kr, vr);
    }

    // The lane groups of a warp hold the same elements of different rows:
    // merge them by shuffles across groups (a + b == b + a, so every group
    // ends with the same bits).
#pragma unroll
    for (int off = L; off < 32; off <<= 1) {
#pragma unroll
        for (int g = 0; g < GB; ++g) {
            const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
            const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
            const float mm = fmaxf(m[g], mo);
            const float ws = expf(m[g] - mm), wo = expf(mo - mm);
            l[g] = l[g] * ws + lo_ * wo;
#pragma unroll
            for (int e = 0; e < VEC; ++e)
                acc[g][e] = acc[g][e] * ws +
                            __shfl_xor_sync(0xffffffffu, acc[g][e], off) * wo;
            m[g] = mm;
        }
    }
    if (lane < L) {
#pragma unroll
        for (int g = 0; g < GB; ++g) {
            if (lane == 0) {
                s_m[warp][g] = m[g];
                s_l[warp][g] = l[g];
            }
            if (active) {
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                    s_acc[warp][g][d0 + e] = acc[g][e];
            }
        }
    }
    __syncthreads();
    // Across the warps, in warp order; one thread an output element.
    for (int i = threadIdx.x; i < GB * HD; i += NW * 32) {
        const int g = i / HD, d = i % HD;
        if (g0 + g >= G) continue;
        float mm = s_m[0][g];
#pragma unroll
        for (int w = 1; w < NW; ++w) mm = fmaxf(mm, s_m[w][g]);
        float ll = 0.f, a = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
            const float wt = expf(s_m[w][g] - mm);
            ll += s_l[w][g] * wt;
            a += s_acc[w][g][d] * wt;
        }
        if (n_split == 1) {
            o[(bh0 + g) * HD + d] = lm::from_f32<QT>(a / fmaxf(ll, 1e-30f));
        } else {
            const long long p = (bh0 + g) * n_split + split;
            ws_acc[p * HD + d] = a;
            if (d == 0) {
                ws_ml[2 * p] = mm;
                ws_ml[2 * p + 1] = ll;
            }
        }
    }
}

// The splits of one (b, h), combined in split order: m = max m_s, weights
// exp(m_s - m), out = sum acc_s w_s / max(sum l_s w_s, 1e-30).
template <class QT>
__global__ void __launch_bounds__(MERGE_THREADS)
decode_merge_kernel(const float* __restrict__ ws_acc,
                    const float* __restrict__ ws_ml, QT* __restrict__ o,
                    int HD, int n_split) {
    __shared__ float w[MAX_SPLITS];
    const long long bh = blockIdx.x;
    const float* ml = ws_ml + bh * n_split * 2;
    float mm = lm::NEG_INF;
    for (int s = 0; s < n_split; ++s) mm = fmaxf(mm, ml[2 * s]);
    for (int s = threadIdx.x; s < n_split; s += MERGE_THREADS)
        w[s] = expf(ml[2 * s] - mm);
    __syncthreads();
    float ll = 0.f;
    for (int s = 0; s < n_split; ++s) ll += ml[2 * s + 1] * w[s];
    const float den = fmaxf(ll, 1e-30f);
    for (int d = threadIdx.x; d < HD; d += MERGE_THREADS) {
        float a = 0.f;
        for (int s = 0; s < n_split; ++s)
            a += ws_acc[(bh * n_split + s) * HD + d] * w[s];
        o[bh * HD + d] = lm::from_f32<QT>(a / den);
    }
}

struct Args {
    const void *q, *k, *v;
    void *o, *ws;
    const int* kv_len_dev;
    int B, Smax, H, KV, hd, kv_len, n_split, rows_per_split, window;
    float scale;
    cudaStream_t stream;
};

template <class QT, class KT, int HD, int GB>
int launch(const Args& a) {
    const int n_hg = (a.H / a.KV + GB - 1) / GB;
    float* ws_acc = static_cast<float*>(a.ws);
    float* ws_ml = ws_acc ? ws_acc + (long long)a.B * a.H * a.n_split * HD
                          : nullptr;
    decode_split_kernel<QT, KT, HD, GB>
        <<<dim3(a.n_split, a.KV * n_hg, a.B), NW * 32, 0, a.stream>>>(
            static_cast<const QT*>(a.q), static_cast<const KT*>(a.k),
            static_cast<const KT*>(a.v), static_cast<QT*>(a.o), ws_acc,
            ws_ml, a.kv_len_dev, a.kv_len, a.Smax, a.H, a.KV, a.n_split,
            a.rows_per_split, a.window, a.scale);
    int err = (int)cudaGetLastError();
    if (err != 0 || a.n_split == 1) return err;
    decode_merge_kernel<QT><<<a.B * a.H, MERGE_THREADS, 0, a.stream>>>(
        ws_acc, ws_ml, static_cast<QT*>(a.o), HD, a.n_split);
    return (int)cudaGetLastError();
}

template <class QT, class KT, int HD>
int launch_gb(const Args& a) {
    switch (heads_per_block(a.H / a.KV)) {
        case 1: return launch<QT, KT, HD, 1>(a);
        case 2: return launch<QT, KT, HD, 2>(a);
        default: return launch<QT, KT, HD, MAX_HEADS_PER_BLOCK>(a);
    }
}

template <class QT, class KT>
int launch_hd(const Args& a) {
    switch (a.hd) {
        case 16: return launch_gb<QT, KT, 16>(a);
        case 32: return launch_gb<QT, KT, 32>(a);
        case 64: return launch_gb<QT, KT, 64>(a);
        case 96: return launch_gb<QT, KT, 96>(a);
        case 128: return launch_gb<QT, KT, 128>(a);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <class QT>
int launch_kv(int kv_dtype, const Args& a) {
    switch (kv_dtype) {
        case lm::F32: return launch_hd<QT, float>(a);
        case lm::BF16: return launch_hd<QT, __nv_bfloat16>(a);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// hd must be 16, 32, 64, 96 or 128. kv_len_dev: an int32 in device memory,
// read by the kernel and clamped to [1, Smax]; if it is null, kv_len is used
// and must lie in [1, Smax]. The sequence is cut into n_split (1 ...
// MAX_SPLITS) splits of rows_per_split rows, which must cover Smax with no
// split empty; with n_split > 1, ws is a float32 workspace of
// B * H * n_split * (hd + 2) elements. q_dtype is also the output's. Else
// cudaErrorInvalidValue.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* o, void* ws, const void* kv_len_dev, int B,
                            int Smax, int H, int KV, int hd, int kv_len,
                            int n_split, int rows_per_split, int window,
                            float scale, int q_dtype, int kv_dtype,
                            void* stream) {
    if (B <= 0 || B > 65535 || Smax <= 0 || H <= 0 || KV <= 0 ||
        H % KV != 0 || n_split < 1 || n_split > MAX_SPLITS ||
        rows_per_split < 1 || (long long)n_split * rows_per_split < Smax ||
        (long long)(n_split - 1) * rows_per_split >= Smax ||
        (n_split > 1 && ws == nullptr) ||
        (kv_len_dev == nullptr && (kv_len < 1 || kv_len > Smax)))
        return (int)cudaErrorInvalidValue;
    const Args a{q, k, v, o, ws, static_cast<const int*>(kv_len_dev), B,
                 Smax, H, KV, hd, kv_len, n_split, rows_per_split, window,
                 scale, static_cast<cudaStream_t>(stream)};
    switch (q_dtype) {
        case lm::F32: return launch_kv<float>(kv_dtype, a);
        case lm::BF16: return launch_kv<__nv_bfloat16>(kv_dtype, a);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* decode_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
