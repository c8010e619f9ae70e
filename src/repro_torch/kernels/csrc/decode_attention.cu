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
// and, with a window, kpos >= kv_len - window; kv_len >= 1 is a launch
// argument, so the same library serves every step of a decode loop.
//
// What bounds it: bytes. Every valid cache row (k and v, hd values each) is
// read once per query head for 2 * hd FMAs: about 1 operation per byte in
// bfloat16, so the least time is the KV bytes / 3.35 TB/s.
//
// Design for that: one block of four warps per (head, sequence). The warps
// split the valid positions between them in chunks of eight consecutive rows
// (a split-K inside the block); a lane holds hd/32 contiguous elements of q,
// of a row and of its accumulator, so a row is one 8- or 16-byte load per
// lane and 256 contiguous bytes per warp, and a chunk keeps eight such loads
// in flight before the dot products (warp shuffle sums) need them. Each warp
// keeps its own online-softmax state (m, l, acc) in registers over only the
// valid rows — positions outside [max(0, kv_len - window), kv_len) are never
// read, which is exact: their weight exp(-1e30 - m) is 0 — and the four
// states are merged through shared memory at the end (m = max m_w, weights
// exp(m_w - m)), then divided by max(l, 1e-30). The G = H / KV query heads of
// a KV head each read it (from L2 after the first); reading it once for all
// G, or a split over many blocks with a merge kernel for long caches, is
// later work.
//
// Plain C interface (loaded with ctypes): the launcher takes the stream,
// launches on it, does not synchronise, allocates nothing and returns the
// CUDA error code of the launch, 0 on success.

#include "lm_common.cuh"

namespace {

constexpr int NW = 4;    // warps per block
constexpr int CH = 8;    // consecutive cache rows a warp takes per step

template <class QT, class KT, int HD>
__global__ void __launch_bounds__(NW * 32)
decode_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ kc,
                        const KT* __restrict__ vc, QT* __restrict__ o,
                        int Smax, int H, int KV, int kv_len, int window,
                        float scale) {
    constexpr int E = HD >= 32 ? HD / 32 : 1;   // elements per lane
    __shared__ float sm[NW], sl[NW], sacc[NW][HD];

    const int h = blockIdx.x, b = blockIdx.y;
    const int kvh = h / (H / KV);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int d0 = lane * E;
    const bool active = d0 < HD;
    const long long stride = (long long)KV * HD;
    const KT* kb = kc + ((long long)b * Smax * KV + kvh) * HD + d0;
    const KT* vb = vc + ((long long)b * Smax * KV + kvh) * HD + d0;

    float qv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) qv[e] = 0.f;
    if (active) {
        lm::load_vec<QT, E>(q + ((long long)b * H + h) * HD + d0, qv);
#pragma unroll
        for (int e = 0; e < E; ++e) qv[e] *= scale;
    }

    float m = lm::NEG_INF, l = 0.f, acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;

    const int lo = window > 0 ? max(0, kv_len - window) : 0;
    for (int j0 = lo + warp * CH; j0 < kv_len; j0 += NW * CH) {
        float kk[CH][E];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            if (active && j0 + c < kv_len) {
                lm::load_vec<KT, E>(kb + (j0 + c) * stride, kk[c]);
            } else {
#pragma unroll
                for (int e = 0; e < E; ++e) kk[c][e] = 0.f;
            }
        }
        float s[CH], mx = lm::NEG_INF;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) dot += qv[e] * kk[c][e];
            s[c] = lm::warp_sum(dot);
            if (j0 + c < kv_len) mx = fmaxf(mx, s[c]);
        }
        const float m_new = fmaxf(m, mx);
        const float corr = expf(m - m_new);
        float p[CH], psum = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            p[c] = j0 + c < kv_len ? expf(s[c] - m_new) : 0.f;
            psum += p[c];
        }
        l = l * corr + psum;
        m = m_new;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] *= corr;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            if (active && j0 + c < kv_len) {
                float vv[E];
                lm::load_vec<KT, E>(vb + (j0 + c) * stride, vv);
#pragma unroll
                for (int e = 0; e < E; ++e) acc[e] += p[c] * vv[e];
            }
        }
    }

    if (lane == 0) {
        sm[warp] = m;
        sl[warp] = l;
    }
    if (active) {
#pragma unroll
        for (int e = 0; e < E; ++e) sacc[warp][d0 + e] = acc[e];
    }
    __syncthreads();
    if (warp != 0) return;
    float M = sm[0];
#pragma unroll
    for (int w = 1; w < NW; ++w) M = fmaxf(M, sm[w]);
    float L = 0.f, wt[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
        wt[w] = expf(sm[w] - M);
        L += sl[w] * wt[w];
    }
    const float den = fmaxf(L, 1e-30f);
    if (active) {
        QT* orow = o + ((long long)b * H + h) * HD + d0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
            float a = 0.f;
#pragma unroll
            for (int w = 0; w < NW; ++w) a += sacc[w][d0 + e] * wt[w];
            orow[e] = lm::from_f32<QT>(a / den);
        }
    }
}

template <class QT, class KT, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Smax, int H, int KV, int kv_len, int window, float scale,
           cudaStream_t stream) {
    decode_attention_kernel<QT, KT, HD><<<dim3(H, B), NW * 32, 0, stream>>>(
        static_cast<const QT*>(q), static_cast<const KT*>(k),
        static_cast<const KT*>(v), static_cast<QT*>(o), Smax, H, KV, kv_len,
        window, scale);
    return (int)cudaGetLastError();
}

template <class QT, class KT>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int Smax, int H, int KV, int kv_len, int window,
              float scale, cudaStream_t s) {
    switch (hd) {
        case 16: return launch<QT, KT, 16>(q, k, v, o, B, Smax, H, KV, kv_len,
                                           window, scale, s);
        case 32: return launch<QT, KT, 32>(q, k, v, o, B, Smax, H, KV, kv_len,
                                           window, scale, s);
        case 64: return launch<QT, KT, 64>(q, k, v, o, B, Smax, H, KV, kv_len,
                                           window, scale, s);
        case 128: return launch<QT, KT, 128>(q, k, v, o, B, Smax, H, KV,
                                             kv_len, window, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <class QT>
int launch_kv(int kv_dtype, int hd, const void* q, const void* k,
              const void* v, void* o, int B, int Smax, int H, int KV,
              int kv_len, int window, float scale, cudaStream_t s) {
    switch (kv_dtype) {
        case lm::F32:
            return launch_hd<QT, float>(hd, q, k, v, o, B, Smax, H, KV,
                                        kv_len, window, scale, s);
        case lm::BF16:
            return launch_hd<QT, __nv_bfloat16>(hd, q, k, v, o, B, Smax, H,
                                                KV, kv_len, window, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// hd must be 16, 32, 64 or 128; 1 <= kv_len <= Smax (else
// cudaErrorInvalidValue). q_dtype is also the output's.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* o, int B, int Smax, int H, int KV, int hd,
                            int kv_len, int window, float scale, int q_dtype,
                            int kv_dtype, void* stream) {
    if (B <= 0 || B > 65535 || H <= 0 || KV <= 0 || H % KV != 0 ||
        kv_len < 1 || kv_len > Smax)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (q_dtype) {
        case lm::F32:
            return launch_kv<float>(kv_dtype, hd, q, k, v, o, B, Smax, H, KV,
                                    kv_len, window, scale, s);
        case lm::BF16:
            return launch_kv<__nv_bfloat16>(kv_dtype, hd, q, k, v, o, B, Smax,
                                            H, KV, kv_len, window, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* decode_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
