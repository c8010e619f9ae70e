// Fused RMSNorm for NVIDIA Hopper (sm_90a):
//   out = x * (1 / sqrt(mean(x^2) + eps)) * scale,
// statistics in float32, the result cast back to the storage type.
//
// Replaces the Pallas kernel `_kernel` / `rms_norm` of
// src/repro/kernels/rmsnorm.py (its `pallas_call` at line 36), which is the
// function `rms_norm` of src/repro/models/layers.py:16. Its plain version is
// `rms_norm_ref` in repro_torch/kernels/rmsnorm.py.
//
// What bounds it: bytes. A row of D values is read, reduced and written with
// about 4 operations per element, far below the card's ~295 operations per
// byte, so its least time is (read x + read scale + write out) / 3.35 TB/s.
// A decode step's few rows (24 x 2048) are bound by latency instead: one
// round trip to memory and a reduction.
//
// Design for that, for the row widths D of REG_WIDTHS (the powers of two
// 128 ... 4096, and the widths of the served models that are not: 1280,
// Whisper's; 3072, phi3-mini's; 8192, InternVL's): the row lives in
// registers. TPR threads share a row (a template parameter, a power of two
// from 16 to 256 that divides the row's NVEC 16-byte vectors), each holding
// NV = NVEC / TPR of them (1 to 8; VEC = 8 bfloat16 or 4 float32 a vector):
// thread j of the row holds vectors j, j + TPR, ..., so each load and store
// instruction of a warp covers contiguous 16-byte pieces. x is read from
// device memory once, all NV loads issued before the first use; the sum of
// squares is a float32 shuffle reduction over the row's threads (through
// shared memory when a row spans warps); the output is written with 16-byte
// stores. Each thread loads its NV vectors of `scale` once and reuses them
// across the rows of a grid-stride loop over groups of 256 / TPR rows, on a
// grid of as many blocks as fit on the card at once. The launcher picks TPR
// (threads_per_row below): one warp a row (more for the widest rows, so
// that NV <= 8) when there are rows enough to fill the SMs, else as many
// threads a row as divide the row, up to a block. D = 128 in bfloat16 is
// 16 vectors: two rows a warp, no lane idle. A row of 160 vectors (1280 in
// bfloat16) has 32 as its largest power-of-two divisor: one warp, NV = 5;
// 384 (3072 in bfloat16) takes 64 threads (NV = 6) or 128 (NV = 3).
//
// Any other D (and every D that is not a multiple of 16 bytes) takes the
// generic kernel: one warp a row, two passes over the row, scalar accesses
// where D is not a multiple of 8 elements.
//
// The reciprocal square root is 1.0f / sqrtf(...), both IEEE (nvcc's default
// -prec-div/-prec-sqrt), not rsqrtf: the reference is held to 1e-6 in
// float32. The output is rounded once, to nearest even.
//
// Plain C interface (loaded with ctypes): the launcher takes the stream,
// launches on it, does not synchronise, allocates nothing and returns the
// CUDA error code of the launch, 0 on success.

#include <type_traits>

#include "lm_common.cuh"

namespace {

constexpr int BLOCK = 256;   // threads a block, both kernels

// The row in registers: TPR threads a row, NV 16-byte vectors a thread.
template <class T, int D, int TPR>
__global__ void __launch_bounds__(BLOCK)
rmsnorm_regs_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                    T* __restrict__ out, long long rows, float eps) {
    using V = lm::Vec16<T>;
    constexpr int NV = D / V::N / TPR;
    constexpr int RPB = BLOCK / TPR;        // rows a block
    constexpr int WPR = TPR / 32;           // warps a row, when TPR > 32
    static_assert(NV >= 1 && NV * V::N * TPR == D, "D, TPR");
    __shared__ float red[BLOCK / 32];
    const int lt = threadIdx.x % TPR, rb = threadIdx.x / TPR;

    uint4 sv[NV];
    const uint4* s4 = reinterpret_cast<const uint4*>(scale);
#pragma unroll
    for (int i = 0; i < NV; ++i) sv[i] = s4[i * TPR + lt];

    const long long groups = (rows + RPB - 1) / RPB;
    for (long long gi = blockIdx.x; gi < groups; gi += gridDim.x) {
        const long long row = gi * RPB + rb;
        const bool ok = row < rows;
        const uint4* x4 = reinterpret_cast<const uint4*>(x + row * D);
        uint4 xv[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i)
            xv[i] = ok ? x4[i * TPR + lt] : make_uint4(0u, 0u, 0u, 0u);
        float ss = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            float f[V::N];
            V::unpack(xv[i], f);
#pragma unroll
            for (int e = 0; e < V::N; ++e) ss += f[e] * f[e];
        }
        if constexpr (TPR <= 32) {
#pragma unroll
            for (int off = TPR / 2; off > 0; off >>= 1)
                ss += __shfl_xor_sync(0xffffffffu, ss, off);
        } else {
            ss = lm::warp_sum(ss);
            if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = ss;
            __syncthreads();
            ss = 0.f;
#pragma unroll
            for (int w = 0; w < WPR; ++w) ss += red[rb * WPR + w];
            __syncthreads();        // red is written again next group
        }
        const float inv = 1.0f / sqrtf(ss / (float)D + eps);
        if (ok) {
            uint4* o4 = reinterpret_cast<uint4*>(out + row * D);
#pragma unroll
            for (int i = 0; i < NV; ++i) {
                float f[V::N], s[V::N];
                V::unpack(xv[i], f);
                V::unpack(sv[i], s);
#pragma unroll
                for (int e = 0; e < V::N; ++e) f[e] = (f[e] * inv) * s[e];
                o4[i * TPR + lt] = V::pack(f);
            }
        }
    }
}

// Any other D: one warp a row, eight rows a block, two passes over the row.
constexpr int VEC = 8;       // contiguous elements a lane handles per step

template <class T>
__global__ void __launch_bounds__(BLOCK)
rmsnorm_generic_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                       T* __restrict__ out, long long rows, int D, float eps) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * (BLOCK / 32) + warp;
    if (row >= rows) return;
    const T* xr = x + row * D;
    T* orow = out + row * D;
    const bool vec = (D % VEC) == 0;

    float ss = 0.f;
    if (vec) {
        for (int i = lane * VEC; i < D; i += 32 * VEC) {
            float v[VEC];
            lm::load_vec<T, VEC>(xr + i, v);
#pragma unroll
            for (int e = 0; e < VEC; ++e) ss += v[e] * v[e];
        }
    } else {
        for (int i = lane; i < D; i += 32) {
            const float v = lm::to_f32(xr[i]);
            ss += v * v;
        }
    }
    ss = lm::warp_sum(ss);
    const float inv = 1.0f / sqrtf(ss / (float)D + eps);

    if (vec) {
        for (int i = lane * VEC; i < D; i += 32 * VEC) {
            float v[VEC], s[VEC];
            lm::load_vec<T, VEC>(xr + i, v);
            lm::load_vec<T, VEC>(scale + i, s);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
                orow[i + e] = lm::from_f32<T>((v[e] * inv) * s[e]);
        }
    } else {
        for (int i = lane; i < D; i += 32)
            orow[i] = lm::from_f32<T>((lm::to_f32(xr[i]) * inv)
                                      * lm::to_f32(scale[i]));
    }
}

template <class T>
int launch_generic(const void* x, const void* scale, void* out,
                   long long rows, int D, float eps, cudaStream_t stream) {
    const long long blocks = (rows + BLOCK / 32 - 1) / (BLOCK / 32);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    rmsnorm_generic_kernel<T><<<(unsigned)blocks, BLOCK, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale),
        static_cast<T*>(out), rows, D, eps);
    return (int)cudaGetLastError();
}

// The card's SM count, read once.
int sm_count() {
    static const int n = [] {
        int dev = 0, sms = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        return sms > 0 ? sms : 1;
    }();
    return n;
}

// The least power of two t >= from with n / t <= most (t <= cap).
constexpr int least_pow2(int from, int n, int most, int cap) {
    return (from >= cap || n <= from * most) ? from
                                             : least_pow2(2 * from, n, most,
                                                          cap);
}

// The largest power of two that divides n, at most cap.
constexpr int pow2_divisor(int n, int cap) {
    return (n % 2 || cap == 1) ? 1 : 2 * pow2_divisor(n / 2, cap / 2);
}

// The two thread counts a row of width D may take, both powers of two that
// divide the row's NVEC 16-byte vectors. FEW (for few rows): the largest
// such count up to a block, so each thread makes as few loads as the row
// allows. MANY: one warp a row, or as many warps as keep each thread at 8
// vectors or fewer (at most FEW); a row of fewer than 32 vectors, a thread
// a vector.
template <class T, int D> struct Width {
    static constexpr int NVEC = D * (int)sizeof(T) / 16;
    static_assert(NVEC * 16 == D * (int)sizeof(T), "D");
    static constexpr int FEW = pow2_divisor(NVEC, BLOCK);
    static constexpr int MANY =
        NVEC < 32 ? NVEC : least_pow2(32, NVEC, 8, FEW);
    static_assert(NVEC % FEW == 0 && NVEC % MANY == 0 && MANY <= FEW
                  && (MANY <= 32 || MANY % 32 == 0), "threads a row");
    static_assert(NVEC / MANY <= 8, "vectors a thread");
};

// Threads a row: MANY, unless that leaves fewer blocks than the card has
// SMs; then FEW.
template <class T, int D>
int threads_per_row(long long rows) {
    using W = Width<T, D>;
    const long long blocks = (rows + BLOCK / W::MANY - 1) / (BLOCK / W::MANY);
    return blocks < sm_count() ? W::FEW : W::MANY;
}

template <class T, int D, int TPR>
int launch_regs(const void* x, const void* scale, void* out, long long rows,
                float eps, cudaStream_t stream) {
    // as many blocks as are resident on the card at once
    static const long long resident = [] {
        int per_sm = 0;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, rmsnorm_regs_kernel<T, D, TPR>, BLOCK, 0);
        return (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
    }();
    const long long groups = (rows + BLOCK / TPR - 1) / (BLOCK / TPR);
    const long long blocks = groups < resident ? groups : resident;
    rmsnorm_regs_kernel<T, D, TPR><<<(unsigned)blocks, BLOCK, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale),
        static_cast<T*>(out), rows, eps);
    return (int)cudaGetLastError();
}

template <class T, int D>
int launch_width(const void* x, const void* scale, void* out, long long rows,
                 float eps, cudaStream_t s) {
    using W = Width<T, D>;
    if (threads_per_row<T, D>(rows) == W::FEW)
        return launch_regs<T, D, W::FEW>(x, scale, out, rows, eps, s);
    return launch_regs<T, D, W::MANY>(x, scale, out, rows, eps, s);
}

// f(std::integral_constant<int, D>) for D one of the register widths (the
// wrapper's REG_WIDTHS), else other().
template <class F, class G>
int with_width(int D, F f, G other) {
    switch (D) {
        case 128: return f(std::integral_constant<int, 128>{});
        case 256: return f(std::integral_constant<int, 256>{});
        case 512: return f(std::integral_constant<int, 512>{});
        case 1024: return f(std::integral_constant<int, 1024>{});
        case 1280: return f(std::integral_constant<int, 1280>{});
        case 2048: return f(std::integral_constant<int, 2048>{});
        case 3072: return f(std::integral_constant<int, 3072>{});
        case 4096: return f(std::integral_constant<int, 4096>{});
        case 8192: return f(std::integral_constant<int, 8192>{});
        default: return other();
    }
}

template <class T>
int launch(const void* x, const void* scale, void* out, long long rows, int D,
           float eps, cudaStream_t s) {
    return with_width(
        D,
        [&](auto w) {
            return launch_width<T, decltype(w)::value>(x, scale, out, rows,
                                                       eps, s);
        },
        [&] { return launch_generic<T>(x, scale, out, rows, D, eps, s); });
}

template <class T>
int tpr_of(long long rows, int D) {
    return with_width(
        D, [&](auto w) { return threads_per_row<T, decltype(w)::value>(rows); },
        [] { return 0; });
}

}  // namespace

extern "C" {

// x, out: [rows, D] contiguous; scale: [D]; all of one dtype (lm::DType);
// 16-byte aligned. D one of 128, 256, ..., 4096, 1280, 3072 and 8192 takes
// the register kernel, any other D the generic one.
int rmsnorm_launch(const void* x, const void* scale, void* out,
                   long long rows, int D, float eps, int dtype, void* stream) {
    if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case lm::F32: return launch<float>(x, scale, out, rows, D, eps, s);
        case lm::BF16:
            return launch<__nv_bfloat16>(x, scale, out, rows, D, eps, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The threads a row that rmsnorm_launch gives (rows, D) of dtype on the
// current device: 0 for the generic kernel, -1 for an unknown dtype.
int rmsnorm_threads_per_row(long long rows, int D, int dtype) {
    switch (dtype) {
        case lm::F32: return tpr_of<float>(rows, D);
        case lm::BF16: return tpr_of<__nv_bfloat16>(rows, D);
        default: return -1;
    }
}

const char* rmsnorm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
