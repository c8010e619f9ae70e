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
//
// Design for that: one warp per row, eight rows per 256-thread block, so a
// grid of rows/8 blocks streams the rows through every SM with no shared
// memory and no block-wide barrier. Each lane reads a contiguous run of 8
// elements at a time (one 16-byte load for bfloat16, two for float32), so a
// warp reads 256 or 512 contiguous bytes per step; the sum of squares is a
// float32 warp shuffle reduction. The second pass reads the row again (from
// L1/L2, the row was just read) rather than holding D/32 values per lane in
// registers. The reciprocal square root is 1.0f / sqrtf(...), both IEEE
// (nvcc's default -prec-div/-prec-sqrt), not rsqrtf: the reference is held to
// 1e-6 in float32.
//
// Plain C interface (loaded with ctypes): the launcher takes the stream,
// launches on it, does not synchronise, allocates nothing and returns the
// CUDA error code of the launch, 0 on success.

#include "lm_common.cuh"

namespace {

constexpr int WARPS = 8;     // rows per block
constexpr int VEC = 8;       // contiguous elements a lane handles per step

template <class T>
__global__ void __launch_bounds__(WARPS * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, long long rows, int D, float eps) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * WARPS + warp;
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
int launch(const void* x, const void* scale, void* out, long long rows, int D,
           float eps, cudaStream_t stream) {
    const long long blocks = (rows + WARPS - 1) / WARPS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    rmsnorm_kernel<T><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale),
        static_cast<T*>(out), rows, D, eps);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: [rows, D] contiguous; scale: [D]; all of one dtype (lm::DType).
// Pointers must be 16-byte aligned when D is a multiple of 8.
int rmsnorm_launch(const void* x, const void* scale, void* out,
                   long long rows, int D, float eps, int dtype,
                   void* stream) {
    if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case lm::F32: return launch<float>(x, scale, out, rows, D, eps, s);
        case lm::BF16:
            return launch<__nv_bfloat16>(x, scale, out, rows, D, eps, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* rmsnorm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
