// Helpers shared by the language-model kernels (rmsnorm.cu,
// flash_attention.cu, decode_attention.cu): element types, conversions to and
// from float32, vector loads, 16-byte packs, warp sums.
//
// Every kernel computes in float32 whatever its storage type, as the Pallas
// kernels it replaces do; bfloat16 -> float32 is exact and float32 ->
// bfloat16 rounds to nearest even, as `astype` does in JAX.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lm {

// Element types across the C interface (the wrappers pass these codes).
enum DType : int { F32 = 0, BF16 = 1 };

// The finite masking value of the reference. Never -INFINITY: a wholly masked
// tile seen before any valid score then gives exp(-1e30 - -1e30) = 1 (garbage
// that the next valid tile's correction exp(-1e30 - m) = 0 wipes out), where
// -inf would give exp(-inf + inf) = NaN.
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <class T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// out[0..E) = p[0..E) as float32, with 16-byte loads where the E elements
// fill one or more of them, else one 8-byte load where they fill one (the
// caller guarantees that alignment).
template <class T, int E>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[E]) {
    if constexpr (sizeof(T) * E % 16 == 0) {
        constexpr int P = 16 / sizeof(T);        // elements per 16 bytes
#pragma unroll
        for (int c = 0; c < E / P; ++c) {
            const uint4 u = reinterpret_cast<const uint4*>(p)[c];
            const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
            for (int e = 0; e < P; ++e) out[c * P + e] = to_f32(t[e]);
        }
    } else if constexpr (sizeof(T) * E == 8) {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int e = 0; e < E; ++e) out[e] = to_f32(t[e]);
    } else {
#pragma unroll
        for (int e = 0; e < E; ++e) out[e] = to_f32(p[e]);
    }
}

// 16 bytes of T as float32 and back (round to nearest even).
template <class T> struct Vec16;
template <> struct Vec16<float> {
    static constexpr int N = 4;
    __device__ static void unpack(const uint4& u, float (&f)[4]) {
        f[0] = __uint_as_float(u.x);
        f[1] = __uint_as_float(u.y);
        f[2] = __uint_as_float(u.z);
        f[3] = __uint_as_float(u.w);
    }
    __device__ static uint4 pack(const float (&f)[4]) {
        return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                          __float_as_uint(f[2]), __float_as_uint(f[3]));
    }
};
template <> struct Vec16<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ static void unpack(const uint4& u, float (&f)[8]) {
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            f[2 * i] = __uint_as_float(w[i] << 16);          // low half first
            f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
    __device__ static uint4 pack(const float (&f)[8]) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
            w[i] = *reinterpret_cast<uint32_t*>(&b);
        }
        return make_uint4(w[0], w[1], w[2], w[3]);
    }
};

// The sum over the 32 lanes of a warp, in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

}  // namespace lm
