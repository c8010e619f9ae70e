// Flash attention for NVIDIA Hopper (sm_90a) on the CUDA cores, float32:
// causal or sliding-window, grouped-query (GQA) attention with an online
// softmax. The float32 route of the wrapper (the tests hold float32 to 2e-5,
// which TF32 or bf16 products on the tensor cores cannot meet); bfloat16
// takes the tensor-core kernel of flash_attention_tc.cu.
//
// Replaces the Pallas kernel `_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py (its `pallas_call` at line 98), which
// computes the function `chunked_attention` of src/repro/models/attention.py
// (line 61). Its plain version is `flash_attention_ref` in
// repro_torch/kernels/flash_attention.py.
//
// Layout as in the reference: q [B, Sq, H, hd], k and v [B, Skv, KV, hd],
// out [B, Sq, H, hd], all contiguous float32.
// Query head h reads KV head h / (H / KV), so consecutive query heads share
// a KV head (jnp.repeat), not h % KV. Masks: kpos < Skv; causal kpos <= qpos;
// a window keeps kpos > qpos - window; qpos = q_offset + row. Masked scores
// are the finite -1e30 (lm_common.cuh); the output divides by max(l, 1e-30).
// q is scaled in float32 inside the kernel, as the Pallas kernel does.
//
// What bounds it: operations. At the serving path's prefill (B = 4, S = 2048,
// 16 heads of 128) a head's q tile of 64 rows does 2 * 64 * 128 * 2 FLOPs for
// every kv row it reads, far above the ~20 (float32) or ~295 (bf16 tensor
// core) operations per byte at which the memory would bound it. This kernel
// does its products as float32 FMAs on the CUDA cores, so its ceiling is the
// 67 TFLOP/s of float32, not the tensor cores' 989: the route for float32
// operands, whose products must stay float32.
//
// Design for that: one block of 128 threads per (q tile of 64 rows, head,
// batch); two threads per query row, each holding half of the row's scores
// (even or odd kv columns) and half of its output accumulator in registers.
// The block walks the kv tiles of 32 rows that its q tile can see — causal
// and window bounds skip the tiles that are wholly masked for every row of
// the tile, which changes no result (a wholly masked tile is a no-op once a
// valid score was seen, and its garbage is wiped when one is seen later) —
// staging each K and V tile in shared memory as float32 (rows padded by one
// word, so the two threads of a pair and the 16 rows of a warp hit distinct
// banks). Per tile: scores from shared Q and K, the masked row maximum over
// the pair (one shuffle), the correction exp(m_prev - m_new), p = exp(s - m)
// written to shared memory, then acc = acc * corr + p V. Heavy q tiles (late
// in a causal sequence) are launched first. 72.75 KiB of shared memory a
// block at hd = 128: three blocks, twelve warps, per SM.
//
// Plain C interface (loaded with ctypes): the launcher takes the stream,
// launches on it, does not synchronise, allocates nothing and returns the
// CUDA error code of the launch, 0 on success.

#include "lm_common.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 32;       // kv rows per tile
constexpr int NT = 2 * BQ;   // threads: two per query row

// 4 floats by one 16-byte load (rows and head dims are multiples of 4)
__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

template <int HD>
constexpr int smem_floats() {
    return BQ * (HD + 1)      // Q, scaled
           + 2 * BK * (HD + 1) // K, V
           + BQ * (BK + 1);    // P
}

template <int HD>
__global__ void __launch_bounds__(NT, 3)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int Sq, int Skv, int H, int KV, int q_offset,
                       int causal, int window, float scale) {
    static_assert(HD % 4 == 0 && HD <= 128, "head_dim");
    constexpr int HP = HD + 1;
    constexpr int HALF = HD / 2;
    extern __shared__ float smem[];
    float* Qs = smem;
    float* Ks = Qs + BQ * HP;
    float* Vs = Ks + BK * HP;
    float* Ps = Vs + BK * HP;

    const int qt = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
    const int h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (H / KV);
    const int q0 = qt * BQ;
    const int tid = threadIdx.x, r = tid >> 1, half = tid & 1;
    const long long q_stride = (long long)H * HD;    // between positions
    const long long kv_stride = (long long)KV * HD;
    const float* qb = q + ((long long)b * Sq * H + h) * HD;
    const float* kb = k + ((long long)b * Skv * KV + kvh) * HD;
    const float* vb = v + ((long long)b * Skv * KV + kvh) * HD;

    for (int idx = tid * 4; idx < BQ * HD; idx += NT * 4) {
        const int rr = idx / HD, d = idx % HD;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q0 + rr < Sq) val = load4(qb + (q0 + rr) * q_stride + d);
        Qs[rr * HP + d] = val.x * scale;
        Qs[rr * HP + d + 1] = val.y * scale;
        Qs[rr * HP + d + 2] = val.z * scale;
        Qs[rr * HP + d + 3] = val.w * scale;
    }

    const int qpos = q_offset + q0 + r;
    // kv rows [kv_lo, kv_hi) hold every score that any row of this tile keeps
    int kv_hi = Skv, kv_lo = 0;
    if (causal) {
        kv_hi = min(Skv, max(0, q_offset + q0 + BQ));
        if (window > 0) kv_lo = max(0, q_offset + q0 - window + 1);
    }
    kv_lo = (kv_lo / BK) * BK;

    float acc[HALF];
#pragma unroll
    for (int i = 0; i < HALF; ++i) acc[i] = 0.f;
    float m = lm::NEG_INF, l = 0.f;

    for (int j0 = kv_lo; j0 < kv_hi; j0 += BK) {
        __syncthreads();   // the previous tile's K, V and P are read
        for (int idx = tid * 4; idx < BK * HD; idx += NT * 4) {
            const int rr = idx / HD, d = idx % HD;
            float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
            if (j0 + rr < Skv) {
                kv4 = load4(kb + (j0 + rr) * kv_stride + d);
                vv4 = load4(vb + (j0 + rr) * kv_stride + d);
            }
            float* kd = Ks + rr * HP + d;
            float* vd = Vs + rr * HP + d;
            kd[0] = kv4.x; kd[1] = kv4.y; kd[2] = kv4.z; kd[3] = kv4.w;
            vd[0] = vv4.x; vd[1] = vv4.y; vd[2] = vv4.z; vd[3] = vv4.w;
        }
        __syncthreads();

        float s[BK / 2];
#pragma unroll
        for (int jj = 0; jj < BK / 2; ++jj) s[jj] = 0.f;
        for (int d = 0; d < HD; ++d) {
            const float qd = Qs[r * HP + d];
#pragma unroll
            for (int jj = 0; jj < BK / 2; ++jj)
                s[jj] += qd * Ks[(2 * jj + half) * HP + d];
        }
        float mx = lm::NEG_INF;
#pragma unroll
        for (int jj = 0; jj < BK / 2; ++jj) {
            const int kpos = j0 + 2 * jj + half;
            bool keep = kpos < Skv;
            if (causal) keep = keep && kpos <= qpos;
            if (window > 0) keep = keep && kpos > qpos - window;
            s[jj] = keep ? s[jj] : lm::NEG_INF;
            mx = fmaxf(mx, s[jj]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        const float m_new = fmaxf(m, mx);
        const float corr = expf(m - m_new);
        float ps = 0.f;
#pragma unroll
        for (int jj = 0; jj < BK / 2; ++jj) {
            const float p = expf(s[jj] - m_new);
            ps += p;
            Ps[r * (BK + 1) + 2 * jj + half] = p;
        }
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        l = l * corr + ps;
        m = m_new;
        __syncwarp();      // the pair's P row is written (both in this warp)
#pragma unroll
        for (int i = 0; i < HALF; ++i) acc[i] *= corr;
        for (int j = 0; j < BK; ++j) {
            const float p = Ps[r * (BK + 1) + j];
#pragma unroll
            for (int i = 0; i < HALF; ++i)
                acc[i] += p * Vs[j * HP + 2 * i + half];
        }
    }

    if (q0 + r < Sq) {
        const float den = fmaxf(l, 1e-30f);
        float* orow =
            o + ((long long)b * Sq * H + h) * HD + (q0 + r) * q_stride;
#pragma unroll
        for (int i = 0; i < HALF; ++i) orow[2 * i + half] = acc[i] / den;
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int H, int KV, int q_offset, int causal, int window,
           float scale, cudaStream_t stream) {
    const int bytes = smem_floats<HD>() * (int)sizeof(float);
    static cudaError_t attr = cudaFuncSetAttribute(
        flash_attention_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((Sq + BQ - 1) / BQ, H, B);
    flash_attention_kernel<HD><<<grid, NT, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, KV,
        q_offset, causal, window, scale);
    return (int)cudaGetLastError();
}

int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int Sq, int Skv, int H, int KV, int q_offset, int causal,
              int window, float scale, cudaStream_t s) {
    switch (hd) {
        case 16: return launch<16>(q, k, v, o, B, Sq, Skv, H, KV, q_offset,
                                   causal, window, scale, s);
        case 32: return launch<32>(q, k, v, o, B, Sq, Skv, H, KV, q_offset,
                                   causal, window, scale, s);
        case 64: return launch<64>(q, k, v, o, B, Sq, Skv, H, KV, q_offset,
                                   causal, window, scale, s);
        case 96: return launch<96>(q, k, v, o, B, Sq, Skv, H, KV, q_offset,
                                   causal, window, scale, s);
        case 128: return launch<128>(q, k, v, o, B, Sq, Skv, H, KV,
                                     q_offset, causal, window, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// float32 q, k, v, out; hd must be 16, 32, 64, 96 or 128 (else
// cudaErrorInvalidValue).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Sq, int Skv, int H, int KV,
                           int hd, int q_offset, int causal, int window,
                           float scale, void* stream) {
    if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 ||
        H > 65535 || B > 65535)
        return (int)cudaErrorInvalidValue;
    return launch_hd(hd, q, k, v, o, B, Sq, Skv, H, KV, q_offset, causal,
                     window, scale, static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
