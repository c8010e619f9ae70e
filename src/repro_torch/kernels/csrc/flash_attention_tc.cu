// Flash attention on Hopper's tensor cores (sm_90a), bfloat16: causal or
// sliding-window grouped-query (GQA) attention with an online softmax and
// float32 statistics. The bfloat16 route of the wrapper; float32 keeps the
// CUDA-core kernel of flash_attention.cu.
//
// Replaces the Pallas kernel `_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py (its `pallas_call` at line 98), which
// computes `chunked_attention` of src/repro/models/attention.py (line 61).
// Its plain version is `flash_attention_ref` in
// repro_torch/kernels/flash_attention.py.
//
// Layout as in the reference: q [B, Sq, H, hd], k and v [B, Skv, KV, hd],
// out [B, Sq, H, hd], contiguous bfloat16. Query head h reads KV head
// h / (H / KV). Masks: kpos < Skv; causal kpos <= qpos; a window keeps
// kpos > qpos - window; qpos = q_offset + row. Masked scores are the finite
// -1e30 (lm_common.cuh); the output divides by max(l, 1e-30).
//
// What bounds it: operations. At the prefill shape (B = 4, S = 2048, 16/8
// heads of 128, causal) the two products do 4 * hd FLOPs for each of the
// 2.1e6 causal (q, k) pairs of a head, 68.7 GFLOP in all: 0.0695 ms at the
// 989 TFLOP/s of bf16 on the tensor cores, against 0.010 ms to read q, k, v
// and write out once at 3.35 TB/s (NVIDIA H100 80GB HBM3, 700 W).
//
// Design for that (the FlashAttention-3 shape):
// - A persistent grid: one block on each SM (its shared memory and registers
//   admit one) walks work items (q tile of 128 rows, batch, query head).
//   The items are ordered by q tile, counted down, so that the causal tiles
//   that walk the most kv tiles come first, and dealt in a snake (round r
//   forwards if r is even, backwards if odd) so that the SMs' loads even
//   out. q is double-buffered: the producer loads the next item's q, K and
//   V while the consumers finish the current one, whose start (q and the
//   first K in flight) and end (the stores) no longer leave the tensor
//   cores idle. Both the persistent grid (against a block per item) and
//   the snake (against plain rounds) made the prefill shape faster on the
//   card (PERF.md).
// - Two consumer warpgroups own 64 q rows each (wgmma M = 64); a producer
//   warpgroup, of which one thread issues every copy, gives its registers to
//   them with setmaxnreg: 168 a thread at launch (384 threads), then 24 for
//   the producer and 240 for each consumer (128 * 24 + 256 * 240 = 384 *
//   168; registers move between whole warpgroups, so a lone producer warp
//   could not free enough).
// - TMA copies q (two buffers, each with a "full" and an "empty" mbarrier)
//   and K, V tiles of 128 kv rows into a ring of two stages, each with a
//   "full" mbarrier for K, one for V, and an "empty" one that the 256
//   consumer threads arrive at when they are done with the stage; the ring
//   runs on across a block's work items. Each tensor map is 4-D over the
//   reference layout, dims (hd, heads, S, B), box (min(hd, 64), 1, 128, 1),
//   so the ragged edge past Sq or Skv is zero-filled by the hardware and
//   never reads the next sequence. A 64-column box is one 128-byte
//   swizzled row; hd = 128 loads as two boxes into two sub-tiles, hd = 32
//   and 16 take the 64- and 32-byte swizzles, and hd = 96 loads as three
//   32-column boxes (64-byte swizzle) into three sub-tiles: Q K^T walks
//   them in 6 k16 steps, and P V's B operand steps from one sub-tile to the
//   next by the descriptor's leading byte offset (m64n96k16, 48 float32
//   accumulators a thread). Every head dim (16, 32, 64, 96, 128) runs
//   here.
// - S = Q K^T: wgmma m64n128k16, both operands from shared memory, K's rows
//   (hd contiguous) the K-major B operand. The scale hd^-0.5 (times log2 e,
//   for ex2) is applied to the float32 scores, not to q: rounding q * scale
//   to bf16 would differ from the Pallas kernel, which scales in float32.
//   p = 2^(x - m) with ex2.approx.ftz.
// - The masks are applied only on tiles that straddle a boundary; tiles
//   wholly masked for every row of the q tile are never visited (as in
//   flash_attention.cu: such a tile is a no-op once a valid score was seen,
//   and its garbage is wiped when one is seen later).
// - O += P V: P is rounded to bf16 in registers and is the A operand straight
//   from the S accumulator's registers (their layouts coincide); V (hd
//   contiguous, N-major) is the B operand with the transpose bit. The row
//   sums l add the float32 p, before that rounding. The only rounding beyond
//   the Pallas kernel's is P's to bf16: about 2^-9 relative in each p.
// - wgmma.fence / commit_group / wait_group 0 separate the S product, the
//   softmax that reads its registers and the P V product that reads P from
//   registers. Within a warpgroup nothing overlaps the softmax; the two
//   warpgroups share the tensor cores as they come. Three schedules of
//   FlashAttention-3 were tried and dropped, each slower at the prefill
//   shape (PERF.md): tile j's S product issued before tile j - 1's
//   P V, to overlap the softmax within a warpgroup; ping-pong turns
//   between the warpgroups on blocks of "P V of tile j, S of tile j + 1" —
//   both hold S, O and P in in-flight products at once, and at hd = 128
//   ptxas then spills P to local memory at any split of registers; and
//   turns between the warpgroups on each product in this kernel's order.
// - Finish: divide by max(l, 1e-30), write bf16 pairs, masked on row < Sq.
// Shared memory at hd = 128: 2 x q 32 KiB + 2 stages x (K 32 + V 32 KiB).
//
// The tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint: the library links no -lcuda) and
// passed as __grid_constant__ parameters.
//
// Plain C interface (loaded with ctypes): the launcher takes the stream,
// launches on it, does not synchronise, allocates nothing and returns the
// CUDA error code of the launch, 0 on success (ENCODE_ERROR + the CUresult
// when a tensor map cannot be encoded).

#include <cuda.h>            // CUtensorMap and its enums; no driver library

#include "lm_common.cuh"

namespace {

constexpr int BQ = 128;                 // q rows per work item
constexpr int BK = 128;                 // kv rows per tile
constexpr int STAGES = 2;               // K/V ring
constexpr int Q_BUFS = 2;               // q tiles: the current and the next
constexpr int CONSUMERS = 256;          // two warpgroups of 64 q rows each
constexpr int NT = CONSUMERS + 128;     // and one producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ENCODE_ERROR = 100000;

// Shared-memory geometry for one head dim: a [rows, hd] tile is NCH
// sub-tiles of [rows, CH], each row of a sub-tile ROWB bytes and swizzled
// at that width (the TMA box and the wgmma descriptor agree on it).
template <int HD>
struct Geo {
    // hd 96 takes three 32-column sub-tiles at the 64-byte swizzle: a
    // 128-byte atom holds 64 columns, which 96 does not fill, and one
    // sub-tile of 96 columns (192 bytes) is no swizzle width at all
    static constexpr int CH = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : HD;
    static constexpr int NCH = HD / CH;
    static constexpr int ROWB = CH * 2;
    // wgmma descriptor layout: 1 = 128-byte swizzle, 2 = 64, 3 = 32
    static constexpr uint32_t LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
    static constexpr int SUB_Q = BQ * ROWB;
    static constexpr int SUB_KV = BK * ROWB;
    static constexpr int Q_BYTES = BQ * HD * 2;
    static constexpr int KV_BYTES = BK * HD * 2;     // one K or one V tile
    // + 1 KiB so that the base can be aligned to the 128-byte swizzle's
    // 1024-byte repeat
    static constexpr int SMEM =
        Q_BUFS * Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
};

// ---- PTX: shared addresses, mbarriers, TMA ---------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("{\n.reg .b64 state;\n"
                 "mbarrier.arrive.shared::cta.b64 state, [%0];\n}"
                 :: "r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of this parity. A wait that
// polls 2^26 times traps, so that a fault in the ring ends the launch with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    for (uint32_t spin = 0;; ++spin) {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (spin == (1u << 26)) __trap();
    }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// ---- PTX: wgmma -------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (in 16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
    return (uint64_t)((addr & 0x3FFFFu) >> 4)
           | (uint64_t)((lbo >> 4) & 0x3FFFu) << 16
           | (uint64_t)((sbo >> 4) & 0x3FFFu) << 32
           | (uint64_t)layout << 62;
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pin registers in place around an asynchronous wgmma: the compiler may not
// move their reads or writes across this point.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory;
// accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
}
// D[64 x N] += A[64 x 16] B[16 x N], A from registers (bf16 pairs), B
// N-major in shared memory (transpose bit set).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <> __device__ __forceinline__ void wgmma_rs<16>(
        float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<32>(
        float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<64>(
        float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<96>(
        float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<128>(
        float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ float ex2(float x) {     // 2^x, subnormals to 0
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo: low half
    return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the kernel -------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(NT, 1)
fa_tc_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             __nv_bfloat16* __restrict__ o, int B, int Sq, int Skv, int H,
             int KV, int q_offset, int causal, int window, float scale_log2) {
    using G = Geo<HD>;
    extern __shared__ uint8_t dsmem[];
    // per q buffer: full, empty; per K/V stage: K full, V full, empty
    __shared__ __align__(8) uint64_t bars[2 * Q_BUFS + 3 * STAGES];

    // Work item w -> (q tile, batch, head): the q tile is the slowest index,
    // counted down, so the heavy causal tiles come first. In round r the
    // blocks take items r * gridDim.x + [0, gridDim.x), block i the i-th of
    // them in even rounds and the i-th from the end in odd ones (a snake:
    // at the prefill shape the busiest SM gets 68 kv tiles against an
    // average of 65.9, where plain rounds would give it 72).
    const int nq = (Sq + BQ - 1) / BQ;
    const int n_work = nq * B * H;
    auto item = [&](int r) {
        return r * (int)gridDim.x
               + (r % 2 ? (int)gridDim.x - 1 - (int)blockIdx.x
                        : (int)blockIdx.x);
    };
    struct Tile { int q0, b, h, kv_lo, n; };
    auto tile_of = [&](int w) {
        Tile x;
        x.q0 = (nq - 1 - w / (B * H)) * BQ;
        x.b = w % (B * H) / H;
        x.h = w % H;
        // kv rows [kv_lo, kv_hi) hold every score that any row of the tile
        // keeps
        int kv_hi = Skv, kv_lo = 0;
        if (causal) {
            kv_hi = min(Skv, q_offset + x.q0 + BQ);
            if (window > 0) kv_lo = max(0, q_offset + x.q0 - window + 1);
        }
        x.kv_lo = (kv_lo / BK) * BK;
        x.n = kv_hi > x.kv_lo ? (kv_hi - x.kv_lo + BK - 1) / BK : 0;
        return x;
    };

    const uint32_t sQ = (smem_u32(dsmem) + 1023u) & ~1023u;  // buffer u at
    const uint32_t sK = sQ + Q_BUFS * G::Q_BYTES;    // + u * Q_BYTES; stage
    const uint32_t sV = sK + STAGES * G::KV_BYTES;   // s at + s * KV_BYTES
    auto full_q = [&](int u) { return smem_u32(&bars[u]); };
    auto empty_q = [&](int u) { return smem_u32(&bars[Q_BUFS + u]); };
    auto full_k = [&](int s) { return smem_u32(&bars[2 * Q_BUFS + s]); };
    auto full_v = [&](int s) {
        return smem_u32(&bars[2 * Q_BUFS + STAGES + s]);
    };
    auto empty = [&](int s) {
        return smem_u32(&bars[2 * Q_BUFS + 2 * STAGES + s]);
    };

    if (threadIdx.x == 0) {
        for (int u = 0; u < Q_BUFS; ++u) {
            mbar_init(full_q(u), 1);
            mbar_init(empty_q(u), CONSUMERS);
        }
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full_k(s), 1);
            mbar_init(full_v(s), 1);
            mbar_init(empty(s), CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= CONSUMERS) {
        // ---- producer warpgroup: one thread issues every copy ---------------
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
        if (threadIdx.x == CONSUMERS) {
            int g = 0;                    // kv tiles loaded: the ring position
            int local = 0;                // work items of this block so far
            for (int r = 0; r * (int)gridDim.x < n_work; ++r) {
                const int w = item(r);
                if (w >= n_work) continue;
                const Tile x = tile_of(w);
                const int kvh = x.h / (H / KV);
                const int u = local % Q_BUFS, quse = local / Q_BUFS;
                ++local;
                if (quse > 0) mbar_wait(empty_q(u), (quse - 1) & 1);
                mbar_expect_tx(full_q(u), G::Q_BYTES);
                for (int c = 0; c < G::NCH; ++c)
                    tma_load_4d(sQ + u * G::Q_BYTES + c * G::SUB_Q, &tq,
                                full_q(u), c * G::CH, x.h, x.q0, x.b);
                for (int it = 0; it < x.n; ++it, ++g) {
                    const int s = g % STAGES, use = g / STAGES;
                    if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
                    const int j0 = x.kv_lo + it * BK;
                    const uint32_t k_dst = sK + s * G::KV_BYTES;
                    const uint32_t v_dst = sV + s * G::KV_BYTES;
                    mbar_expect_tx(full_k(s), G::KV_BYTES);
                    for (int c = 0; c < G::NCH; ++c)
                        tma_load_4d(k_dst + c * G::SUB_KV, &tk, full_k(s),
                                    c * G::CH, kvh, j0, x.b);
                    mbar_expect_tx(full_v(s), G::KV_BYTES);
                    for (int c = 0; c < G::NCH; ++c)
                        tma_load_4d(v_dst + c * G::SUB_KV, &tv, full_v(s),
                                    c * G::CH, kvh, j0, x.b);
                }
            }
        }
    } else {
        // ---- two consumer warpgroups ----------------------------------------
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
        const int wg = threadIdx.x / 128, wi = (threadIdx.x / 32) % 4;
        const int lane = threadIdx.x % 32, g4 = lane / 4, t = lane % 4;
        // this thread's two rows of a q tile: r0 and r0 + 8
        const int r0 = 64 * wg + 16 * wi + g4;
        float acc[HD / 2];
        float sc[64];
        uint32_t pa[BK / 16][4];
        int g = 0;                        // kv tiles consumed: ring position
        int local = 0;
        for (int r = 0; r * (int)gridDim.x < n_work; ++r) {
            const int w = item(r);
            if (w >= n_work) continue;
            const Tile x = tile_of(w);
            const int q0 = x.q0;
            const int qpos0 = q_offset + q0 + r0, qpos1 = qpos0 + 8;
            const int u = local % Q_BUFS, quse = local / Q_BUFS;
            ++local;
            // the warpgroup's rows of this tile's q
            const uint32_t sQw = sQ + u * G::Q_BYTES + 64 * wg * G::ROWB;
#pragma unroll
            for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
            float m0 = lm::NEG_INF, m1 = lm::NEG_INF;     // in log2 units
            float l0 = 0.f, l1 = 0.f;                     // this thread's share

            mbar_wait(full_q(u), quse & 1);
            if (x.n == 0) mbar_arrive(empty_q(u));
            for (int it = 0; it < x.n; ++it, ++g) {
                const int s = g % STAGES;
                const uint32_t par = (g / STAGES) & 1;
                const int j0 = x.kv_lo + it * BK;
                const uint32_t sKs = sK + s * G::KV_BYTES;
                const uint32_t sVs = sV + s * G::KV_BYTES;

                // S = Q K^T over hd in steps of 16
                mbar_wait(full_k(s), par);
                pin(sc);
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < HD / 16; ++kk) {
                    const int c = kk * 16 / G::CH;
                    const uint32_t off = (kk * 16 % G::CH) * 2;   // bytes
                    wgmma_ss_n128(
                        sc,
                        make_desc(sQw + c * G::SUB_Q + off, 16, 8 * G::ROWB,
                                  G::LAYOUT),
                        make_desc(sKs + c * G::SUB_KV + off, 16, 8 * G::ROWB,
                                  G::LAYOUT),
                        kk > 0);
                }
                wg_commit();
                wg_wait_all();
                pin(sc);
                // the tile's last S product: q's buffer is free for the next
                if (it + 1 == x.n) mbar_arrive(empty_q(u));

                // scale, mask where the tile straddles a boundary
#pragma unroll
                for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
                const bool straddles =
                    j0 + BK > Skv
                    || (causal && j0 + BK - 1 > q_offset + q0)
                    || (window > 0 && j0 <= q_offset + q0 + BQ - 1 - window);
                if (straddles) {
#pragma unroll
                    for (int i = 0; i < 64; ++i) {
                        // accumulator i: row r0 + 8 * ((i / 2) % 2),
                        // column 8 * (i / 4) + 2 * t + i % 2
                        const int kpos = j0 + 8 * (i / 4) + 2 * t + (i % 2);
                        const int qpos = (i / 2) % 2 ? qpos1 : qpos0;
                        bool keep = kpos < Skv;
                        if (causal) keep = keep && kpos <= qpos;
                        if (window > 0) keep = keep && kpos > qpos - window;
                        if (!keep) sc[i] = lm::NEG_INF;
                    }
                }

                // online softmax: the row maxima over the quad that holds a
                // row
                float mx0 = lm::NEG_INF, mx1 = lm::NEG_INF;
#pragma unroll
                for (int i = 0; i < 64; i += 4) {
                    mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
                    mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
                }
#pragma unroll
                for (int off = 1; off <= 2; off <<= 1) {
                    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
                    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
                }
                const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
                const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
                m0 = mn0;
                m1 = mn1;
                float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        // pair j of the k16 slice: row r0 (j even) or r0 + 8
                        const int i = 8 * kk + 2 * j;
                        const float mr = (j % 2) ? mn1 : mn0;
                        const float p0 = ex2(sc[i] - mr);
                        const float p1 = ex2(sc[i + 1] - mr);
                        if (j % 2) ps1 += p0 + p1; else ps0 += p0 + p1;
                        pa[kk][j] = pack_bf16(p0, p1);
                    }
                }
                l0 = l0 * c0 + ps0;
                l1 = l1 * c1 + ps1;
#pragma unroll
                for (int i = 0; i < HD / 2; i += 4) {
                    acc[i] *= c0;
                    acc[i + 1] *= c0;
                    acc[i + 2] *= c1;
                    acc[i + 3] *= c1;
                }

                // O += P V over the tile's kv rows in steps of 16
                mbar_wait(full_v(s), par);
                pin(acc);
                pin(pa);
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk)
                    wgmma_rs<HD>(acc, pa[kk],
                                 make_desc(sVs + kk * 16 * G::ROWB, G::SUB_KV,
                                           8 * G::ROWB, G::LAYOUT));
                wg_commit();
                wg_wait_all();
                pin(acc);
                mbar_arrive(empty(s));
            }

            // the row sums over the quad, then out = acc / max(l, 1e-30)
#pragma unroll
            for (int off = 1; off <= 2; off <<= 1) {
                l0 += __shfl_xor_sync(0xffffffffu, l0, off);
                l1 += __shfl_xor_sync(0xffffffffu, l1, off);
            }
            const float inv0 = 1.f / fmaxf(l0, 1e-30f);
            const float inv1 = 1.f / fmaxf(l1, 1e-30f);
            const long long row_stride = (long long)H * HD;
            __nv_bfloat16* ob =
                o + ((long long)x.b * Sq * H + x.h) * HD + 2 * t;
            if (q0 + r0 < Sq) {
                __nv_bfloat16* orow = ob + (q0 + r0) * row_stride;
#pragma unroll
                for (int i = 0; i < HD / 2; i += 4)
                    *reinterpret_cast<uint32_t*>(orow + 2 * i) =
                        pack_bf16(acc[i] * inv0, acc[i + 1] * inv0);
            }
            if (q0 + r0 + 8 < Sq) {
                __nv_bfloat16* orow = ob + (q0 + r0 + 8) * row_stride;
#pragma unroll
                for (int i = 0; i < HD / 2; i += 4)
                    *reinterpret_cast<uint32_t*>(orow + 2 * i) =
                        pack_bf16(acc[i + 2] * inv1, acc[i + 3] * inv1);
            }
        }
    }
}

// ---- host: tensor maps and the launch ---------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// The 4-D map over [n, S, heads, hd] bf16 (dims innermost first), box
// (CH, 1, rows, 1), swizzled at the box's row width; 0 or ENCODE_ERROR + the
// CUresult.
int encode(CUtensorMap* map, const void* ptr, int n, int S, int heads, int hd,
           int ch, int rows) {
    EncodeTiled fn = encode_fn();
    if (fn == nullptr) return (int)cudaErrorInitializationError;
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                                (cuuint64_t)S, (cuuint64_t)n};
    const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                   (cuuint64_t)heads * hd * 2,
                                   (cuuint64_t)S * heads * hd * 2};
    const cuuint32_t box[4] = {(cuuint32_t)ch, 1, (cuuint32_t)rows, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle swz = ch * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : ch * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int H, int KV, int q_offset, int causal, int window,
           float scale, cudaStream_t stream) {
    using G = Geo<HD>;
    static cudaError_t attr = cudaFuncSetAttribute(
        fa_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G::SMEM);
    if (attr != cudaSuccess) return (int)attr;
    CUtensorMap mq, mk, mv;
    int err = encode(&mq, q, B, Sq, H, HD, G::CH, BQ);
    if (!err) err = encode(&mk, k, B, Skv, KV, HD, G::CH, BK);
    if (!err) err = encode(&mv, v, B, Skv, KV, HD, G::CH, BK);
    if (err) return err;
    // persistent: one block on each SM (the shared memory and the registers
    // admit one), each walking its work items
    static const int sms = [] {
        int dev = 0, n = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        return n > 0 ? n : 1;
    }();
    const long long work = (long long)((Sq + BQ - 1) / BQ) * B * H;
    if (work > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int grid = work < sms ? (int)work : sms;
    fa_tc_kernel<HD><<<grid, NT, G::SMEM, stream>>>(
        mq, mk, mv, static_cast<__nv_bfloat16*>(o), B, Sq, Skv, H, KV,
        q_offset, causal, window, scale * LOG2E);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bfloat16 q, k, v, out; hd must be 16, 32, 64, 96 or 128 (else
// cudaErrorInvalidValue).
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              void* o, int B, int Sq, int Skv, int H, int KV,
                              int hd, int q_offset, int causal, int window,
                              float scale, void* stream) {
    if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 16: return launch<16>(q, k, v, o, B, Sq, Skv, H, KV, q_offset,
                                   causal, window, scale, s);
        case 32: return launch<32>(q, k, v, o, B, Sq, Skv, H, KV, q_offset,
                                   causal, window, scale, s);
        case 64: return launch<64>(q, k, v, o, B, Sq, Skv, H, KV, q_offset,
                                   causal, window, scale, s);
        case 96: return launch<96>(q, k, v, o, B, Sq, Skv, H, KV, q_offset,
                                   causal, window, scale, s);
        case 128: return launch<128>(q, k, v, o, B, Sq, Skv, H, KV, q_offset,
                                     causal, window, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* flash_attention_tc_error_string(int err) {
    if (err >= ENCODE_ERROR) return "cuTensorMapEncodeTiled failed";
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
