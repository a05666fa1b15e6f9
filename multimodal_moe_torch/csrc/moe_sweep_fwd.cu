// Fused MoE expert sweep forward for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's sweep (models/moe.py,
// moe_apply_sweep) is XLA's matmuls. Computes the same function as
// ops/moe_sweep.py:_sweep_plain, for one MoE level in bf16:
//   out[t] = x[t] + sum_e g[t, e] * (silu(x[t] . W1[e] + b1[e]) . W2[e] + b2[e])
// over all E experts and every token (dropless: every expert on every token,
// weighted by the renormalised top-k gates g, which are 0 for the experts a
// token did not select). Rounding points: x . W1[e] summed in fp32, b1, SiLU
// and the gate applied in fp32, the gated hidden value rounded once to bf16;
// its product with W2[e] summed in fp32 over the hidden units and the experts,
// on top of x + sum_e g b2[e] in fp32; the output rounded once to bf16.
//
// What bounds it on this card: a token costs 4*E*d*h flops (both products of
// every expert) against 4*d bytes in and out. At the MoE-YOLO-s widths (d =
// 128/256/512, h = 2d, E = 4) that is 2*E*h = 2048..8192 flops a byte, far
// above the H100's bf16 ridge (~295): the kernel is bound by operations (2.76
// TFLOP, 2.8 ms, for the three levels of a B = 128 serving step at 704x1248).
// The eager sweep it replaces writes and rereads the (E, T, h) hidden and the
// (E, T, d) expert outputs in device memory (~57 GB a step); here they never
// leave the SM.
//
// The design:
//   * One block owns a tile of kBM = 128 token rows and a block of DN output
//     columns, for all E experts, and walks tiles persistently (one block an
//     SM). Three warpgroups: two consumers of 64 rows each (wgmma, 232
//     registers a thread after setmaxnreg) and one producer (one thread
//     issuing TMA copies, 40 registers).
//   * The x tile (128 x d) arrives once a tile by TMA in 64-column slabs
//     swizzled 128B, and stays in shared memory for every expert and chunk.
//   * For each expert e and each chunk of HC hidden units:
//       GEMM1  hidden (64 x HC a warpgroup, fp32 registers) = x . W1[e][:, chunk]
//              with wgmma m64nHCk16 reading both operands from shared memory;
//       bias b1, SiLU (ex2/rcp approximations, relative error ~1e-6, far under
//              the bf16 rounding that follows), times the row's gate, rounded
//              to bf16 straight into wgmma A-operand registers (the
//              accumulator layout of m64nNk16 is the A layout of the next
//              product, so no shuffle and no shared memory);
//       GEMM2  acc (64 x DN, fp32 registers) += hidden . W2[e][chunk, cols]
//              with wgmma m64nDNk16, A from registers.
//     HC = 128 where DN <= 128 (level 0), else 64: acc, hidden and the A
//     fragments share the 232 registers. An m64n64 chain of wgmmas runs well
//     below the tensor cores' rate, so the wider chunk took level 0 from
//     3.22 to 2.76 ms (MoE-YOLO-s at B = 128 on an H100 SXM at 700 W).
//   * The two consumers take turns on the tensor cores (named barriers 1 and
//     2): a warpgroup issues GEMM2 of chunk q - 1 and GEMM1 of chunk q, passes
//     the turn, waits for its products, and applies bias, SiLU and gate (the
//     SFU's work) while the other's products run. Without the turns the three
//     levels took 8.03 ms against 7.11. Each commit group is straight-line
//     wgmmas after a fence, and no accumulator is touched until the wait:
//     otherwise ptxas serialises every wgmma (11.1 ms).
//   * The weights (all experts: at most 8 MB at d = 512, L2-resident) stream
//     through a ring of 32 KB stages, filled by TMA (W1 transposed to
//     (E, h, d) and W2 to (E, d, h) by the wrapper, so both B operands are
//     K-major) and handed over with mbarriers: full (TMA bytes landed) and
//     empty (the eight consumer warps are done reading). A warpgroup holds a
//     block's stages (one W2 stage, ceil(d / 256) W1 stages) until its wait,
//     so the ring must hold one block: d <= 512 (moe_sweep_stages).
//   * acc starts as x + sum_e g b2[e] (read from the x tile in shared memory),
//     so the epilogue only rounds and stores. Each output element is written by
//     one thread: no atomics, and results repeat bit for bit.
//   * DN = d for d <= 256. Wider levels split the columns into ceil(d / 256)
//     blocks of DN <= 256 that each recompute the hidden chunks (d = 512:
//     GEMM1 twice, 1.5x the flops), since a 64 x 512 fp32 accumulator would
//     need 256 registers a thread.
//   * Tokens past T (the last tile) are zeros from TMA's out-of-bounds fill
//     and are not stored; columns past d of the last column block are zeros
//     likewise and are not stored.

#include <cuda.h>  // CUtensorMap and its enums; libcuda itself is found with dlopen
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                 // token rows a block (two consumer warpgroups)
constexpr int kThreads = 384;            // warpgroups 0, 1 consume; 2 produces
constexpr int kConsumerWarps = 8;
constexpr int kSlab = 64;                // bf16 columns of a 128-byte swizzle row
constexpr int kXSlabBytes = kBM * 128;   // one 64-column slab of the x tile
constexpr int kW1Slabs = 4;              // W1 slabs a ring stage at 64 hidden units a chunk
constexpr int kStageBytes = 32768;
constexpr int kMaxStages = 8;
constexpr int kMaxK = 4;                 // top-k at most
constexpr int kMaxSmem = 232448;
constexpr int kAlign = 1024;             // 128B swizzle atoms are 1024-byte aligned
constexpr int kConsumerRegs = 232, kProducerRegs = 40;

// Ring stages for width d: as many as fit beside the x tile (moe_sweep_stages
// says whether they hold a block).
int stages_for(int d) {
  const int free_bytes = kMaxSmem - kAlign - 8 * (2 * kMaxStages + 2) - (d / kSlab) * kXSlabBytes;
  const int s = free_bytes / kStageBytes;
  return s < kMaxStages ? s : kMaxStages;
}

size_t smem_bytes(int d, int stages) {
  return (size_t)kAlign + (size_t)(d / kSlab) * kXSlabBytes + (size_t)stages * kStageBytes +
         8 * (2 * (size_t)stages + 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Spin until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA --------------------------------------------------------------------

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major operand in 128B-swizzled
// layout: rows of 128 bytes (64 bf16 of K), 8-row groups 1024 bytes apart
// (SBO), the leading offset unused (1). The k16 step kk starts 32*kk bytes in.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Turns of the two consumer warpgroups on the tensor cores: warpgroup w
// waits on named barrier 1 + w until the other has passed it the turn.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}
// Keeps the compiler from moving accesses of accumulator registers across a
// wgmma issue or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

// d (m64n64, fp32) = A (smem, 64 x 16) . B (smem, 64 x 16) + (scale_d ? d : 0), both
// K-major, 128B swizzle.
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (m64n128, fp32) = A (smem, 64 x 16) . B (smem, 128 x 16) + (scale_d ? d : 0).
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (m64n64, fp32) += A (registers, 64 x 16 bf16) . B (smem, 64 x 16, K-major, 128B swizzle).
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n128, fp32) += A (registers, 64 x 16 bf16) . B (smem, 128 x 16, K-major, 128B swizzle).
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n192, fp32) += A (registers, 64 x 16 bf16) . B (smem, 192 x 16, K-major, 128B swizzle).
template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n256, fp32) += A (registers, 64 x 16 bf16) . B (smem, 256 x 16, K-major, 128B swizzle).
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// ---- the kernel ---------------------------------------------------------------

// silu(v) = v / (1 + 2^(-v log2 e)) with the hardware's ex2 and rcp
// approximations (relative error ~1e-6, against bf16's 2^-8 that follows).
__device__ __forceinline__ float silu_approx(float v) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(v * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.0f + e));
  return v * r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The row's gate for expert e: its top-k gates summed where the index is e,
// in slot order (the scatter-add of models/moe.py:gate_matrix).
__device__ __forceinline__ float gate_of(const int (&id)[kMaxK], const float (&g)[kMaxK], int e) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) s += id[j] == e ? g[j] : 0.0f;
  return s;
}

// Byte offset of x[r, col] in the swizzled x tile: 64-column slabs of kBM
// rows, 128-byte rows whose 16-byte pieces are permuted by r % 8.
__device__ __forceinline__ uint32_t x_offset(int r, int col) {
  return (col / kSlab) * kXSlabBytes + r * 128 + ((((col % kSlab) >> 3) ^ (r & 7)) << 4) +
         (col & 7) * 2;
}

struct Params {
  const long long* idx;  // (T, k) expert indices
  const float* gates;    // (T, k) gates
  const bf16* b1;        // (E, h)
  const bf16* b2;        // (E, d)
  bf16* out;             // (T, d)
  int T, d, h, E, k;
  int nb;                // column blocks of DN
  int stages;            // ring stages
  int ntiles;            // ceil(T / kBM) * nb
};

// The weight ring as one consumer warpgroup walks it: full[s] completes when
// stage s's TMA bytes have landed, empty[s] when the eight consumer warps
// are done reading it.
struct Ring {
  uint32_t base, bars;
  int stages, stage;
  uint32_t phase;
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (stages + s); }
  // Waits for the next stage in ring order; returns its address.
  __device__ __forceinline__ uint32_t acquire() {
    mbar_wait(full(stage), phase);
    const uint32_t addr = base + stage * kStageBytes;
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
    return addr;
  }
};

// One warpgroup's block of tensor-core work, issued in its turn: GEMM2 of
// the previous chunk (acc += hidden . W2 tile, A from registers) if G2, then
// GEMM1 of this chunk (hacc = x . W1 chunk, over W1S stages) if G1; then the
// turn passes and the block is waited for. Each commit group is straight-line
// wgmmas after a fence, and no accumulator is touched until the wait:
// otherwise ptxas serialises every wgmma.
template <int DN, int W1S, int HC, bool G2, bool G1>
__device__ __forceinline__ void tensor_block(Ring& ring, float (&acc)[DN / 2], float (&hacc)[HC / 2],
                                             const uint32_t (&af)[HC / 16][4], uint32_t x_wg,
                                             int xslabs, int wg) {
  constexpr int kSlabs = kStageBytes / (HC * 128);  // W1 slabs a stage
  turn_wait(wg);
  fence_regs(acc);
  fence_regs(hacc);
  if (G2) {
    const uint32_t w_s = ring.acquire();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HC / 16; ++kk)  // 64 hidden units a slab of DN rows
      wgmma_rs<DN>(acc, af[kk], desc_sw128(w_s + (kk / 4) * DN * 128 + 32 * (kk % 4)));
    wgmma_commit();
  }
  if (G1) {
#pragma unroll
    for (int s1 = 0; s1 < W1S; ++s1) {
      const int slabs = min(kSlabs, xslabs - s1 * kSlabs);
      const uint32_t w_s = ring.acquire();
      const uint32_t xk = x_wg + s1 * kSlabs * kXSlabBytes;
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < kSlabs; ++sl) {
        if (sl < slabs) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)  // the chunk's first product overwrites hacc
            wgmma_ss<HC>(hacc, desc_sw128(xk + sl * kXSlabBytes + 32 * kk),
                         desc_sw128(w_s + sl * HC * 128 + 32 * kk), s1 + sl + kk > 0);
        }
      }
      wgmma_commit();
    }
  }
  turn_pass(wg);
  wgmma_wait0();
  fence_regs(hacc);
  fence_regs(acc);
}

// Accumulator layout of wgmma m64nNk16 (fp32), with g = lane / 4, t = lane % 4:
// d[4j], d[4j + 1] are row 16 * warp + g, columns 8j + 2t and 8j + 2t + 1;
// d[4j + 2], d[4j + 3] the same columns of row 16 * warp + g + 8. The A
// operand from registers (m64k16 bf16) takes a[0] = row g, k 2t..2t+1, a[1] =
// row g + 8, the same k, a[2], a[3] = k 8 + 2t.. of the same rows: the hidden
// accumulator's n8 blocks 2kk and 2kk + 1 are the A fragment of k16 step kk.
// HC hidden units a chunk (128 where DN <= 128, else 64: the registers of
// acc, hacc and the A fragments), W1S the W1 stages of a chunk.
template <int DN, int W1S, int HC>
__global__ void __launch_bounds__(kThreads, 1)
sweep_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w1,
             const __grid_constant__ CUtensorMap tm_w2, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s = smem_addr(smem_raw);
  const uint32_t x_s = (raw_s + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const unsigned char* x_ptr = smem_raw + (x_s - raw_s);
  const int xslabs = p.d / kSlab;
  Ring ring{x_s + xslabs * kXSlabBytes, 0, p.stages, 0, 0};
  ring.bars = ring.base + p.stages * kStageBytes;  // full[S], empty[S], x_full, x_empty
  const uint32_t x_full = ring.bars + 16 * p.stages, x_empty = x_full + 8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), kConsumerWarps);
    }
    mbar_init(x_full, 1);
    mbar_init(x_empty, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  constexpr int kSlabs = kStageBytes / (HC * 128);  // W1 slabs a stage
  const int nchunks = p.h / HC;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // Producer: one thread issues every copy, in the order the consumers
    // read them: the x tile, then for each expert and hidden chunk the W1
    // stages (up to 256 of d each) and the W2 stage.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0, xphase = 0;
      auto next = [&]() {
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      };
      for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
        const int rt = tile / p.nb, n0 = (tile - rt * p.nb) * DN;
        mbar_wait(x_empty, xphase ^ 1);
        xphase ^= 1;
        mbar_expect_tx(x_full, xslabs * kXSlabBytes);
        for (int s = 0; s < xslabs; ++s)
          tma_2d(x_s + s * kXSlabBytes, &tm_x, s * kSlab, rt * kBM, x_full);
        for (int e = 0; e < p.E; ++e) {
          for (int c = 0; c < nchunks; ++c) {
            for (int s1 = 0; s1 < W1S; ++s1) {
              const int slabs = min(kSlabs, xslabs - s1 * kSlabs);
              mbar_wait(ring.empty(stage), phase ^ 1);
              mbar_expect_tx(ring.full(stage), slabs * HC * 128);
              for (int sl = 0; sl < slabs; ++sl)
                tma_3d(ring.base + stage * kStageBytes + sl * HC * 128, &tm_w1,
                       (s1 * kSlabs + sl) * kSlab, c * HC, e, ring.full(stage));
              next();
            }
            mbar_wait(ring.empty(stage), phase ^ 1);
            mbar_expect_tx(ring.full(stage), HC / kSlab * DN * 128);
            for (int i = 0; i < HC / kSlab; ++i)
              tma_3d(ring.base + stage * kStageBytes + i * DN * 128, &tm_w2, c * HC + i * kSlab,
                     n0, e, ring.full(stage));
            next();
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns tile rows 64 * wg .. 64 * wg + 63; this
  // thread rows ra and ra + 8, columns n0 + 8j + 2t (+1).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int tw = threadIdx.x & 127, lane = tw & 31, t = lane & 3;
  const int ra = wg * 64 + (tw >> 5) * 16 + (lane >> 2);
  const uint32_t x_wg = x_s + wg * 64 * 128;
  uint32_t xphase = 0;
  float hacc[HC / 2];
  uint32_t af[HC / 16][4];
#pragma unroll
  for (int i = 0; i < HC / 2; ++i) hacc[i] = 0.0f;
  if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const int rt = tile / p.nb, n0 = (tile - rt * p.nb) * DN;
    const long long row_a = (long long)rt * kBM + ra, row_b = row_a + 8;
    int ia[kMaxK], ib[kMaxK];
    float pa[kMaxK], pb[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      const bool oka = j < p.k && row_a < p.T, okb = j < p.k && row_b < p.T;
      ia[j] = oka ? (int)p.idx[row_a * p.k + j] : -1;
      pa[j] = oka ? p.gates[row_a * p.k + j] : 0.0f;
      ib[j] = okb ? (int)p.idx[row_b * p.k + j] : -1;
      pb[j] = okb ? p.gates[row_b * p.k + j] : 0.0f;
    }

    // acc = x + sum_e g b2[e], from the x tile.
    float acc[DN / 2];
    mbar_wait(x_full, xphase);
    xphase ^= 1;
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      float2 xa = make_float2(0.0f, 0.0f), xb = xa;
      if (col < p.d) {
        xa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x_ptr + x_offset(ra, col)));
        xb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x_ptr + x_offset(ra + 8, col)));
      }
      acc[4 * j] = xa.x;
      acc[4 * j + 1] = xa.y;
      acc[4 * j + 2] = xb.x;
      acc[4 * j + 3] = xb.y;
    }
    for (int e = 0; e < p.E; ++e) {
      const float ga = gate_of(ia, pa, e), gb = gate_of(ib, pb, e);
      const bf16* b2e = p.b2 + (size_t)e * p.d;
#pragma unroll
      for (int j = 0; j < DN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col < p.d) {
          const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2e + col));
          acc[4 * j] += ga * bb.x;
          acc[4 * j + 1] += ga * bb.y;
          acc[4 * j + 2] += gb * bb.x;
          acc[4 * j + 3] += gb * bb.y;
        }
      }
    }

    // Blocks of tensor-core work, one per chunk q = e * nchunks + c and one
    // more: GEMM1 of chunk q and GEMM2 of chunk q - 1. The two warpgroups
    // take turns to issue their blocks (named barriers 1 and 2), so that one
    // applies bias, SiLU and gate (the SFU's work) while the other's block
    // runs on the tensor cores.
    const int nq = p.E * nchunks;
    for (int q = 0; q <= nq; ++q) {
      const int first = ring.stage;  // the ring stages this block reads, in order
      if (q == 0)
        tensor_block<DN, W1S, HC, false, true>(ring, acc, hacc, af, x_wg, xslabs, wg);
      else if (q < nq)
        tensor_block<DN, W1S, HC, true, true>(ring, acc, hacc, af, x_wg, xslabs, wg);
      else
        tensor_block<DN, W1S, HC, true, false>(ring, acc, hacc, af, x_wg, xslabs, wg);
      if (lane == 0) {
        const int used = (q > 0) + (q < nq) * W1S;
        for (int i = 0, s = first; i < used; ++i, s = s + 1 == p.stages ? 0 : s + 1)
          mbar_arrive(ring.empty(s));
        // The x tile's last read: free it for the next tile's copy.
        if (q == nq - 1) mbar_arrive(x_empty);
      }
      if (q < nq) {
        // Bias, SiLU and the gate in fp32, rounded once to bf16 as A fragments.
        const int e = q / nchunks, c = q - e * nchunks;
        const float ga = gate_of(ia, pa, e), gb = gate_of(ib, pb, e);
        const bf16* b1c = p.b1 + (size_t)e * p.h + c * HC;
#pragma unroll
        for (int j = 0; j < HC / 8; ++j) {
          const float2 bb = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(b1c + 8 * j + 2 * t));
          af[j >> 1][(j & 1) * 2] = pack_bf16(silu_approx(hacc[4 * j] + bb.x) * ga,
                                              silu_approx(hacc[4 * j + 1] + bb.y) * ga);
          af[j >> 1][(j & 1) * 2 + 1] = pack_bf16(silu_approx(hacc[4 * j + 2] + bb.x) * gb,
                                                  silu_approx(hacc[4 * j + 3] + bb.y) * gb);
        }
      }
    }

    // Round once and store this thread's pairs.
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col < p.d) {
        if (row_a < p.T)
          *reinterpret_cast<__nv_bfloat162*>(p.out + row_a * p.d + col) =
              __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        if (row_b < p.T)
          *reinterpret_cast<__nv_bfloat162*>(p.out + row_b * p.d + col) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
  if (wg == 0) turn_wait(wg);  // warpgroup 1's last pass
}

// ---- host side ------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that the runtime has loaded (no link
// against libcuda, so the library builds with a plain nvcc command).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A bf16 tensor map, dims[0] innermost, 128B swizzle, zeros out of bounds.
int make_map(CUtensorMap* map, const void* ptr, cuuint32_t rank, const cuuint64_t* dims,
             const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                        strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DN, int W1S, int HC>
int launch(const void* x, const void* w1t, const void* w2t, const Params& p, cudaStream_t stream) {
  const cuuint64_t T = p.T, d = p.d, h = p.h, E = p.E;
  CUtensorMap tm_x, tm_w1, tm_w2;
  const cuuint64_t x_dims[2] = {d, T}, x_strides[1] = {d * 2};
  const cuuint32_t x_box[2] = {kSlab, kBM};
  const cuuint64_t w1_dims[3] = {d, h, E}, w1_strides[2] = {d * 2, h * d * 2};
  const cuuint32_t w1_box[3] = {kSlab, HC, 1};
  const cuuint64_t w2_dims[3] = {h, d, E}, w2_strides[2] = {h * 2, d * h * 2};
  const cuuint32_t w2_box[3] = {kSlab, DN, 1};
  int err = make_map(&tm_x, x, 2, x_dims, x_strides, x_box);
  if (err == 0) err = make_map(&tm_w1, w1t, 3, w1_dims, w1_strides, w1_box);
  if (err == 0) err = make_map(&tm_w2, w2t, 3, w2_dims, w2_strides, w2_box);
  if (err != 0) return err;

  const size_t smem = smem_bytes(p.d, p.stages);
  cudaError_t e = cudaFuncSetAttribute(sweep_kernel<DN, W1S, HC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int grid = p.ntiles < sms ? p.ntiles : sms;
  sweep_kernel<DN, W1S, HC><<<grid, kThreads, smem, stream>>>(tm_x, tm_w1, tm_w2, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Ring stages the kernel uses at width d: 0 where d does not fit, that is
// where the ring cannot hold one block's stages (a W2 stage and the W1
// stages of a chunk), which a warpgroup waits for before releasing any.
extern "C" int moe_sweep_stages(int d) {
  if (d < kSlab || d % kSlab) return 0;
  const int s = stages_for(d);
  return s >= 1 + (d / kSlab + kW1Slabs - 1) / kW1Slabs ? s : 0;
}

// x (T, d), w1t (E, h, d) = W1 transposed, b1 (E, h), w2t (E, d, h) = W2
// transposed, b2 (E, d), out (T, d): bf16, contiguous, 16-byte aligned; idx
// (T, k) int64 and gates (T, k) fp32. d and h multiples of 64, 1 <= k <= 4.
// Returns the launch's cudaError_t (cudaErrorSymbolNotFound where libcuda
// lacks cuTensorMapEncodeTiled).
extern "C" int moe_sweep_fwd_launch(const void* x, const void* idx, const void* gates,
                                    const void* w1t, const void* b1, const void* w2t,
                                    const void* b2, void* out, long long T, int d, int h, int E,
                                    int k, void* stream) {
  if (T <= 0 || T > (1ll << 31) - 1 - kBM || h < kSlab || h % kSlab || E < 1 || k < 1 || k > kMaxK ||
      moe_sweep_stages(d) == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int nb = (d + 255) / 256;
  const int dn = ((d + nb - 1) / nb + kSlab - 1) / kSlab * kSlab;
  const int w1s = (d / kSlab + kW1Slabs - 1) / kW1Slabs;
  Params p{static_cast<const long long*>(idx), static_cast<const float*>(gates),
           static_cast<const bf16*>(b1), static_cast<const bf16*>(b2), static_cast<bf16*>(out),
           (int)T, d, h, E, k, nb, moe_sweep_stages(d),
           (int)((T + kBM - 1) / kBM) * nb};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // d <= 512 (moe_sweep_stages): one W1 stage up to d = 256, two above;
  // 128 hidden units a chunk where the registers allow.
  const bool wide_chunk = dn <= 128 && h % 128 == 0;
  switch (dn * 4 + (w1s - 1) * 2 + wide_chunk) {
    case 64 * 4: return launch<64, 1, 64>(x, w1t, w2t, p, s);
    case 64 * 4 + 1: return launch<64, 1, 128>(x, w1t, w2t, p, s);
    case 128 * 4: return launch<128, 1, 64>(x, w1t, w2t, p, s);
    case 128 * 4 + 1: return launch<128, 1, 128>(x, w1t, w2t, p, s);
    case 192 * 4: return launch<192, 1, 64>(x, w1t, w2t, p, s);
    case 192 * 4 + 2: return launch<192, 2, 64>(x, w1t, w2t, p, s);
    case 256 * 4: return launch<256, 1, 64>(x, w1t, w2t, p, s);
    default: return launch<256, 2, 64>(x, w1t, w2t, p, s);
  }
}
