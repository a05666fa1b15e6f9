// Grouped matrix multiplication (dropless MoE) for NVIDIA Hopper (sm_90a).
//
// Replaces: megablox gmm and tgmm (jax/experimental/pallas/ops/tpu/megablox),
// called by multimodal_moe_tpu/models/moe.py:moe_apply_gmm at lines 281 and
// 285, and their VJP (megablox ops.py:_gmm_bwd). Computes the functions of
// ops/gmm_kernel.py:gmm_plain and tgmm_plain. The rows of lhs are sorted by
// expert: group g owns rows [off_g, off_g + n_g), off_g = n_0 + ... + n_{g-1},
// with the sizes n_g on the device (no host sync anywhere).
//   gmm:   out[m, :] = lhs[m, :] . rhs[g]     (rhs (E, K, N))
//          out[m, :] = lhs[m, :] . rhs[g]^T   (transpose_rhs: rhs (E, N, K))
//          for m in group g; rows past the last group are zeros.
//   tgmm:  out[g] = lhs[seg_g]^T . rhs[seg_g] (lhs (M, K), rhs (M, N),
//          out (E, K, N)); zeros for an empty group.
// Inputs float32 or bfloat16, sums and output float32 (megablox's
// preferred_element_type), every element within 2*n*u*sum|a_i*b_i| of the
// float32 product (u = 2^-24, n the length of its sum).
//
// What bounds it on this card: an fp32-accurate product on the tensor cores
// costs three TF32 products (below), 6*M*K*N flops at 495 TFLOP/s, against
// lhs, rhs and the float32 output moved once at 3.35 TB/s. At the MoE-YOLO-s
// training step that is the bytes at level 0 (675 MB, 0.20 ms a launch: the
// (M, 256) float32 output is most of it) and the tensor cores at levels 1-2
// (0.17 ms a launch).
//
// What the design does about it:
//   * Tensor cores, fp32-accurate: each float32 x is split into
//     big = tf32(x) and small = tf32(x - big) (rounded as cvt.rna.tf32.f32
//     rounds: to nearest, ties away from zero; see tf32_rna), and the
//     block issues small*big, big*small and big*big into the same float32
//     accumulators with mma.sync m16n8k8 (every TF32 x TF32 product is exact
//     in float32). That leaves ~3*2^-22 of sum|ab| per element whatever the
//     length of the sum, inside the bound once the sum has 12 or more terms.
//     A bf16 value is exact in TF32: its small part is zero and its products
//     drop out (one product for bf16 x bf16, two for a mixed pair).
//   * Short sums, exact: a block whose reduction is shorter than
//     kShortReduction (gmm: K; tgmm: the whole segment's length, read from
//     the sizes) runs the same tile loop with SIMT float32 FMAs instead, one
//     sum per output element in order (within n*u*sum|ab|). The branch is
//     uniform across the block; both paths are this kernel.
//   * The tile loop: a block makes a 128 x 128 output tile with 4 warps of
//     64 x 64 each (the split is done per warp, so wide warp tiles split
//     each element for fewer products). The reduction comes in stages of 32
//     through a ring of kStages stages in dynamic shared memory, filled by
//     cp.async 16-byte (float32) or 8-byte (bf16) copies with zero fill past
//     the valid range; one barrier a stage. An operand whose reduction runs
//     along its rows in device memory (gmm's lhs, the transposed rhs) is
//     stored [index][k] and read by ldmatrix (float32; bf16 element by
//     element); one whose output index runs along the rows (gmm's rhs, both
//     tgmm operands) is stored [k][index] and read as 16-byte quads along the
//     index, after permuting which tile row or column each fragment row or
//     column holds (frag_row, frag_col). Row pads keep a warp's reads free
//     of bank conflicts (Stage), one loop serves all three products, and a
//     float32 ring (104-111 KB) leaves room for two blocks an SM.
//   * The store: the finished tile goes through shared memory (the ring is
//     free by then), so each warp writes whole 512-byte row segments; stores
//     straight from the fragments (each 32-byte sector in two 16-byte halves
//     from separate instructions) made the level-0 gmm, whose float32
//     output is most of its bytes, far slower.
//   * Why mma.sync and not wgmma yet: wgmma takes TF32 operands only K-major
//     in shared memory, and only the transposed gmm has both operands so
//     (gmm's rhs is N-major, both tgmm operands M-major); TMA cannot
//     transpose 4-byte elements. mma.sync fragments are the threads' own
//     shared-memory reads, so any layout works.
//   * gmm, tiles that straddle groups: a row tile finds the groups that
//     intersect it (prefix sums of the sizes in shared memory) and runs the
//     tile loop once per group, with the other groups' lhs rows zero-filled,
//     so every row takes its own expert's weights and gets exact zeros from
//     the rest. Empty groups are skipped.
//   * tgmm: an output tile (K x N of one expert) sums over the expert's whole
//     segment, ~110k rows at level 0, and there are only a few such tiles.
//     So each segment is cut into chunks of R rows (R from the wrapper, sized
//     to fill the card); work item w = (group, chunk) writes a float32
//     partial, and a second pass adds each group's partials in chunk order
//     (deterministic, no atomics), writing zeros where a group has none.
//     At most ceil(M / R) + E work items exist; the wrapper launches that
//     many and the spare ones return at once.
//   * Offsets in 64 bits (M * N reaches 1.1e8 here, ~9e8 at serving sizes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;     // output tile edge (gmm: token rows x columns; tgmm: K x N)
constexpr int kWarpsM = 2, kWarpsN = 2;                  // warps of a block
constexpr int kWarpM = kTile / kWarpsM, kWarpN = kTile / kWarpsN;  // a warp's outputs: 64 x 64
constexpr int kMT = kWarpM / 16, kNT = kWarpN / 8;      // its m16 and n8 mma tiles: 4 x 8
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kBK = 32;        // reduction elements a stage
constexpr int kStages = 3;     // depth of the cp.async ring
constexpr int kMinBlocks = 2;  // blocks an SM holds at once (shared memory: 2 rings)
constexpr int kQuads = kTile * kBK / 4 / kThreads;  // 4-element copies a thread, operand, stage
constexpr int kReduceThreads = 256;                 // tgmm's second pass
// store_tile stages the finished tile in the ring: 128 rows of up to 136
// floats, more than a bf16 x bf16 ring holds.
constexpr size_t kStoreBytes = (size_t)kTile * (kTile + 8) * sizeof(float);
static_assert(kMT % 2 == 0 && kNT % 4 == 0, "fragment reads take m-tile pairs, n-tile quads");
// Sums shorter than this take the exact SIMT path (ops/gmm_kernel.py:
// SHORT_REDUCTION mirrors it): the split's ~3*2^-22*sum|ab| plus the sum's own
// n*u*sum|ab| fit in 2*n*u*sum|ab| from n = 12 on. That count models the
// accumulation as float32 adds rounded to nearest (as the CPU emulation in
// tests/test_torch_gmm_split.py does); mma.sync aligns each k8 step's
// products to the largest exponent and truncates, which the model does not
// capture. The card cases of 15, 16 and 17 rows (chip_smoke.py,
// tests/test_torch_gmm.py) are what check the threshold on the kernel.
constexpr int kShortReduction = 16;
constexpr int kMaxE = 1024;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may ask for

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// Four elements from device to shared memory without a register round trip;
// zeros where ok is false (source size 0: no byte is copied; the callers
// still pass an address inside the operand).
__device__ __forceinline__ void cp_async_quad(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_quad(bf16* dst, const bf16* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One operand's stage in shared memory: kTile output indices i by kBK
// reduction indices k. kRC ("reduction contiguous", the reduction runs along
// the rows in device memory): stored s[i][k], fragments read by ldmatrix
// (float32) or one element at a time (bf16); else s[k][i], fragments read as
// quads along i. The row pads make those reads free of bank conflicts: rows
// 36 words apart put ldmatrix's 8 rows of 4 words in 32 distinct banks, and
// rows 136 (float32) or 72 (bf16) words apart put the quads of lanes t = 0..3
// 8 banks apart.
template <typename T, bool kRC>
struct Stage {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kLd = kRC ? (kF32 ? kBK + 4 : kBK + 8) : (kF32 ? kTile + 8 : kTile + 16);
  static constexpr int kBytes = (kRC ? kTile : kBK) * kLd * (int)sizeof(T);
  __device__ static __forceinline__ float at(const T* s, int i, int k) {
    return to_float(kRC ? s[i * kLd + k] : s[k * kLd + i]);
  }
  // Elements (i..i + 3, k) of a stage stored s[k][i], i a multiple of 4.
  __device__ static __forceinline__ float4 quad(const T* s, int k, int i) {
    if constexpr (kF32) {
      return *reinterpret_cast<const float4*>(s + k * kLd + i);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(s + k * kLd + i);
      return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                         __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
    }
  }
};

// Four 8 x 4 float32 matrices from shared memory (ldmatrix's 8 x 8 b16 with
// two halves a float); lane l gives the address of row l % 8 of matrix l / 8,
// and lane (g, t) receives element (g, t) of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Which tile element each accumulator holds. The fragments of mma.m16n8k8
// (PTX ISA), with g = lane / 4, t = lane % 4: a[0..3] at (row, k) = (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); b[0..1] at (k, column) = (t, g),
// (t + 4, g); c[2h + e] at (g + 8h, 2t + e). The product does not care which
// tile row (column) sits in which fragment row (column), as long as the
// operand and the store agree. So in a stage stored s[k][i] the rows g and
// g + 8 of m-tiles 2p and 2p + 1 are tile rows 32p + 4g + {0, 1, 2, 3}, and
// column g of n-tiles 4q..4q + 3 is tile column 32q + 4g + {0, 1, 2, 3} (one
// 16-byte read each). Warp (wm, wn) owns tile rows wm*kWarpM + [0, kWarpM)
// and columns wn*kWarpN + [0, kWarpN): m-tile i, n-tile j.
template <bool kRC>
__device__ __forceinline__ int frag_row(int wm, int i, int g, int h) {
  return wm * kWarpM + (kRC ? 16 * i + g + 8 * h : 32 * (i >> 1) + 4 * g + 2 * (i & 1) + h);
}
template <bool kRC>
__device__ __forceinline__ int frag_col(int wn, int j, int c) {
  return wn * kWarpN + (kRC ? 8 * j + c : 32 * (j >> 2) + 4 * c + (j & 3));
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero): half a TF32 ulp added to the magnitude bits, the 13 low bits
// cleared. The same result for every finite x (and inf) in two integer
// operations; cvt.rna compiles to a sequence of four or five on sm_90a
// (inf/NaN tests and selects), and the split is most of this kernel's ALU
// work. Not for NaN: the carry turns a NaN with high mantissa bits (the
// card's canonical 0x7fffffff among them) into -0, and one with only low
// bits into inf. split handles NaN itself.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small (+ what TF32 cannot hold of the rest), both TF32. A NaN x
// gets the canonical NaN as its big part, so the big x big product (and
// big x small) carries it into the sum as the plain float32 product does;
// its small part does not matter then.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = x != x ? 0x7fffffffu : tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// c (16 x 8) += a (16 x 8, row) . b (8 x 8, col), TF32 operands, float32 sums.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// big and small parts of n fragment values (small is zero for bf16 input).
template <typename T, int n>
__device__ __forceinline__ void split_all(const float (&x)[n], uint32_t (&big)[n],
                                          uint32_t (&small)[n]) {
#pragma unroll
  for (int r = 0; r < n; ++r) {
    if constexpr (sizeof(T) == 4) {
      split(x[r], big[r], small[r]);
    } else {
      big[r] = __float_as_uint(x[r]);  // a bf16 value is exact in TF32
    }
  }
}

// One k8 step's B fragments of the warp's kNT n-tiles: bx[j][h] at (k0 + t
// + 4h, frag_col(j, g)).
template <typename TB, bool kRB>
__device__ __forceinline__ void load_b(const TB* sb, int k0, int wn, int lane,
                                       float (&bx)[kNT][2]) {
  using SB = Stage<TB, kRB>;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (kRB && SB::kF32) {
#pragma unroll
    // matrices (n-tile j, k0), (j, k0 + 4), (j + 1, k0), (j + 1, k0 + 4)
    for (int j = 0; j < kNT; j += 2) {
      uint32_t r[4];
      const int m = lane >> 3;
      ldsm_x4(r, sb + frag_col<true>(wn, j + (m >> 1), lane & 7) * SB::kLd + k0 + 4 * (m & 1));
      bx[j][0] = __uint_as_float(r[0]), bx[j][1] = __uint_as_float(r[1]);
      bx[j + 1][0] = __uint_as_float(r[2]), bx[j + 1][1] = __uint_as_float(r[3]);
    }
  } else if constexpr (kRB) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) bx[j][h] = SB::at(sb, frag_col<true>(wn, j, g), k0 + t + 4 * h);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kNT / 4; ++q) {
      const float4 lo = SB::quad(sb, k0 + t, frag_col<false>(wn, 4 * q, g));
      const float4 hi = SB::quad(sb, k0 + t + 4, frag_col<false>(wn, 4 * q, g));
      const float l[4] = {lo.x, lo.y, lo.z, lo.w}, u[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) bx[4 * q + r][0] = l[r], bx[4 * q + r][1] = u[r];
    }
  }
}

// One k8 step's A fragments of m-tiles 2p and 2p + 1: ax[q][r] for a[r].
template <typename TA, bool kRA>
__device__ __forceinline__ void load_a(const TA* sa, int k0, int wm, int p, int lane,
                                       float (&ax)[2][4]) {
  using SA = Stage<TA, kRA>;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (kRA && SA::kF32) {
#pragma unroll
    // matrices (rows 0-7, k0), (8-15, k0), (0-7, k0 + 4), (8-15, k0 + 4)
    for (int q = 0; q < 2; ++q) {
      uint32_t r[4];
      const int m = lane >> 3;
      ldsm_x4(r, sa + frag_row<true>(wm, 2 * p + q, lane & 7, m & 1) * SA::kLd + k0 + 4 * (m >> 1));
#pragma unroll
      for (int c = 0; c < 4; ++c) ax[q][c] = __uint_as_float(r[c]);
    }
  } else if constexpr (kRA) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ax[q][c] = SA::at(sa, frag_row<true>(wm, 2 * p + q, g, c & 1), k0 + t + 4 * (c >> 1));
      }
    }
  } else {
    const float4 lo = SA::quad(sa, k0 + t, frag_row<false>(wm, 2 * p, g, 0));
    const float4 hi = SA::quad(sa, k0 + t + 4, frag_row<false>(wm, 2 * p, g, 0));
    ax[0][0] = lo.x, ax[0][1] = lo.y, ax[0][2] = hi.x, ax[0][3] = hi.y;
    ax[1][0] = lo.z, ax[1][1] = lo.w, ax[1][2] = hi.z, ax[1][3] = hi.w;
  }
}

// acc += one stage's product on the tensor cores: per k8 step, small*big,
// big*small, then big*big into the same accumulators (products that a bf16
// operand makes zero are skipped); each m-tile's kNT n-tiles are issued back
// to back, so consecutive mma.sync are independent.
template <typename TA, bool kRA, typename TB, bool kRB>
__device__ __forceinline__ void mma_stage(const TA* sa, const TB* sb, int wm, int wn, int lane,
                                          float (&acc)[kMT][kNT][4]) {
  constexpr bool kSmallA = sizeof(TA) == 4, kSmallB = sizeof(TB) == 4;
#pragma unroll
  for (int k0 = 0; k0 < kBK; k0 += 8) {
    float bx[kNT][2];
    load_b<TB, kRB>(sb, k0, wn, lane, bx);
    uint32_t bb[kNT][2], bs[kNT][2];
#pragma unroll
    for (int j = 0; j < kNT; ++j) split_all<TB, 2>(bx[j], bb[j], bs[j]);
#pragma unroll
    for (int p = 0; p < kMT / 2; ++p) {
      float ax[2][4];
      load_a<TA, kRA>(sa, k0, wm, p, lane, ax);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t ab[4], as[4];
        split_all<TA, 4>(ax[q], ab, as);
        float(&c)[kNT][4] = acc[2 * p + q];
        if constexpr (kSmallA) {
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_tf32(c[j], as, bb[j]);
        }
        if constexpr (kSmallB) {
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_tf32(c[j], ab, bs[j]);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(c[j], ab, bb[j]);
      }
    }
  }
}

// The exact path: the same accumulators as mma_stage, by float32 FMAs in
// order of the reduction index (the zero-filled tail adds exact zeros).
template <typename TA, bool kRA, typename TB, bool kRB>
__device__ __forceinline__ void fma_stage(const TA* sa, const TB* sb, int wm, int wn, int lane,
                                          float (&acc)[kMT][kNT][4]) {
  using SA = Stage<TA, kRA>;
  using SB = Stage<TB, kRB>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k = 0; k < kBK; ++k) {
    float a[kMT][2], b[kNT][2];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) a[i][h] = SA::at(sa, frag_row<kRA>(wm, i, g, h), k);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) b[j][e] = SB::at(sb, frag_col<kRB>(wn, j, 2 * t + e), k);
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = fmaf(a[i][c >> 1], b[j][c & 1], acc[i][j][c]);
      }
    }
  }
}

// A thread's share of the copies of one operand in one pass: kQuads quads of
// 4 elements a stage, along k (kRC: rows tid/8 + (kThreads/8)j, reduction
// offset 4*(tid%8)) or along i (reduction offsets tid/32 + (kThreads/32)j,
// indices 4*(tid%32)). Element (i, k) lives at ptr[i*ld + k] (kRC) or
// ptr[k*ld + i]; indices outside [i_lo, i_hi) and reduction offsets past the
// pass's length are zero-filled, their copies pointed at `safe` (an address
// inside the operand: theirs may lie past its end).
template <typename T, bool kRC>
struct Loader {
  const T* src;  // quad 0 at the pass's first reduction index
  unsigned ok;   // bit j: quad j's index i is valid

  __device__ __forceinline__ void set(const T* ptr, long long ld, long long i0, long long i_lo,
                                      long long i_hi, long long k_begin, int tid) {
    ok = 0;
    if constexpr (kRC) {
      const long long i = i0 + (tid >> 3);
      src = ptr + i * ld + k_begin + 4 * (tid & 7);
#pragma unroll
      for (int j = 0; j < kQuads; ++j) {
        const long long r = i + kThreads / 8 * j;
        ok |= (r >= i_lo && r < i_hi) << j;
      }
    } else {
      const long long i = i0 + 4 * (tid & 31);
      src = ptr + (k_begin + (tid >> 5)) * ld + i;
      ok = i >= i_lo && i < i_hi ? (1u << kQuads) - 1 : 0u;
    }
  }

  // Stage `step` of the pass (k_len reduction elements) into s.
  __device__ __forceinline__ void load(T* s, int step, int k_len, long long ld, const T* safe,
                                       int tid) const {
    using S = Stage<T, kRC>;
    constexpr int kRows = kThreads / 8, kKs = kThreads / 32;  // strides of j
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      const int koff = step * kBK + (kRC ? 4 * (tid & 7) : (tid >> 5) + kKs * j);
      const bool valid = ((ok >> j) & 1u) && koff < k_len;
      const T* p = kRC ? src + kRows * j * ld + step * kBK
                       : src + (long long)(koff - (tid >> 5)) * ld;
      T* d = kRC ? s + ((tid >> 3) + kRows * j) * S::kLd + 4 * (tid & 7)
                 : s + ((tid >> 5) + kKs * j) * S::kLd + 4 * (tid & 31);
      cp_async_quad(d, valid ? p : safe, valid);
    }
  }
};

// Write acc to out through shared memory (the ring, free after the tile
// loop): each thread puts its accumulators at their tile positions, then
// each warp stores whole 512-byte row segments (float4 a lane), rows below
// r_end and columns below c_end (a multiple of 4).
template <bool kRA, bool kRB>
__device__ __forceinline__ void store_tile(unsigned char* smem, float* __restrict__ out,
                                           long long ld, long long r0, long long r_end,
                                           long long c0, long long c_end,
                                           const float (&acc)[kMT][kNT][4]) {
  constexpr int kLd = kRB ? kTile + 8 : kTile + 4;  // conflict-free float2 / float4 writes
  static_assert(kTile * kLd * sizeof(float) <= kStoreBytes, "ring_bytes() holds the tile");
  float* st = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = st + frag_row<kRA>(wm, i, g, h) * kLd;
      if constexpr (kRB) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          *reinterpret_cast<float2*>(row + frag_col<true>(wn, j, 2 * t)) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < kNT / 4; ++q) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float(&v)[kNT][4] = acc[i];
            *reinterpret_cast<float4*>(row + frag_col<false>(wn, 4 * q, 2 * t + e)) =
                make_float4(v[4 * q][2 * h + e], v[4 * q + 1][2 * h + e],
                            v[4 * q + 2][2 * h + e], v[4 * q + 3][2 * h + e]);
          }
        }
      }
    }
  }
  __syncthreads();
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kTile * kTile / 4; idx += kThreads) {
    const int r = idx / (kTile / 4), c = 4 * (idx % (kTile / 4));
    if (r0 + r < r_end && c0 + c < c_end) {
      *reinterpret_cast<float4*>(out + (r0 + r) * ld + c0 + c) =
          *reinterpret_cast<const float4*>(st + r * kLd + c);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kMT][kNT][4]) {
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;
    }
  }
}

// One pass of the tile loop: the sum over k_len reduction elements of
// operands a and b, added into acc. The copies run kStages - 1 stages ahead
// of the products; one barrier a stage. The ring is free again on return.
template <typename TA, bool kRA, typename TB, bool kRB>
__device__ __forceinline__ void tile_loop(unsigned char* ring, const Loader<TA, kRA>& a,
                                          long long lda, const TA* safe_a,
                                          const Loader<TB, kRB>& b, long long ldb,
                                          const TB* safe_b, int k_len, bool exact,
                                          float (&acc)[kMT][kNT][4]) {
  using SA = Stage<TA, kRA>;
  using SB = Stage<TB, kRB>;
  constexpr int kStageBytes = SA::kBytes + SB::kBytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int steps = (k_len + kBK - 1) / kBK;
  auto stage_a = [&](int s) { return reinterpret_cast<TA*>(ring + s * kStageBytes); };
  auto stage_b = [&](int s) { return reinterpret_cast<TB*>(ring + s * kStageBytes + SA::kBytes); };
  auto load = [&](int step) {
    a.load(stage_a(step % kStages), step, k_len, lda, safe_a, tid);
    b.load(stage_b(step % kStages), step, k_len, ldb, safe_b, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();  // empty groups keep the count uniform
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();  // this thread's copies of `step` have landed
    __syncthreads();               // everyone's have, and `step - 1` is consumed
    if (step + kStages - 1 < steps) load(step + kStages - 1);
    cp_async_commit();
    const int s = step % kStages;
    if (exact) {
      fma_stage<TA, kRA, TB, kRB>(stage_a(s), stage_b(s), wm, wn, lane, acc);
    } else {
      mma_stage<TA, kRA, TB, kRB>(stage_a(s), stage_b(s), wm, wn, lane, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Group offsets off[0..E] (and, for tgmm, each group's chunk count and first
// work item) in shared memory: the sizes are read in parallel, the prefix
// sums by one thread (E is small).
__device__ void group_offsets(const int* __restrict__ sizes, int E, long long rows_per_chunk,
                              int* s_sizes, long long* off, int* chunk_start) {
  for (int g = threadIdx.x; g < E; g += blockDim.x) s_sizes[g] = max(sizes[g], 0);
  __syncthreads();
  if (threadIdx.x == 0) {
    long long acc = 0;
    int chunks = 0;
    for (int g = 0; g < E; ++g) {
      off[g] = acc;
      acc += s_sizes[g];
      if (chunk_start != nullptr) {
        chunk_start[g] = chunks;
        chunks += (int)((s_sizes[g] + rows_per_chunk - 1) / rows_per_chunk);
      }
    }
    off[E] = acc;
    if (chunk_start != nullptr) chunk_start[E] = chunks;
  }
  __syncthreads();
}

// Dynamic shared memory: the ring (at least kStoreBytes), then off[E + 1],
// chunk_start[E + 1] and the sizes[E].
template <typename TA, bool kRA, typename TB, bool kRB>
__host__ __device__ constexpr size_t ring_bytes() {
  constexpr size_t ring = (size_t)kStages * (Stage<TA, kRA>::kBytes + Stage<TB, kRB>::kBytes);
  return ring > kStoreBytes ? ring : kStoreBytes;
}
size_t smem_bytes(size_t ring, int E) {
  return ring + (size_t)(E + 1) * sizeof(long long) + (size_t)(2 * E + 1) * sizeof(int);
}

// gmm: block b makes rows [128 * (b / tiles_n), + 128) and columns
// [128 * (b % tiles_n), + 128) of out (M, N); K is the reduction length.
// The column tiles of one row tile run side by side and share its lhs rows
// in L2. The tile loop runs once per non-empty group the rows meet, with the
// other groups' rows zero-filled; rows past the last group stay zeros.
template <typename TA, typename TB, bool kTransRhs>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gmm_kernel(const TA* __restrict__ lhs, const TB* __restrict__ rhs, const int* __restrict__ sizes,
           float* __restrict__ out, long long M, int K, int N, int E) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr size_t kRing = ring_bytes<TA, true, TB, kTransRhs>();
  long long* off = reinterpret_cast<long long*>(smem + kRing);
  int* s_sizes = reinterpret_cast<int*>(off + E + 1);
  group_offsets(sizes, E, 1, s_sizes, off, nullptr);

  const int tiles_n = (N + kTile - 1) / kTile;
  const long long row0 = (long long)(blockIdx.x / tiles_n) * kTile;
  const long long row_end = min(row0 + kTile, M);
  const long long col0 = (long long)(blockIdx.x % tiles_n) * kTile;
  int g = 0;  // the first group ending past row0 (off[] is shared: the same for every thread)
  for (int hi = E; g < hi;) {
    const int mid = (g + hi) / 2;
    if (off[mid + 1] > row0) hi = mid; else g = mid + 1;
  }

  float acc[kMT][kNT][4];
  zero(acc);
  const bool exact = K < kShortReduction;
  for (; g < E && off[g] < row_end; ++g) {
    const long long lo = max(row0, off[g]), hi = min(row_end, off[g + 1]);
    if (lo >= hi) continue;  // an empty group
    Loader<TA, true> a;
    Loader<TB, kTransRhs> b;
    a.set(lhs, K, row0, lo, hi, 0, threadIdx.x);
    b.set(rhs + (long long)g * K * N, kTransRhs ? K : N, col0, 0, N, 0, threadIdx.x);
    tile_loop(smem, a, K, lhs, b, kTransRhs ? K : N, rhs, K, exact, acc);
  }
  store_tile<true, kTransRhs>(smem, out, N, row0, row_end, col0, N, acc);
}

// tgmm, first pass: block b = (work item w = b / tiles, output tile b % tiles)
// makes the partial sum of lhs[rows]^T . rhs[rows] over the rows of w's chunk
// (group g, chunk c of its segment) for a 128 x 128 tile of the (K, N)
// output, into partial[w]. The tiles of one work item run side by side and
// share its rows in L2. The exact path is taken by the whole segment's
// length.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tgmm_partial_kernel(const TA* __restrict__ lhs, const TB* __restrict__ rhs,
                    const int* __restrict__ sizes, float* __restrict__ partial, long long M, int K,
                    int N, int E, long long rows_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr size_t kRing = ring_bytes<TA, false, TB, false>();
  long long* off = reinterpret_cast<long long*>(smem + kRing);
  int* chunk_start = reinterpret_cast<int*>(off + E + 1);
  int* s_sizes = chunk_start + E + 1;
  group_offsets(sizes, E, rows_per_chunk, s_sizes, off, chunk_start);

  const int tiles_n = (N + kTile - 1) / kTile;
  const int tiles = ((K + kTile - 1) / kTile) * tiles_n;
  const int w = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  if (w >= chunk_start[E]) return;  // a spare work item (uniform across the block)
  int g = 0;                        // the group whose chunks hold w
  for (int hi = E; g < hi;) {
    const int mid = (g + hi) / 2;
    if (chunk_start[mid + 1] > w) hi = mid; else g = mid + 1;
  }
  const long long k0 = (long long)(tile / tiles_n) * kTile;
  const long long n0 = (long long)(tile % tiles_n) * kTile;
  const long long lo = off[g] + (long long)(w - chunk_start[g]) * rows_per_chunk;
  const long long hi = min(min(lo + rows_per_chunk, off[g + 1]), M);

  float acc[kMT][kNT][4];
  zero(acc);
  Loader<TA, false> a;
  Loader<TB, false> b;
  a.set(lhs, K, k0, 0, K, lo, threadIdx.x);
  b.set(rhs, N, n0, 0, N, lo, threadIdx.x);
  tile_loop(smem, a, K, lhs, b, N, rhs, (int)(hi - lo), off[g + 1] - off[g] < kShortReduction,
            acc);
  store_tile<false, false>(smem, partial + (long long)w * K * N, N, k0, K, n0, N, acc);
}

// tgmm, second pass: out[g, k, n] = sum over g's chunks, in chunk order, of
// partial[chunk_start[g] + c, k, n]; zeros for a group without rows.
__global__ void __launch_bounds__(kReduceThreads)
tgmm_reduce_kernel(const float* __restrict__ partial, const int* __restrict__ sizes,
                   float* __restrict__ out, int K, int N, int E, long long rows_per_chunk) {
  __shared__ long long off[kMaxE + 1];
  __shared__ int chunk_start[kMaxE + 1];
  __shared__ int s_sizes[kMaxE];
  group_offsets(sizes, E, rows_per_chunk, s_sizes, off, chunk_start);
  const long long kn = (long long)K * N;
  const long long total = kn * E;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int g = (int)(i / kn);
    const long long e = i - g * kn;
    float sum = 0.0f;
    for (int c = chunk_start[g]; c < chunk_start[g + 1]; ++c) sum += partial[c * kn + e];
    out[i] = sum;
  }
}

// Let the kernel take `smem` bytes of dynamic shared memory (above the 48 KB
// default) and prefer shared memory to L1, so kMinBlocks blocks fit an SM.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename TA, typename TB, bool kTransRhs>
int launch_gmm_as(const void* lhs, const void* rhs, const int* sizes, float* out, long long M,
                  int K, int N, int E, cudaStream_t stream) {
  const auto kernel = gmm_kernel<TA, TB, kTransRhs>;
  const size_t smem = smem_bytes(ring_bytes<TA, true, TB, kTransRhs>(), E);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((M + kTile - 1) / kTile) * ((N + kTile - 1) / kTile);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)tiles, kThreads, smem, stream>>>(
      static_cast<const TA*>(lhs), static_cast<const TB*>(rhs), sizes, out, M, K, N, E);
  return (int)cudaGetLastError();
}

template <typename TA, typename TB>
int launch_gmm(const void* lhs, const void* rhs, const int* sizes, float* out, long long M, int K,
               int N, int E, bool trans, cudaStream_t stream) {
  return trans ? launch_gmm_as<TA, TB, true>(lhs, rhs, sizes, out, M, K, N, E, stream)
               : launch_gmm_as<TA, TB, false>(lhs, rhs, sizes, out, M, K, N, E, stream);
}

template <typename TA, typename TB>
int launch_tgmm(const void* lhs, const void* rhs, const int* sizes, float* partial, float* out,
                long long M, int K, int N, int E, long long rows_per_chunk, int work_items,
                cudaStream_t stream) {
  const auto kernel = tgmm_partial_kernel<TA, TB>;
  const size_t smem = smem_bytes(ring_bytes<TA, false, TB, false>(), E);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((K + kTile - 1) / kTile) * ((N + kTile - 1) / kTile);
  if (tiles * work_items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)(tiles * work_items), kThreads, smem, stream>>>(
      static_cast<const TA*>(lhs), static_cast<const TB*>(rhs), sizes, partial, M, K, N, E,
      rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)E * K * N;
  const long long need = (total + kReduceThreads - 1) / kReduceThreads;
  const unsigned blocks = (unsigned)(need < 65536 ? need : 65536);
  tgmm_reduce_kernel<<<blocks, kReduceThreads, 0, stream>>>(partial, sizes, out, K, N, E,
                                                            rows_per_chunk);
  return (int)cudaGetLastError();
}

bool shapes_ok(long long M, int K, int N, int E) {
  return M >= 1 && K >= 4 && N >= 4 && K % 4 == 0 && N % 4 == 0 && E >= 1 && E <= kMaxE;
}

}  // namespace

// lhs (M, K), rhs (E, K, N) or, with transpose_rhs, (E, N, K), group sizes
// (E,) int32, out (M, N) float32; lhs and rhs float32 or bfloat16 (the
// *_bf16 flags), contiguous, 16-byte aligned, on the device. K and N
// multiples of 4, 1 <= E <= 1024. Returns the launch's cudaError_t.
extern "C" int gmm_launch(const void* lhs, int lhs_bf16, const void* rhs, int rhs_bf16,
                          const int* group_sizes, float* out, long long M, int K, int N, int E,
                          int transpose_rhs, void* stream) {
  if (!shapes_ok(M, K, N, E)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool t = transpose_rhs != 0;
  if (lhs_bf16 && rhs_bf16) {
    return launch_gmm<bf16, bf16>(lhs, rhs, group_sizes, out, M, K, N, E, t, s);
  }
  if (lhs_bf16) return launch_gmm<bf16, float>(lhs, rhs, group_sizes, out, M, K, N, E, t, s);
  if (rhs_bf16) return launch_gmm<float, bf16>(lhs, rhs, group_sizes, out, M, K, N, E, t, s);
  return launch_gmm<float, float>(lhs, rhs, group_sizes, out, M, K, N, E, t, s);
}

// lhs (M, K), rhs (M, N), group sizes (E,) int32 -> out (E, K, N) float32,
// through partial (work_items, K, N) float32 scratch; work_items must be at
// least ceil(M / rows_per_chunk) + E. Same type and layout rules as
// gmm_launch. Returns the first failing launch's cudaError_t.
extern "C" int tgmm_launch(const void* lhs, int lhs_bf16, const void* rhs, int rhs_bf16,
                           const int* group_sizes, float* partial, float* out, long long M, int K,
                           int N, int E, long long rows_per_chunk, int work_items, void* stream) {
  if (!shapes_ok(M, K, N, E) || rows_per_chunk < 1 ||
      work_items < (M + rows_per_chunk - 1) / rows_per_chunk + E) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lhs_bf16 && rhs_bf16) {
    return launch_tgmm<bf16, bf16>(lhs, rhs, group_sizes, partial, out, M, K, N, E, rows_per_chunk,
                                   work_items, s);
  }
  if (lhs_bf16) {
    return launch_tgmm<bf16, float>(lhs, rhs, group_sizes, partial, out, M, K, N, E,
                                    rows_per_chunk, work_items, s);
  }
  if (rhs_bf16) {
    return launch_tgmm<float, bf16>(lhs, rhs, group_sizes, partial, out, M, K, N, E,
                                    rows_per_chunk, work_items, s);
  }
  return launch_tgmm<float, float>(lhs, rhs, group_sizes, partial, out, M, K, N, E, rows_per_chunk,
                                   work_items, s);
}
