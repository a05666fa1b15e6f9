// Multi-scale deformable attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces: multimodal_moe_tpu/ops/deformable_pallas.py:_fwd_kernel, together
// with the XLA precompute around it (_slot_weights, _prep).
// Computes the same function as ops/deformable.py:ms_deformable_attention:
//   out[b, q, h, :] = sum over level l, point p, corner c of
//       attn[b,q,h,l,p] * bilinear_c * values[b, start_l + cy*W_l + cx, h, :]
// with x = loc_x*W_l - 0.5, y = loc_y*H_l - 0.5 (grid_sample with
// align_corners=False) and zero padding: a corner outside the map (NaN and
// +-inf locations fail the same test) adds nothing; it is skipped, never
// multiplied by a zero weight.
//
// What bounds it on this card: bytes. Per (b, q, head) it reads up to L*P*4
// value rows of D floats (4*D bytes each) and does 2*D flops on each, 0.5
// flop per byte, far below the ~20 flops per byte (67 TFLOP/s over
// 3.35 TB/s) where fp32 arithmetic would be the limit. What held the first
// version back was latency: one corner at a time, one 4-byte load a lane.
//
// What the design does about it:
//   * One warp per (b, q, head). A value row is split into 16-byte pieces
//     where D % 4 == 0 (VEC = 4; else 4-byte pieces, VEC = 1), one piece a
//     lane, in a group of GS lanes (D/VEC rounded up to a power of 2). The
//     warp's 32/GS groups take that many corners at once: at D = 32 the 4
//     corners of one point, one per 8-lane group, each lane one
//     ld.global.nc.v4.f32 of a 128-byte row. A corner's bounds test is a
//     per-lane predicate, not a warp branch.
//   * kUnroll steps (six points at D = 32) are loaded before any is
//     summed, so six 16-byte loads a lane are in flight; blocks of 4 warps.
//   * Each lane accumulates its pieces over the corners its group takes;
//     the groups combine once, at the end, in log2(32/GS) xor-shuffles (16
//     and 8 at D = 32), and group 0 stores 16 bytes a lane.
//   * The bilinear weights and the sums stay in registers: nothing but the
//     (B, Q, NH*D) output is written to device memory. The TPU design's
//     on-chip value slab (~2.3 MB per (batch, head)) does not fit a Hopper
//     block; rows come from device memory through the 50 MB L2 instead.
//   * Corner tests in float before any cast to int; 64-bit row offsets.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 4;
constexpr int kUnroll = 6;  // steps whose loads are in flight together
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long start[kMaxLevels];  // first row of the level on the SumHW axis
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC, int GS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ms_deform_fwd_kernel(const float* __restrict__ values, const float* __restrict__ loc,
                     const float* __restrict__ attn, float* __restrict__ out,
                     long long n_warps, int S, int Q, int NH, int D, int L, int P,
                     Levels lv) {
  constexpr int G = 32 / GS;                 // lane groups
  constexpr int PPS = G >= 4 ? G / 4 : 1;    // points a step
  constexpr int CPG = G >= 4 ? 1 : 4 / G;    // corners a group takes per step
  const long long gw = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (gw >= n_warps) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int gi = lane / GS, sub = lane % GS;
  const int pj = gi / 4;  // the group's point within a step
  // gw = (b*Q + q)*NH + h, the row-major index of (b, q, h).
  const int h = (int)(gw % NH);
  const long long b = gw / NH / Q;
  const int LP = L * P;
  const float* gloc = loc + gw * LP * 2;
  const float* gattn = attn + gw * LP;
  const long long row_stride = (long long)NH * D;
  const long long base = b * S * row_stride + (long long)h * D + sub * VEC;
  const bool owns = sub * VEC < D;  // the lane holds channels of the row

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;

  for (int j0 = 0; j0 < LP; j0 += 32) {
    const int jl = j0 + lane;
    float mx = 0.0f, my = 0.0f, ma = 0.0f;
    if (jl < LP) {
      mx = gloc[2 * jl];
      my = gloc[2 * jl + 1];
      ma = gattn[jl];
    }
    const int jn = min(32, LP - j0);
    for (int t0 = 0; t0 < jn; t0 += PPS * kUnroll) {
      bool inside[kUnroll][CPG];
      float w[kUnroll][CPG];
      float v[kUnroll][CPG][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * PPS + pj;
        const bool live = t < jn;
        const int ts = live ? t : 0;
        const float lx = __shfl_sync(kFull, mx, ts);
        const float ly = __shfl_sync(kFull, my, ts);
        const float a = __shfl_sync(kFull, ma, ts);
        const int l = (j0 + ts) / P;
        const int Wi = lv.w[l];
        const float Hf = (float)lv.h[l], Wf = (float)Wi;
        const float x = lx * Wf - 0.5f;
        const float y = ly * Hf - 0.5f;
        const float x0 = floorf(x), y0 = floorf(y);
        const float wx = x - x0, wy = y - y0;
        const float* vl = values + base + lv.start[l] * row_stride;
#pragma unroll
        for (int r = 0; r < CPG; ++r) {
          const int c = (gi & 3) + G * r;
          const int dy = c >> 1, dx = c & 1;
          const float cx = x0 + (float)dx, cy = y0 + (float)dy;
          // False for NaN as well; decided before any cast to int.
          inside[u][r] = live && cx >= 0.0f && cx < Wf && cy >= 0.0f && cy < Hf;
          w[u][r] = a * ((dx ? wx : 1.0f - wx) * (dy ? wy : 1.0f - wy));
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[u][r][e] = 0.0f;
          if (inside[u][r] && owns)
            load_vec<VEC>(vl + ((long long)(int)cy * Wi + (int)cx) * row_stride, v[u][r]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int r = 0; r < CPG; ++r) {
          if (!inside[u][r]) continue;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] += w[u][r] * v[u][r][e];
        }
      }
    }
  }

  // The groups' partial sums, combined across the warp.
#pragma unroll
  for (int off = GS; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(kFull, acc[e], off);
  }
  // out (B, Q, NH*D): ((b*Q + q)*NH + h)*D + d
  if (gi == 0 && owns) {
    float* o = out + gw * D + sub * VEC;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      *o = acc[0];
    }
  }
}

template <int VEC, int GS>
cudaError_t launch(const float* values, const float* loc, const float* attn, float* out,
                   long long n_warps, int S, int Q, int NH, int D, int L, int P,
                   const Levels& lv, cudaStream_t stream) {
  const long long blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  ms_deform_fwd_kernel<VEC, GS><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      values, loc, attn, out, n_warps, S, Q, NH, D, L, P, lv);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// values (B, S, NH, D), loc (B, Q, NH, L, P, 2), attn (B, Q, NH, L, P) →
// out (B, Q, NH*D); all float32, contiguous, on the device. level_hw is a
// host array [H_0, W_0, H_1, W_1, ...] of L levels with sum H_l*W_l == S.
// D <= 32, L <= 8. The 16-byte path needs D % 4 == 0 and values and out
// 16-byte aligned; otherwise the 4-byte path runs. Returns the launch's
// cudaError_t.
extern "C" int ms_deform_fwd_launch(const void* values, const void* loc, const void* attn,
                                    void* out, int B, int S, int Q, int NH, int D, int L,
                                    int P, const int* level_hw, void* stream) {
  if (L < 1 || L > kMaxLevels || D < 1 || D > 32 || P < 1) return (int)cudaErrorInvalidValue;
  Levels lv = {};
  long long start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    lv.start[l] = start;
    start += (long long)lv.h[l] * lv.w[l];
  }
  if (start != S) return (int)cudaErrorInvalidValue;
  const long long n_warps = (long long)B * Q * NH;
  if (n_warps == 0) return (int)cudaSuccess;
  const bool vec4 = D % 4 == 0 && aligned16(values) && aligned16(out);
  const int width = vec4 ? D / 4 : D;
  int gs = 1;
  while (gs < width) gs <<= 1;
  const float* v = static_cast<const float*>(values);
  const float* lc = static_cast<const float*>(loc);
  const float* at = static_cast<const float*>(attn);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MS_DEFORM_FWD_CASE(VEC, GS) \
  return (int)launch<VEC, GS>(v, lc, at, o, n_warps, S, Q, NH, D, L, P, lv, st)
  if (vec4) {
    switch (gs) {
      case 1: MS_DEFORM_FWD_CASE(4, 1);
      case 2: MS_DEFORM_FWD_CASE(4, 2);
      case 4: MS_DEFORM_FWD_CASE(4, 4);
      default: MS_DEFORM_FWD_CASE(4, 8);
    }
  }
  switch (gs) {
    case 1: MS_DEFORM_FWD_CASE(1, 1);
    case 2: MS_DEFORM_FWD_CASE(1, 2);
    case 4: MS_DEFORM_FWD_CASE(1, 4);
    case 8: MS_DEFORM_FWD_CASE(1, 8);
    case 16: MS_DEFORM_FWD_CASE(1, 16);
    default: MS_DEFORM_FWD_CASE(1, 32);
  }
#undef MS_DEFORM_FWD_CASE
}
