// Multi-scale deformable attention backward for NVIDIA Hopper (sm_90a).
//
// Replaces: multimodal_moe_tpu/ops/deformable_pallas.py:_bwd_kernel (the
// pallas_call of _bwd_rule) together with the elementwise part of _bwd_rule
// that turns its per-corner sums into d(loc) and d(attn). Given the output
// cotangent g it computes, for every sample point and each of its 4
// bilinear corners c = 2*dy + dx inside the map,
//   s_c = <g[b,q,h,:], values[b, start_l + cy*W_l + cx, h, :]>
//   dv[b, start_l + cy*W_l + cx, h, :] += attn[b,q,h,l,p] * bilinear_c * g[b,q,h,:]
// and from the four s_c of the point, in registers,
//   d_attn = sum_c bilinear_c * s_c
//   d_loc  = (W_l * sum_c s_c*attn*(+-wy_c), H_l * sum_c s_c*attn*(+-wx_c))
// in the fp32 operations, and the order, of
// ops/deformable.py:ms_deform_attn_loc_attn_grads (built with --fmad=false).
// A corner outside the map (NaN and +-inf locations fail the same test)
// adds exactly nothing to any output: it is skipped or selected out, never
// multiplied by a zero weight. s never leaves the chip.
//
// What bounds it on this card: bytes. Per (b, q, head) it reads up to L*P*4
// value rows of D floats and adds into as many dv rows, 2 flops per element
// read or added; dv itself (the size of `values`, 295 MB in the RT-DETR
// training step) is zeroed by the caller and written back by the atomics.
// Far below the ~20 flops per byte where fp32 arithmetic would be the limit.
//
// What the design does about it:
//   * One warp per (b, q, head). A value row is split into 16-byte pieces
//     where D % 4 == 0 (VEC = 4; else 4-byte pieces, VEC = 1), one piece a
//     lane, in a group of GS lanes (D/VEC rounded up to a power of 2). The
//     warp's 32/GS groups take that many corners at once: at D = 32 the 4
//     corners of one point, one per 8-lane group, each lane one
//     ld.global.nc.v4.f32. A corner's bounds test is a per-lane predicate,
//     not a warp branch.
//   * s_c reduces over its group in log2(GS) xor-shuffles (3 at D = 32).
//   * The dv add is one 16-byte vector atomic a lane (atomicAdd on float4,
//     Hopper only, global memory): 4x fewer atomic instructions than one
//     float each. cuobjdump -sass (CUDA 12.9) shows one vector reduction,
//     REDG.E.ADD.F32x4.FTZ.RN.STRONG.GPU, not four scalar ones; like the
//     scalar float atomic it flushes denormal sums to zero. Atomics resolve
//     in L2; a corner's adds hit one 128-byte row.
//   * Each lane carries its pending add: while the group's next corner hits
//     the same dv row, the add joins the carry instead of becoming a
//     reduction; the carry leaves when the row changes and at the end. The
//     points of one query often share pixels on the coarse levels (small
//     boxes, offsets near their initial pattern), and back-to-back
//     reductions of one warp on one row are what made those rows hot.
//   * Each step's loads start before any of its atomics or shuffles
//     (kUnroll steps at a time), so three 16-byte loads a lane are in flight.
//   * The point's d_attn and d_loc are gathered into the lane of that point
//     and leave in one coalesced store per output across the warp's points.
//   * Corner tests in float before any cast to int; 64-bit row offsets. The
//     kernel allocates nothing: the wrapper passes dv zeroed.
// Atomics add in an order that changes from run to run, so dv is not bitwise
// reproducible, and s_c is summed in another order than the plain version;
// ops/deformable_kernel.py:deform_bwd_tolerance bounds both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 3;  // steps whose loads are in flight together
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

template <int VEC>
__device__ __forceinline__ void red_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// Sum over the GS lanes of a group (GS a power of 2): every lane gets it.
template <int GS>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = GS / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One sample point as its group sees it.
template <int CPG, int VEC>
struct Step {
  float a, wx, wy, x0, y0, Wf, Hf;
  bool live;
  bool inside[CPG];
  long long row[CPG];
  float v[CPG][VEC];
};

template <int VEC, int GS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ms_deform_bwd_kernel(const float* __restrict__ values, const float* __restrict__ loc,
                     const float* __restrict__ attn, const float* __restrict__ g,
                     float* __restrict__ dv, float* __restrict__ d_loc,
                     float* __restrict__ d_attn, long long n_warps, int S, int Q, int NH, int D,
                     int L, int P, Levels lv) {
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

  float gv[VEC];
  // g (B, Q, NH*D): ((b*Q + q)*NH + h)*D + d
#pragma unroll
  for (int e = 0; e < VEC; ++e) gv[e] = 0.0f;
  if (owns) load_vec<VEC>(g + gw * D + sub * VEC, gv);

  long long prow[CPG];
  float pacc[CPG][VEC];
#pragma unroll
  for (int r = 0; r < CPG; ++r) {
    prow[r] = -1;
#pragma unroll
    for (int e = 0; e < VEC; ++e) pacc[r][e] = 0.0f;
  }
  for (int j0 = 0; j0 < LP; j0 += 32) {
    const int jl = j0 + lane;
    float mx = 0.0f, my = 0.0f, ma = 0.0f;
    if (jl < LP) {
      mx = gloc[2 * jl];
      my = gloc[2 * jl + 1];
      ma = gattn[jl];
    }
    const int jn = min(32, LP - j0);
    float res_attn = 0.0f, res_x = 0.0f, res_y = 0.0f;  // this lane's point, jl
    for (int t0 = 0; t0 < jn; t0 += PPS * kUnroll) {
      Step<CPG, VEC> st[kUnroll];
      // Geometry and loads of kUnroll steps first, so their loads overlap.
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        Step<CPG, VEC>& s = st[u];
        const int t = t0 + u * PPS + pj;
        s.live = t < jn;
        const int ts = s.live ? t : 0;
        const float lx = __shfl_sync(kFull, mx, ts);
        const float ly = __shfl_sync(kFull, my, ts);
        s.a = __shfl_sync(kFull, ma, ts);
        const int l = (j0 + ts) / P;
        const int Wi = lv.w[l];
        s.Hf = (float)lv.h[l];
        s.Wf = (float)Wi;
        const float x = lx * s.Wf - 0.5f;
        const float y = ly * s.Hf - 0.5f;
        s.x0 = floorf(x);
        s.y0 = floorf(y);
        s.wx = x - s.x0;
        s.wy = y - s.y0;
        const long long lbase = base + lv.start[l] * row_stride;
#pragma unroll
        for (int r = 0; r < CPG; ++r) {
          const int c = (gi & 3) + G * r;
          const float cx = s.x0 + (float)(c & 1), cy = s.y0 + (float)(c >> 1);
          // False for NaN as well; decided before any cast to int.
          s.inside[r] = s.live && cx >= 0.0f && cx < s.Wf && cy >= 0.0f && cy < s.Hf;
          s.row[r] = s.inside[r] ? lbase + ((long long)(int)cy * Wi + (int)cx) * row_stride : 0;
#pragma unroll
          for (int e = 0; e < VEC; ++e) s.v[r][e] = 0.0f;
          if (s.inside[r] && owns) load_vec<VEC>(values + s.row[r], s.v[r]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const Step<CPG, VEC>& s = st[u];
        float sr[CPG];
#pragma unroll
        for (int r = 0; r < CPG; ++r) {
          const int c = (gi & 3) + G * r;
          const int dy = c >> 1, dx = c & 1;
          float part = gv[0] * s.v[r][0];
#pragma unroll
          for (int e = 1; e < VEC; ++e) part += gv[e] * s.v[r][e];
          const float sum = group_sum<GS>(part);
          sr[r] = s.inside[r] ? sum : 0.0f;
          if (s.inside[r] && owns) {
            const float w = s.a * ((dx ? s.wx : 1.0f - s.wx) * (dy ? s.wy : 1.0f - s.wy));
            if (s.row[r] == prow[r]) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) pacc[r][e] += w * gv[e];
            } else {
              if (prow[r] >= 0) red_vec<VEC>(dv + prow[r], pacc[r]);
              prow[r] = s.row[r];
#pragma unroll
              for (int e = 0; e < VEC; ++e) pacc[r][e] = w * gv[e];
            }
          }
        }
        // The point's four corner sums, from the groups that made them.
        float da = 0.0f, dwx = 0.0f, dwy = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int dy = c >> 1, dx = c & 1;
          const float sc = __shfl_sync(kFull, sr[G >= 4 ? 0 : c / G], ((pj * 4 + c) % G) * GS);
          const float cx = s.x0 + (float)dx, cy = s.y0 + (float)dy;
          const bool in = s.live && cx >= 0.0f && cx < s.Wf && cy >= 0.0f && cy < s.Hf;
          const float wx_c = dx ? s.wx : 1.0f - s.wx;
          const float wy_c = dy ? s.wy : 1.0f - s.wy;
          // ms_deform_attn_loc_attn_grads, term by term.
          da = da + (in ? (wy_c * wx_c) * sc : 0.0f);
          dwx = dwx + (in ? (sc * s.a) * (wy_c * (dx ? 1.0f : -1.0f)) : 0.0f);
          dwy = dwy + (in ? (sc * s.a) * ((dy ? 1.0f : -1.0f) * wx_c) : 0.0f);
        }
        const float dlx = dwx * s.Wf, dly = dwy * s.Hf;
        // Hand each point's results to the lane of that point.
#pragma unroll
        for (int p = 0; p < PPS; ++p) {
          const int src = p * 4 * GS;
          const float ra = PPS > 1 ? __shfl_sync(kFull, da, src) : da;
          const float rx = PPS > 1 ? __shfl_sync(kFull, dlx, src) : dlx;
          const float ry = PPS > 1 ? __shfl_sync(kFull, dly, src) : dly;
          if (lane == t0 + u * PPS + p) {
            res_attn = ra;
            res_x = rx;
            res_y = ry;
          }
        }
      }
    }
    if (jl < LP) {
      d_attn[gw * LP + jl] = res_attn;
      reinterpret_cast<float2*>(d_loc)[gw * LP + jl] = make_float2(res_x, res_y);
    }
  }
#pragma unroll
  for (int r = 0; r < CPG; ++r)
    if (prow[r] >= 0) red_vec<VEC>(dv + prow[r], pacc[r]);
}

template <int VEC, int GS>
cudaError_t launch(const float* values, const float* loc, const float* attn, const float* g,
                   float* dv, float* d_loc, float* d_attn, long long n_warps, int S, int Q,
                   int NH, int D, int L, int P, const Levels& lv, cudaStream_t stream) {
  const long long blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  ms_deform_bwd_kernel<VEC, GS><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      values, loc, attn, g, dv, d_loc, d_attn, n_warps, S, Q, NH, D, L, P, lv);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// values (B, S, NH, D), loc (B, Q, NH, L, P, 2), attn (B, Q, NH, L, P),
// g (B, Q, NH*D) → dv (B, S, NH, D), added into (the caller zeroes it),
// d_loc (B, Q, NH, L, P, 2) and d_attn (B, Q, NH, L, P), written; all
// float32, contiguous, on the device; d_loc 8-byte aligned. level_hw is a
// host array [H_0, W_0, H_1, W_1, ...] of L levels with sum H_l*W_l == S.
// D <= 32, L <= 8. The 16-byte path needs D % 4 == 0 and values, g and dv
// 16-byte aligned; otherwise the 4-byte path runs. Returns the launch's
// cudaError_t.
extern "C" int ms_deform_bwd_launch(const void* values, const void* loc, const void* attn,
                                    const void* g, void* dv, void* d_loc, void* d_attn, int B,
                                    int S, int Q, int NH, int D, int L, int P,
                                    const int* level_hw, void* stream) {
  if (L < 1 || L > kMaxLevels || D < 1 || D > 32 || P < 1) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(d_loc) % 8 != 0) return (int)cudaErrorMisalignedAddress;
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
  const bool vec4 = D % 4 == 0 && aligned16(values) && aligned16(g) && aligned16(dv);
  const int width = vec4 ? D / 4 : D;
  int gs = 1;
  while (gs < width) gs <<= 1;
  const float* v = static_cast<const float*>(values);
  const float* lc = static_cast<const float*>(loc);
  const float* at = static_cast<const float*>(attn);
  const float* gg = static_cast<const float*>(g);
  float* dvp = static_cast<float*>(dv);
  float* dl = static_cast<float*>(d_loc);
  float* da = static_cast<float*>(d_attn);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MS_DEFORM_BWD_CASE(VEC, GS) \
  return (int)launch<VEC, GS>(v, lc, at, gg, dvp, dl, da, n_warps, S, Q, NH, D, L, P, lv, st)
  if (vec4) {
    switch (gs) {
      case 1: MS_DEFORM_BWD_CASE(4, 1);
      case 2: MS_DEFORM_BWD_CASE(4, 2);
      case 4: MS_DEFORM_BWD_CASE(4, 4);
      default: MS_DEFORM_BWD_CASE(4, 8);
    }
  }
  switch (gs) {
    case 1: MS_DEFORM_BWD_CASE(1, 1);
    case 2: MS_DEFORM_BWD_CASE(1, 2);
    case 4: MS_DEFORM_BWD_CASE(1, 4);
    case 8: MS_DEFORM_BWD_CASE(1, 8);
    case 16: MS_DEFORM_BWD_CASE(1, 16);
    default: MS_DEFORM_BWD_CASE(1, 32);
  }
#undef MS_DEFORM_BWD_CASE
}
