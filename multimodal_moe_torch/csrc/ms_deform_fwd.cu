// Multi-scale deformable attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces: multimodal_moe_tpu/ops/deformable_pallas.py:_fwd_kernel, together
// with the XLA precompute around it (_slot_weights, _prep).
// Computes the same function as ops/deformable.py:ms_deformable_attention:
//   out[b, q, h, :] = sum over level l, point p, corner c of
//       attn[b,q,h,l,p] * bilinear_c * values[b, start_l + cy*W_l + cx, h, :]
// with x = loc_x*W_l - 0.5, y = loc_y*H_l - 0.5 (grid_sample with
// align_corners=False) and zero padding: a corner outside the map adds
// nothing.
//
// What bounds it on this card: bytes. Per (b, q, head) it reads L*P*4 value
// rows of D floats (4*D bytes each) and does 2*D flops on each, 0.5 flop per
// byte, far below the ~20 flops per byte (67 TFLOP/s over 3.35 TB/s) where
// fp32 arithmetic would be the limit.
//
// What the design does about it:
//   * One warp per (b, q, head), lane = channel (D <= 32, the port's head
//     widths are 8, 16 and 32). In the (B, SumHW, NH, D) layout a value row of one head is contiguous,
//     so at D=32 each corner read is one coalesced 128-byte line; no
//     transpose of `values` is made.
//   * Every lane computes the same geometry, so the in-bounds branches are
//     warp-uniform. The L*P locations and weights of the warp's query are
//     read once, one point per lane, coalesced, and broadcast by shuffles.
//   * The bilinear weights and the sum stay in registers: nothing but the
//     (B, Q, NH*D) output is written to device memory. The TPU design's
//     on-chip value slab (~2.3 MB per (batch, head)) does not fit a Hopper
//     block; rows come from device memory through the 50 MB L2 instead.
//   * Corner tests are made in float before any cast to int, so a location
//     far out of range never overflows an int; row offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long start[kMaxLevels];  // first row of the level on the SumHW axis
};

// Lane d owns channel d; lanes d >= D only help with the geometry.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ms_deform_fwd_kernel(const float* __restrict__ values, const float* __restrict__ loc,
                     const float* __restrict__ attn, float* __restrict__ out,
                     long long n_warps, int S, int Q, int NH, int D, int L, int P,
                     Levels lv) {
  const long long gw = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (gw >= n_warps) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  // gw = (b*Q + q)*NH + h, the row-major index of (b, q, h).
  const int h = (int)(gw % NH);
  const long long b = gw / NH / Q;
  const int LP = L * P;
  const float* gloc = loc + gw * LP * 2;
  const float* gattn = attn + gw * LP;
  const long long row_stride = (long long)NH * D;
  const float* vbase = values + b * S * row_stride + (long long)h * D;

  const bool owns = lane < D;
  float acc = 0.0f;

  for (int j0 = 0; j0 < LP; j0 += 32) {
    const int jl = j0 + lane;
    float mx = 0.0f, my = 0.0f, ma = 0.0f;
    if (jl < LP) {
      mx = gloc[2 * jl];
      my = gloc[2 * jl + 1];
      ma = gattn[jl];
    }
    const int jn = min(32, LP - j0);
    for (int t = 0; t < jn; ++t) {
      const float lx = __shfl_sync(kFull, mx, t);
      const float ly = __shfl_sync(kFull, my, t);
      const float a = __shfl_sync(kFull, ma, t);
      const int l = (j0 + t) / P;
      const int Hi = lv.h[l], Wi = lv.w[l];
      const float Hf = (float)Hi, Wf = (float)Wi;
      const float x = lx * Wf - 0.5f;
      const float y = ly * Hf - 0.5f;
      const float x0 = floorf(x), y0 = floorf(y);
      const float wx = x - x0, wy = y - y0;
      const float* vl = vbase + lv.start[l] * row_stride;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int dy = c >> 1, dx = c & 1;
        const float cx = x0 + (float)dx, cy = y0 + (float)dy;
        // False for NaN as well; decided before any cast to int.
        if (!(cx >= 0.0f && cx < Wf && cy >= 0.0f && cy < Hf)) continue;
        const float w = a * ((dx ? wx : 1.0f - wx) * (dy ? wy : 1.0f - wy));
        const float* row = vl + ((long long)(int)cy * Wi + (int)cx) * row_stride;
        if (owns) acc += w * __ldg(row + lane);
      }
    }
  }

  // out (B, Q, NH*D): ((b*Q + q)*NH + h)*D + d
  if (owns) out[gw * D + lane] = acc;
}

}  // namespace

// values (B, S, NH, D), loc (B, Q, NH, L, P, 2), attn (B, Q, NH, L, P) →
// out (B, Q, NH*D); all float32, contiguous, on the device. level_hw is a
// host array [H_0, W_0, H_1, W_1, ...] of L levels with sum H_l*W_l == S.
// D <= 32, L <= 8. Returns the launch's cudaError_t.
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
  const long long blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ms_deform_fwd_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<float*>(out), n_warps, S, Q, NH, D, L, P,
      lv);
  return (int)cudaGetLastError();
}
