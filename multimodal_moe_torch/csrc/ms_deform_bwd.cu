// Multi-scale deformable attention backward for NVIDIA Hopper (sm_90a).
//
// Replaces: multimodal_moe_tpu/ops/deformable_pallas.py:_bwd_kernel (the
// pallas_call of _bwd_rule). Given the output cotangent g it computes, for
// every sample point and each of its 4 bilinear corners c = 2*dy + dx,
//   s[b,q,h,l,p,c] = <g[b,q,h,:], values[b, start_l + cy*W_l + cx, h, :]>
//   dv[b, start_l + cy*W_l + cx, h, :] += attn[b,q,h,l,p] * bilinear_c * g[b,q,h,:]
// for the corners inside the map; a corner outside gets s = 0 and adds
// nothing (grid_sample's zero padding, align_corners=False, as the forward
// in ms_deform_fwd.cu). d(loc) and d(attn) follow from s elementwise, outside
// the kernel (ops/deformable.py:ms_deform_attn_loc_attn_grads), as the TPU
// code computes them outside its kernel too.
//
// What bounds it on this card: bytes. Per (b, q, head) it reads L*P*4 value
// rows of D floats and adds into as many dv rows, with 2 flops per element
// read or added; dv itself (the size of `values`, 295 MB in the RT-DETR
// training step) must be written once. Far below the ~20 flops per byte
// where fp32 arithmetic would be the limit.
//
// What the design does about it:
//   * The TPU kernel owns one (batch, head) value slab in VMEM and adds into
//     it with a sequential read-modify-write: its grid runs in order. Blocks
//     on Hopper run unordered and a ~2.3 MB slab does not fit 227 KB, so dv
//     lives in device memory and the sums into it are fp32 atomicAdd. One
//     warp per (b, q, head), lane = channel: at D=32 a corner's 32 adds hit
//     one 128-byte row, one coalesced reduction transaction, resolved in L2.
//   * s is a warp-shuffle reduction of g[lane]*V_c[lane]; lane 0 writes the
//     four corners of a point as one 16-byte store.
//   * Geometry is the forward kernel's, computed identically by every lane,
//     so the in-bounds branches are warp-uniform; corner tests in float
//     before any cast to int, 64-bit row offsets.
//   * The kernel allocates nothing: the wrapper passes dv zeroed and s.
// Atomics add in an order that changes from run to run, so dv is not bitwise
// reproducible; its tolerance is stated where it is compared.

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Lane d owns channel d; lanes d >= D only help with the geometry.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ms_deform_bwd_kernel(const float* __restrict__ values, const float* __restrict__ loc,
                     const float* __restrict__ attn, const float* __restrict__ g,
                     float* __restrict__ dv, float* __restrict__ s, long long n_warps, int S,
                     int Q, int NH, int D, int L, int P, Levels lv) {
  const long long gw = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (gw >= n_warps) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  // gw = (b*Q + q)*NH + h, the row-major index of (b, q, h).
  const int h = (int)(gw % NH);
  const long long b = gw / NH / Q;
  const int LP = L * P;
  const float* gloc = loc + gw * LP * 2;
  const float* gattn = attn + gw * LP;
  float4* gs = reinterpret_cast<float4*>(s + gw * LP * 4);
  const long long row_stride = (long long)NH * D;
  const long long base = b * S * row_stride + (long long)h * D;

  const bool owns = lane < D;
  // g (B, Q, NH*D): ((b*Q + q)*NH + h)*D + d
  const float gd = owns ? g[gw * D + lane] : 0.0f;

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
      const long long lbase = base + lv.start[l] * row_stride;
      float sc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int dy = c >> 1, dx = c & 1;
        const float cx = x0 + (float)dx, cy = y0 + (float)dy;
        sc[c] = 0.0f;
        // False for NaN as well; decided before any cast to int.
        if (!(cx >= 0.0f && cx < Wf && cy >= 0.0f && cy < Hf)) continue;
        const float w = a * ((dx ? wx : 1.0f - wx) * (dy ? wy : 1.0f - wy));
        const long long row = lbase + ((long long)(int)cy * Wi + (int)cx) * row_stride;
        const float v = owns ? __ldg(values + row + lane) : 0.0f;
        sc[c] = warp_sum(gd * v);
        if (owns) atomicAdd(dv + row + lane, w * gd);
      }
      if (lane == 0) gs[j0 + t] = make_float4(sc[0], sc[1], sc[2], sc[3]);
    }
  }
}

}  // namespace

// values (B, S, NH, D), loc (B, Q, NH, L, P, 2), attn (B, Q, NH, L, P),
// g (B, Q, NH*D) → dv (B, S, NH, D), added into (the caller zeroes it), and
// s (B, Q, NH, L, P, 4), written; all float32, contiguous, on the device; s
// 16-byte aligned. level_hw is a host array [H_0, W_0, H_1, W_1, ...] of L
// levels with sum H_l*W_l == S. D <= 32, L <= 8. Returns the launch's
// cudaError_t.
extern "C" int ms_deform_bwd_launch(const void* values, const void* loc, const void* attn,
                                    const void* g, void* dv, void* s, int B, int S, int Q,
                                    int NH, int D, int L, int P, const int* level_hw,
                                    void* stream) {
  if (L < 1 || L > kMaxLevels || D < 1 || D > 32 || P < 1) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(s) % 16 != 0) return (int)cudaErrorMisalignedAddress;
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
  ms_deform_bwd_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const float*>(g), static_cast<float*>(dv),
      static_cast<float*>(s), n_warps, S, Q, NH, D, L, P, lv);
  return (int)cudaGetLastError();
}
