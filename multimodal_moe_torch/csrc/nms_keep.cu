// Greedy NMS keep mask for NVIDIA Hopper (sm_90a).
//
// Replaces: multimodal_moe_tpu/ops/nms_pallas.py:_nms_keep_kernel.
// Computes the same function: over K score-sorted candidates per image, a
// candidate i that is valid and not yet removed removes every j > i whose
// IoU with it is >= iou_threshold (and, unless class_agnostic, whose class
// is the same; a different class counts as IoU 0). keep[b][j] = 1 for the
// candidates that survive.
//
// What bounds it on this card: not bytes (about B*K*28 bytes in and out)
// and hardly operations (B*K*(K-1)/2 IoUs of ~14 fp32 operations each, a
// few microseconds at the fp32 rate). The limit is the K-step serial chain
// of the greedy walk: step i needs the outcome of every step before it.
//
// What the design does about it: one block per image.
//   Phase 1 (all threads): every IoU test is made up front, in parallel,
//     into a suppression bitmask in shared memory, M[w][i] = 64 bits over
//     j in [64w, 64w+64), set where j > i and i suppresses j. Stored
//     word-major with a row pitch of K+1 words, so that the phase-1 stores
//     (consecutive i) and the phase-2 loads (consecutive w) are free of bank
//     conflicts.
//   Phase 2 (one warp): lane w holds the 64-bit "removed" word w in a
//     register. Step i reads bit i with one shuffle; if i survives, each
//     lane ORs in word w of row i. No IoU arithmetic is left on the chain.
// Shared memory: K*16 B of boxes, K*4 B of classes and ceil(K/64)*(K+1)*8 B
// of mask; 152 KB at K=1024, so K is limited to what 227 KB hold.
//
// Exactness: the IoU is evaluated in the order of ops/boxes.py
// pairwise_iou, inter / (((area_i + area_j) - inter) + 1e-7f). The file
// is compiled with --fmad=false so that no multiply-add is contracted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float area_of(float4 b) {
  return fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
}

__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float4* __restrict__ boxes, const int* __restrict__ valid,
                const int* __restrict__ classes, int* __restrict__ keep,
                int K, float iou_threshold, int class_agnostic) {
  extern __shared__ unsigned long long smem[];
  const int W = (K + 63) / 64;
  const int ld = K + 1;
  unsigned long long* mask = smem;                                  // W * ld
  float4* sbox = reinterpret_cast<float4*>(mask + (size_t)W * ld);  // K
  int* scls = reinterpret_cast<int*>(sbox + K);                     // K

  const int b = blockIdx.x;
  const float4* gbox = boxes + (size_t)b * K;
  const int* gvalid = valid + (size_t)b * K;
  const int* gcls = classes + (size_t)b * K;
  int* gkeep = keep + (size_t)b * K;

  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    sbox[j] = gbox[j];
    scls[j] = gcls[j];
  }
  __syncthreads();

  // Phase 1: task t = w*K + i, so a warp shares one column word w (the
  // column boxes are broadcast reads) and stores to consecutive i.
  for (int t = threadIdx.x; t < W * K; t += blockDim.x) {
    const int w = t / K;
    const int i = t - w * K;
    unsigned long long bits = 0ull;
    const int j0 = w * 64;
    if (j0 + 63 > i) {
      const float4 a = sbox[i];
      const float area_a = area_of(a);
      const int ca = scls[i];
      const int jstart = max(j0, i + 1);
      const int jend = min(j0 + 64, K);
      for (int j = jstart; j < jend; ++j) {
        const float4 c = sbox[j];
        const float iw = fmaxf(fminf(a.z, c.z) - fmaxf(a.x, c.x), 0.0f);
        const float ih = fmaxf(fminf(a.w, c.w) - fmaxf(a.y, c.y), 0.0f);
        const float inter = iw * ih;
        const float uni = (area_a + area_of(c)) - inter;
        float iou = inter / (uni + 1e-7f);
        if (!class_agnostic && scls[j] != ca) iou = 0.0f;
        if (iou >= iou_threshold) bits |= 1ull << (j - j0);
      }
    }
    mask[(size_t)w * ld + i] = bits;
  }
  __syncthreads();

  // Phase 2: the serial walk, one warp.
  unsigned long long* removed_out = mask;  // reuses row 0 after the walk
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned long long removed = 0ull;
    for (int w = 0; w < W; ++w) {
      const int j_lo = w * 64 + lane;
      const int j_hi = j_lo + 32;
      const unsigned lo = __ballot_sync(kFull, j_lo >= K || gvalid[min(j_lo, K - 1)] == 0);
      const unsigned hi = __ballot_sync(kFull, j_hi >= K || gvalid[min(j_hi, K - 1)] == 0);
      if (lane == w) removed = (unsigned long long)lo | ((unsigned long long)hi << 32);
    }
    for (int i = 0; i < K; ++i) {
      const unsigned long long rw = __shfl_sync(kFull, removed, i >> 6);
      if (!((rw >> (i & 63)) & 1ull) && lane < W) {
        removed |= mask[(size_t)lane * ld + i];
      }
    }
    __syncwarp();
    if (lane < W) removed_out[lane] = removed;
  }
  __syncthreads();
  // A kept i never gets its own bit set (rows only cover j > i), so the
  // final complement of "removed" is the keep set.
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    gkeep[j] = ((removed_out[j >> 6] >> (j & 63)) & 1ull) ? 0 : 1;
  }
}

}  // namespace

static size_t nms_keep_smem_bytes(int K) {  // mirrors ops/nms_kernel.py smem_bytes
  const size_t W = (K + 63) / 64;
  return W * (size_t)(K + 1) * 8 + (size_t)K * 16 + (size_t)K * 4;
}

// boxes (B, K, 4) f32, valid (B, K) i32, classes (B, K) i32 → keep (B, K) i32,
// all contiguous on the device. Returns the launch's cudaError_t.
extern "C" int nms_keep_launch(const void* boxes, const void* valid,
                               const void* classes, void* keep, int B, int K,
                               float iou_threshold, int class_agnostic,
                               void* stream) {
  if (B <= 0 || K <= 0) return (int)cudaSuccess;
  const size_t smem = nms_keep_smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_keep_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(valid),
      static_cast<const int*>(classes), static_cast<int*>(keep), K,
      iou_threshold, class_agnostic);
  return (int)cudaGetLastError();
}
