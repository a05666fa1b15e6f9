// Greedy NMS keep mask for NVIDIA Hopper (sm_90a).
//
// Replaces: multimodal_moe_tpu/ops/nms_pallas.py:_nms_keep_kernel.
// Computes the same function: over K score-sorted candidates per image, a
// candidate i that is valid and not yet removed removes every j > i whose
// IoU with it is >= iou_threshold (and, unless class_agnostic, whose class
// is the same; a different class counts as IoU 0). keep[b][j] = 1 for the
// candidates that survive.
//
// What bounds it on this card: not bytes (about B*K*28 bytes in and out).
// The operations are K(K-1)/2 IoUs an image of ~14 single fp32 operations
// each (no multiply-add: --fmad=false), at most half the card's 67 TFLOP/s.
// Beyond that bound sits the greedy walk, a chain of K steps of which each
// needs the outcome of every step before it.
//
// What the design does about it, for K <= kSmemMaxK = 1024: two launches.
//   Launch 1, the IoU bitmask (mask_kernel): a grid of C CTAs an image (C a
//     power of two chosen by the wrapper so that the grid fills the SMs
//     twice over), each with the image's boxes in shared memory. Work comes
//     in units of 64 rows x 32 columns of the upper triangle; the image's
//     CTAs take equal shares, a warp one unit at a time, a lane two rows:
//     the lane holds its rows' boxes in registers and sets bit jj of each
//     row's 32-bit word where row i removes column j = 32g + jj. Two rows a
//     lane halve the shared-memory loads a pair. The words go to a scratch
//     buffer in device memory (2.3 MB at B=128 K=512, 8.7 MB at K=1024; it
//     stays in the 50 MB L2 for launch 2).
//   Launch 2, the walk (walk_kernel): one CTA an image copies its mask into
//     shared memory with 16-byte loads, packs the valid flags into one bit
//     a candidate by warp ballots, and one warp walks, blocked by
//     32-candidate groups: lane g owns the "removed" word of group g. Lane
//     g loads its 32 diagonal rows into registers up front; at step g it
//     resolves its own 32 candidates against them with no load or shuffle
//     on the chain. One shuffle then gives every lane group g's kept rows,
//     and each lane g' > g ORs in its words of those rows, read as eight
//     16-byte loads issued together. The chain is G = K/32 such blocks.
//   Mask layout: group g keeps the words of rows 0..32g+31 only (the upper
//     triangle), at offset 16g(g+1) + 4g words: every group starts 16-byte
//     aligned, and eight lanes' 16-byte loads of one row block fall on 32
//     different banks. 68 KB at K=1024.
//   No division where the answer is known. For t <= 0 a pair of the same
//     class whose intersection is exactly 0 has IoU +0, or NaN where an
//     area is NaN, so its bit is !isnan(area_i + area_j). For t > 0 a
//     margin filter settles every pair whose IoU lies clearly off t, a zero
//     intersection included (0 < c_lo * den for any positive den): with
//     c_lo = fl(t(1 - 2^-20)), c_hi = fl(t(1 + 2^-20)) and
//     den = ((area_i + area_j) - inter) + 1e-7 as the reference computes it,
//       inter < fl(c_lo * den) implies inter/den < t(1 - 2^-21) < pred(t),
//         since fl(c_lo * den) <= t den (1 - 2^-20)(1 + 2^-24)^2, and the
//         gap below a normal t is at most 2^-23 t; so fl(inter/den) < t;
//       inter > fl(c_hi * den) implies inter/den > t, so fl(inter/den) >= t.
//     Both hold while c * den is a normal float: den >= 1e-7 and the filter
//     is on only for 2^-90 <= t <= 2^90 (off, every pair of the same class
//     divides). Where c_lo * den overflows, t > 1 and inter <= den (inter
//     <= min area), so the IoU is <= 1 < t and the bit is 0, as the test
//     says. A NaN den or inter fails both tests and divides. Only pairs
//     whose IoU is within a factor 1 +- 2^-20 of t, or NaN, reach the
//     division, in a pass over the columns where any lane of the warp
//     needs one. Built with -DNMS_MARGIN_FILTER=0 the kernel keeps only the
//     exact zero-intersection shortcut (for t > 0 a zero intersection has
//     IoU +0 or NaN, so its bit is 0); chip_smoke.py times that build
//     against this one. The wrapper loads the default build.
//
// Pools above kSmemMaxK = 1024 (any K; device memory for the scratch is
// the only limit): the same units, bits, mask layout and walk order, in two
// other launches, because the whole image no longer fits one CTA's shared
// memory (the packed mask is 267 KB at K = 2048, the boxes 433 KB at
// K = 18,018).
//   Launch 1 (mask_tiles_kernel): a warp keeps only its unit's column tile
//     (32 boxes, areas and classes: 768 bytes) in shared memory and its
//     lanes' two rows in registers, each loaded from device memory.
//   Launch 2 (walk_global_kernel): one CTA an image walks the mask where
//     launch 1 left it, in device memory (20 MB an image at K = 18,018,
//     mostly served from L2). Several warps, not one: thread t of the CTA
//     owns the "removed" words of groups t, t + 256, ... in shared memory
//     (4 bytes a group). At step g the owner of group g loads its 32
//     diagonal rows and resolves its candidates, publishes the kept bits
//     in shared memory (double-buffered, one __syncthreads a step), and
//     every thread ORs those rows' words into its own later groups with
//     eight 16-byte loads a group.
//   Scratch: group_offset and every offset into the scratch are 64-bit
//     (5.1 M words an image at K = 18,018: B = 128 passes 2^31 bytes).
//   A simple design, not tuned: at small B the mask launch leaves SMs idle,
//   and the walk waits on a device-memory load at every step.
//
// Exactness: the IoU is evaluated in the order of ops/boxes.py
// pairwise_iou, inter / (((area_i + area_j) - inter) + 1e-7f), with
// NaN-propagating min, max and clamp (PTX max.NaN / min.NaN), as
// torch.maximum, torch.minimum and clamp_min do. The file is compiled with
// --fmad=false so that no multiply-add is contracted. The division is IEEE
// (no fast math). Both designs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef NMS_MARGIN_FILTER
#define NMS_MARGIN_FILTER 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// The largest pool whose packed mask a walk CTA keeps in shared memory.
constexpr int kSmemMaxK = 1024;
// Shared memory a Hopper CTA can opt in to.
constexpr size_t kMaxSmemBytes = 232448;
constexpr unsigned kFull = 0xffffffffu;

// Offset, in 32-bit words, of group g's rows in the mask (rows 0..32g+31);
// group_offset(G) is the mask's size.
__host__ __device__ __forceinline__ long long group_offset(long long g) {
  return 16LL * g * (g + 1) + 4LL * g;
}

// Shared memory of a launch-1 CTA: boxes, areas and classes, padded to
// 32(G+1) entries.
__host__ __forceinline__ size_t mask_smem_bytes(int K) {
  const int G = (K + 31) / 32;
  return (size_t)(G + 1) * 32 * (16 + 8);
}

// Shared memory of a launch-2 CTA: the mask, the valid and removed words.
__host__ __forceinline__ size_t walk_smem_bytes(int K) {
  const int G = (K + 31) / 32;
  return (size_t)group_offset(G) * 4 + 64 * 4;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float area_of(float4 b) {
  return max_nan(b.z - b.x, 0.0f) * max_nan(b.w - b.y, 0.0f);
}

__device__ __forceinline__ float intersection(float4 a, float4 c) {
  const float w = max_nan(min_nan(a.z, c.z) - max_nan(a.x, c.x), 0.0f);
  const float h = max_nan(min_nan(a.w, c.w) - max_nan(a.y, c.y), 0.0f);
  return w * h;
}

// Unit index u -> (column group g, row block r2 of 64 rows), 64 r2 <= 32 g,
// in the order (0,0), (1,0), (2,0), (2,1), (3,0), (3,1), ... Group g has
// g/2 + 1 units, so units before group 2h number h(h+1), before 2h+1 (h+1)^2.
__device__ __forceinline__ void unit_of(int u, int& g, int& r2) {
  int s = (int)sqrtf((float)u);
  while (s * s > u) --s;
  while ((s + 1) * (s + 1) <= u) ++s;
  g = u >= s * s + s ? 2 * s : 2 * s - 1;
  const int h = g >> 1;
  r2 = u - ((g & 1) ? (h + 1) * (h + 1) : h * (h + 1));
}

__host__ __device__ __forceinline__ int n_units(int G) {
  const int h = G >> 1;
  return (G & 1) ? (h + 1) * (h + 1) : h * (h + 1);
}

// The columns of group g that row block r (32 rows, one a lane) may remove:
// j > i and j < K.
__device__ __forceinline__ uint32_t pair_columns(int g, int r, int K, int lane) {
  if (r > g) return 0u;
  const int j0 = 32 * g;
  uint32_t pairs = K - j0 >= 32 ? kFull : (1u << (K - j0)) - 1u;
  if (r == g) pairs &= lane == 31 ? 0u : kFull << (lane + 1);
  return pairs;
}

// The divisions a row's word still needs, one column at a time where any
// lane of the warp needs one.
__device__ __forceinline__ uint32_t divide_left(uint32_t word, uint32_t need, float4 a, float area_a,
                                                const float4* col, const float2* col_ac, float t) {
  uint32_t todo = __reduce_or_sync(kFull, need);
  while (todo) {
    const int jj = __ffs(todo) - 1;
    todo &= todo - 1u;
    if ((need >> jj) & 1u) {
      const float inter = intersection(a, col[jj]);
      const float iou = inter / (((area_a + col_ac[jj].x) - inter) + 1e-7f);
      word |= (uint32_t)(iou >= t) << jj;
    }
  }
  return word;
}

template <bool kAgnostic, bool kZeroHits>
__device__ __forceinline__ void pair_bits(float4 a, float2 aci, float4 c, float2 acj, float c_lo,
                                          float c_hi, uint32_t bit, uint32_t& word, uint32_t& need) {
  const bool same = kAgnostic || __float_as_int(aci.y) == __float_as_int(acj.y);
  const float inter = intersection(a, c);
  if (kZeroHits) {
    // t <= 0: an IoU of 0 counts. A different class is IoU 0; a zero
    // intersection is IoU +0 unless the area sum is NaN.
    const float s = aci.x + acj.x;
    const bool zero = inter == 0.0f;
    if (!same || (zero && s == s)) word |= bit;
    if (same && !zero) need |= bit;
  } else {
    // t > 0: the margin filter settles the pair, a zero intersection
    // included (0 < c_lo * den), or leaves it to the division.
    const float den = ((aci.x + acj.x) - inter) + 1e-7f;
    const bool sure = inter > c_hi * den;
    if (same && sure) word |= bit;
    if (same && !sure && !(inter < c_lo * den) && (NMS_MARGIN_FILTER || inter != 0.0f)) {
      need |= bit;
    }
  }
}

// One unit: rows i0 = 64 r2 + lane and i1 = i0 + 32 (boxes a0, a1; areas
// and class bits ac0, ac1) against columns 32g..32g+31 (col, col_ac).
// dst points at group g's words; row i's word goes to dst[i] for the rows
// group g keeps (i < 32(g+1)). Boxes past K are zeros; c_lo and c_hi are
// the margin filter's factors (NaN where the filter is off).
template <bool kAgnostic, bool kZeroHits>
__device__ __forceinline__ void unit_words(int g, int r2, int K, float t, float c_lo, float c_hi,
                                           float4 a0, float2 ac0, float4 a1, float2 ac1,
                                           const float4* col, const float2* col_ac,
                                           uint32_t* dst, int lane) {
  const int i0 = 64 * r2 + lane, i1 = i0 + 32;
  uint32_t word0 = 0u, need0 = 0u, word1 = 0u, need1 = 0u;
#pragma unroll
  for (int jj = 0; jj < 32; ++jj) {
    const float4 c = col[jj];
    const float2 acj = col_ac[jj];
    pair_bits<kAgnostic, kZeroHits>(a0, ac0, c, acj, c_lo, c_hi, 1u << jj, word0, need0);
    pair_bits<kAgnostic, kZeroHits>(a1, ac1, c, acj, c_lo, c_hi, 1u << jj, word1, need1);
  }
  const uint32_t pairs0 = pair_columns(g, 2 * r2, K, lane);
  const uint32_t pairs1 = pair_columns(g, 2 * r2 + 1, K, lane);
  word0 = divide_left(word0 & pairs0, need0 & pairs0, a0, ac0.x, col, col_ac, t);
  word1 = divide_left(word1 & pairs1, need1 & pairs1, a1, ac1.x, col, col_ac, t);
  const int rows = min(K, 32 * (g + 1));
  if (i0 < rows) dst[i0] = word0;
  if (i1 < rows) dst[i1] = word1;
}

// Phase 2 on one warp: the greedy walk over G groups of 32 candidates.
// On return remw[g] holds the removed bits of group g.
__device__ __forceinline__ void walk(const uint32_t* mask, const uint32_t* vbits,
                                     uint32_t* remw, int G, int lane) {
  uint32_t rem = lane < G ? ~vbits[lane] : kFull;
  const int own_group = min(lane, G - 1);
  const uint32_t* own = mask + group_offset(own_group);
  uint32_t diag[32];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const uint4 v = reinterpret_cast<const uint4*>(own + 32 * own_group)[p];
    diag[4 * p] = v.x;
    diag[4 * p + 1] = v.y;
    diag[4 * p + 2] = v.z;
    diag[4 * p + 3] = v.w;
  }
  for (int g = 0; g < G; ++g) {
    if (lane == g) {
      // Candidate q survives unless removed; a survivor removes its row's
      // bits.
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        if (!((rem >> q) & 1u)) rem |= diag[q];
      }
    }
    const uint32_t kept = ~__shfl_sync(kFull, rem, g);
    // Every lane reads its own group's words of group g's 32 rows (in
    // bounds for every lane); only lanes g < lane < G keep the result.
    const uint4* col = reinterpret_cast<const uint4*>(own + 32 * g);
    uint4 v[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) v[p] = col[p];
    uint32_t add[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const uint32_t k4 = kept >> (4 * p);
      add[0] |= (k4 & 1u) ? v[p].x : 0u;
      add[1] |= (k4 & 2u) ? v[p].y : 0u;
      add[2] |= (k4 & 4u) ? v[p].z : 0u;
      add[3] |= (k4 & 8u) ? v[p].w : 0u;
    }
    if (lane > g && lane < G) rem |= (add[0] | add[1]) | (add[2] | add[3]);
  }
  remw[lane] = rem;
}

// The margin filter's factors for threshold t (NaN: always divide).
__device__ __forceinline__ void filter_factors(float t, bool zero_hits, float& c_lo, float& c_hi) {
  const bool on = NMS_MARGIN_FILTER && !zero_hits && t >= 0x1p-90f && t <= 0x1p90f;
  c_lo = on ? t * (1.0f - 0x1p-20f) : __int_as_float(0x7fc00000);
  c_hi = on ? t * (1.0f + 0x1p-20f) : __int_as_float(0x7fc00000);
}

// Launch 1: image blockIdx.y's share blockIdx.x of gridDim.x of the
// mask's units, into scratch (group_offset(G) words an image).
template <bool kAgnostic, bool kZeroHits>
__global__ void __launch_bounds__(kThreads)
mask_kernel(const float4* __restrict__ boxes, const int* __restrict__ classes,
            uint32_t* __restrict__ scratch, int K, float t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = gridDim.x, rank = blockIdx.x, b = blockIdx.y;
  const int G = (K + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float c_lo, c_hi;
  filter_factors(t, kZeroHits, c_lo, c_hi);

  float4* sbox = reinterpret_cast<float4*>(smem_raw);             // 32 (G + 1)
  float2* sac = reinterpret_cast<float2*>(sbox + 32 * (G + 1));   // 32 (G + 1): area, class bits
  const size_t base = (size_t)b * K;
  for (int j = threadIdx.x; j < 32 * (G + 1); j += kThreads) {
    const float4 bx = j < K ? boxes[base + j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    sbox[j] = bx;
    sac[j] = make_float2(area_of(bx), j < K ? __int_as_float(classes[base + j]) : 0.0f);
  }
  __syncthreads();

  uint32_t* mask = scratch + (size_t)b * group_offset(G);
  const int units = n_units(G);
  const int u0 = (int)((long long)units * rank / C);
  const int u1 = (int)((long long)units * (rank + 1) / C);
  for (int u = u0 + warp; u < u1; u += kWarps) {
    int g, r2;
    unit_of(u, g, r2);
    const int i0 = 64 * r2 + lane;
    unit_words<kAgnostic, kZeroHits>(g, r2, K, t, c_lo, c_hi, sbox[i0], sac[i0], sbox[i0 + 32],
                                     sac[i0 + 32], sbox + 32 * g, sac + 32 * g,
                                     mask + group_offset(g), lane);
  }
}

// Box j of the image at base, zeros past K, and its area and class bits.
__device__ __forceinline__ float4 box_at(const float4* __restrict__ boxes, size_t base, int j,
                                         int K) {
  return j < K ? boxes[base + j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ float2 area_class_at(const int* __restrict__ classes, size_t base,
                                                int j, int K, float4 bx) {
  return make_float2(area_of(bx), j < K ? __int_as_float(classes[base + j]) : 0.0f);
}

// Launch 1 for K > kSmemMaxK: the units of mask_kernel, with only the
// unit's column tile in shared memory (one tile a warp) and the rows in
// registers. n_units(G) stays below 2^31 up to K = 2.9 M, whose mask would
// take a terabyte an image.
template <bool kAgnostic, bool kZeroHits>
__global__ void __launch_bounds__(kThreads)
mask_tiles_kernel(const float4* __restrict__ boxes, const int* __restrict__ classes,
                  uint32_t* __restrict__ scratch, int K, float t) {
  __shared__ float4 tile_box[kWarps][32];
  __shared__ float2 tile_ac[kWarps][32];
  const int C = gridDim.x, rank = blockIdx.x, b = blockIdx.y;
  const int G = (K + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float c_lo, c_hi;
  filter_factors(t, kZeroHits, c_lo, c_hi);

  const size_t base = (size_t)b * K;
  uint32_t* mask = scratch + (size_t)b * group_offset(G);
  const int units = n_units(G);
  const int u0 = (int)((long long)units * rank / C);
  const int u1 = (int)((long long)units * (rank + 1) / C);
  for (int u = u0 + warp; u < u1; u += kWarps) {
    int g, r2;
    unit_of(u, g, r2);
    const int j = 32 * g + lane, i0 = 64 * r2 + lane, i1 = i0 + 32;
    const float4 c = box_at(boxes, base, j, K);
    const float4 a0 = box_at(boxes, base, i0, K), a1 = box_at(boxes, base, i1, K);
    tile_box[warp][lane] = c;
    tile_ac[warp][lane] = area_class_at(classes, base, j, K, c);
    __syncwarp();
    unit_words<kAgnostic, kZeroHits>(g, r2, K, t, c_lo, c_hi, a0,
                                     area_class_at(classes, base, i0, K, a0), a1,
                                     area_class_at(classes, base, i1, K, a1), tile_box[warp],
                                     tile_ac[warp], mask + group_offset(g), lane);
    __syncwarp();  // the tile is read before the next unit overwrites it
  }
}

// Launch 2: image blockIdx.x's walk, from its mask in scratch.
__global__ void __launch_bounds__(kThreads)
walk_kernel(const int* __restrict__ valid, const uint32_t* __restrict__ scratch,
            int* __restrict__ keep, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int G = (K + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long words = group_offset(G);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem_raw);  // words
  uint32_t* vbits = mask + words;                          // 32
  uint32_t* remw = vbits + 32;                             // 32

  const uint4* src = reinterpret_cast<const uint4*>(scratch + (size_t)b * words);
  uint4* dst = reinterpret_cast<uint4*>(mask);
  for (int w = threadIdx.x; w < (int)(words / 4); w += kThreads) dst[w] = src[w];
  const size_t base = (size_t)b * K;
  for (int g = warp; g < G; g += kWarps) {
    const int j = 32 * g + lane;
    const unsigned bits = __ballot_sync(kFull, j < K && valid[base + min(j, K - 1)] != 0);
    if (lane == 0) vbits[g] = bits;
  }
  __syncthreads();

  if (warp == 0) walk(mask, vbits, remw, G, lane);
  __syncthreads();
  // A kept i never gets its own bit set (rows only cover j > i), so the
  // complement of "removed" is the keep set.
  for (int j = threadIdx.x; j < K; j += kThreads) {
    keep[base + j] = ((remw[j >> 5] >> (j & 31)) & 1u) ? 0 : 1;
  }
}

// Launch 2 for K > kSmemMaxK: image blockIdx.x's walk on its mask in
// scratch. Thread t owns the removed words of groups t, t + kThreads, ...
__global__ void __launch_bounds__(kThreads)
walk_global_kernel(const int* __restrict__ valid, const uint32_t* __restrict__ scratch,
                   int* __restrict__ keep, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int G = (K + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* remw = reinterpret_cast<uint32_t*>(smem_raw);  // G
  uint32_t* keptw = remw + G;                              // 2: step g's in keptw[g & 1]
  const uint32_t* mask = scratch + (size_t)b * group_offset(G);
  const size_t base = (size_t)b * K;
  for (int g = warp; g < G; g += kWarps) {
    const int j = 32 * g + lane;
    const unsigned bits = __ballot_sync(kFull, j < K && valid[base + min(j, K - 1)] != 0);
    if (lane == 0) remw[g] = ~bits;
  }
  __syncthreads();

  for (int g = 0; g < G; ++g) {
    // Group g's owner updated remw[g] itself at every earlier step.
    if (threadIdx.x == g % kThreads) {
      const uint4* row = reinterpret_cast<const uint4*>(mask + group_offset(g) + 32 * g);
      uint32_t diag[32];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const uint4 v = row[p];
        diag[4 * p] = v.x;
        diag[4 * p + 1] = v.y;
        diag[4 * p + 2] = v.z;
        diag[4 * p + 3] = v.w;
      }
      uint32_t rem = remw[g];
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        if (!((rem >> q) & 1u)) rem |= diag[q];
      }
      remw[g] = rem;
      keptw[g & 1] = ~rem;
    }
    __syncthreads();
    const uint32_t kept = keptw[g & 1];
    if (kept == 0u) continue;
    for (int h = threadIdx.x; h < G; h += kThreads) {
      if (h <= g) continue;
      const uint4* col = reinterpret_cast<const uint4*>(mask + group_offset(h) + 32 * g);
      uint4 v[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) v[p] = col[p];
      uint32_t add = 0u;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const uint32_t k4 = kept >> (4 * p);
        add |= (k4 & 1u) ? v[p].x : 0u;
        add |= (k4 & 2u) ? v[p].y : 0u;
        add |= (k4 & 4u) ? v[p].z : 0u;
        add |= (k4 & 8u) ? v[p].w : 0u;
      }
      remw[h] |= add;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < K; j += kThreads) {
    keep[base + j] = ((remw[j >> 5] >> (j & 31)) & 1u) ? 0 : 1;
  }
}

typedef void (*MaskFn)(const float4*, const int*, uint32_t*, int, float);

MaskFn mask_kernel_for(bool agnostic, bool zero_hits) {
  if (agnostic) return zero_hits ? mask_kernel<true, true> : mask_kernel<true, false>;
  return zero_hits ? mask_kernel<false, true> : mask_kernel<false, false>;
}

MaskFn mask_tiles_kernel_for(bool agnostic, bool zero_hits) {
  if (agnostic) return zero_hits ? mask_tiles_kernel<true, true> : mask_tiles_kernel<true, false>;
  return zero_hits ? mask_tiles_kernel<false, true> : mask_tiles_kernel<false, false>;
}

}  // namespace

// 32-bit words of scratch one image needs at pool K: its packed mask.
extern "C" long long nms_scratch_words(int K) { return group_offset((K + 31) / 32); }

// boxes (B, K, 4) f32, valid (B, K) i32, classes (B, K) i32 -> keep (B, K) i32,
// all contiguous on the device, any K >= 1; scratch holds
// B * nms_scratch_words(K) 32-bit words. `ctas` CTAs an image compute the
// mask. Returns the first
// failing cudaError_t, or cudaSuccess.
extern "C" int nms_keep_launch(const void* boxes, const void* valid, const void* classes,
                               void* keep, void* scratch, int B, int K, float iou_threshold,
                               int class_agnostic, int ctas, void* stream) {
  if (B <= 0 || K <= 0) return (int)cudaSuccess;
  if (ctas < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (K > kSmemMaxK) {
    // The walk's removed words: 4 bytes a group (above 48 KB only past
    // K = 393,000, whose mask would take 19 GB an image).
    const size_t walk_bytes = ((size_t)(K + 31) / 32 + 2) * 4;
    if (walk_bytes > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
    if (walk_bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(walk_global_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)walk_bytes);
      if (err != cudaSuccess) return (int)err;
    }
    mask_tiles_kernel_for(class_agnostic != 0, 0.0f >= iou_threshold)
        <<<dim3((unsigned)ctas, (unsigned)B), kThreads, 0, s>>>(
            static_cast<const float4*>(boxes), static_cast<const int*>(classes),
            static_cast<uint32_t*>(scratch), K, iou_threshold);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    walk_global_kernel<<<B, kThreads, walk_bytes, s>>>(
        static_cast<const int*>(valid), static_cast<const uint32_t*>(scratch),
        static_cast<int*>(keep), K);
    return (int)cudaGetLastError();
  }
  // The walk's shared memory exceeds 48 KB from K = 512 on: allowed once
  // per device.
  static bool walk_ready[64] = {};
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64) return (int)cudaErrorInvalidDevice;
  if (!walk_ready[device]) {
    err = cudaFuncSetAttribute(walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)walk_smem_bytes(kSmemMaxK));
    if (err != cudaSuccess) return (int)err;
    walk_ready[device] = true;
  }
  mask_kernel_for(class_agnostic != 0, 0.0f >= iou_threshold)
      <<<dim3((unsigned)ctas, (unsigned)B), kThreads, mask_smem_bytes(K), s>>>(
          static_cast<const float4*>(boxes), static_cast<const int*>(classes),
          static_cast<uint32_t*>(scratch), K, iou_threshold);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  walk_kernel<<<B, kThreads, walk_smem_bytes(K), s>>>(
      static_cast<const int*>(valid), static_cast<const uint32_t*>(scratch),
      static_cast<int*>(keep), K);
  return (int)cudaGetLastError();
}
