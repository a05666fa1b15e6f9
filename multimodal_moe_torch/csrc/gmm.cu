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
// Inputs float32 or bfloat16 (converted to float32 on load), sums and output
// float32 (megablox's preferred_element_type).
//
// What bounds it on this card: at the MoE-YOLO-s training step every launch
// is 2*M*K*N = 28.8 GFLOP against at most ~0.7 GB of traffic (level 0, first
// gmm: 225 MB in, 450 MB out), i.e. 40+ flops a byte in float32, past the
// fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20 flops a byte): the FMA units.
//
// What the design does about it:
//   * SIMT float32: a block makes a 128 x 128 output tile with 256 threads,
//     8 x 8 outputs a thread in registers (64 FMAs per 16 shared-memory
//     reads), the reduction in steps of 8 through two shared-memory buffers
//     (the next step's tile is fetched into registers while this one is
//     multiplied). Loads are 16 bytes (float32) or 8 bytes (bfloat16) a
//     thread. No tensor cores, no TMA, no wgmma: later work.
//   * gmm, tiles that straddle groups: megablox walks an ordered grid over a
//     tile->group table. Here a row tile finds the groups that intersect it
//     (prefix sums of the sizes in shared memory) and runs the reduction once
//     per group, loading the lhs rows of the other groups as zeros, so every
//     row takes its own expert's weights and gets exact zeros from the rest.
//     Empty groups are skipped. The extra passes are at most E - 1 per
//     column tile of the whole matrix.
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

constexpr int kThreads = 256;
constexpr int kBM = 128;   // output rows a block (gmm: token rows; tgmm: K rows)
constexpr int kBN = 128;   // output columns a block
constexpr int kBK = 8;     // reduction step
constexpr int kPad = 4;    // shared row padding (floats): conflict-free transposed stores
constexpr int kMaxE = 1024;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

struct Tiles {
  float a[2][kBK][kBM + kPad];  // a[k][row]
  float b[2][kBK][kBN + kPad];  // b[k][col]
};

// Group offsets off[0..E] (and, for tgmm, each group's chunk count and first
// work item) in shared memory: the sizes are read in parallel, the prefix
// sums by one thread (E is small).
__device__ void group_offsets(const int* __restrict__ sizes, int E, long long rows_per_chunk,
                              long long* off, int* chunk_start) {
  __shared__ int s_sizes[kMaxE];
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

// The register tile: thread (ty, tx) = (tid / 16, tid % 16) owns output rows
// ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns tx*4 + {0..3} and
// 64 + tx*4 + {0..3}.
__device__ __forceinline__ void mma_step(const Tiles& s, int buf, int ty, int tx,
                                         float (&acc)[8][8]) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&s.a[buf][k][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&s.a[buf][k][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&s.b[buf][k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&s.b[buf][k][64 + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Tile loaders. "Rows x 8" reads 128 rows of 8 consecutive reduction
// elements (two threads a row, 4 elements each) and stores them transposed
// (s[k][row]); "8 x cols" reads 8 reduction rows of 128 consecutive columns
// (32 threads a row) and stores them as they are (s[k][col]). Elements
// outside the valid range are zeros.
template <typename T>
__device__ __forceinline__ float4 rows_by_8(const T* __restrict__ x, long long ld, long long row,
                                            bool row_ok, int k, int kdim) {
  if (!row_ok || k >= kdim) return make_float4(0.f, 0.f, 0.f, 0.f);
  return load4(x + row * ld + k);
}
__device__ __forceinline__ void store_rows_by_8(float (&s)[kBK][kBM + kPad], int tid, float4 v) {
  const int r = tid >> 1, k = (tid & 1) * 4;
  s[k][r] = v.x;
  s[k + 1][r] = v.y;
  s[k + 2][r] = v.z;
  s[k + 3][r] = v.w;
}
template <typename T>
__device__ __forceinline__ float4 by_cols(const T* __restrict__ x, long long ld, long long row,
                                          bool row_ok, int col, int cdim) {
  if (!row_ok || col >= cdim) return make_float4(0.f, 0.f, 0.f, 0.f);
  return load4(x + row * ld + col);
}
__device__ __forceinline__ void store_by_cols(float (&s)[kBK][kBN + kPad], int tid, float4 v) {
  *reinterpret_cast<float4*>(&s[tid >> 5][(tid & 31) * 4]) = v;
}

// Write the register tile to out (ld columns), rows [row0, row_end),
// columns below ncols (a multiple of 4).
__device__ __forceinline__ void store_tile(float* __restrict__ out, long long ld, long long row0,
                                           long long row_end, int col0, int ncols, int ty, int tx,
                                           const float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= row_end) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * 64 + tx * 4;
      if (c >= ncols) continue;
      *reinterpret_cast<float4*>(out + r * ld + c) =
          make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
    }
  }
}

// gmm: block (x, y) makes rows [x*128, x*128 + 128) and columns
// [y*128, y*128 + 128) of out (M, N); K is the reduction length.
template <typename TA, typename TB, bool kTransRhs>
__global__ void __launch_bounds__(kThreads, 2)
gmm_kernel(const TA* __restrict__ lhs, const TB* __restrict__ rhs, const int* __restrict__ sizes,
           float* __restrict__ out, long long M, int K, int N, int E) {
  __shared__ __align__(16) Tiles s;
  __shared__ long long off[kMaxE + 1];
  __shared__ int first_group;
  group_offsets(sizes, E, 1, off, nullptr);

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long row0 = (long long)blockIdx.x * kBM;
  const long long row_end = min(row0 + kBM, M);
  const int col0 = blockIdx.y * kBN;
  if (tid == 0) {
    int g = 0;
    while (g < E && off[g + 1] <= row0) ++g;
    first_group = g;
  }
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  // This thread's load slots: lhs row a_row, reduction offset a_k; rhs row
  // (or, transposed, column) b_row and column b_col.
  const long long a_row = row0 + (tid >> 1);
  const int a_k = (tid & 1) * 4;
  const int b_k = tid >> 5, b_col = col0 + (tid & 31) * 4;  // rhs (K, N)
  const int bt_n = col0 + (tid >> 1), bt_k = (tid & 1) * 4;  // rhs^T: rhs (N, K)
  const int steps = (K + kBK - 1) / kBK;

  // Every thread runs the same loop: off[] and first_group are shared.
  for (int g = first_group; g < E && off[g] < row_end; ++g) {
    const long long lo = max(row0, off[g]), hi = min(row_end, off[g + 1]);
    if (lo >= hi) continue;  // an empty group
    const TB* w = rhs + (long long)g * K * N;
    const bool a_ok = a_row >= lo && a_row < hi;

    auto fetch_a = [&](int k0) { return rows_by_8(lhs, K, a_row, a_ok, k0 + a_k, K); };
    auto fetch_b = [&](int k0) {
      return kTransRhs ? rows_by_8(w, K, bt_n, bt_n < N, k0 + bt_k, K)
                       : by_cols(w, N, k0 + b_k, k0 + b_k < K, b_col, N);
    };
    auto put_b = [&](int buf, float4 v) {
      if (kTransRhs) {
        store_rows_by_8(s.b[buf], tid, v);
      } else {
        store_by_cols(s.b[buf], tid, v);
      }
    };

    float4 ra = fetch_a(0), rb = fetch_b(0);
    store_rows_by_8(s.a[0], tid, ra);
    put_b(0, rb);
    __syncthreads();
    for (int step = 0; step < steps; ++step) {
      const int cur = step & 1;
      const bool more = step + 1 < steps;
      if (more) {
        ra = fetch_a((step + 1) * kBK);
        rb = fetch_b((step + 1) * kBK);
      }
      mma_step(s, cur, ty, tx, acc);
      if (more) {
        store_rows_by_8(s.a[cur ^ 1], tid, ra);
        put_b(cur ^ 1, rb);
      }
      __syncthreads();
    }
  }
  store_tile(out, N, row0, row_end, col0, N, ty, tx, acc);
}

// tgmm, first pass: work item blockIdx.x = (group g, chunk c of its segment)
// makes the partial sum of lhs[rows]^T . rhs[rows] over the chunk's rows for
// the (128 x 128) tile blockIdx.y of the (K, N) output, into partial[w].
template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads, 2)
tgmm_partial_kernel(const TA* __restrict__ lhs, const TB* __restrict__ rhs,
                    const int* __restrict__ sizes, float* __restrict__ partial, long long M, int K,
                    int N, int E, long long rows_per_chunk) {
  __shared__ __align__(16) Tiles s;
  __shared__ long long off[kMaxE + 1];
  __shared__ int chunk_start[kMaxE + 1];
  __shared__ int my_group;
  group_offsets(sizes, E, rows_per_chunk, off, chunk_start);

  const int w = blockIdx.x;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  if (tid == 0) {
    int g = 0;
    while (g < E && chunk_start[g + 1] <= w) ++g;
    my_group = g;
  }
  __syncthreads();
  const int g = my_group;
  if (g >= E) return;  // a spare work item (uniform across the block)

  const int tiles_n = (N + kBN - 1) / kBN;
  const int k0 = (blockIdx.y / tiles_n) * kBM, n0 = (blockIdx.y % tiles_n) * kBN;
  const long long lo = off[g] + (long long)(w - chunk_start[g]) * rows_per_chunk;
  const long long hi = min(min(lo + rows_per_chunk, off[g + 1]), M);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  const int r = tid >> 5, c = (tid & 31) * 4;
  const int steps = (int)((hi - lo + kBK - 1) / kBK);
  auto fetch_a = [&](long long m0) { return by_cols(lhs, K, m0 + r, m0 + r < hi, k0 + c, K); };
  auto fetch_b = [&](long long m0) { return by_cols(rhs, N, m0 + r, m0 + r < hi, n0 + c, N); };

  if (steps > 0) {
    float4 ra = fetch_a(lo), rb = fetch_b(lo);
    store_by_cols(s.a[0], tid, ra);
    store_by_cols(s.b[0], tid, rb);
    __syncthreads();
    for (int step = 0; step < steps; ++step) {
      const int cur = step & 1;
      const bool more = step + 1 < steps;
      if (more) {
        ra = fetch_a(lo + (long long)(step + 1) * kBK);
        rb = fetch_b(lo + (long long)(step + 1) * kBK);
      }
      mma_step(s, cur, ty, tx, acc);
      if (more) {
        store_by_cols(s.a[cur ^ 1], tid, ra);
        store_by_cols(s.b[cur ^ 1], tid, rb);
      }
      __syncthreads();
    }
  }
  store_tile(partial + (long long)w * K * N, N, k0, K, n0, N, ty, tx, acc);
}

// tgmm, second pass: out[g, k, n] = sum over g's chunks, in chunk order, of
// partial[chunk_start[g] + c, k, n]; zeros for a group without rows.
__global__ void __launch_bounds__(kThreads)
tgmm_reduce_kernel(const float* __restrict__ partial, const int* __restrict__ sizes,
                   float* __restrict__ out, int K, int N, int E, long long rows_per_chunk) {
  __shared__ long long off[kMaxE + 1];
  __shared__ int chunk_start[kMaxE + 1];
  group_offsets(sizes, E, rows_per_chunk, off, chunk_start);
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

template <typename TA, typename TB>
int launch_gmm(const void* lhs, const void* rhs, const int* sizes, float* out, long long M, int K,
               int N, int E, bool trans, cudaStream_t stream) {
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((N + kBN - 1) / kBN));
  if (trans) {
    gmm_kernel<TA, TB, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const TA*>(lhs), static_cast<const TB*>(rhs), sizes, out, M, K, N, E);
  } else {
    gmm_kernel<TA, TB, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const TA*>(lhs), static_cast<const TB*>(rhs), sizes, out, M, K, N, E);
  }
  return (int)cudaGetLastError();
}

template <typename TA, typename TB>
int launch_tgmm(const void* lhs, const void* rhs, const int* sizes, float* partial, float* out,
                long long M, int K, int N, int E, long long rows_per_chunk, int work_items,
                cudaStream_t stream) {
  const int tiles = ((K + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  tgmm_partial_kernel<TA, TB><<<dim3((unsigned)work_items, (unsigned)tiles), kThreads, 0, stream>>>(
      static_cast<const TA*>(lhs), static_cast<const TB*>(rhs), sizes, partial, M, K, N, E,
      rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)E * K * N;
  const long long need = (total + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(need < 65536 ? need : 65536);
  tgmm_reduce_kernel<<<blocks, kThreads, 0, stream>>>(partial, sizes, out, K, N, E, rows_per_chunk);
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
  if (lhs_bf16 && rhs_bf16) return launch_gmm<bf16, bf16>(lhs, rhs, group_sizes, out, M, K, N, E, t, s);
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
