// Gram kernel for Hopper (sm_90a): out = XᵀX of a row-major [M, K] matrix.
//
// Replaces the TPU kernel of src/repro/kernels/gram.py:
//   gram_kernel_call (_gram_kernel) -> gram_*
//
// What it computes.  The K×K cofactor block Σ_m x_m x_mᵀ of the materialized
// ("noPre") design matrix.  The result is symmetric, so only the K(K+1)/2
// upper-triangle sums are formed; the finishing pass writes each to both
// halves, so the output is exactly symmetric.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s fp32 off the tensor
// cores).  Each of the M·K inputs is read once; the work is M·K(K+1) flops.
// At the noPre path's K = 5 that is 1.2 flops per byte, far under the
// card's ~20 flops/byte balance, so it is bound by bytes (18.6 M rows:
// 373 MB, ~0.11 ms).  At K ≈ 130 it crosses over and is bound by flops.
// The TPU kernel tiles the output into 128×128 MXU blocks over a sequential
// (i, j, m) grid; here blocks run in parallel, so each block owns a range of
// rows and writes its partial sums to a scratch [P, K(K+1)/2] array, and a
// second pass adds the P partials per entry (no atomics: the result does
// not depend on the order blocks finish).
//
// Two instantiations:
//  * K ≤ 8 ("small"): K is a template parameter; each thread keeps the
//    K(K+1)/2 sums in registers over a strided range of rows, then the block
//    reduces them with warp shuffles and shared memory.
//  * K > 8 ("tiled"): a block owns one 32×32 tile (ti ≤ tj) of the upper
//    triangle and one row range; it stages 32-row slices of the two column
//    panels in shared memory and each of its 256 threads accumulates four
//    entries of the tile.
//
// float inputs accumulate in float, double in double.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // tiled path: output tile edge
constexpr int kSlice = 32;     // tiled path: rows staged per step
constexpr unsigned kFull = 0xffffffffu;

// index of (i, j), i <= j, in the row-major upper triangle of a k×k matrix
__host__ __device__ __forceinline__ int64_t tri(int i, int j, int k) {
  return (int64_t)i * k - (int64_t)i * (i - 1) / 2 + (j - i);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// partial[blockIdx.x, :] = upper-triangle sums of the rows this block strides
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
gram_small(const T* __restrict__ x, int64_t m, T* __restrict__ partial) {
  constexpr int NT = K * (K + 1) / 2;
  T acc[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t] = T(0);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < m;
       row += stride) {
    T v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = x[row * K + j];
    int t = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
#pragma unroll
      for (int j = i; j < K; ++j) acc[t++] += v[i] * v[j];
    }
  }
  __shared__ T red[kWarps][NT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    T s = warp_sum(acc[t]);
    if (lane == 0) red[warp][t] = s;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < NT; t += blockDim.x) {
    T s = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][t];
    partial[(int64_t)blockIdx.x * NT + t] = s;
  }
}

// blockIdx.x: upper tile (ti <= tj) of the output; blockIdx.y: row range.
// partial[blockIdx.y, tri(i, j)] for the tile's entries with i <= j.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_tiled(const T* __restrict__ x, int64_t m, int k, int64_t rows_per_part,
           T* __restrict__ partial) {
  const int ntile = (k + kTile - 1) / kTile;
  int u = blockIdx.x, ti = 0;
  while (u >= ntile - ti) {  // row ti of the tile triangle has ntile-ti tiles
    u -= ntile - ti;
    ++ti;
  }
  const int tj = ti + u;
  __shared__ T a[kSlice][kTile + 1];
  __shared__ T b[kSlice][kTile + 1];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;  // ty in [0, 8)
  T acc[4] = {T(0), T(0), T(0), T(0)};
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_part;
  const int64_t r1 = r0 + rows_per_part < m ? r0 + rows_per_part : m;
  for (int64_t base = r0; base < r1; base += kSlice) {
    for (int e = threadIdx.x; e < kSlice * kTile; e += blockDim.x) {
      const int rr = e / kTile, cc = e % kTile;
      const int64_t row = base + rr;
      const int ca = ti * kTile + cc, cb = tj * kTile + cc;
      const bool in = row < r1;
      a[rr][cc] = (in && ca < k) ? x[row * k + ca] : T(0);
      b[rr][cc] = (in && cb < k) ? x[row * k + cb] : T(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kSlice; ++rr) {
      const T bv = b[rr][tx];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] += a[rr][ty + 8 * r] * bv;
    }
    __syncthreads();
  }
  const int nt = k * (k + 1) / 2;
  const int j = tj * kTile + tx;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ti * kTile + ty + 8 * r;
    if (i < k && j < k && i <= j)
      partial[(int64_t)blockIdx.y * nt + tri(i, j, k)] = acc[r];
  }
}

// One block per upper entry t: out[i, j] = out[j, i] = Σ_p partial[p, t].
template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_finish(const T* __restrict__ partial, int parts, int k,
            T* __restrict__ out) {
  const int nt = k * (k + 1) / 2;
  const int t = blockIdx.x;
  T s = T(0);
  for (int p = threadIdx.x; p < parts; p += blockDim.x)
    s += partial[(int64_t)p * nt + t];
  __shared__ T red[kWarps];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    T total = T(0);
    for (int w = 0; w < kWarps; ++w) total += red[w];
    int i = 0, rest = t;
    while (rest >= k - i) {
      rest -= k - i;
      ++i;
    }
    const int j = i + rest;
    out[(int64_t)i * k + j] = total;
    out[(int64_t)j * k + i] = total;
  }
}

template <typename T>
int launch_small(const T* x, int64_t m, int k, int parts, T* partial,
                 cudaStream_t s) {
  switch (k) {
#define GRAM_SMALL_CASE(KK)                                             \
  case KK:                                                              \
    gram_small<T, KK><<<parts, kThreads, 0, s>>>(x, m, partial);        \
    break;
    GRAM_SMALL_CASE(1)
    GRAM_SMALL_CASE(2)
    GRAM_SMALL_CASE(3)
    GRAM_SMALL_CASE(4)
    GRAM_SMALL_CASE(5)
    GRAM_SMALL_CASE(6)
    GRAM_SMALL_CASE(7)
    GRAM_SMALL_CASE(8)
#undef GRAM_SMALL_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* x, int64_t m, int k, int parts, T* partial, T* out,
           cudaStream_t s) {
  if (m <= 0 || k <= 0 || parts <= 0) return (int)cudaErrorInvalidValue;
  int err;
  if (k <= 8) {
    err = launch_small<T>(x, m, k, parts, partial, s);
  } else {
    const int ntile = (k + kTile - 1) / kTile;
    int64_t rows = (m + parts - 1) / parts;
    rows = (rows + kSlice - 1) / kSlice * kSlice;
    dim3 grid(ntile * (ntile + 1) / 2, parts);
    gram_tiled<T><<<grid, kThreads, 0, s>>>(x, m, k, rows, partial);
    err = (int)cudaGetLastError();
  }
  if (err != 0) return err;
  gram_finish<T><<<k * (k + 1) / 2, kThreads, 0, s>>>(partial, parts, k, out);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  ``x`` is a contiguous [m, k] matrix, ``partial``
// scratch of parts * k(k+1)/2 values, ``out`` the [k, k] result (every entry
// written).  ``parts`` is the number of row ranges: blocks of the small path,
// row splits of the tiled one.  Device memory on the caller's stream;
// returns a cudaError_t.
#define GRAM_API(T, SUFFIX)                                                 \
  extern "C" int gram_##SUFFIX(const T* x, int64_t m, int k, int parts,      \
                               T* partial, T* out, void* stream) {          \
    return launch<T>(x, m, k, parts, partial, out, (cudaStream_t)stream);   \
  }

GRAM_API(float, f32)
GRAM_API(double, f64)
