// Grouped Gram kernels for Hopper (sm_90a): per-group cofactor blocks
// out[g] = Σ_{seg[m] = g} x_m x_mᵀ, for one or several segment-id columns.
//
// Replaces the TPU kernels of src/repro/kernels/segment_gram.py:
//   segment_gram_kernel_call       (_segment_gram_kernel)       -> segment_gram_*
//   multi_segment_gram_kernel_call (_multi_segment_gram_kernel) -> multi_segment_gram_*
//
// What they compute.  x is a row-major [M, K] matrix (callers put a column of
// ones first, so each block carries count, sums and Gram at once) and segs a
// row-major [M, n_seg] int32 matrix of group ids.  Column c's ids index its
// own band of G_c groups; the bands lie side by side in one [ΣG, K, K]
// output (offset_c = G_0 + ... + G_{c-1}).  An id outside [0, G_c) — padding,
// negative — adds nothing, as the TPU kernel's all-zero one-hot row does.
// segment_gram is the case n_seg = 1.
//
// What bounds them on an H100 (3.35 TB/s).  Each row is read once (K values
// and n_seg ids) and costs K(K+1)/2 products, added to n_seg groups: a few
// flops per byte, so the bound is bytes (Favorita's 18.6 M rows: 522 MB at
// K = 6, n_seg = 1; 447 MB at K = 4, n_seg = 2 — 0.13 to 0.16 ms).  The
// work that limits this simple design is the adds themselves.
//
// Design.  The TPU kernel adds rows with a one-hot matmul into a VMEM-resident
// [G, K, K] accumulator; the H100 has no use for that O(M·G) product.  Here
// one thread takes one row, forms its K(K+1)/2 distinct products (the blocks
// are symmetric) and adds each to its group's entry in an accumulator of
// [ΣG, K(K+1)/2] values privatized in the block's shared memory (the
// wrapper chunks groups so that it fits), flushed once per block to the
// global compact result with atomics — the Favorita store_nbr band (54
// groups of ~345 K rows each) then costs shared-memory atomics only.
// Where the 32 rows of a warp fall in one group (rows sorted by a key, few
// groups) the warp first sums each product with shuffles and one lane adds.
// A last small kernel expands the compact [ΣG, K(K+1)/2] sums into the
// symmetric [ΣG, K, K] output.
//
// float inputs accumulate in float, double in double.  Atomics add in an
// order that changes from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSMs = 132;
constexpr int kSmemPerSM = 232448;  // what one block may have on sm_90
constexpr int kCacheK = 8;          // rows up to this width live in registers
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int64_t tri(int i, int j, int k) {
  return (int64_t)i * k - (int64_t)i * (i - 1) / 2 + (j - i);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// Add product p of entry t to group gid (per lane) or, when the whole warp
// shares group gid0, the warp's sum once.
template <typename T>
__device__ __forceinline__ void add_entry(T* acc, int nt, bool uniform,
                                          bool valid, int64_t gid,
                                          int64_t gid0, int64_t t, T p) {
  if (uniform) {
    p = warp_sum(valid ? p : T(0));
    if ((threadIdx.x & 31) == 0) atomicAdd(acc + gid0 * nt + t, p);
  } else if (valid) {
    atomicAdd(acc + gid * nt + t, p);
  }
}

// bands: [2 * n_seg] int64 — groups of each column, then its band offset.
// Accumulates in dynamic shared memory, then adds the block's sums to
// ``out``.
template <typename T, bool kCached>
__global__ void __launch_bounds__(kThreads)
segment_gram_rows(const T* __restrict__ x, const int32_t* __restrict__ segs,
                  int64_t m, int k, int n_seg,
                  const int64_t* __restrict__ bands, int64_t total,
                  T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = k * (k + 1) / 2;
  T* acc = reinterpret_cast<T*>(smem_raw);
  for (int64_t e = threadIdx.x; e < total * nt; e += blockDim.x) acc[e] = T(0);
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // every lane of a warp runs the same iterations (the bound is per block),
  // so the ballots and shuffles below always see all 32 lanes
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < m;
       base += stride) {
    const int64_t row = base + threadIdx.x;
    const bool in = row < m;
    const T* xr = x + (in ? row : 0) * k;
    T v[kCacheK];
    if constexpr (kCached) {
#pragma unroll
      for (int j = 0; j < kCacheK; ++j) v[j] = (in && j < k) ? xr[j] : T(0);
    }
    for (int c = 0; c < n_seg; ++c) {
      const int64_t s = in ? (int64_t)segs[row * n_seg + c] : -1;
      const bool valid = s >= 0 && s < bands[c];
      const int64_t gid = valid ? bands[n_seg + c] + s : -1;
      const unsigned vmask = __ballot_sync(kFull, valid);
      if (vmask == 0) continue;  // warp-uniform
      const int64_t gid0 = __shfl_sync(kFull, gid, __ffs(vmask) - 1);
      const bool uniform = __all_sync(kFull, !valid || gid == gid0);
      if constexpr (kCached) {
#pragma unroll
        for (int i = 0; i < kCacheK; ++i) {
#pragma unroll
          for (int j = i; j < kCacheK; ++j) {
            if (j < k)  // warp-uniform
              add_entry(acc, nt, uniform, valid, gid, gid0, tri(i, j, k),
                        v[i] * v[j]);
          }
        }
      } else {
        int64_t t = 0;
        for (int i = 0; i < k; ++i) {
          const T xi = in ? xr[i] : T(0);
          for (int j = i; j < k; ++j, ++t)
            add_entry(acc, nt, uniform, valid, gid, gid0, t,
                      xi * (in ? xr[j] : T(0)));
        }
      }
    }
  }
  __syncthreads();
  for (int64_t e = threadIdx.x; e < total * nt; e += blockDim.x) {
    const T val = acc[e];
    if (val != T(0)) atomicAdd(out + e, val);
  }
}

// out[g, i, j] = compact[g, tri(min(i, j), max(i, j))]
template <typename T>
__global__ void __launch_bounds__(256)
expand_sym(const T* __restrict__ compact, int64_t total, int k,
           T* __restrict__ out) {
  const int64_t n = total * k * k;
  const int nt = k * (k + 1) / 2;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t g = e / ((int64_t)k * k);
    const int r = (int)(e % ((int64_t)k * k));
    const int i = r / k, j = r % k;
    out[e] = compact[g * nt + (i <= j ? tri(i, j, k) : tri(j, i, k))];
  }
}

template <typename T, bool kCached>
void launch_rows(unsigned blocks, size_t smem, cudaStream_t s, const T* x,
                 const int32_t* segs, int64_t m, int k, int n_seg,
                 const int64_t* bands, int64_t total, T* compact) {
  auto kern = segment_gram_rows<T, kCached>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  kern<<<blocks, kThreads, smem, s>>>(x, segs, m, k, n_seg, bands, total,
                                      compact);
}

template <typename T>
int launch(const T* x, const int32_t* segs, int64_t m, int k, int n_seg,
           const int64_t* bands, int64_t total, T* compact, T* out,
           cudaStream_t s) {
  const int64_t nt = (int64_t)k * (k + 1) / 2;
  const int64_t acc_bytes = total * nt * (int64_t)sizeof(T);
  if (k <= 0 || total <= 0 || n_seg <= 0 || acc_bytes > kSmemPerSM)
    return (int)cudaErrorInvalidValue;
  if (m > 0) {
    // as many blocks as fit the SMs at once (by threads and shared memory)
    int64_t per_sm = kSmemPerSM / (acc_bytes + 1024);
    if (per_sm > 2048 / kThreads) per_sm = 2048 / kThreads;
    if (per_sm < 1) per_sm = 1;
    int64_t blocks = (m + kThreads - 1) / kThreads;
    if (blocks > kSMs * per_sm) blocks = kSMs * per_sm;
    if (k <= kCacheK)
      launch_rows<T, true>((unsigned)blocks, (size_t)acc_bytes, s, x, segs, m,
                           k, n_seg, bands, total, compact);
    else
      launch_rows<T, false>((unsigned)blocks, (size_t)acc_bytes, s, x, segs,
                            m, k, n_seg, bands, total, compact);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int64_t n = total * k * k;
  int64_t blocks = (n + 255) / 256;
  if (blocks > kSMs * 32) blocks = kSMs * 32;
  expand_sym<T><<<(unsigned)blocks, 256, 0, s>>>(compact, total, k, out);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  ``x`` is a contiguous [m, k] matrix, ``segs`` a
// contiguous [m, n_seg] int32 matrix, ``bands`` [2 * n_seg] int64 device
// values (groups of each column, then band offsets; total = Σ groups),
// ``compact`` a zeroed [total, k(k+1)/2] buffer, ``out`` the [total, k, k]
// result (every entry written).  The [total, k(k+1)/2] accumulator must
// fit one block's shared memory (232,448 bytes).  Device memory on the
// caller's stream; returns a cudaError_t.
#define SEGMENT_GRAM_API(T, SUFFIX)                                          \
  extern "C" int segment_gram_##SUFFIX(                                      \
      const T* x, const int32_t* seg, int64_t m, int k, int64_t g,           \
      const int64_t* bands, T* compact, T* out, void* stream) {              \
    return launch<T>(x, seg, m, k, 1, bands, g, compact, out,                \
                     (cudaStream_t)stream);                                  \
  }                                                                          \
  extern "C" int multi_segment_gram_##SUFFIX(                                \
      const T* x, const int32_t* segs, int64_t m, int k, int n_seg,          \
      const int64_t* bands, int64_t total, T* compact, T* out,               \
      void* stream) {                                                        \
    return launch<T>(x, segs, m, k, n_seg, bands, total, compact, out,       \
                     (cudaStream_t)stream);                                  \
  }

SEGMENT_GRAM_API(float, f32)
SEGMENT_GRAM_API(double, f64)
