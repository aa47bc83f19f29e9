// Fused traversal-node kernels for Hopper (sm_90a): extend-with-feature +
// GROUP BY, and the multi-block segmented sum of a packed payload.
//
// Replaces the TPU kernels of src/repro/kernels/segment_view.py:
//   segment_view_kernel_call   (_segment_view_kernel)   -> segment_view2_*
//   segment_view1_kernel_call  (_segment_view1_kernel)  -> segment_view1_*
//   segment_reduce_kernel_call (_segment_reduce_kernel) -> segment_reduce_*
//
// What they compute.  A view row carries (c, l[k], q[k*k]), a feature value
// x and a segment id.  Degree 2 sums, per segment, the distinct entries of
// the bordered (k+2)x(k+2) matrix [[c, xc, l'], [xc, x2c, (xl)'], [l, xl, q]]
// in the compact layout [c, xc, x*xc, l(k), x*l(k), q(k*k)] of width
// W = 3 + 2k + k*k; the Python wrapper expands that [G, W] result into the
// packed blocks at G size.  Degree 1 sums [c, xc, l(k)] (W = k + 2).  The
// reduce kernel sums the rows of an arbitrary [M, W] payload.  Rows whose
// segment id lies outside [0, G) contribute nothing.
//
// What bounds them on an H100 (3.35 TB/s, 67 TFLOP/s fp32 off the tensor
// cores).  Each row is read once (c, x, l, q, seg: (3 + k + k*k) values and
// one int32) and each of the G*W sums written once; a row costs ~W flops,
// far under one flop per byte, so all three are memory-bound.  The TPU
// kernels kept the whole [G, W] accumulator in VMEM and added rows with a
// one-hot matmul.  On the traversal's heavy nodes G*W is many megabytes
// (G = 90,936 groups of W = 11 at item_nbr, G ~ 18.6 M rows at the first
// two feature nodes), far past the 227 KB of shared memory a block has, so
// here one thread takes one row and adds each of its W values to the
// global [G, W] output with an fp32/fp64 atomicAdd (L2 atomics).  Where the
// 32 rows of a warp all fall in one segment (sorted runs, G = 1) the warp
// first sums them with shuffles, and one lane issues the W atomics.
//
// Atomics add in an order that changes from run to run: fp32 results agree
// with a sequential sum to a few ulps of the segment's sum of magnitudes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;
constexpr unsigned kFull = 0xffffffffu;

enum Payload { kView2 = 0, kView1 = 1, kReduce = 2 };

template <typename T, int P>
__device__ __forceinline__ T row_value(int j, int64_t row, int k, int w,
                                       T cv, T xv, T xc, const T* l,
                                       const T* q, const T* data) {
  if constexpr (P == kReduce) {
    return data[row * w + j];
  } else {
    if (j == 0) return cv;
    if (j == 1) return xc;
    if constexpr (P == kView1) {
      return l[row * k + (j - 2)];
    } else {
      if (j == 2) return xv * xc;
      j -= 3;
      if (j < k) return l[row * k + j];
      j -= k;
      if (j < k) return xv * l[row * k + j];
      j -= k;
      return q[row * (int64_t)k * k + j];
    }
  }
}

// One thread per row, grid-stride.  Every lane of a warp runs the same
// number of iterations (the loop bound is per block), so the warp-wide
// ballots and shuffles below always see all 32 lanes.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
segment_rows(const T* __restrict__ c, const T* __restrict__ x,
             const T* __restrict__ l, const T* __restrict__ q,
             const T* __restrict__ data, const int32_t* __restrict__ seg,
             int64_t m, int k, int w, int64_t g, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < m;
       base += stride) {
    const int64_t row = base + threadIdx.x;
    int32_t s = -1;
    if (row < m) s = seg[row];
    const bool valid = s >= 0 && (int64_t)s < g;
    const unsigned vmask = __ballot_sync(kFull, valid);
    if (vmask == 0) continue;  // warp-uniform
    const int32_t s0 = __shfl_sync(kFull, s, __ffs(vmask) - 1);
    const bool uniform = __all_sync(kFull, !valid || s == s0);
    T cv = 0, xv = 0;
    if constexpr (P != kReduce) {
      if (valid) {
        cv = c[row];
        xv = x[row];
      }
    }
    const T xc = xv * cv;
    for (int j = 0; j < w; ++j) {
      T v = valid ? row_value<T, P>(j, row, k, w, cv, xv, xc, l, q, data)
                  : T(0);
      if (uniform) {
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_down_sync(kFull, v, off);
        if (lane == 0) atomicAdd(out + (int64_t)s0 * w + j, v);
      } else if (valid) {
        atomicAdd(out + (int64_t)s * w + j, v);
      }
    }
  }
}

template <typename T, int P>
int launch(const T* c, const T* x, const T* l, const T* q, const T* data,
           const int32_t* seg, int64_t m, int k, int w, int64_t g, T* out,
           cudaStream_t stream) {
  if (m <= 0 || w <= 0) return 0;
  int64_t blocks = (m + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  segment_rows<T, P><<<(unsigned)blocks, kThreads, 0, stream>>>(
      c, x, l, q, data, seg, m, k, w, g, out);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  ``out`` is a zeroed [g, w] buffer; every pointer
// is device memory on the caller's stream; returns a cudaError_t.
#define SEGMENT_VIEW_API(T, SUFFIX)                                          \
  extern "C" int segment_view2_##SUFFIX(const T* c, const T* x, const T* l, \
                                        const T* q, const int32_t* seg,     \
                                        int64_t m, int k, int64_t g, T* out, \
                                        void* stream) {                     \
    return launch<T, kView2>(c, x, l, q, nullptr, seg, m, k,                \
                             3 + 2 * k + k * k, g, out,                     \
                             (cudaStream_t)stream);                         \
  }                                                                         \
  extern "C" int segment_view1_##SUFFIX(const T* c, const T* x, const T* l, \
                                        const int32_t* seg, int64_t m,      \
                                        int k, int64_t g, T* out,           \
                                        void* stream) {                     \
    return launch<T, kView1>(c, x, l, nullptr, nullptr, seg, m, k, k + 2,   \
                             g, out, (cudaStream_t)stream);                 \
  }                                                                         \
  extern "C" int segment_reduce_##SUFFIX(const T* data, const int32_t* seg, \
                                         int64_t m, int w, int64_t g,       \
                                         T* out, void* stream) {            \
    return launch<T, kReduce>(nullptr, nullptr, nullptr, nullptr, data,     \
                              seg, m, 0, w, g, out, (cudaStream_t)stream);  \
  }

SEGMENT_VIEW_API(float, f32)
SEGMENT_VIEW_API(double, f64)
