// Feature-scaling moments for Hopper (sm_90a): (sum x, max |x|) of one
// column in a single pass.
//
// Replaces the TPU kernel of src/repro/kernels/moments.py:
//   moments_kernel_call (_moments_kernel) -> moments_*
//
// What bounds it on an H100: it reads each of the M values once and writes
// two scalars, two flops per value — memory-bound at M * sizeof(T) bytes
// over 3.35 TB/s.  The TPU kernel walked the column in order, folding each
// block into two scalars held across its sequential grid.  Blocks of a GPU
// grid run in no order, so here each thread strides over the column
// keeping a private sum and max, the block reduces those with warp
// shuffles and shared memory, and one thread per block folds the block's
// pair into the output: atomicAdd for the sum, and atomicMax on the
// unsigned bit pattern of the max, whose order equals the float order for
// the non-negative values |x| takes.  The block count is capped, so the
// output sees a few thousand atomics at most.  The caller supplies the
// count and zeroes both outputs.
//
// The sum's order of addition changes from run to run (atomics): fp32
// results agree with a sequential sum to a few ulps of sum |x|.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void fold_max(float* out, float v) {
  atomicMax(reinterpret_cast<unsigned int*>(out), __float_as_uint(v));
}

__device__ __forceinline__ void fold_max(double* out, double v) {
  atomicMax(reinterpret_cast<unsigned long long*>(out),
            (unsigned long long)__double_as_longlong(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const T* __restrict__ x, int64_t m, T* __restrict__ sum_out,
               T* __restrict__ max_out) {
  __shared__ T s_sum[kThreads / 32];
  __shared__ T s_max[kThreads / 32];
  T s = 0, mx = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const T v = x[i];
    s += v;
    mx = fmax(mx, fabs(v));
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(kFull, s, off);
    mx = fmax(mx, __shfl_down_sync(kFull, mx, off));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_sum[warp] = s;
    s_max[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? s_sum[lane] : T(0);
    mx = lane < kThreads / 32 ? s_max[lane] : T(0);
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(kFull, s, off);
      mx = fmax(mx, __shfl_down_sync(kFull, mx, off));
    }
    if (lane == 0) {
      atomicAdd(sum_out, s);
      fold_max(max_out, mx);
    }
  }
}

template <typename T>
int launch(const T* x, int64_t m, T* sum_out, T* max_out,
           cudaStream_t stream) {
  if (m <= 0) return 0;
  int64_t blocks = (m + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  moments_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(x, m, sum_out,
                                                                max_out);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes: ``sum_out`` and ``max_out`` are zeroed 1-element
// device buffers; returns a cudaError_t.
extern "C" int moments_f32(const float* x, int64_t m, float* sum_out,
                           float* max_out, void* stream) {
  return launch<float>(x, m, sum_out, max_out, (cudaStream_t)stream);
}

extern "C" int moments_f64(const double* x, int64_t m, double* sum_out,
                           double* max_out, void* stream) {
  return launch<double>(x, m, sum_out, max_out, (cudaStream_t)stream);
}
