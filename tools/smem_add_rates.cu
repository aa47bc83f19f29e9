// Shared-memory float add rates on one Hopper SM: the forms an accumulator
// of per-group sums in shared memory can take (csrc/segment_gram.cu).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o rates smem_add_rates.cu
//   ./rates            # one line per form: ms, adds a clock per SM
//
// One CTA per SM (132) of 1024 threads holds G groups of E floats (G = 4,100
// and E = 11, the segment_gram CTA's share at K = 6; or 54 hot groups).
// Each thread adds a value to the E entries of a random group, ITERS times.
// The forms:
//   atomicAdd       one atomicAdd per add (sm_90: a compare-and-swap loop)
//   red.shared      red.shared.add.f32 (compiles as atomicAdd does)
//   plain           load, add, store: racy, the rate of the memory alone
//   batched CAS     all E loads, then all E compare-and-swaps, again for
//                   those that lost a race
//   CAS, atomicAdd  the same, but a lost race goes through atomicAdd
//   cluster atomicAdd  atomicAdd into the other CTA of a cluster of two
//                   (distributed shared memory)
// `tools/segment_gram_variants.py` builds and runs it and prints its SASS.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

namespace cg = cooperative_groups;

constexpr int kEntries = 11, kIters = 2048, kThreads = 1024;

enum Form { kAtomic, kRed, kPlain, kBatchedCas, kCasThenAdd, kCluster };

__device__ __forceinline__ uint32_t rnd(uint32_t& s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return s;
}

template <int F>
__global__ void __launch_bounds__(kThreads, 1) adds(int groups, float* out) {
  extern __shared__ float acc[];
  for (int e = threadIdx.x; e < groups * kEntries; e += blockDim.x) acc[e] = 0.f;
  __syncthreads();
  if (F == kCluster) cg::this_cluster().sync();
  uint32_t s = 12345u + threadIdx.x * 7919u + blockIdx.x * 104729u;
  const float v = threadIdx.x * 1e-3f;
  for (int it = 0; it < kIters; ++it) {
    const int g = (int)(((rnd(s) & 0xFFFFu) * (uint32_t)groups) >> 16);
    float* p = acc + g * kEntries;
    if (F == kAtomic) {
#pragma unroll
      for (int t = 0; t < kEntries; ++t) atomicAdd(p + t, v);
    } else if (F == kRed) {
      const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
#pragma unroll
      for (int t = 0; t < kEntries; ++t)
        asm volatile("red.shared.add.f32 [%0], %1;" ::"r"(a + 4 * t), "f"(v)
                     : "memory");
    } else if (F == kPlain) {
#pragma unroll
      for (int t = 0; t < kEntries; ++t) p[t] += v;
    } else if (F == kBatchedCas || F == kCasThenAdd) {
      unsigned* q = reinterpret_cast<unsigned*>(p);
      unsigned old[kEntries];
#pragma unroll
      for (int t = 0; t < kEntries; ++t) old[t] = ((volatile unsigned*)q)[t];
      unsigned pend = (1u << kEntries) - 1;
      do {
#pragma unroll
        for (int t = 0; t < kEntries; ++t) {
          if (pend >> t & 1) {
            const unsigned got =
                atomicCAS(q + t, old[t], __float_as_uint(__uint_as_float(old[t]) + v));
            if (got == old[t])
              pend &= ~(1u << t);
            else
              old[t] = got;
          }
        }
        if (F == kCasThenAdd) {
#pragma unroll
          for (int t = 0; t < kEntries; ++t)
            if (pend >> t & 1) atomicAdd(p + t, v);
          pend = 0;
        }
      } while (pend);
    } else {
      cg::cluster_group cl = cg::this_cluster();
      float* r = cl.map_shared_rank(p, cl.block_rank() ^ 1);
#pragma unroll
      for (int t = 0; t < kEntries; ++t) atomicAdd(r + t, v);
    }
  }
  __syncthreads();
  if (F == kCluster) cg::this_cluster().sync();
  float sum = 0.f;
  for (int e = threadIdx.x; e < groups * kEntries; e += blockDim.x) sum += acc[e];
  atomicAdd(out, sum);
}

template <int F>
void run(const char* name, int groups, float* out, int clock_khz) {
  auto k = adds<F>;
  const int smem = groups * kEntries * 4;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = F == kCluster ? 2 : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = 132;
  cfg.blockDim = kThreads;
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int w = 0; w < 2; ++w) cudaLaunchKernelEx(&cfg, k, groups, out);
  const int reps = 5;
  cudaEventRecord(a);
  for (int r = 0; r < reps; ++r) cudaLaunchKernelEx(&cfg, k, groups, out);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  ms /= reps;
  const double adds = (double)kThreads * kIters * kEntries;  // a CTA, an SM
  printf("%-18s G %5d: %.4f ms, %.3f adds a clock per SM (at the %d MHz clock; %s)\n",
         name, groups, ms, adds / (ms * 1e-3 * clock_khz * 1e3), clock_khz / 1000,
         cudaGetErrorString(cudaGetLastError()));
}

int main() {
  float* out;
  cudaMalloc(&out, 4);
  int clock_khz;
  cudaDeviceGetAttribute(&clock_khz, cudaDevAttrClockRate, 0);
  for (int groups : {4100, 54}) {
    run<kAtomic>("atomicAdd", groups, out, clock_khz);
    run<kRed>("red.shared", groups, out, clock_khz);
    run<kPlain>("plain (racy)", groups, out, clock_khz);
    run<kBatchedCas>("batched CAS", groups, out, clock_khz);
    run<kCasThenAdd>("CAS, atomicAdd", groups, out, clock_khz);
    run<kCluster>("cluster atomicAdd", groups, out, clock_khz);
  }
  return cudaDeviceSynchronize() != cudaSuccess;
}
