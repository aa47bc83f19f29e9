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
//   plain, routed   plain adds where each lane's group lies in its own
//                   bank: entry-major [E, G'] (G' = G rounded up to 32) and
//                   the group's low five bits the lane's (as if rows were
//                   routed to lanes by group): the rate without conflicts
//   CAS, routed     CAS, atomicAdd on that layout
//   CAS64, CAS128   12 floats a group (E + 1, padded), added two or four at
//                   a time by 64- or 128-bit compare-and-swaps, retried
//   match, private  one copy of the [G, E] sums a warp (G = 54 only):
//                   __match_any_sync, the shuffle tree that sums a group's
//                   lanes, and plain adds by each group's lowest lane
// `tools/segment_gram_variants.py` builds and runs it and prints its SASS.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

namespace cg = cooperative_groups;

constexpr int kEntries = 11, kIters = 2048, kThreads = 1024;

enum Form {
  kAtomic, kRed, kPlain, kBatchedCas, kCasThenAdd, kCluster, kPlainRouted,
  kCasRouted, kMatchPrivate, kCas64, kCas128
};
constexpr int kWide = 12;  // floats a group of the 64- and 128-bit forms

// 128-bit compare-and-swap of shared memory at p: (lo, hi) expected, set
// to what was there; true where it swapped
__device__ __forceinline__ bool cas128(void* p, unsigned long long& lo,
                                       unsigned long long& hi,
                                       unsigned long long nlo,
                                       unsigned long long nhi) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  unsigned long long rlo, rhi;
  asm volatile(
      "{\n .reg .b128 d, b, c;\n mov.b128 b, {%2, %3};\n"
      " mov.b128 c, {%4, %5};\n atom.shared.cas.b128 d, [%6], b, c;\n"
      " mov.b128 {%0, %1}, d;\n}\n"
      : "=l"(rlo), "=l"(rhi)
      : "l"(lo), "l"(hi), "l"(nlo), "l"(nhi), "r"(a)
      : "memory");
  const bool ok = rlo == lo && rhi == hi;
  lo = rlo;
  hi = rhi;
  return ok;
}

// two floats plus v, as the bits of one 64-bit word
__device__ __forceinline__ unsigned long long add2(unsigned long long w,
                                                   float v) {
  return (unsigned long long)__float_as_uint(__uint_as_float((unsigned)w) + v) |
         (unsigned long long)__float_as_uint(
             __uint_as_float((unsigned)(w >> 32)) + v) << 32;
}

// the adds an iteration of form f makes a thread
__host__ __device__ constexpr int entries(int f) {
  return f == kCas64 || f == kCas128 ? kWide : kEntries;
}
constexpr unsigned kFull = 0xffffffffu;

// the floats a CTA's accumulator of `groups` takes in form F
__host__ __device__ constexpr int acc_floats(int f, int groups) {
  return f == kPlainRouted || f == kCasRouted ? (groups + 31) / 32 * 32 * kEntries
         : f == kMatchPrivate                 ? kThreads / 32 * groups * kEntries
                                              : groups * entries(f);
}

__device__ __forceinline__ uint32_t rnd(uint32_t& s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return s;
}

template <int F>
__global__ void __launch_bounds__(kThreads, 1) adds(int groups, float* out) {
  extern __shared__ __align__(16) float acc[];
  const int n_acc = acc_floats(F, groups);
  for (int e = threadIdx.x; e < n_acc; e += blockDim.x) acc[e] = 0.f;
  __syncthreads();
  if (F == kCluster) cg::this_cluster().sync();
  uint32_t s = 12345u + threadIdx.x * 7919u + blockIdx.x * 104729u;
  const float v = threadIdx.x * 1e-3f;
  for (int it = 0; it < kIters; ++it) {
    int g = (int)(((rnd(s) & 0xFFFFu) * (uint32_t)groups) >> 16);
    const int lane = threadIdx.x & 31, padded = (groups + 31) / 32 * 32;
    if (F == kPlainRouted || F == kCasRouted) g = (g & ~31) | lane;
    float* p = acc + g * kEntries;
    if (F == kCas64) {
      unsigned long long* q =
          reinterpret_cast<unsigned long long*>(acc + g * kWide);
      unsigned long long old[kWide / 2];
      unsigned pend = (1u << (kWide / 2)) - 1;
#pragma unroll
      for (int t = 0; t < kWide / 2; ++t)
        old[t] = ((volatile unsigned long long*)q)[t];
      while (pend) {
#pragma unroll
        for (int t = 0; t < kWide / 2; ++t) {
          if (pend >> t & 1) {
            const unsigned long long got = atomicCAS(q + t, old[t], add2(old[t], v));
            if (got == old[t])
              pend &= ~(1u << t);
            else
              old[t] = got;
          }
        }
      }
    } else if (F == kCas128) {
      float* q = acc + g * kWide;
      unsigned long long lo[kWide / 4], hi[kWide / 4];
      unsigned pend = (1u << (kWide / 4)) - 1;
#pragma unroll
      for (int t = 0; t < kWide / 4; ++t) {
        lo[t] = ((volatile unsigned long long*)q)[2 * t];
        hi[t] = ((volatile unsigned long long*)q)[2 * t + 1];
      }
      while (pend) {
#pragma unroll
        for (int t = 0; t < kWide / 4; ++t)
          if ((pend >> t & 1) &&
              cas128(q + 4 * t, lo[t], hi[t], add2(lo[t], v), add2(hi[t], v)))
            pend &= ~(1u << t);
      }
    } else if (F == kPlainRouted) {
#pragma unroll
      for (int t = 0; t < kEntries; ++t) acc[t * padded + g] += v;
    } else if (F == kCasRouted) {
      unsigned* q = reinterpret_cast<unsigned*>(acc);
      unsigned old[kEntries], pend = 0;
#pragma unroll
      for (int t = 0; t < kEntries; ++t) old[t] = ((volatile unsigned*)q)[t * padded + g];
#pragma unroll
      for (int t = 0; t < kEntries; ++t)
        if (atomicCAS(q + t * padded + g, old[t],
                      __float_as_uint(__uint_as_float(old[t]) + v)) != old[t])
          pend |= 1u << t;
#pragma unroll
      for (int t = 0; t < kEntries; ++t)
        if (pend >> t & 1) atomicAdd(acc + t * padded + g, v);
    } else if (F == kMatchPrivate) {
      float* mine = acc + (threadIdx.x >> 5) * groups * kEntries + g * kEntries;
      const unsigned peers = __match_any_sync(kFull, g);
      float val[kEntries];
#pragma unroll
      for (int t = 0; t < kEntries; ++t) val[t] = v + t;
      int rank = __popc(peers & ((1u << lane) - 1));
      unsigned above = peers & (0xfffffffeu << lane);
      while (__any_sync(kFull, above)) {
        const int next = __ffs(above);
#pragma unroll
        for (int t = 0; t < kEntries; ++t) {
          const float o = __shfl_sync(kFull, val[t], (next - 1) & 31);
          if (next) val[t] += o;
        }
        above &= ~__ballot_sync(kFull, rank & 1);
        rank >>= 1;
      }
      if (__ffs(peers) - 1 == lane) {
#pragma unroll
        for (int t = 0; t < kEntries; ++t) mine[t] += val[t];
      }
      __syncwarp();
    } else if (F == kAtomic) {
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
  for (int e = threadIdx.x; e < n_acc; e += blockDim.x) sum += acc[e];
  atomicAdd(out, sum);
}

template <int F>
void run(const char* name, int groups, float* out, int clock_khz) {
  auto k = adds<F>;
  const int smem = acc_floats(F, groups) * 4;
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
  const double adds = (double)kThreads * kIters * entries(F);  // a CTA, an SM
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
    run<kPlainRouted>("plain, routed", groups, out, clock_khz);
    run<kCasRouted>("CAS, routed", groups, out, clock_khz);
    if (groups == 54) run<kMatchPrivate>("match, private", groups, out, clock_khz);
    run<kCas64>("CAS64, 12 a group", groups, out, clock_khz);
    run<kCas128>("CAS128, 12 a group", groups, out, clock_khz);
  }
  return cudaDeviceSynchronize() != cudaSuccess;
}
