// The alternative to path C of csrc/segment_view.cu that
// tools/segment_view_variants.py times against it: a segmented reduce in
// group order, without atomics.  One warp per group walks the group's rows
// through ``order`` (the rows sorted by segment id, as
// kernels/ops.py:group_ids_device sorts them; ``starts`` [G + 1] the first
// sorted row of each group), sums each row's degree-2 compact entries in
// registers, reduces across the warp and writes the blocks c' [G],
// l' [G, K+1], q' [G, K+1, K+1].  Sums are the same bit for bit from run to
// run; the price is a random gather of every row's blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
sorted_view2(const float* __restrict__ c, const float* __restrict__ x,
             const float* __restrict__ l, const float* __restrict__ q,
             const int32_t* __restrict__ order,
             const int64_t* __restrict__ starts, int64_t g,
             float* __restrict__ out_c, float* __restrict__ out_l,
             float* __restrict__ out_q) {
  constexpr int W = 3 + 2 * K + K * K;
  constexpr int KK = K + 1;
  const int lane = threadIdx.x & 31;
  const int64_t s = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= g) return;  // warp-uniform
  float acc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = 0.f;
  for (int64_t i = starts[s] + lane; i < starts[s + 1]; i += 32) {
    const int64_t row = order[i];
    const float cv = c[row], xv = x[row], xc = xv * cv;
    acc[0] += cv;
    acc[1] += xc;
    acc[2] += xv * xc;
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const float la = l[row * K + a];
      acc[3 + a] += la;
      acc[3 + K + a] += xv * la;
    }
#pragma unroll
    for (int t = 0; t < K * K; ++t) acc[3 + 2 * K + t] += q[row * K * K + t];
  }
#pragma unroll
  for (int j = 0; j < W; ++j)
    for (int off = 16; off > 0; off >>= 1)
      acc[j] += __shfl_down_sync(kFull, acc[j], off);
  if (lane != 0) return;
  float* ls = out_l + s * KK;
  float* qs = out_q + s * KK * KK;
  out_c[s] = acc[0];
  ls[0] = acc[1];
  qs[0] = acc[2];
#pragma unroll
  for (int a = 0; a < K; ++a) {
    ls[1 + a] = acc[3 + a];
    qs[1 + a] = qs[(1 + a) * KK] = acc[3 + K + a];
#pragma unroll
    for (int b = 0; b < K; ++b) qs[(1 + a) * KK + 1 + b] = acc[3 + 2 * K + a * K + b];
  }
}

}  // namespace

extern "C" int segment_view2_sorted_f32(const float* c, const float* x,
                                        const float* l, const float* q,
                                        const int32_t* order,
                                        const int64_t* starts, int64_t g,
                                        int k, float* out_c, float* out_l,
                                        float* out_q, void* stream) {
  const unsigned blocks = (unsigned)((g + kWarps - 1) / kWarps);
  if (g <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    case 0: sorted_view2<0><<<blocks, kWarps * 32, 0, st>>>(c, x, l, q, order, starts, g, out_c, out_l, out_q); break;
    case 1: sorted_view2<1><<<blocks, kWarps * 32, 0, st>>>(c, x, l, q, order, starts, g, out_c, out_l, out_q); break;
    case 2: sorted_view2<2><<<blocks, kWarps * 32, 0, st>>>(c, x, l, q, order, starts, g, out_c, out_l, out_q); break;
    case 3: sorted_view2<3><<<blocks, kWarps * 32, 0, st>>>(c, x, l, q, order, starts, g, out_c, out_l, out_q); break;
    case 4: sorted_view2<4><<<blocks, kWarps * 32, 0, st>>>(c, x, l, q, order, starts, g, out_c, out_l, out_q); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
