// Fused traversal-node kernels for Hopper (sm_90a): extend-with-feature +
// GROUP BY, and the multi-block segmented sum of a view's blocks.
//
// Replaces the TPU kernels of src/repro/kernels/segment_view.py:
//   segment_view_kernel_call   (_segment_view_kernel)   -> segment_view2_*
//   segment_view1_kernel_call  (_segment_view1_kernel)  -> segment_view1_*
//   segment_reduce_kernel_call (_segment_reduce_kernel) -> segment_blocks_*
//
// What they compute.  A view row carries (c, l[k], q[k*k]), a feature value
// x and a segment id.  Degree 2 sums, per segment, the distinct entries of
// the bordered (k+2)x(k+2) matrix [[c, xc, l'], [xc, x2c, (xl)'], [l, xl, q]]
// in the compact order [c, xc, x*xc, l(k), x*l(k), q(k*k)] of width
// W = 3 + 2k + k*k, and writes them into the blocks c' [G], l' [G, k+1],
// q' [G, k+1, k+1] (the x*l sums twice, by symmetry).  Degree 1 sums
// [c, xc, l(k)] of width W = k+2 into c' [G] and l' [G, k+1].  The blocks
// payload sums [c, l(k), q(k*k)] (up to its degree) into c' [G], l' [G, k],
// q' [G, k, k].  Rows whose segment id lies outside [0, G) contribute
// nothing.
//
// What bounds them on an H100 (3.35 TB/s, 67 TFLOP/s fp32 off the tensor
// cores).  Each row is read once and each of the G*W sums written once; a
// row costs ~W flops, far under one flop per byte, so all are memory-bound.
// The TPU kernels kept the whole [G, W] accumulator in VMEM and added rows
// with a one-hot matmul.  Here every payload (degree 2, degree 1, the
// blocks) takes one of two paths per call (plan();
// kernels/segment_view.py:plan mirrors it):
//
//   A  one row per group.  The caller passes ``order``, each group's row
//      (the ids are then a permutation: the traversal's first feature
//      nodes of either degree and every regroup of the main path, whose
//      device sort has it).  One thread per group gathers its row and
//      stores its values straight into the final blocks, coalesced: no
//      atomics, no zero fill, no second pass, and the result is the same
//      bit for bit from run to run.
//   C  otherwise (item_nbr: 18.6 M rows into 90,936 groups of W 11 at
//      degree 2, W 4 at degree 1: one vector reduction a row).  Lanes
//      of a warp that share a segment first combine their values
//      (__match_any_sync and a shuffle tree); each leader then adds four
//      values at a time with Hopper's vector reduction (atomicAdd on a
//      float4: one red.global.add.v4.f32) into a [G, Wp] accumulator, Wp
//      = W rounded up to 4, zeroed and resident in L2 at these sizes.  A
//      finishing kernel writes the blocks at G size.  float64 adds its four
//      values with scalar atomics.
//
// Atomics add in an order that changes from run to run (path C): fp32
// results agree with a sequential sum to a few ulps of the segment's sum of
// magnitudes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;
constexpr unsigned kFull = 0xffffffffu;

enum Payload { kView2 = 0, kView1 = 1, kBlocks = 2 };
enum Path { kOneRow = 0, kAtomic = 1 };

// ---------------------------------------------------------------------------
// the payloads' rows and blocks, paths A and C

template <typename T>
struct Rows {  // the input rows; x only for the views, deg only for kBlocks
  const T* c;
  const T* x;
  const T* l;
  const T* q;
  const int32_t* seg;
  int64_t m;
  int k;
  int deg;
};

template <typename T>
struct Blocks {  // the outputs c', l', q'
  T* c;
  T* l;
  T* q;
};

template <int P>
__host__ __device__ __forceinline__ int width(int k, int deg) {
  if (P == kView2) return 3 + 2 * k + k * k;
  if (P == kView1) return 2 + k;
  return 1 + (deg >= 1 ? k : 0) + (deg == 2 ? k * k : 0);
}

// entry j of the compact row (cv = c[row], xv = x[row], xc = xv * cv)
template <typename T, int P>
__device__ __forceinline__ T value(const Rows<T>& in, int64_t row, int j,
                                   T cv, T xv, T xc) {
  const int k = in.k;
  if (j == 0) return cv;
  if constexpr (P == kView2) {
    if (j == 1) return xc;
    if (j == 2) return xv * xc;
    j -= 3;
    if (j < k) return in.l[row * k + j];
    j -= k;
    if (j < k) return xv * in.l[row * k + j];
    j -= k;
    return in.q[row * (int64_t)k * k + j];
  } else if constexpr (P == kView1) {
    if (j == 1) return xc;
    return in.l[row * k + (j - 2)];
  } else {
    j -= 1;
    const int kl = in.deg >= 1 ? k : 0;
    if (j < kl) return in.l[row * k + j];
    return in.q[row * (int64_t)k * k + (j - kl)];
  }
}

// put(p) at each place of the blocks that compact entry j of group s goes
// to: one place, two for degree 2's x*l entries; degree 1's [xc, l] is
// its l' row as it stands
template <typename T, int P, typename Put>
__device__ __forceinline__ void to_blocks(const Blocks<T>& o, int64_t s,
                                          int j, int k, int deg, Put put) {
  if (j == 0) {
    put(o.c + s);
    return;
  }
  if constexpr (P == kView2) {
    const int kk = k + 1;
    T* ls = o.l + s * kk;
    T* qs = o.q + s * kk * kk;
    if (j == 1) {
      put(ls);
    } else if (j == 2) {
      put(qs);
    } else if ((j -= 3) < k) {
      put(ls + 1 + j);
    } else if ((j -= k) < k) {
      put(qs + 1 + j);
      put(qs + (1 + j) * kk);
    } else {
      j -= k;
      put(qs + (1 + j / k) * kk + 1 + j % k);
    }
  } else if constexpr (P == kView1) {
    put(o.l + s * (k + 1) + (j - 1));
  } else {
    j -= 1;
    const int kl = deg >= 1 ? k : 0;
    if (j < kl)
      put(o.l + s * k + j);
    else
      put(o.q + s * k * k + (j - kl));
  }
}

// A: one thread per group gathers its row (order[i], the rows in group
// order) and stores its W values straight into the blocks
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
seg_store(Rows<T> in, const int32_t* __restrict__ order, int64_t g, int w,
          Blocks<T> out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < g;
       i += stride) {
    const int64_t row = order[i], s = i;
    if (row < 0 || row >= in.m) continue;
    const T cv = in.c[row];
    T xv = 0;
    if constexpr (P != kBlocks) xv = in.x[row];
    const T xc = xv * cv;
    for (int j = 0; j < w; ++j) {
      const T v = value<T, P>(in, row, j, cv, xv, xc);
      to_blocks<T, P>(out, s, j, in.k, in.deg, [&](T* p) { *p = v; });
    }
  }
}

// Sum v over each lane's peers (the lanes of its segment) into the peer
// with the lowest lane: a shuffle tree of log2(peers) steps (all 32 lanes
// take part; lanes without a segment form a group of their own and sum
// zeros).  Lanes other than the lowest of each group end with partial sums.
template <typename T>
__device__ __forceinline__ void reduce_peers(unsigned peers, int lane,
                                             T (&v)[4]) {
  int rank = __popc(peers & ((1u << lane) - 1));
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(kFull, above)) {
    const int next = __ffs(above);  // 1 + the next peer's lane, 0 if none
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const T o = __shfl_sync(kFull, v[t], (next - 1) & 31);
      if (next) v[t] += o;
    }
    above &= ~__ballot_sync(kFull, rank & 1);
    rank >>= 1;
  }
}

// four sums of a group: p lies in the padded accumulator, 16-byte aligned
__device__ __forceinline__ void add4(float* p, const float (&v)[4], int) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void add4(double* p, const double (&v)[4], int n) {
  for (int t = 0; t < 4 && t < n; ++t) atomicAdd(p + t, v[t]);
}

// C: warp-combined rows, vector atomics into a zeroed [G, wp] accumulator.
// For each group of four compact entries, the lowest lane of each segment
// present in the warp adds v, summed over the lanes of that segment.  The
// loop bound is per block, so every lane of a warp runs each iteration.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
seg_atomic(Rows<T> in, int64_t g, int w, int wp, T* __restrict__ acc) {
  const int lane = threadIdx.x & 31;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < in.m;
       base += step) {
    const int64_t row = base + threadIdx.x;
    int32_t s = -1;
    if (row < in.m) s = in.seg[row];
    const bool valid = s >= 0 && (int64_t)s < g;
    if (__ballot_sync(kFull, valid) == 0) continue;  // warp-uniform
    const unsigned peers = __match_any_sync(kFull, valid ? s : -1);
    const bool merge = __any_sync(kFull, valid && peers != (1u << lane));
    const bool leader = valid && __ffs(peers) - 1 == lane;
    T cv = 0, xv = 0;
    if (valid) {
      cv = in.c[row];
      if constexpr (P != kBlocks) xv = in.x[row];
    }
    const T xc = xv * cv;
    for (int j0 = 0; j0 < w; j0 += 4) {
      T v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        v[t] = valid && j0 + t < w ? value<T, P>(in, row, j0 + t, cv, xv, xc)
                                   : T(0);
      if (merge) reduce_peers(peers, lane, v);  // warp-uniform
      if (leader) add4(acc + (int64_t)s * wp + j0, v, w - j0);
    }
  }
}

// C's second pass: the [G, wp] sums into the blocks, one thread per entry
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
seg_finish(const T* __restrict__ acc, int64_t g, int k, int deg, int w,
           int wp, Blocks<T> out) {
  const int64_t n = g * w;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t s = i / w;
    const int j = (int)(i - s * w);
    const T v = acc[s * wp + j];
    to_blocks<T, P>(out, s, j, k, deg, [&](T* p) { *p = v; });
  }
}

struct Plan {
  int path, w, wp;
};

// The path, and the compact and padded widths, of a call with or without
// each group's row (``order``); kernels/segment_view.py:plan is its mirror.
Plan plan(int payload, int k, int deg, bool one_row) {
  Plan p;
  p.w = payload == kView2   ? width<kView2>(k, deg)
        : payload == kView1 ? width<kView1>(k, deg)
                            : width<kBlocks>(k, deg);
  p.wp = (p.w + 3) / 4 * 4;
  p.path = one_row ? kOneRow : kAtomic;
  return p;
}

int64_t grid(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

// ``path`` is the caller's choice (the Python mirror's); it must be the one
// plan() makes, as the caller sized ``acc`` for it: A (``order`` given,
// one row per group, m == g) stores every entry of ``out``; C adds into a
// zeroed [G, wp] ``acc`` and then writes every entry of ``out``.
template <typename T, int P>
int run(const Rows<T>& in, const int32_t* order, int64_t g, int path,
        Blocks<T> out, T* acc, cudaStream_t stream) {
  const Plan p = plan(P, in.k, in.deg, order != nullptr);
  if (p.path != path || (order && in.m != g)) return (int)cudaErrorInvalidValue;
  if (in.m <= 0 || g <= 0) return 0;
  if (path == kOneRow) {
    seg_store<T, P><<<(unsigned)grid(g), kThreads, 0, stream>>>(in, order, g,
                                                                 p.w, out);
  } else {
    seg_atomic<T, P><<<(unsigned)grid(in.m), kThreads, 0, stream>>>(
        in, g, p.w, p.wp, acc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    seg_finish<T, P><<<(unsigned)grid(g * p.w), kThreads, 0, stream>>>(
        acc, g, in.k, in.deg, p.w, p.wp, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  Every pointer is device memory on the caller's
// stream; each function returns a cudaError_t.  ``order`` (may be null)
// lists each group's one row (path A); ``path`` is the caller's plan
// (segment_view_plan), checked against the library's own.
#define SEGMENT_VIEW_API(T, SUFFIX)                                          \
  extern "C" int segment_view2_##SUFFIX(                                    \
      const T* c, const T* x, const T* l, const T* q, const int32_t* seg,   \
      const int32_t* order, int64_t m, int k, int64_t g, int path,          \
      T* out_c, T* out_l, T* out_q, T* acc, void* stream) {                 \
    return run<T, kView2>(Rows<T>{c, x, l, q, seg, m, k, 2}, order, g,      \
                          path, Blocks<T>{out_c, out_l, out_q}, acc,        \
                          (cudaStream_t)stream);                            \
  }                                                                         \
  extern "C" int segment_view1_##SUFFIX(                                    \
      const T* c, const T* x, const T* l, const int32_t* seg,               \
      const int32_t* order, int64_t m, int k, int64_t g, int path,          \
      T* out_c, T* out_l, T* acc, void* stream) {                           \
    return run<T, kView1>(Rows<T>{c, x, l, nullptr, seg, m, k, 1}, order,   \
                          g, path, Blocks<T>{out_c, out_l, nullptr}, acc,   \
                          (cudaStream_t)stream);                            \
  }                                                                         \
  extern "C" int segment_blocks_##SUFFIX(                                   \
      const T* c, const T* l, const T* q, const int32_t* seg,               \
      const int32_t* order, int64_t m, int k, int degree, int64_t g,        \
      int path, T* out_c, T* out_l, T* out_q, T* acc, void* stream) {       \
    return run<T, kBlocks>(Rows<T>{c, nullptr, l, q, seg, m, k, degree},    \
                           order, g, path, Blocks<T>{out_c, out_l, out_q},  \
                           acc, (cudaStream_t)stream);                      \
  }

SEGMENT_VIEW_API(float, f32)
SEGMENT_VIEW_API(double, f64)

// The plan for a call: out = {path, W, padded W}.  payload 0 is degree 2
// (segment_view2_*), 1 degree 1 (segment_view1_*), 2 the blocks payload
// (segment_blocks_*); one_row states that the call passes ``order``.
extern "C" int segment_view_plan(int payload, int k, int degree, int one_row,
                                 int* out) {
  if (payload != kView2 && payload != kView1 && payload != kBlocks)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(payload, k, degree, one_row != 0);
  out[0] = p.path;
  out[1] = p.w;
  out[2] = p.wp;
  return 0;
}
