// The flash-attention backward for Hopper (sm_90a): dQ, dK and dV of
// flash.cu's attention over the model's [B, S, H, D] layout, with GQA,
// causal, sliding-window and key-length masks.
//
// Replaces no TPU kernel.  The reference's Pallas flash kernel
// (src/repro/kernels/flash.py, flash_kernel_call) has no backward: the
// reference trains over long sequences by differentiating its jnp
// recurrence (chunked_attention under jax.checkpoint).  The port's
// counterpart of that gradient is this kernel, so that training never
// leaves the hand-written path.
//
// What it computes.  With the forward's row log-sum-exp L [B, H, Sq]
// (flash.cu writes it) and the same visibility predicate (key j < kv_len,
// j <= i when causal, j > i - window when a window is set):
//   P  = exp(S·scale - L) on visible keys, 0 elsewhere (S = Q Kᵀ);
//   Δ  = rowsum(dO ∘ O)                      (a pre-pass, float32 [B, H, Sq]);
//   dV = Pᵀ dO;   dS = P ∘ (dO Vᵀ - Δ);
//   dK = dSᵀ Q · scale;   dQ = dS K · scale,
// every product in float32 whatever the input type (bf16 inputs are
// widened on load), the results rounded once to the input type.  A row
// that sees no key has L = -inf and P = 0, so its dQ is 0 (never NaN); a
// key that no query sees gets dK = dV = 0.
//
// What bounds it on an H100.  Five matrix products of 2·D flops per
// visible (query, key) pair against reading q, k, v, o, dO, L and writing
// dq, dk, dv once: operations, as the forward.  This first design runs
// them as scalar float32 FMAs from shared memory (67 TFLOP/s off the tensor
// cores), and recomputes S and dO Vᵀ in both passes below (seven products
// in all); wgmma and TMA are later work.
//
// Design.  Blocks of 256 threads walk 32 x 32 (query, key) tiles staged in
// shared memory as float32 (rows padded by 4 floats, so the float4 reads of
// eight neighbouring rows fall in distinct banks).  Each tile first forms S
// and dO Vᵀ (a thread 4 scores of one row), then P and dS into shared
// memory, then the thread's own accumulators:
//  * dkdv_kernel: one block per (batch, KV head, key tile) keeps dK and dV
//    of its 32 keys in registers and walks every query tile that can see a
//    key of the tile, for each of the G query heads of the group, so the
//    GQA sum stays inside the block: no atomics.
//  * dq_kernel: one block per (batch, head, query tile) keeps dQ in
//    registers and walks the key tiles the forward walks (key_tiles), the
//    latest query tiles first (the longest causal rows).
//  * delta_kernel: one warp per (batch, query, head) row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;        // queries per tile
constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kLDS = kBK + 1;  // a P / dS row (floats)
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;     // [B, Sq, H, D]
  const void* k;     // [B, Sk, KH, D]
  const void* v;     // [B, Sk, KH, D]
  const void* o;     // [B, Sq, H, D], the forward's output
  const void* dout;  // [B, Sq, H, D]
  const float* lse;  // [B, H, Sq]
  float* delta;      // [B, H, Sq], written by delta_kernel
  void* dq;          // [B, Sq, H, D]
  void* dk;          // [B, Sk, KH, D]
  void* dv;          // [B, Sk, KH, D]
  int b, sq, sk, h, kh, d, causal, window, kv_len;
  float scale;
};

__device__ __forceinline__ bool visible(const Args& a, int i, int j) {
  return j < a.kv_len && (!a.causal || j <= i) &&
         (a.window <= 0 || j > i - a.window);
}

// four values at p (16-byte aligned for float, 8-byte for bf16) as float
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

__device__ __forceinline__ void axpy4(float s, float4 x, float (&acc)[4]) {
  acc[0] = fmaf(s, x.x, acc[0]);
  acc[1] = fmaf(s, x.y, acc[1]);
  acc[2] = fmaf(s, x.z, acc[2]);
  acc[3] = fmaf(s, x.w, acc[3]);
}

// rows [r0, r0 + nrows) of a [*, stride] matrix into dst[r][c] as float
// (row length DP + 4); rows past `limit` and columns past d are 0
template <typename T, int DP>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t stride,
                                      int r0, int nrows, int limit, int d) {
  constexpr int kChunks = DP / 4;
  for (int idx = threadIdx.x; idx < nrows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit && c < d) val = load4(src + (r0 + r) * stride + c);
    store4(dst + r * (DP + 4) + c, val);
  }
}

// L and Δ of queries [q0, q0 + kBQ) of one head into ls, dls (-inf and 0
// past Sq)
__device__ __forceinline__ void stage_rows(const Args& a, float* ls, float* dls,
                                           int64_t row_base, int q0) {
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    const bool in = q0 + i < a.sq;
    ls[i] = in ? a.lse[row_base + q0 + i] : -INFINITY;
    dls[i] = in ? a.delta[row_base + q0 + i] : 0.f;
  }
}

// one (query tile, key tile) pair: P and dS into ps / dss [kBQ][kLDS].
// Thread t forms row t / 8, keys t % 8 + 8j (j < 4) of S and dO Vᵀ.
template <int DP>
__device__ __forceinline__ void probs(const Args& a, const float* qs,
                                      const float* dos, const float* ks,
                                      const float* vs, const float* ls,
                                      const float* dls, float* ps, float* dss,
                                      int q0, int k0) {
  constexpr int kLD = DP + 4;
  const int r = threadIdx.x / 8, c0 = threadIdx.x % 8;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
  const float* qrow = qs + r * kLD;
  const float* grow = dos + r * kLD;
#pragma unroll 4
  for (int dd = 0; dd < DP; dd += 4) {
    const float4 q4 = load4(qrow + dd), g4 = load4(grow + dd);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 8 * j;
      s[j] = dot4(q4, load4(ks + c * kLD + dd), s[j]);
      dp[j] = dot4(g4, load4(vs + c * kLD + dd), dp[j]);
    }
  }
  const int qi = q0 + r;
  const float lrow = ls[r], drow = dls[r];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + 8 * j;
    // a row past Sq or one that saw no key (L = -inf) has p = 0
    float p = 0.f;
    if (qi < a.sq && lrow != -INFINITY && visible(a, qi, k0 + c))
      p = expf(fmaf(s[j], a.scale, -lrow));
    ps[r * kLDS + c] = p;
    dss[r * kLDS + c] = p * (dp[j] - drow);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(Args a) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)a.b * a.sq * a.h) return;
  const T* o = static_cast<const T*>(a.o) + row * a.d;
  const T* g = static_cast<const T*>(a.dout) + row * a.d;
  float s = 0.f;
  for (int c = lane * 4; c < a.d; c += 128) s = dot4(load4(o + c), load4(g + c), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) {
    // row runs over (batch, query, head); Δ is [B, H, Sq]
    const int head = row % a.h;
    const int64_t bq = row / a.h;
    const int qi = bq % a.sq, batch = bq / a.sq;
    a.delta[((int64_t)batch * a.h + head) * a.sq + qi] = s;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(Args a) {
  constexpr int kLD = DP + 4;
  constexpr int kChunks = DP / 4;             // float4 columns a row
  constexpr int kMine = (kChunks + 7) / 8;    // of them a thread accumulates
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [kBK][kLD]
  float* vs = ks + kBK * kLD;                  // [kBK][kLD]
  float* qs = vs + kBK * kLD;                  // [kBQ][kLD]
  float* dos = qs + kBQ * kLD;                 // [kBQ][kLD]
  float* ps = dos + kBQ * kLD;                 // [kBQ][kLDS]
  float* dss = ps + kBQ * kLDS;                // [kBQ][kLDS]
  float* ls = dss + kBQ * kLDS;                // [kBQ]
  float* dls = ls + kBQ;                       // [kBQ]

  const int k0 = blockIdx.x * kBK;
  const int kv_head = blockIdx.y, batch = blockIdx.z;
  const int group = a.h / a.kh;
  const int64_t q_stride = (int64_t)a.h * a.d, kv_stride = (int64_t)a.kh * a.d;
  const T* kg = static_cast<const T*>(a.k) + ((int64_t)batch * a.sk * a.kh + kv_head) * a.d;
  const T* vg = static_cast<const T*>(a.v) + ((int64_t)batch * a.sk * a.kh + kv_head) * a.d;
  stage<T, DP>(ks, kg, kv_stride, k0, kBK, a.sk, a.d);
  stage<T, DP>(vs, vg, kv_stride, k0, kBK, a.sk, a.d);

  const int key = threadIdx.x / 8, col0 = threadIdx.x % 8;  // accumulator owner
  float dk[kMine][4], dv[kMine][4];
#pragma unroll
  for (int j = 0; j < kMine; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  // the queries that can see a key of [k0, min(k0 + kBK, kv_len))
  const int k_last = min(k0 + kBK, a.kv_len) - 1;
  const int q_begin = a.causal ? k0 : 0;
  const int q_end = k_last < k0 ? 0
                    : a.window > 0 ? min(a.sq, k_last + a.window) : a.sq;
  for (int q0 = q_begin / kBQ * kBQ; q0 < q_end; q0 += kBQ) {
    for (int hh = 0; hh < group; ++hh) {
      const int head = kv_head * group + hh;
      const T* qg = static_cast<const T*>(a.q) + ((int64_t)batch * a.sq * a.h + head) * a.d;
      const T* gg = static_cast<const T*>(a.dout) + ((int64_t)batch * a.sq * a.h + head) * a.d;
      __syncthreads();  // the previous pair's reads of qs, dos, ps, dss are done
      stage<T, DP>(qs, qg, q_stride, q0, kBQ, a.sq, a.d);
      stage<T, DP>(dos, gg, q_stride, q0, kBQ, a.sq, a.d);
      stage_rows(a, ls, dls, ((int64_t)batch * a.h + head) * a.sq, q0);
      __syncthreads();
      probs<DP>(a, qs, dos, ks, vs, ls, dls, ps, dss, q0, k0);
      __syncthreads();
      for (int r = 0; r < kBQ; ++r) {
        const float p = ps[r * kLDS + key], ds = dss[r * kLDS + key];
#pragma unroll
        for (int j = 0; j < kMine; ++j) {
          const int ch = col0 + 8 * j;
          if (ch < kChunks) {
            axpy4(p, load4(dos + r * kLD + ch * 4), dv[j]);
            axpy4(ds, load4(qs + r * kLD + ch * 4), dk[j]);
          }
        }
      }
    }
  }

  if (k0 + key >= a.sk) return;
  const int64_t off = ((int64_t)batch * a.sk + k0 + key) * kv_stride + (int64_t)kv_head * a.d;
  T* dkg = static_cast<T*>(a.dk) + off;
  T* dvg = static_cast<T*>(a.dv) + off;
#pragma unroll
  for (int j = 0; j < kMine; ++j) {
    const int c = (col0 + 8 * j) * 4;
    if (c < a.d) {
      store4(dkg + c, make_float4(dk[j][0] * a.scale, dk[j][1] * a.scale,
                                  dk[j][2] * a.scale, dk[j][3] * a.scale));
      store4(dvg + c, make_float4(dv[j][0], dv[j][1], dv[j][2], dv[j][3]));
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  constexpr int kLD = DP + 4;
  constexpr int kChunks = DP / 4;
  constexpr int kMine = (kChunks + 7) / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kBK * kLD;
  float* qs = vs + kBK * kLD;
  float* dos = qs + kBQ * kLD;
  float* ps = dos + kBQ * kLD;
  float* dss = ps + kBQ * kLDS;
  float* ls = dss + kBQ * kLDS;
  float* dls = ls + kBQ;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // latest tiles first
  const int head = blockIdx.y, batch = blockIdx.z;
  const int kv_head = head / (a.h / a.kh);
  const int64_t q_stride = (int64_t)a.h * a.d, kv_stride = (int64_t)a.kh * a.d;
  const int64_t q_off = ((int64_t)batch * a.sq * a.h + head) * a.d;
  stage<T, DP>(qs, static_cast<const T*>(a.q) + q_off, q_stride, q0, kBQ, a.sq, a.d);
  stage<T, DP>(dos, static_cast<const T*>(a.dout) + q_off, q_stride, q0, kBQ, a.sq, a.d);
  stage_rows(a, ls, dls, ((int64_t)batch * a.h + head) * a.sq, q0);
  const T* kg = static_cast<const T*>(a.k) + ((int64_t)batch * a.sk * a.kh + kv_head) * a.d;
  const T* vg = static_cast<const T*>(a.v) + ((int64_t)batch * a.sk * a.kh + kv_head) * a.d;

  const int row = threadIdx.x / 8, col0 = threadIdx.x % 8;  // accumulator owner
  float dq[kMine][4];
#pragma unroll
  for (int j = 0; j < kMine; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  // key tiles [first, last) that can hold a visible key (flash.cu's
  // key_tiles)
  int end = a.kv_len;
  if (a.causal) end = min(end, min(q0 + kBQ, a.sq));
  const int begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int first = begin / kBK, last = end > begin ? (end + kBK - 1) / kBK : first;
  for (int kt = first; kt < last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's reads of ks, vs, dss are done
    stage<T, DP>(ks, kg, kv_stride, k0, kBK, a.sk, a.d);
    stage<T, DP>(vs, vg, kv_stride, k0, kBK, a.sk, a.d);
    __syncthreads();
    probs<DP>(a, qs, dos, ks, vs, ls, dls, ps, dss, q0, k0);
    __syncthreads();
    for (int c = 0; c < kBK; ++c) {
      const float ds = dss[row * kLDS + c];
#pragma unroll
      for (int j = 0; j < kMine; ++j) {
        const int ch = col0 + 8 * j;
        if (ch < kChunks) axpy4(ds, load4(ks + c * kLD + ch * 4), dq[j]);
      }
    }
  }

  if (q0 + row >= a.sq) return;
  T* dqg = static_cast<T*>(a.dq) + q_off + (int64_t)(q0 + row) * q_stride;
#pragma unroll
  for (int j = 0; j < kMine; ++j) {
    const int c = (col0 + 8 * j) * 4;
    if (c < a.d)
      store4(dqg + c, make_float4(dq[j][0] * a.scale, dq[j][1] * a.scale,
                                  dq[j][2] * a.scale, dq[j][3] * a.scale));
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int DP>
constexpr int smem_bytes() {
  return ((2 * kBK + 2 * kBQ) * (DP + 4) + 2 * kBQ * kLDS + 2 * kBQ) * 4;
}

template <typename T, int DP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<DP>();
  static_assert(kSmem <= 232448, "over the block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int64_t rows = (int64_t)a.b * a.sq * a.h;
  const int rows_per_block = kThreads / 32;
  delta_kernel<T><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                    kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.sk > 0) {
    dkdv_kernel<T, DP><<<dim3((a.sk + kBK - 1) / kBK, a.kh, a.b), kThreads,
                         kSmem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dq_kernel<T, DP><<<dim3((a.sq + kBQ - 1) / kBQ, a.h, a.b), kThreads, kSmem,
                     stream>>>(a);
  return cudaGetLastError();
}

// the instantiation width for head dim d: the least of 16, 32, 64, 128, 256
// that holds it (0 if none does), as flash.cu's
int padded_dim(int d) {
  for (int dp = 16; dp <= 256; dp *= 2)
    if (d <= dp) return dp;
  return 0;
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* delta, void* dq, void* dk,
        void* dv, int b, int sq, int sk, int h, int kh, int d, int causal,
        int window, int kv_len, void* stream) {
  if (b < 1 || sq < 1 || sk < 0 || kh < 1 || h % kh != 0 || d % 8 != 0 ||
      padded_dim(d) == 0 || kv_len < 0 || kv_len > sk)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.b = b; a.sq = sq; a.sk = sk; a.h = h; a.kh = kh; a.d = d;
  a.causal = causal; a.window = window; a.kv_len = kv_len;
  a.scale = (float)pow((double)d, -0.5);  // as the forward rounds it
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_dim(d)) {
    case 16: return (int)launch<T, 16>(a, s);
    case 32: return (int)launch<T, 32>(a, s);
    case 64: return (int)launch<T, 64>(a, s);
    case 128: return (int)launch<T, 128>(a, s);
    default: return (int)launch<T, 256>(a, s);
  }
}

}  // namespace

// q, o, dout, dq [B, Sq, H, D]; k, v, dk, dv [B, Sk, KH, D], all contiguous
// and 16-byte aligned, of one type; lse (the forward's) and delta (scratch)
// float32 [B, H, Sq]; window <= 0 means none.  Three launches on the stream
// (Δ, dK/dV, dQ).  Returns a cudaError_t.
extern "C" int flash_backward_bf16(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int b, int sq, int sk,
                                   int h, int kh, int d, int causal, int window,
                                   int kv_len, void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq,
                            sk, h, kh, d, causal, window, kv_len, stream);
}

extern "C" int flash_backward_f32(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* delta, void* dq,
                                  void* dk, void* dv, int b, int sq, int sk,
                                  int h, int kh, int d, int causal, int window,
                                  int kv_len, void* stream) {
  return run<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, sk, h, kh,
                    d, causal, window, kv_len, stream);
}
