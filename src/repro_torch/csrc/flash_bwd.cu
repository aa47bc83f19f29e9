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
//   Δ  = rowsum(dO ∘ O)                      (a pre-pass, float32);
//   dV = Pᵀ dO;   dS = P ∘ (dO Vᵀ - Δ);
//   dK = dSᵀ Q · scale;   dQ = dS K · scale,
// with float32 sums, the results rounded once to the input type.  A row
// that sees no key has L = -inf and P = 0, so its dQ is 0 (never NaN); a
// key that no query sees gets dK = dV = 0.
//
// What bounds it on an H100.  Five matrix products of 2·D flops per
// visible (query, key) pair against reading q, k, v, o, dO, L and writing
// dq, dk, dv once: hundreds of flops per byte at thousands of keys, so the
// tensor cores bound it (989 TFLOP/s bf16, 495 TF32).  Scalar float32 FMAs
// reach 67 TFLOP/s at best: both types run their products on wgmma.
//
// bf16 at DP <= 128 (two warpgroups, 256 threads; the Hopper helpers are
// hopper.cuh's, shared with flash.cu):
//  * One block per (batch, query head, 128 keys).  Blocks start in index
//    order, x fastest: every (batch, head) of the first key tile, then of
//    the next, so under causal masking the key tiles that the most query
//    tiles see start first.  Per-head blocks give the card B·H·Sk/128 of
//    them (288 at smollm's 9 heads and 4,096 tokens on 132 SMs).
//  * Thread 0 loads the block's K and V tiles once, then keeps a ring of
//    query stages in flight, each a 64-query Q tile and dO tile (TMA, 4-d
//    maps over [B, S, heads, D], rows past Sq and columns past D
//    zero-filled) and their rows of L·log2 e and Δ (1-d bulk copies from
//    the pre-pass's padded rows); a stage is loaded again once every
//    thread has released it (an mbarrier of 256 arrivals).  No producer
//    warpgroup: a third warpgroup would cap each thread at 168 registers
//    (three warps on an SM sub-partition), under what a warpgroup holds.
//  * Each warpgroup owns 64 keys (wgmma's M).  For each stage it forms
//    Sᵀ = K Qᵀ and dPᵀ = V dOᵀ with wgmma from shared memory (all K-major
//    along D); Pᵀ = exp2(Sᵀ·scale·log2 e - L·log2 e) and
//    dSᵀ = Pᵀ ∘ (dPᵀ - Δ) on the accumulator fragments (the mask only on
//    tiles that straddle the diagonal, the window edge or kv_len; the
//    pre-pass gives a row with L = -inf, and a row past Sq, +inf, so its P
//    is 0); then dV += Pᵀ dO and dK += dSᵀ Q with Pᵀ and dSᵀ packed to bf16
//    as the register A operand and dO, Q read MN-major from the stage, dK
//    and dV staying in float32 registers across the block's query tiles
//    (128 of them a thread at DP = 128, with 64 for Sᵀ and dPᵀ).
//  * dQ in one pass: both warpgroups store dSᵀ in shared memory (bf16,
//    128-byte swizzle, two buffers), and one warpgroup a tile, taking
//    turns, forms dQ_part = dS K over the block's 128 keys with a wgmma
//    whose operands are both MN-major, one panel of D at a time, and adds
//    it into a float32 dQ accumulator with vector atomics (once a tile and
//    block: half the atomics of a product per warpgroup).  Five products,
//    no recomputation.
//  * GQA: a group's query heads are separate blocks, so dK and dV are
//    added with atomics into float32 accumulators [B, Sk, KH, D]; with one
//    query head per KV head they are stored directly.
//  * Three launches: the pre-pass (Δ, L·log2 e, one warp a row over rows
//    padded to the stage), the main kernel, and a finish pass that scales
//    dQ (and rounds the GQA accumulators) into the input type.  Every
//    buffer is the caller's: one zeroed float32 workspace (rows, dQ and,
//    under GQA, dK / dV accumulators) of flash_bwd_workspace floats.
//  * BwdGeometry is mirrored in kernels/flash.py (bwd_geometry) for the
//    CPU tests; flash_bwd_geometry reports it.  Design choices measured
//    with tools/flash_bwd_variants.py are in PERF.md (Findings, PR 26).
//
// float32 at DP <= 128: 3xTF32 on wgmma (Tf32Geometry, mirrored in
// kernels/flash.py's bwd_geometry; flash_bwd_f32_geometry reports it).
// Scalar float32 FMAs reach 67 TFLOP/s; plain TF32 keeps 10 mantissa bits
// (about 1e-3), short of float32.  Each operand x is split into hi =
// tf32(x) and lo = tf32(x - hi), and a·b is taken as hi·hi + hi·lo + lo·hi
// in float32 accumulators: about 2^-21 relative, three tensor-core products
// for one (bound: 3x the operations at 495 TFLOP/s).
//  * The TF32 wgmma reads both operands K-major only: its transpose
//    immediates exist for 16-bit types alone.  Three of the five products
//    contract over the sequence (dV = Pᵀ dO, dK = dSᵀ Q, dQ = dS K) and
//    read Q, dO or K along their non-contiguous dimension, so a pre-pass
//    (split_kernel) writes, beside the natural hi / lo planes [B·heads, S,
//    d] of Q, dO, K and V, transposed ones [B·heads, d, S8] of Q, dO and K,
//    and TMA feeds both kinds in 128-byte-swizzled panels of 32 float32
//    columns (64-byte at DP = 16).  The pre-pass body (split_planes) and
//    the products (Tf32Ops) are hopper.cuh's, shared with flash.cu's
//    float32 forward.  Pᵀ, dSᵀ and dS are the register A
//    operand of those products: a thread's accumulator columns (2t4,
//    2t4 + 1) enter a TF32 A fragment as k = t4 and t4 + 4, so the
//    transposed planes hold the sequence permuted within each 8 to match.
//  * hi and lo double every tile: one kernel that held K, V and Kᵀ and
//    staged Q, dO, Qᵀ and dOᵀ would need 256 KiB at DP = 64 and 480 at 128,
//    over the 227 a block has.  So the work is split in two kernels of one
//    warpgroup (128 threads) each, S and dP formed in both (seven products
//    for five): dkdv_tf32_kernel, a block per (batch, KV head, 64 keys),
//    holds K and V and walks the group's query heads' tiles (Sᵀ = K Qᵀ,
//    dPᵀ = V dOᵀ, dV += Pᵀ dO, dK += dSᵀ Q; no atomics, GQA summed in its
//    registers); dq_tf32_kernel, a block per (batch, head, 64 queries),
//    holds Q and dO and walks the forward's key tiles (S = Q Kᵀ, dP = dO
//    Vᵀ, dQ += dS K).  A stage's natural and transposed tiles ride two
//    barriers, so the next natural tile loads during this stage's
//    sequence products and the next transposed one during the next
//    stage's products over D.  Stages: 64 queries (dK/dV) and 64 keys (dQ)
//    at DP <= 64; 16 and 32 at DP = 128, where the resident tiles take 128
//    KiB.  Every gradient is stored once, float32: no accumulator and no
//    finish pass; the workspace (rows and planes, flash_bwd_workspace) is
//    written in full before it is read.
//  * The tensor cores' accumulation rounds toward zero: summed in them over
//    every stage, dK drifted by about 1e-4 of its norm at 4,096 tokens and
//    three heads, so each stage's sequence products go into a fresh
//    accumulator that is added to the running sum in float32.
//
// float32 and bf16 at DP = 256: scalar kernels, blocks of 256 threads on
// 32 x 32 (query, key) tiles
// staged in shared memory as float32 (rows padded by 4 floats, so the
// float4 reads of eight neighbouring rows fall in distinct banks); each
// tile forms S and dO Vᵀ (a thread 4 scores of one row), then P and dS
// into shared memory, then the thread's own accumulators:
//  * dkdv_kernel: one block per (batch, KV head, key tile) keeps dK and dV
//    of its 32 keys in registers and walks every query tile that can see a
//    key of the tile, for each of the G query heads of the group, so the
//    GQA sum stays inside the block: no atomics.
//  * dq_kernel: one block per (batch, head, query tile) keeps dQ in
//    registers and walks the key tiles the forward walks (key_tiles), the
//    latest query tiles first (the longest causal rows).
//  * delta_kernel: one warp per (batch, query, head) row.
// At DP = 256, dK and dV of 64 keys would be 256 float32 registers a
// thread, over the 255 a thread can have; splitting them across
// warpgroups is later work (ROADMAP queue 2), so that width keeps the
// scalar kernels in both types (no config of configs/ has it).

#include <math.h>

#include "hopper.cuh"

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
  // the caller's zeroed float32 workspace: Δ [B, H, Sq] for the scalar
  // kernels; the padded rows and the accumulators for the wgmma path
  float* work;
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
    dls[i] = in ? a.work[row_base + q0 + i] : 0.f;
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
    a.work[((int64_t)batch * a.h + head) * a.sq + qi] = s;
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
// bf16 at DP <= 128: wgmma on TMA-fed stages, two warpgroups
// ---------------------------------------------------------------------------

constexpr int kKeysWG = 64;        // keys per warpgroup (wgmma's M)
// two warpgroups and no producer warpgroup: a third warpgroup would put
// three warps on an SM sub-partition (16,384 registers each) and cap every
// thread at 168 registers, under dK and dV of 64 keys x 128 columns (128)
// with Sᵀ and dPᵀ (64); with 256 threads a thread may take 255
constexpr int kThreads16 = 256;
constexpr float kLog2e = 1.4426950408889634f;

// the instantiation for padded width DP; flash_bwd_geometry reports it
template <int DP>
struct BwdGeometry {
  static constexpr int kPanel = DP < 64 ? DP : 64;  // columns per panel
  static constexpr int kSwizzle = kPanel * 2;       // bytes per panel row
  static constexpr int kPanels = DP / kPanel;
  static constexpr int kBK = 2 * kKeysWG;           // keys per block
  static constexpr int kBQ = 64;                    // queries per stage
  static constexpr int kStages = 3;  // 2 and 4 measured no faster
  static constexpr int kKVBytes = kBK * DP * 2;     // one K or one V tile
  static constexpr int kQBytes = kBQ * DP * 2;      // one Q or one dO tile
  static constexpr int kDsBytes = kKeysWG * kBQ * 2;  // one dSᵀ buffer
  static constexpr int kRowBytes = kBQ * 4;         // one L or Δ row
  static constexpr int kBarBytes = (2 * kStages + 1) * 8;
  // + 1024: the base is rounded up to the 128-byte swizzle's 1 KiB repeat;
  // K, V, the stages' Q and dO, four dSᵀ buffers (two a warpgroup), the
  // stages' rows, the barriers
  static constexpr int kSmem = 1024 + 2 * kKVBytes + 2 * kStages * kQBytes +
                               4 * kDsBytes + 2 * kStages * kRowBytes +
                               kBarBytes;
  static_assert(kSmem <= 232448, "over the block's shared memory");
  static_assert(DP % kPanel == 0 && kBQ * 2 == 128, "tile shape");
};

// rows of the stages padded to whole stages: the pre-pass writes them all
__host__ __device__ __forceinline__ int padded_rows(int sq) {
  return (sq + 63) / 64 * 64;
}

// query tiles [*first, *last) of bq queries that can see a key of
// [k0, k0 + bk)
__device__ __forceinline__ void query_tiles(const Args& a, int k0, int bk,
                                            int bq, int* first, int* last) {
  const int k_end = min(k0 + bk, a.kv_len);
  if (k_end <= k0) {
    *first = *last = 0;
    return;
  }
  const int begin = a.causal ? k0 : 0;
  const int end = a.window > 0 ? min(a.sq, k_end - 1 + a.window) : a.sq;
  *first = begin / bq;
  *last = end > begin ? (end + bq - 1) / bq : *first;
}

// every key of [k0, k0 + bk) visible to every query of [r0, r0 + rows): the
// tile needs no mask (flash.cu's predicate)
__device__ __forceinline__ bool tile_interior(const Args& a, int r0, int rows,
                                              int k0, int bk) {
  return k0 + bk <= a.kv_len && (!a.causal || k0 + bk - 1 <= r0) &&
         (a.window <= 0 || k0 > r0 + rows - 1 - a.window);
}

// Δ = rowsum(dO ∘ O) and L·log2 e (+inf for a row that sees no key, and
// for the padding rows past Sq, so that their P is 0) into the workspace's
// [B, H, padded_rows(Sq)] rows; one warp a (batch, query, head) row
template <typename T>
__global__ void __launch_bounds__(kThreads) rows_kernel(Args a) {
  const int sq_pad = padded_rows(a.sq);
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)a.b * sq_pad * a.h) return;
  const int head = row % a.h;
  const int64_t bq = row / a.h;
  const int qi = bq % sq_pad, batch = bq / sq_pad;
  float s = 0.f;
  if (qi < a.sq) {
    const int64_t off = (((int64_t)batch * a.sq + qi) * a.h + head) * a.d;
    const T* o = static_cast<const T*>(a.o) + off;
    const T* g = static_cast<const T*>(a.dout) + off;
    for (int c = lane * 4; c < a.d; c += 128)
      s = dot4(load4(o + c), load4(g + c), s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) {
    const int64_t at = ((int64_t)batch * a.h + head) * sq_pad + qi;
    const float l = qi < a.sq ? a.lse[((int64_t)batch * a.h + head) * a.sq + qi]
                              : -INFINITY;
    a.work[at] = l == -INFINITY ? INFINITY : l * kLog2e;
    a.work[(int64_t)a.b * a.h * sq_pad + at] = s;
  }
}

// one warpgroup's work on a stage, on register fragments: element
// 4j + 2rr + e of a 64 x 64 accumulator is key row (warp·16 + g + 8rr) of
// the warpgroup's 64, query 8j + 2t4 + e of the stage (wgmma's accumulator
// layout, g = lane / 4, t4 = lane % 4)
template <int DP>
struct BwdTileOps {
  using G = BwdGeometry<DP>;
  static constexpr int kPanel = G::kPanel, kSw = G::kSwizzle, kBK = G::kBK;
  static constexpr int kBQ = G::kBQ;
  typedef float Tile[kBQ / 2];                      // 64 keys x 64 queries
  typedef float Acc[G::kPanels][kPanel / 2];        // 64 keys x DP
  typedef uint32_t Frag[kBQ / 16][4];               // bf16 A fragments

  // Sᵀ = K Qᵀ (or dPᵀ = V dOᵀ): the warpgroup's 64 rows of the K (V) tile
  // against the stage's Q (dO), both K-major (issued, not waited)
  __device__ __forceinline__ static void issue_t(Tile& acc, uint32_t kv_wg,
                                                 uint32_t st) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int p = kk * 16 / kPanel, col_bytes = (kk * 16 % kPanel) * 2;
      const uint64_t da = smem_desc<kSw>(kv_wg + p * kBK * kSw + col_bytes, 1);
      const uint64_t db = smem_desc<kSw>(st + p * kBQ * kSw + col_bytes, 1);
      WgmmaSS<kBQ>::run(acc, da, db, kk > 0);
    }
  }

  // acc += A B: A the bf16 fragments (64 keys x 64 queries), B the stage's
  // dO (Q) read MN-major, 16 queries a step, one wgmma per panel (issued,
  // not waited); as flash.cu's P·V
  __device__ __forceinline__ static void issue_acc(Acc& acc, const Frag& fa,
                                                   uint32_t st) {
#pragma unroll
    for (int kt = 0; kt < kBQ / 16; ++kt)
#pragma unroll
      for (int p = 0; p < G::kPanels; ++p) {
        const uint64_t db = smem_desc<kSw>(st + p * kBQ * kSw + kt * 16 * kSw,
                                           8 * kSw / 16);
        WgmmaRS<kPanel>::run(acc[p], fa[kt], db);
      }
  }

  // dQ_part[64 queries x panel p] = dS K over the block's 128 keys: A is
  // dSᵀ in shared memory (both warpgroups' rows, keys; queries contiguous:
  // MN-major), B the K tile's panel p (MN-major), 16 keys a step (issued,
  // not waited)
  __device__ __forceinline__ static void issue_dq(float (&acc)[kPanel / 2],
                                                  uint32_t ds, uint32_t k_s,
                                                  int p) {
#pragma unroll
    for (int kt = 0; kt < kBK / 16; ++kt) {
      const uint64_t da = smem_desc<128>(ds + kt * 16 * 128, 8 * 128 / 16);
      const uint64_t db = smem_desc<kSw>(k_s + p * kBK * kSw + kt * 16 * kSw,
                                         8 * kSw / 16);
      WgmmaSS<kPanel, 1>::run(acc, da, db, kt > 0);
    }
  }

  // Pᵀ into st and dSᵀ = Pᵀ ∘ (dPᵀ - Δ) into dp, masked where the tile
  // straddles an edge; lrow / drow the stage's L·log2 e and Δ rows
  __device__ __forceinline__ static void probs(Tile& st, Tile& dp,
                                               const float* lrow,
                                               const float* drow,
                                               const Args& a, bool interior,
                                               int key0, int q0, int t4,
                                               float scale2) {
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
      const int c = j * 8 + t4 * 2;
      const float2 l2 = *reinterpret_cast<const float2*>(lrow + c);
      const float2 d2 = *reinterpret_cast<const float2*>(drow + c);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = j * 4 + rr * 2 + e;
          float s = st[i];
          if (!interior && !visible(a, q0 + c + e, key0 + 8 * rr)) s = -INFINITY;
          const float p = exp2_ftz(fmaf(s, scale2, -(e ? l2.y : l2.x)));
          st[i] = p;
          dp[i] = p * (dp[i] - (e ? d2.y : d2.x));
        }
    }
  }

  // bf16 A fragments from a tile: the fragment of 16 queries holds key
  // rows g, g + 8 and queries 2t4, 2t4 + 8 (two 8-query blocks)
  __device__ __forceinline__ static void pack(const Tile& t, Frag& f) {
#pragma unroll
    for (int kt = 0; kt < kBQ / 16; ++kt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        f[kt][r] = pack_bf16(t[kt * 8 + 2 * r], t[kt * 8 + 2 * r + 1]);
  }

  // the dSᵀ fragments into a 64 x 64 bf16 buffer, rows of 128 bytes in the
  // 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), as a
  // TMA load would have put them: conflict-free, one 4-byte store each
  __device__ __forceinline__ static void store_ds(unsigned char* ds,
                                                  const Frag& f, int warp,
                                                  int g, int t4) {
#pragma unroll
    for (int kt = 0; kt < kBQ / 16; ++kt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = warp * 16 + g + 8 * (r & 1);
        const int chunk = (2 * kt + (r >> 1)) ^ g;
        *reinterpret_cast<uint32_t*>(ds + row * 128 + chunk * 16 + t4 * 4) =
            f[kt][r];
      }
  }
};

template <int DP>
__global__ void __launch_bounds__(kThreads16, 1)
    bwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, Args a) {
  using G = BwdGeometry<DP>;
  using T = BwdTileOps<DP>;
  constexpr int kPanel = G::kPanel, kSw = G::kSwizzle, kBK = G::kBK;
  constexpr int kBQ = G::kBQ, kStages = G::kStages;
  extern __shared__ unsigned char smem[];
  // shared-space addresses: K, V, per stage a Q and a dO tile (each its
  // panels one after another), the dSᵀ buffers, per stage the L and Δ
  // rows, then the barriers
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  unsigned char* const gbase = smem + (base - smem_u32(smem));
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + G::kKVBytes;
  const uint32_t st_s = v_s + G::kKVBytes;
  const uint32_t ds_s = st_s + 2 * kStages * G::kQBytes;
  const uint32_t rows_s = ds_s + 4 * G::kDsBytes;
  const uint32_t bars = rows_s + 2 * kStages * G::kRowBytes;
  const uint32_t kv_bar = bars + 16 * kStages;  // full: bars + 8s, empty: + 8(S + s)

  const int head = blockIdx.x % a.h, batch = blockIdx.x / a.h;
  const int k0 = blockIdx.y * kBK;
  const int sq_pad = padded_rows(a.sq);
  int first, last;
  query_tiles(a, k0, kBK, kBQ, &first, &last);
  const int n_tiles = last - first;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kThreads16);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues every load: K and V once, then query tile i into stage
  // i % kStages (its Q and dO tiles by TMA, its L·log2 e and Δ rows by bulk
  // copy), the first kStages up front and each later one as soon as every
  // thread has released the stage
  const float* const lrows = a.work + ((int64_t)batch * a.h + head) * sq_pad;
  const float* const drows = lrows + (int64_t)a.b * a.h * sq_pad;
  auto load = [&](int i) {
    const int s = i % kStages;
    const uint32_t full = bars + 8 * s;
    mbar_expect_tx(full, 2 * G::kQBytes + 2 * G::kRowBytes);
    const uint32_t q_st = st_s + 2 * s * G::kQBytes;
    const uint32_t do_st = q_st + G::kQBytes;
    const int q0 = (first + i) * kBQ;
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p) {
      tma_load(q_st + p * kBQ * kSw, &q_map, full, p * kPanel, head, q0, batch);
      tma_load(do_st + p * kBQ * kSw, &do_map, full, p * kPanel, head, q0,
               batch);
    }
    const uint32_t row_st = rows_s + 2 * s * G::kRowBytes;
    bulk_load(row_st, lrows + q0, full, G::kRowBytes);
    bulk_load(row_st + G::kRowBytes, drows + q0, full, G::kRowBytes);
  };
  if (threadIdx.x == 0 && n_tiles > 0) {
    const int kv_head = head / (a.h / a.kh);
    mbar_expect_tx(kv_bar, 2 * G::kKVBytes);
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p) {
      tma_load(k_s + p * kBK * kSw, &k_map, kv_bar, p * kPanel, kv_head, k0,
               batch);
      tma_load(v_s + p * kBK * kSw, &v_map, kv_bar, p * kPanel, kv_head, k0,
               batch);
    }
    for (int i = 0; i < kStages && i < n_tiles; ++i) load(i);
  }
  __syncwarp();

  // ---- two warpgroups: 64 keys each ----
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw0 = k0 + wg * kKeysWG;    // the warpgroup's keys
  const int key0 = kw0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const uint32_t k_wg = k_s + wg * kKeysWG * kSw;
  const uint32_t v_wg = v_s + wg * kKeysWG * kSw;
  const float scale2 = a.scale * kLog2e;  // scores in the log2 domain

  typename T::Acc dk, dv;
#pragma unroll
  for (int p = 0; p < G::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < kPanel / 2; ++i) dk[p][i] = dv[p][i] = 0.f;

  if (n_tiles > 0) {
    float* const dq_acc = a.work + 2 * (int64_t)a.b * a.h * sq_pad;
    const int64_t q_stride = (int64_t)a.h * a.d;
    mbar_wait(kv_bar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int q0 = (first + i) * kBQ;
      const uint32_t q_st = st_s + 2 * s * G::kQBytes;
      const uint32_t do_st = q_st + G::kQBytes;
      // dSᵀ buffer i % 2: the 128 keys' rows, this warpgroup's 64 of them
      const uint32_t ds_all = ds_s + 2 * (i & 1) * G::kDsBytes;
      const uint32_t ds = ds_all + wg * G::kDsBytes;
      const float* lrow =
          reinterpret_cast<const float*>(gbase + (rows_s - base) + 2 * s * G::kRowBytes);
      mbar_wait(bars + 8 * s, (i / kStages) & 1);

      typename T::Tile st, dp;
      wg_fence();
      T::issue_t(st, k_wg, q_st);   // Sᵀ = K Qᵀ
      T::issue_t(dp, v_wg, do_st);  // dPᵀ = V dOᵀ
      wg_commit();
      wg_wait_all();
      fence_regs(st);
      fence_regs(dp);
      T::probs(st, dp, lrow, lrow + kBQ, a,
               tile_interior(a, q0, kBQ, kw0, kKeysWG), key0, q0, t4, scale2);
      typename T::Frag pa, da;
      T::pack(st, pa);
      T::pack(dp, da);
      T::store_ds(gbase + (ds - base), da, warp, g, t4);
      // the generic-proxy stores before the wgmma's async-proxy reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(da);
      wg_fence();
      T::issue_acc(dv, pa, do_st);  // dV += Pᵀ dO
      T::issue_acc(dk, da, q_st);   // dK += dSᵀ Q
      wg_commit();
      wg_wait_all();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(da);
      mbar_arrive(bars + 8 * (kStages + s));  // done with stage s
      if (threadIdx.x == 0 && i + kStages < n_tiles) {
        mbar_wait(bars + 8 * (kStages + s), (i / kStages) & 1);
        load(i + kStages);
      }
      __syncwarp();

      // dQ by warpgroup i % 2, over the block's 128 keys, once both
      // warpgroups have stored their dSᵀ rows (the other only arrives); a
      // buffer is stored again two tiles later, after the warpgroup that
      // read it has arrived at the next tile's barrier
      const int bar_id = 1 + (i & 1);
      if (wg != (i & 1)) {
        asm volatile("bar.arrive %0, %1;\n" ::"r"(bar_id), "n"(kThreads16)
                     : "memory");
        continue;
      }
      asm volatile("bar.sync %0, %1;\n" ::"r"(bar_id), "n"(kThreads16)
                   : "memory");
#pragma unroll
      for (int p = 0; p < G::kPanels; ++p) {
        float acc[kPanel / 2];
        wg_fence();
        T::issue_dq(acc, ds_all, k_s, p);
        wg_commit();
        wg_wait_all();
        fence_regs(acc);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int qi = q0 + warp * 16 + g + 8 * rr;
          if (qi >= a.sq) continue;
          float* row = dq_acc + ((int64_t)batch * a.sq + qi) * q_stride +
                       (int64_t)head * a.d;
#pragma unroll
          for (int j = 0; j < kPanel / 8; ++j) {
            const int col = p * kPanel + j * 8 + t4 * 2;
            if (col < a.d)
              atomicAdd(reinterpret_cast<float2*>(row + col),
                        make_float2(acc[j * 4 + rr * 2], acc[j * 4 + rr * 2 + 1]));
          }
        }
      }
    }
  }

  // dK (scaled) and dV: stored as bf16 when the KV head has one query
  // head, else added into the float32 group accumulators
  const int group = a.h / a.kh, kv_head = head / group;
  const int64_t kv_stride = (int64_t)a.kh * a.d;
  const int64_t acc_floats = (int64_t)a.b * a.sk * kv_stride;
  float* const dk_acc =
      a.work + 2 * (int64_t)a.b * a.h * sq_pad + (int64_t)a.b * a.sq * a.h * a.d;
  float* const dv_acc = dk_acc + acc_floats;
  if (group != 1 && n_tiles == 0) return;  // nothing to add
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = key0 + 8 * rr;
    if (key >= a.sk) continue;
    const int64_t off = ((int64_t)batch * a.sk + key) * kv_stride +
                        (int64_t)kv_head * a.d;
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p)
#pragma unroll
      for (int j = 0; j < kPanel / 8; ++j) {
        const int col = p * kPanel + j * 8 + t4 * 2;
        if (col >= a.d) continue;
        const int i = j * 4 + rr * 2;
        const float2 k2 = make_float2(dk[p][i] * a.scale, dk[p][i + 1] * a.scale);
        const float2 v2 = make_float2(dv[p][i], dv[p][i + 1]);
        if (group == 1) {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.dk) + off + col) =
              __floats2bfloat162_rn(k2.x, k2.y);
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.dv) + off + col) =
              __floats2bfloat162_rn(v2.x, v2.y);
        } else {
          atomicAdd(reinterpret_cast<float2*>(dk_acc + off + col), k2);
          atomicAdd(reinterpret_cast<float2*>(dv_acc + off + col), v2);
        }
      }
  }
}

// dq = dQ accumulator · scale, and under GQA dk / dv = their accumulators,
// rounded to bf16; four values a step
__global__ void __launch_bounds__(kThreads) finish_kernel(Args a) {
  const int sq_pad = padded_rows(a.sq);
  const float* dq_acc = a.work + 2 * (int64_t)a.b * a.h * sq_pad;
  const int64_t nq = (int64_t)a.b * a.sq * a.h * a.d;
  const int64_t nk = a.h == a.kh ? 0 : (int64_t)a.b * a.sk * a.kh * a.d;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * 4;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i < nq + 2 * nk; i += stride) {
    float4 x = load4(dq_acc + i);
    __nv_bfloat16* out;
    if (i < nq) {
      x = make_float4(x.x * a.scale, x.y * a.scale, x.z * a.scale, x.w * a.scale);
      out = static_cast<__nv_bfloat16*>(a.dq) + i;
    } else if (i < nq + nk) {
      out = static_cast<__nv_bfloat16*>(a.dk) + (i - nq);
    } else {
      out = static_cast<__nv_bfloat16*>(a.dv) + (i - nq - nk);
    }
    store4(out, x);
  }
}

// ---------------------------------------------------------------------------
// float32 at DP <= 128: 3xTF32 wgmma on TMA-fed tiles, one warpgroup a block
// ---------------------------------------------------------------------------

constexpr int kThreadsTf32 = 128;
constexpr int kRowsTf32 = 64;  // keys of a dK/dV block, queries of a dQ block

// the float32 instantiation for padded width DP; flash_bwd_f32_geometry
// reports it
template <int DP>
struct Tf32Geometry {
  static constexpr int kPanel = DP < 32 ? DP : 32;  // floats a natural panel row
  static constexpr int kSwizzle = kPanel * 4;       // bytes a panel row
  // queries a dK/dV stage, keys a dQ stage: at DP = 128 the resident
  // 64-row hi and lo tiles take 128 KiB, and the stages what is left
  static constexpr int kBQ = DP >= 128 ? 16 : 64;
  static constexpr int kBK = DP >= 128 ? 32 : 64;
  static constexpr int kPanelQ = kBQ < 32 ? kBQ : 32;  // a transposed Q panel
  static constexpr int kPanelK = kBK < 32 ? kBK : 32;  // a transposed K panel
  static constexpr int kTile = kRowsTf32 * DP * 4;  // one resident hi or lo tile
  static constexpr int kQTile = kBQ * DP * 4;       // one dK/dV stage tile
  static constexpr int kKTile = kBK * DP * 4;       // one dQ stage tile
  // + 1024: the base rounded up to the 1 KiB swizzle repeat; then the
  // resident K, V (Q, dO) hi and lo, the stage's natural and transposed
  // hi and lo tiles, the L·log2 e and Δ rows, three mbarriers
  static constexpr int kSmemDkdv =
      1024 + 4 * kTile + 8 * kQTile + 2 * kBQ * 4 + 3 * 8;
  static constexpr int kSmemDq =
      1024 + 4 * kTile + 2 * kRowsTf32 * 4 + 6 * kKTile + 3 * 8;
  static_assert(kSmemDkdv <= 232448 && kSmemDq <= 232448,
                "over the block's shared memory");
  static_assert(DP % kPanel == 0 && kBQ % kPanelQ == 0 && kBK % kPanelK == 0,
                "tile shape");
  static_assert(kPanel == Tf32Ops<DP>::kP && kRowsTf32 == Tf32Ops<DP>::kM,
                "the panels Tf32Ops reads");
};

// the workspace of the float32 path, in floats: L·log2 e and Δ rows
// (rows_kernel), then the 3xTF32 planes, [0] hi and [1] lo: natural
// [B·heads, S, d] of Q, dO, K, V and transposed [B·heads, d, S8] of Q, dO,
// K (split_kernel)
struct Tf32Planes {
  float *qn[2], *qt[2], *on[2], *ot[2], *kn[2], *kt[2], *vn[2];
};

__host__ __forceinline__ long long tf32_floats(int b, int sq, int sk, int h,
                                               int kh, int d) {
  const long long nq = (long long)b * h * sq * d, nqt = (long long)b * h * d * round8(sq);
  const long long nk = (long long)b * kh * sk * d, nkt = (long long)b * kh * d * round8(sk);
  return 2LL * b * h * padded_rows(sq) + 4 * (nq + nqt) + 2 * (nk + nkt) + 2 * nk;
}

__host__ __forceinline__ Tf32Planes tf32_planes(const Args& a) {
  const long long nq = (long long)a.b * a.h * a.sq * a.d;
  const long long nqt = (long long)a.b * a.h * a.d * round8(a.sq);
  const long long nk = (long long)a.b * a.kh * a.sk * a.d;
  const long long nkt = (long long)a.b * a.kh * a.d * round8(a.sk);
  float* p = a.work + 2LL * a.b * a.h * padded_rows(a.sq);
  Tf32Planes t;
  for (int i = 0; i < 2; ++i) { t.qn[i] = p; p += nq; }
  for (int i = 0; i < 2; ++i) { t.qt[i] = p; p += nqt; }
  for (int i = 0; i < 2; ++i) { t.on[i] = p; p += nq; }
  for (int i = 0; i < 2; ++i) { t.ot[i] = p; p += nqt; }
  for (int i = 0; i < 2; ++i) { t.kn[i] = p; p += nk; }
  for (int i = 0; i < 2; ++i) { t.kt[i] = p; p += nkt; }
  for (int i = 0; i < 2; ++i) { t.vn[i] = p; p += nk; }
  return t;
}

// x [B, S, heads, d] float32 into its 3xTF32 planes (split_planes in
// hopper.cuh: natural hi / lo [B·heads, S, d] and, where t_hi is given,
// transposed hi / lo [B·heads, d, S8], the sequence permuted within each 8)
__global__ void __launch_bounds__(256)
    split_kernel(const float* x, int seq, int heads, int d, float* n_hi,
                 float* n_lo, float* t_hi, float* t_lo) {
  split_planes(x, seq, heads, d, n_hi, n_lo, t_hi, t_lo);
}

// [0] hi, [1] lo of every operand a kernel reads by TMA
struct DkdvMaps {
  CUtensorMap k[2], v[2], q[2], o[2], qt[2], ot[2];  // o: dO
};
struct DqMaps {
  CUtensorMap q[2], o[2], k[2], v[2], kt[2];
};

// dK and dV of 64 keys of one KV head: the block walks every query tile
// that sees them, for each of the group's query heads, so the GQA sum
// stays in its registers.  Per stage: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, Pᵀ and
// dSᵀ on the fragments, dV += Pᵀ dO and dK += dSᵀ Q with Pᵀ, dSᵀ as the
// register A operand and dO, Q read from their transposed planes.
template <int DP>
__global__ void __launch_bounds__(kThreadsTf32, 1)
    dkdv_tf32_kernel(const __grid_constant__ DkdvMaps maps, Args a) {
  using G = Tf32Geometry<DP>;
  using O = Tf32Ops<DP>;
  constexpr int kP = G::kPanel, kSw = G::kSwizzle, kBQ = G::kBQ;
  constexpr int kPT = G::kPanelQ;
  extern __shared__ unsigned char smem[];
  // K hi, lo, V hi, lo; the stage's Q hi, lo, dO hi, lo; its Qᵀ hi, lo,
  // dOᵀ hi, lo; its L·log2 e and Δ rows; the K/V, natural and transposed
  // barriers
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  unsigned char* const gbase = smem + (base - smem_u32(smem));
  const uint32_t kv_s = base;
  const uint32_t nat_s = kv_s + 4 * G::kTile;
  const uint32_t tr_s = nat_s + 4 * G::kQTile;
  const uint32_t rows_s = tr_s + 4 * G::kQTile;
  const uint32_t kv_bar = rows_s + 2 * kBQ * 4, nat_bar = kv_bar + 8,
                 tr_bar = kv_bar + 16;
  const float* const rows = reinterpret_cast<const float*>(gbase + (rows_s - base));

  const int kv_head = blockIdx.x % a.kh, batch = blockIdx.x / a.kh;
  const int k0 = blockIdx.y * kRowsTf32;
  const int group = a.h / a.kh;
  const int sq_pad = padded_rows(a.sq);
  int first, last;
  query_tiles(a, k0, kRowsTf32, kBQ, &first, &last);
  const int per_head = last - first, n = per_head * group;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    mbar_init(nat_bar, 1);
    mbar_init(tr_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage i: query tile first + i % per_head of the group's head i / per_head
  auto load_nat = [&](int i) {
    const int mat = batch * a.h + kv_head * group + i / per_head;
    const int q0 = (first + i % per_head) * kBQ;
    mbar_expect_tx(nat_bar, 4 * G::kQTile);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int p = 0; p < DP / kP; ++p) {
        const uint32_t off = t * G::kQTile + p * kBQ * kSw;
        tma_load3(nat_s + off, &maps.q[t], nat_bar, p * kP, q0, mat);
        tma_load3(nat_s + 2 * G::kQTile + off, &maps.o[t], nat_bar, p * kP, q0, mat);
      }
  };
  auto load_tr = [&](int i) {
    const int mat = batch * a.h + kv_head * group + i / per_head;
    const int q0 = (first + i % per_head) * kBQ;
    mbar_expect_tx(tr_bar, 4 * G::kQTile + 2 * kBQ * 4);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int p = 0; p < kBQ / kPT; ++p) {
        const uint32_t off = t * G::kQTile + p * DP * kPT * 4;
        tma_load3(tr_s + off, &maps.qt[t], tr_bar, q0 + p * kPT, 0, mat);
        tma_load3(tr_s + 2 * G::kQTile + off, &maps.ot[t], tr_bar, q0 + p * kPT, 0, mat);
      }
    const float* l = a.work + (int64_t)mat * sq_pad + q0;
    bulk_load(rows_s, l, tr_bar, kBQ * 4);
    bulk_load(rows_s + kBQ * 4, l + (int64_t)a.b * a.h * sq_pad, tr_bar, kBQ * 4);
  };
  if (threadIdx.x == 0 && n > 0) {
    const int mat = batch * a.kh + kv_head;
    mbar_expect_tx(kv_bar, 4 * G::kTile);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int p = 0; p < DP / kP; ++p) {
        const uint32_t off = t * G::kTile + p * kRowsTf32 * kSw;
        tma_load3(kv_s + off, &maps.k[t], kv_bar, p * kP, k0, mat);
        tma_load3(kv_s + 2 * G::kTile + off, &maps.v[t], kv_bar, p * kP, k0, mat);
      }
    load_nat(0);
    load_tr(0);
  }
  __syncwarp();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const float scale2 = a.scale * kLog2e;
  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

  if (n > 0) mbar_wait(kv_bar, 0);
  for (int i = 0; i < n; ++i) {
    const int q0 = (first + i % per_head) * kBQ;
    float st[kBQ / 2], dp[kBQ / 2];
    mbar_wait(nat_bar, i & 1);
    wg_fence();
    O::template issue_d<kBQ>(st, kv_s, G::kTile, nat_s, G::kQTile);                    // Sᵀ
    O::template issue_d<kBQ>(dp, kv_s + 2 * G::kTile, G::kTile,  // dPᵀ
                             nat_s + 2 * G::kQTile, G::kQTile);
    wg_commit();
    wg_wait_all();
    fence_regs(st);
    fence_regs(dp);
    __syncthreads();  // every warp's products have read the natural stage
    if (threadIdx.x == 0 && i + 1 < n) load_nat(i + 1);

    // Pᵀ into st, dSᵀ = Pᵀ ∘ (dPᵀ - Δ) into dp, masked where the tile
    // straddles an edge (a row past Sq, or one that sees no key, has
    // L·log2 e = +inf, so its p is 0)
    mbar_wait(tr_bar, i & 1);
    const bool interior = tile_interior(a, q0, kBQ, k0, kRowsTf32);
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
      const int c = j * 8 + t4 * 2;
      const float2 l2 = *reinterpret_cast<const float2*>(rows + c);
      const float2 d2 = *reinterpret_cast<const float2*>(rows + kBQ + c);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = j * 4 + rr * 2 + e;
          float s = st[x];
          if (!interior && !visible(a, q0 + c + e, key0 + 8 * rr)) s = -INFINITY;
          const float p = exp2_ftz(fmaf(s, scale2, -(e ? l2.y : l2.x)));
          st[x] = p;
          dp[x] = p * (dp[x] - (e ? d2.y : d2.x));
        }
    }

    {  // dV += Pᵀ dO
      uint32_t hi[kBQ / 8][4], lo[kBQ / 8][4];
      O::template frags<kBQ / 8>(st, hi, lo);
      O::template add_s<kBQ / 8, kPT>(dv, hi, lo, tr_s + 2 * G::kQTile, G::kQTile);
    }
    {  // dK += dSᵀ Q
      uint32_t hi[kBQ / 8][4], lo[kBQ / 8][4];
      O::template frags<kBQ / 8>(dp, hi, lo);
      O::template add_s<kBQ / 8, kPT>(dk, hi, lo, tr_s, G::kQTile);
    }
    __syncthreads();  // every warp's products have read the transposed stage
    if (threadIdx.x == 0 && i + 1 < n) load_tr(i + 1);
  }

  // dK (scaled) and dV of the thread's keys, float32 (zeros for keys that
  // no query sees)
  const int64_t kv_stride = (int64_t)a.kh * a.d;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = key0 + 8 * rr;
    if (key >= a.sk) continue;
    const int64_t off = ((int64_t)batch * a.sk + key) * kv_stride + (int64_t)kv_head * a.d;
    float* const dkg = static_cast<float*>(a.dk) + off;
    float* const dvg = static_cast<float*>(a.dv) + off;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + t4 * 2, x = j * 4 + rr * 2;
      if (col >= a.d) continue;
      *reinterpret_cast<float2*>(dkg + col) =
          make_float2(dk[x] * a.scale, dk[x + 1] * a.scale);
      *reinterpret_cast<float2*>(dvg + col) = make_float2(dv[x], dv[x + 1]);
    }
  }
}

// dQ of 64 queries of one head: the block walks the key tiles the forward
// walks.  Per stage: S = Q Kᵀ and dP = dO Vᵀ (S and dP again: a second
// pass over the pairs, so that dQ needs no atomics and no stored dS), P and
// dS on the fragments, dQ += dS K with dS as the register A operand and K
// read from its transposed plane.
template <int DP>
__global__ void __launch_bounds__(kThreadsTf32, 1)
    dq_tf32_kernel(const __grid_constant__ DqMaps maps, Args a) {
  using G = Tf32Geometry<DP>;
  using O = Tf32Ops<DP>;
  constexpr int kP = G::kPanel, kSw = G::kSwizzle, kBK = G::kBK;
  constexpr int kPT = G::kPanelK;
  extern __shared__ unsigned char smem[];
  // Q hi, lo, dO hi, lo; the queries' L·log2 e and Δ rows; the stage's K
  // hi, lo, V hi, lo; its Kᵀ hi, lo; the resident, natural and transposed
  // barriers
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  unsigned char* const gbase = smem + (base - smem_u32(smem));
  const uint32_t q_s = base;
  const uint32_t nat_s = q_s + 4 * G::kTile;
  const uint32_t tr_s = nat_s + 4 * G::kKTile;
  const uint32_t rows_s = tr_s + 2 * G::kKTile;
  const uint32_t res_bar = rows_s + 2 * kRowsTf32 * 4, nat_bar = res_bar + 8,
                 tr_bar = res_bar + 16;
  const float* const rows = reinterpret_cast<const float*>(gbase + (rows_s - base));

  const int head = blockIdx.x % a.h, batch = blockIdx.x / a.h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRowsTf32;  // latest tiles first
  const int kv_head = head / (a.h / a.kh);
  const int sq_pad = padded_rows(a.sq);
  // key tiles [first, last) that can hold a visible key (flash.cu's
  // key_tiles)
  int end = a.kv_len;
  if (a.causal) end = min(end, min(q0 + kRowsTf32, a.sq));
  const int begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int first = begin / kBK, last = end > begin ? (end + kBK - 1) / kBK : first;
  const int n = last - first;

  if (threadIdx.x == 0) {
    mbar_init(res_bar, 1);
    mbar_init(nat_bar, 1);
    mbar_init(tr_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int kv_mat = batch * a.kh + kv_head;
  auto load_nat = [&](int j) {
    const int k0 = (first + j) * kBK;
    mbar_expect_tx(nat_bar, 4 * G::kKTile);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int p = 0; p < DP / kP; ++p) {
        const uint32_t off = t * G::kKTile + p * kBK * kSw;
        tma_load3(nat_s + off, &maps.k[t], nat_bar, p * kP, k0, kv_mat);
        tma_load3(nat_s + 2 * G::kKTile + off, &maps.v[t], nat_bar, p * kP, k0, kv_mat);
      }
  };
  auto load_tr = [&](int j) {
    const int k0 = (first + j) * kBK;
    mbar_expect_tx(tr_bar, 2 * G::kKTile);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int p = 0; p < kBK / kPT; ++p)
        tma_load3(tr_s + t * G::kKTile + p * DP * kPT * 4, &maps.kt[t], tr_bar,
                  k0 + p * kPT, 0, kv_mat);
  };
  if (threadIdx.x == 0 && n > 0) {
    const int mat = batch * a.h + head;
    mbar_expect_tx(res_bar, 4 * G::kTile + 2 * kRowsTf32 * 4);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int p = 0; p < DP / kP; ++p) {
        const uint32_t off = t * G::kTile + p * kRowsTf32 * kSw;
        tma_load3(q_s + off, &maps.q[t], res_bar, p * kP, q0, mat);
        tma_load3(q_s + 2 * G::kTile + off, &maps.o[t], res_bar, p * kP, q0, mat);
      }
    const float* l = a.work + (int64_t)mat * sq_pad + q0;
    bulk_load(rows_s, l, res_bar, kRowsTf32 * 4);
    bulk_load(rows_s + kRowsTf32 * 4, l + (int64_t)a.b * a.h * sq_pad, res_bar,
              kRowsTf32 * 4);
    load_nat(0);
    load_tr(0);
  }
  __syncwarp();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16 + g;  // this thread's queries: q0 + row0, + 8
  const float scale2 = a.scale * kLog2e;
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  float lrow[2] = {0.f, 0.f}, drow[2] = {0.f, 0.f};
  if (n > 0) {
    mbar_wait(res_bar, 0);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      lrow[rr] = rows[row0 + 8 * rr];
      drow[rr] = rows[kRowsTf32 + row0 + 8 * rr];
    }
  }

  for (int j = 0; j < n; ++j) {
    const int k0 = (first + j) * kBK;
    float st[kBK / 2], dp[kBK / 2];
    mbar_wait(nat_bar, j & 1);
    wg_fence();
    O::template issue_d<kBK>(st, q_s, G::kTile, nat_s, G::kKTile);                     // S
    O::template issue_d<kBK>(dp, q_s + 2 * G::kTile, G::kTile,  // dP
                             nat_s + 2 * G::kKTile, G::kKTile);
    wg_commit();
    wg_wait_all();
    fence_regs(st);
    fence_regs(dp);
    __syncthreads();  // every warp's products have read the natural stage
    if (threadIdx.x == 0 && j + 1 < n) load_nat(j + 1);

    // dS = P ∘ (dP - Δ) into dp, masked where the tile straddles an edge
    const bool interior = tile_interior(a, q0, kRowsTf32, k0, kBK);
#pragma unroll
    for (int jj = 0; jj < kBK / 8; ++jj)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = jj * 4 + rr * 2 + e;
          float s = st[x];
          if (!interior && !visible(a, q0 + row0 + 8 * rr, k0 + jj * 8 + t4 * 2 + e))
            s = -INFINITY;
          const float p = exp2_ftz(fmaf(s, scale2, -lrow[rr]));
          dp[x] = p * (dp[x] - drow[rr]);
        }

    mbar_wait(tr_bar, j & 1);
    {  // dQ += dS K
      uint32_t hi[kBK / 8][4], lo[kBK / 8][4];
      O::template frags<kBK / 8>(dp, hi, lo);
      O::template add_s<kBK / 8, kPT>(dq, hi, lo, tr_s, G::kKTile);
    }
    __syncthreads();  // every warp's products have read the transposed stage
    if (threadIdx.x == 0 && j + 1 < n) load_tr(j + 1);
  }

  // dQ (scaled) of the thread's queries, float32 (zeros where no key is
  // visible)
  const int64_t q_stride = (int64_t)a.h * a.d;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + row0 + 8 * rr;
    if (qi >= a.sq) continue;
    float* const row = static_cast<float*>(a.dq) + ((int64_t)batch * a.sq + qi) * q_stride +
                       (int64_t)head * a.d;
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      const int col = jj * 8 + t4 * 2, x = jj * 4 + rr * 2;
      if (col < a.d)
        *reinterpret_cast<float2*>(row + col) =
            make_float2(dq[x] * a.scale, dq[x + 1] * a.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int DP>
constexpr int smem_bytes() {
  return ((2 * kBK + 2 * kBQ) * (DP + 4) + 2 * kBQ * kLDS + 2 * kBQ) * 4;
}

// the scalar kernels (float32; bf16 at DP = 256)
template <typename T, int DP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<DP>();
  static_assert(kSmem <= 232448, "over the block's shared memory");
  static unsigned long long dkdv_in = 0, dq_in = 0;
  cudaError_t err;
  if ((err = opt_in(dkdv_kernel<T, DP>, kSmem, &dkdv_in)) != cudaSuccess ||
      (err = opt_in(dq_kernel<T, DP>, kSmem, &dq_in)) != cudaSuccess)
    return err;
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

// the wgmma path (bf16, DP <= 128): pre-pass, main kernel, finish
template <int DP>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  using G = BwdGeometry<DP>;
  const int64_t rows = (int64_t)a.b * padded_rows(a.sq) * a.h;
  const int rows_per_block = kThreads / 32;
  rows_kernel<__nv_bfloat16><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                               kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.sk > 0) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    CUtensorMap q_map, do_map, k_map, v_map;
    if (!encode_map(encode, &q_map, a.q, a.b, a.sq, a.h, a.d, G::kPanel,
                    G::kBQ, G::kSwizzle) ||
        !encode_map(encode, &do_map, a.dout, a.b, a.sq, a.h, a.d, G::kPanel,
                    G::kBQ, G::kSwizzle) ||
        !encode_map(encode, &k_map, a.k, a.b, a.sk, a.kh, a.d, G::kPanel,
                    G::kBK, G::kSwizzle) ||
        !encode_map(encode, &v_map, a.v, a.b, a.sk, a.kh, a.d, G::kPanel,
                    G::kBK, G::kSwizzle))
      return cudaErrorInvalidValue;
    static unsigned long long opted_in = 0;
    if ((err = opt_in(bwd_bf16_kernel<DP>, G::kSmem, &opted_in)) != cudaSuccess)
      return err;
    const dim3 grid(a.b * a.h, (a.sk + G::kBK - 1) / G::kBK);
    bwd_bf16_kernel<DP><<<grid, kThreads16, G::kSmem, stream>>>(
        q_map, do_map, k_map, v_map, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  finish_kernel<<<264, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// the 3xTF32 path (float32, DP <= 128): rows and planes, the dK/dV kernel,
// the dQ kernel
template <int DP>
cudaError_t launch_tf32(const Args& a, cudaStream_t stream) {
  using G = Tf32Geometry<DP>;
  const int64_t rows = (int64_t)a.b * padded_rows(a.sq) * a.h;
  const int rows_per_block = kThreads / 32;
  rows_kernel<float><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                       kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.sk == 0)  // no key: dQ is 0 (dK and dV are empty)
    return cudaMemsetAsync(a.dq, 0, (size_t)a.b * a.sq * a.h * a.d * 4, stream);
  const Tf32Planes t = tf32_planes(a);
  auto split = [&](const void* x, int seq, int heads, float* const (&n)[2],
                   float* const* tr) {
    return launch_split(split_kernel, x, a.b, seq, heads, a.d, n[0], n[1],
                        tr ? tr[0] : nullptr, tr ? tr[1] : nullptr, stream);
  };
  if ((err = split(a.q, a.sq, a.h, t.qn, t.qt)) != cudaSuccess ||
      (err = split(a.dout, a.sq, a.h, t.on, t.ot)) != cudaSuccess ||
      (err = split(a.k, a.sk, a.kh, t.kn, t.kt)) != cudaSuccess ||
      (err = split(a.v, a.sk, a.kh, t.vn, nullptr)) != cudaSuccess)
    return err;

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // a natural plane [mats, seq, d] in boxes of `rows` rows; a transposed
  // plane [mats, d, seq8] in boxes of DP rows and `panel` positions
  auto nat = [&](CUtensorMap* m, const float* p, int mats, int seq, int box) {
    const long long dims[3] = {a.d, seq, mats};
    const long long strides[2] = {4LL * a.d, 4LL * seq * a.d};
    return encode_map_f32(encode, m, p, dims, strides, G::kPanel, box);
  };
  auto trn = [&](CUtensorMap* m, const float* p, int mats, int seq, int panel) {
    const long long s8 = round8(seq);
    const long long dims[3] = {s8, a.d, mats};
    const long long strides[2] = {4 * s8, 4 * s8 * a.d};
    return encode_map_f32(encode, m, p, dims, strides, panel, DP);
  };
  const int qm = a.b * a.h, km = a.b * a.kh;
  DkdvMaps dm;
  DqMaps qmaps;
  for (int i = 0; i < 2; ++i)
    if (!nat(&dm.k[i], t.kn[i], km, a.sk, kRowsTf32) ||
        !nat(&dm.v[i], t.vn[i], km, a.sk, kRowsTf32) ||
        !nat(&dm.q[i], t.qn[i], qm, a.sq, G::kBQ) ||
        !nat(&dm.o[i], t.on[i], qm, a.sq, G::kBQ) ||
        !trn(&dm.qt[i], t.qt[i], qm, a.sq, G::kPanelQ) ||
        !trn(&dm.ot[i], t.ot[i], qm, a.sq, G::kPanelQ) ||
        !nat(&qmaps.q[i], t.qn[i], qm, a.sq, kRowsTf32) ||
        !nat(&qmaps.o[i], t.on[i], qm, a.sq, kRowsTf32) ||
        !nat(&qmaps.k[i], t.kn[i], km, a.sk, G::kBK) ||
        !nat(&qmaps.v[i], t.vn[i], km, a.sk, G::kBK) ||
        !trn(&qmaps.kt[i], t.kt[i], km, a.sk, G::kPanelK))
      return cudaErrorInvalidValue;
  static unsigned long long dkdv_in = 0, dq_in = 0;
  if ((err = opt_in(dkdv_tf32_kernel<DP>, G::kSmemDkdv, &dkdv_in)) != cudaSuccess ||
      (err = opt_in(dq_tf32_kernel<DP>, G::kSmemDq, &dq_in)) != cudaSuccess)
    return err;
  dkdv_tf32_kernel<DP><<<dim3(km, (a.sk + kRowsTf32 - 1) / kRowsTf32), kThreadsTf32,
                         G::kSmemDkdv, stream>>>(dm, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_tf32_kernel<DP><<<dim3(qm, (a.sq + kRowsTf32 - 1) / kRowsTf32), kThreadsTf32,
                       G::kSmemDq, stream>>>(qmaps, a);
  return cudaGetLastError();
}

template <int DP>
void tf32_geometry(int* out) {
  using G = Tf32Geometry<DP>;
  const int g[] = {DP, G::kPanel, G::kSwizzle, G::kBQ, G::kBK, G::kSmemDkdv,
                   G::kSmemDq, 1};
  for (int i = 0; i < 8; ++i) out[i] = g[i];
}

template <int DP>
void bwd_geometry(int* out) {
  using G = BwdGeometry<DP>;
  const int g[] = {DP, G::kPanel, G::kSwizzle, G::kBK, G::kBQ, G::kStages,
                   G::kSmem, 1};
  for (int i = 0; i < 8; ++i) out[i] = g[i];
}

int run(bool bf16, const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* work, void* dq, void* dk,
        void* dv, int b, int sq, int sk, int h, int kh, int d, int causal,
        int window, int kv_len, void* stream) {
  if (b < 1 || sq < 1 || sk < 0 || kh < 1 || h % kh != 0 || d % 8 != 0 ||
      padded_dim(d) == 0 || kv_len < 0 || kv_len > sk)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.work = static_cast<float*>(work);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.b = b; a.sq = sq; a.sk = sk; a.h = h; a.kh = kh; a.d = d;
  a.causal = causal; a.window = window; a.kv_len = kv_len;
  a.scale = (float)pow((double)d, -0.5);  // as the forward rounds it
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    switch (padded_dim(d)) {
      case 16: return (int)launch_bf16<16>(a, s);
      case 32: return (int)launch_bf16<32>(a, s);
      case 64: return (int)launch_bf16<64>(a, s);
      case 128: return (int)launch_bf16<128>(a, s);
      default: return (int)launch<__nv_bfloat16, 256>(a, s);
    }
  }
  switch (padded_dim(d)) {
    case 16: return (int)launch_tf32<16>(a, s);
    case 32: return (int)launch_tf32<32>(a, s);
    case 64: return (int)launch_tf32<64>(a, s);
    case 128: return (int)launch_tf32<128>(a, s);
    default: return (int)launch<float, 256>(a, s);
  }
}

}  // namespace

// q, o, dout, dq [B, Sq, H, D]; k, v, dk, dv [B, Sk, KH, D], all contiguous
// and 16-byte aligned, of one type; lse (the forward's) float32 [B, H, Sq];
// work a float32 workspace of the floats flash_bwd_workspace names, zeroed
// for the bf16 entry point (the float32 one writes every float it reads);
// window <= 0 means none.
// Three launches on the stream (the float32 path at DP <= 128: seven, the
// rows, four plane splits and its two kernels).  Returns a cudaError_t.
extern "C" int flash_backward_bf16(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const void* lse, void* work, void* dq,
                                   void* dk, void* dv, int b, int sq, int sk,
                                   int h, int kh, int d, int causal, int window,
                                   int kv_len, void* stream) {
  return run(true, q, k, v, o, dout, lse, work, dq, dk, dv, b, sq,
                            sk, h, kh, d, causal, window, kv_len, stream);
}

extern "C" int flash_backward_f32(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* work, void* dq,
                                  void* dk, void* dv, int b, int sq, int sk,
                                  int h, int kh, int d, int causal, int window,
                                  int kv_len, void* stream) {
  return run(false, q, k, v, o, dout, lse, work, dq, dk, dv, b, sq, sk, h, kh,
                    d, causal, window, kv_len, stream);
}

// the floats of the workspace flash_backward_{bf16,f32} take (bf16 != 0 for
// the bf16 entry point), into *out: the bf16 wgmma path's L·log2 e and Δ
// rows, padded to whole stages, its float32 dQ accumulator [B, Sq, H, D]
// and, under GQA, the dK and dV accumulators [B, Sk, KH, D]; the float32
// path's rows and 3xTF32 planes (Tf32Planes); Δ [B, H, Sq] for the scalar
// kernels (DP = 256).  Returns a cudaError_t.
extern "C" int flash_bwd_workspace(int bf16, int b, int sq, int sk, int h,
                                   int kh, int d, long long* out) {
  if (d < 8 || d % 8 != 0 || padded_dim(d) == 0)
    return (int)cudaErrorInvalidValue;
  if (padded_dim(d) == 256)
    *out = (long long)b * h * sq;
  else if (!bf16)
    *out = tf32_floats(b, sq, sk, h, kh, d);
  else
    *out = 2LL * b * h * padded_rows(sq) + (long long)b * sq * h * d +
           (h == kh ? 0 : 2LL * b * sk * kh * d);
  return 0;
}

// the bf16 instantiation for head dim d, as eight ints: padded width, panel
// columns, swizzle bytes, keys per block, queries per stage, stages,
// dynamic shared-memory bytes, and 1 for the wgmma path (DP <= 128); at
// DP = 256 the scalar kernels: 256, 0, 0, 32, 32, 0, their shared memory,
// 0.  Returns a cudaError_t.
extern "C" int flash_bwd_geometry(int d, int* out) {
  if (d < 8 || d % 8 != 0 || padded_dim(d) == 0)
    return (int)cudaErrorInvalidValue;
  switch (padded_dim(d)) {
    case 16: bwd_geometry<16>(out); break;
    case 32: bwd_geometry<32>(out); break;
    case 64: bwd_geometry<64>(out); break;
    case 128: bwd_geometry<128>(out); break;
    default: {
      const int g[] = {256, 0, 0, kBK, kBQ, 0, smem_bytes<256>(), 0};
      for (int i = 0; i < 8; ++i) out[i] = g[i];
    }
  }
  return 0;
}

// the float32 instantiation for head dim d, as eight ints: padded width,
// natural panel columns, swizzle bytes, queries a dK/dV stage, keys a dQ
// stage, the dK/dV and the dQ kernel's dynamic shared-memory bytes, and 1
// for the 3xTF32 path (DP <= 128); at DP = 256 the scalar kernels: 256, 0,
// 0, 32, 32, their shared memory twice, 0.  Returns a cudaError_t.
extern "C" int flash_bwd_f32_geometry(int d, int* out) {
  if (d < 8 || d % 8 != 0 || padded_dim(d) == 0)
    return (int)cudaErrorInvalidValue;
  switch (padded_dim(d)) {
    case 16: tf32_geometry<16>(out); break;
    case 32: tf32_geometry<32>(out); break;
    case 64: tf32_geometry<64>(out); break;
    case 128: tf32_geometry<128>(out); break;
    default: {
      const int g[] = {256, 0, 0, kBQ, kBK, smem_bytes<256>(), smem_bytes<256>(), 0};
      for (int i = 0; i < 8; ++i) out[i] = g[i];
    }
  }
  return 0;
}
