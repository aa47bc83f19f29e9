// Flash attention for Hopper (sm_90a): online-softmax attention over the
// model's [B, S, H, D] layout, with GQA, causal, sliding-window and
// key-length masks.
//
// Replaces the TPU kernel of src/repro/kernels/flash.py:
//   flash_kernel_call (_flash_kernel) -> flash_attention_{bf16,f32}
//
// What it computes, as the TPU kernel does.  For query i and key j (indices
// into the sequence, which are the positions on every call the model makes)
// the key is visible iff j < kv_len, and j <= i when causal, and
// j > i - window when a window is set.  Scores are q·k in float32 times
// D^-1/2; a running (m, l, acc) per query row in float32 folds each tile of
// keys in:  m' = max(m, max s);  p = exp(s - m') on visible keys, 0
// elsewhere (so a row with no visible key yet stays at l = 0, acc = 0);
// l' = l·exp(m - m') + Σp;  acc' = acc·exp(m - m') + p·V, with p rounded to
// V's dtype before the product.  The output is acc / max(l, 1e-30) in q's
// dtype, so a fully masked row is 0.
//
// What bounds it on an H100.  Two matrix products of 2·D flops per visible
// (query, key) pair each, against reading q, k, v and writing the output
// once: at D = 64 and thousands of keys that is hundreds of flops per byte,
// above the card's ~295 bf16 flops per byte, so the tensor cores bound it
// (989 TFLOP/s bf16).  Float32 inputs run off the tensor cores (67 TFLOP/s):
// TF32 would not hold float32 accuracy.
//
// Design.  The TPU kernel walks a sequential (head, q-block, k-block) grid
// and keeps the running state in VMEM scratch between grid steps.  Here one
// block of 4 warps owns (batch, head, 64 queries) and loops over key tiles
// itself, keeping the state in registers.  The block reads its query head's
// KV head h / (H/KH) directly: GQA costs no repeated K/V.  Tiles are bounds
// checked, so no padding is needed: rows past the sequence load as zeros and
// are never stored, and the head dim is zero-padded to the instantiation's
// width DP (16, 32, 64, 128 or 256) inside shared memory.  Key tiles wholly
// above the causal diagonal, wholly before the window, or past kv_len are
// skipped: their p would be 0 and their correction 1, so skipping is exact.
// Query blocks are issued latest first, so the longest causal rows start
// first.
//  * bf16: each warp owns 16 query rows.  S = Q·Kᵀ for a 64-key tile is
//    mma.sync m16n8k16 with float32 accumulators; the softmax runs on the
//    accumulator fragments; P (packed to bf16 straight from those
//    fragments) times V is a second mma.sync into the float32 output
//    fragments.  K is staged row-major and V transposed in shared memory,
//    each row padded by 8 values so the fragment loads hit 32 distinct banks.
//  * float32: two threads per query row, 32-key tiles; each thread forms 16
//    scores with float4 dot products and owns half of the row's output
//    columns; p goes through shared memory between the two products.
// Not yet used: wgmma, TMA, warp specialisation, double buffering.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kThreads = 128;  // 4 warps
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;  // [B, Sq, H, D]
  const void* k;  // [B, Sk, KH, D]
  const void* v;  // [B, Sk, KH, D]
  void* out;      // [B, Sq, H, D]
  int sq, sk, h, kh, d, causal, window, kv_len;
  float scale;
};

__device__ __forceinline__ bool visible(const Args& a, int i, int j) {
  return j < a.kv_len && (!a.causal || j <= i) &&
         (a.window <= 0 || j > i - a.window);
}

// key tiles [*first, *last) that can hold a visible key for queries
// [q0, q0 + kBQ)
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int bk,
                                          int* first, int* last) {
  int end = a.kv_len;
  if (a.causal) end = min(end, min(q0 + kBQ, a.sq));
  int begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  *first = begin / bk;
  *last = end > begin ? (end + bk - 1) / bk : *first;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, float32 accumulate)
// ---------------------------------------------------------------------------

constexpr int kBK16 = 64;            // keys per tile
constexpr int kLDV = kBK16 + 8;      // transposed V row (bf16 values)

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + nrows) of a [*, stride] bf16 matrix into shared memory,
// 8 values (16 bytes) per load; rows past `limit` and columns past d are 0.
// transpose = false: dst[r][c] with row length ld; true: dst[c][r].
template <int DP, bool kTranspose>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* src,
                                           int64_t stride, int r0, int nrows,
                                           int limit, int d) {
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < nrows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < limit && c < d)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    if (!kTranspose) {
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[(c + i) * ld + r] = e[i];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bf16_kernel(Args a) {
  constexpr int kLDQ = DP + 8;  // Q / K row (bf16 values)
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [kBQ][kLDQ]
  __nv_bfloat16* ks = qs + kBQ * kLDQ;                           // [kBK16][kLDQ]
  __nv_bfloat16* vt = ks + kBK16 * kLDQ;                         // [DP][kLDV]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int kv_head = head / (a.h / a.kh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const int64_t q_stride = (int64_t)a.h * a.d, kv_stride = (int64_t)a.kh * a.d;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) +
                            ((int64_t)batch * a.sq * a.h + head) * a.d;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) +
                            ((int64_t)batch * a.sk * a.kh + kv_head) * a.d;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) +
                            ((int64_t)batch * a.sk * a.kh + kv_head) * a.d;

  stage_bf16<DP, false>(qs, kLDQ, qg, q_stride, q0, kBQ, a.sq, a.d);

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_row[2] = {kNegInf, kNegInf}, l_row[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  int first, last;
  key_tiles(a, q0, kBK16, &first, &last);
  for (int kt = first; kt < last; ++kt) {
    const int k0 = kt * kBK16;
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    stage_bf16<DP, false>(ks, kLDQ, kg, kv_stride, k0, kBK16, a.sk, a.d);
    stage_bf16<DP, true>(vt, kLDV, vg, kv_stride, k0, kBK16, a.sk, a.d);
    __syncthreads();

    // S = Q Kᵀ: 16 rows x 64 keys per warp, eight 16x8 fragments
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const __nv_bfloat16* qa = qs + (warp * 16 + g) * kLDQ + kk * 16 + t4 * 2;
      const uint32_t af[4] = {ld32(qa), ld32(qa + 8 * kLDQ), ld32(qa + 8),
                              ld32(qa + 8 * kLDQ + 8)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* kb = ks + (j * 8 + g) * kLDQ + kk * 16 + t4 * 2;
        mma_bf16(s[j], af, ld32(kb), ld32(kb + 8));
      }
    }

    // online softmax on the fragments: element (j, e) of row rr is key
    // k0 + 8j + 2·t4 + (e & 1), row row0 + 8·rr with rr = e >> 1
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qi = row0 + 8 * rr;
      uint32_t vis = 0;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bit = j * 2 + e;
          float x = s[j][rr * 2 + e] * a.scale;
          if (visible(a, qi, k0 + j * 8 + t4 * 2 + e)) {
            vis |= 1u << bit;
          } else {
            x = kNegInf;
          }
          s[j][rr * 2 + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m_row[rr], mx);
      const float corr = expf(m_row[rr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = (vis >> (j * 2 + e)) & 1u
                              ? expf(s[j][rr * 2 + e] - m_new) : 0.f;
          s[j][rr * 2 + e] = p;
          sum += p;
        }
      }
      // l stays a per-thread partial over its columns; the four threads of
      // a row are summed once at the end
      l_row[rr] = l_row[rr] * corr + sum;
      m_row[rr] = m_new;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[n][rr * 2] *= corr;
        o[n][rr * 2 + 1] *= corr;
      }
    }

    // O += P V, P rounded to bf16 from the score fragments
#pragma unroll
    for (int t = 0; t < kBK16 / 16; ++t) {
      const uint32_t pf[4] = {
          pack_bf16(s[2 * t][0], s[2 * t][1]),
          pack_bf16(s[2 * t][2], s[2 * t][3]),
          pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
          pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]),
      };
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const __nv_bfloat16* vb = vt + (n * 8 + g) * kLDV + t * 16 + t4 * 2;
        mma_bf16(o[n], pf, ld32(vb), ld32(vb + 8));
      }
    }
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out) +
                      ((int64_t)batch * a.sq * a.h + head) * a.d;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_row[rr];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    const float denom = fmaxf(l, 1e-30f);
    const int qi = row0 + 8 * rr;
    if (qi >= a.sq) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + t4 * 2;
      if (c < a.d)
        *reinterpret_cast<__nv_bfloat162*>(og + qi * q_stride + c) =
            __floats2bfloat162_rn(o[n][rr * 2] / denom,
                                  o[n][rr * 2 + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs (two threads per query row)
// ---------------------------------------------------------------------------

constexpr int kBK32 = 32;        // keys per tile
constexpr int kHalfKeys = kBK32 / 2;
constexpr int kLDP = kBK32 + 1;  // p row (floats)

// rows [r0, r0 + nrows) of a [*, stride] float matrix into dst[r][c] (row
// length ld), 4 values (16 bytes) per load; rows past `limit` and columns
// past d are 0
template <int DP>
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src,
                                          int64_t stride, int r0, int nrows,
                                          int limit, int d) {
  constexpr int kChunks = DP / 4;
  for (int idx = threadIdx.x; idx < nrows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit && c < d)
      val = *reinterpret_cast<const float4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(Args a) {
  constexpr int kLD = DP + 4;  // padded row (floats)
  constexpr int kHalfD = DP / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kBQ][kLD]
  float* ks = qs + kBQ * kLD;                  // [kBK32][kLD]
  float* vs = ks + kBK32 * kLD;                // [kBK32][kLD]
  float* ps = vs + kBK32 * kLD;                // [kBQ][kLDP]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int kv_head = head / (a.h / a.kh);
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int qi = q0 + r;

  const int64_t q_stride = (int64_t)a.h * a.d, kv_stride = (int64_t)a.kh * a.d;
  const float* qg = static_cast<const float*>(a.q) +
                    ((int64_t)batch * a.sq * a.h + head) * a.d;
  const float* kg = static_cast<const float*>(a.k) +
                    ((int64_t)batch * a.sk * a.kh + kv_head) * a.d;
  const float* vg = static_cast<const float*>(a.v) +
                    ((int64_t)batch * a.sk * a.kh + kv_head) * a.d;

  stage_f32<DP>(qs, kLD, qg, q_stride, q0, kBQ, a.sq, a.d);

  float o[kHalfD];  // output columns half·DP/2 + [0, DP/2)
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) o[i] = 0.f;
  float m_row = kNegInf, l_part = 0.f;

  int first, last;
  key_tiles(a, q0, kBK32, &first, &last);
  for (int kt = first; kt < last; ++kt) {
    const int k0 = kt * kBK32;
    __syncthreads();
    stage_f32<DP>(ks, kLD, kg, kv_stride, k0, kBK32, a.sk, a.d);
    stage_f32<DP>(vs, kLD, vg, kv_stride, k0, kBK32, a.sk, a.d);
    __syncthreads();

    // this thread's 16 keys: k0 + half·16 + c
    float s[kHalfKeys];
#pragma unroll
    for (int c = 0; c < kHalfKeys; ++c) s[c] = 0.f;
    const float* qrow = qs + r * kLD;
#pragma unroll 4
    for (int dd = 0; dd < DP; dd += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(qrow + dd);
#pragma unroll
      for (int c = 0; c < kHalfKeys; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(
            ks + (half * kHalfKeys + c) * kLD + dd);
        s[c] = fmaf(q4.x, k4.x, s[c]);
        s[c] = fmaf(q4.y, k4.y, s[c]);
        s[c] = fmaf(q4.z, k4.z, s[c]);
        s[c] = fmaf(q4.w, k4.w, s[c]);
      }
    }
    uint32_t vis = 0;
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kHalfKeys; ++c) {
      float x = s[c] * a.scale;
      if (visible(a, qi, k0 + half * kHalfKeys + c)) {
        vis |= 1u << c;
      } else {
        x = kNegInf;
      }
      s[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    const float m_new = fmaxf(m_row, mx);
    const float corr = expf(m_row - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kHalfKeys; ++c) {
      const float p = (vis >> c) & 1u ? expf(s[c] - m_new) : 0.f;
      ps[r * kLDP + half * kHalfKeys + c] = p;
      sum += p;
    }
    l_part = l_part * corr + sum;
    m_row = m_new;
    __syncwarp();  // the row's partner thread (same warp) wrote its half of p

#pragma unroll
    for (int i = 0; i < kHalfD; ++i) o[i] *= corr;
    for (int c = 0; c < kBK32; ++c) {
      const float p = ps[r * kLDP + c];
      const float* vrow = vs + c * kLD + half * kHalfD;
#pragma unroll
      for (int i = 0; i < kHalfD; i += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vrow + i);
        o[i] = fmaf(p, v4.x, o[i]);
        o[i + 1] = fmaf(p, v4.y, o[i + 1]);
        o[i + 2] = fmaf(p, v4.z, o[i + 2]);
        o[i + 3] = fmaf(p, v4.w, o[i + 3]);
      }
    }
  }

  const float l = l_part + __shfl_xor_sync(kFull, l_part, 1);
  const float denom = fmaxf(l, 1e-30f);
  if (qi >= a.sq) return;
  float* og = static_cast<float*>(a.out) +
              ((int64_t)batch * a.sq * a.h + head) * a.d + qi * q_stride;
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) {
    const int c = half * kHalfD + i;
    if (c < a.d) og[c] = o[i] / denom;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int DP>
cudaError_t launch_bf16(const Args& a, int b, cudaStream_t stream) {
  constexpr int kSmem =
      (kBQ + kBK16) * (DP + 8) * 2 + DP * kLDV * 2;  // bytes
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, b);
  flash_bf16_kernel<DP><<<grid, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const Args& a, int b, cudaStream_t stream) {
  constexpr int kSmem =
      ((kBQ + 2 * kBK32) * (DP + 4) + kBQ * kLDP) * 4;  // bytes
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, b);
  flash_f32_kernel<DP><<<grid, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

// the instantiation width for head dim d: the least of 16, 32, 64, 128, 256
// that holds it (0 if none does)
int padded_dim(int d) {
  for (int dp = 16; dp <= 256; dp *= 2)
    if (d <= dp) return dp;
  return 0;
}

Args make_args(const void* q, const void* k, const void* v, void* out, int sq,
               int sk, int h, int kh, int d, int causal, int window,
               int kv_len) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.sq = sq; a.sk = sk; a.h = h; a.kh = kh; a.d = d;
  a.causal = causal; a.window = window; a.kv_len = kv_len;
  a.scale = (float)pow((double)d, -0.5);  // D^-1/2 rounded once to float
  return a;
}

bool bad_shape(int b, int sq, int sk, int h, int kh, int d, int kv_len) {
  return b < 1 || sq < 1 || sk < 0 || kh < 1 || h % kh != 0 || d % 8 != 0 ||
         padded_dim(d) == 0 || kv_len < 0 || kv_len > sk;
}

}  // namespace

// q [B, Sq, H, D], k / v [B, Sk, KH, D], out [B, Sq, H, D], all contiguous
// and 16-byte aligned; window <= 0 means none.  Returns a cudaError_t.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* out, int b, int sq, int sk, int h,
                                    int kh, int d, int causal, int window,
                                    int kv_len, void* stream) {
  if (bad_shape(b, sq, sk, h, kh, d, kv_len)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, out, sq, sk, h, kh, d, causal, window, kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_dim(d)) {
    case 16: return (int)launch_bf16<16>(a, b, s);
    case 32: return (int)launch_bf16<32>(a, b, s);
    case 64: return (int)launch_bf16<64>(a, b, s);
    case 128: return (int)launch_bf16<128>(a, b, s);
    default: return (int)launch_bf16<256>(a, b, s);
  }
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int b, int sq, int sk, int h,
                                   int kh, int d, int causal, int window,
                                   int kv_len, void* stream) {
  if (bad_shape(b, sq, sk, h, kh, d, kv_len)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, out, sq, sk, h, kh, d, causal, window, kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_dim(d)) {
    case 16: return (int)launch_f32<16>(a, b, s);
    case 32: return (int)launch_f32<32>(a, b, s);
    case 64: return (int)launch_f32<64>(a, b, s);
    case 128: return (int)launch_f32<128>(a, b, s);
    default: return (int)launch_f32<256>(a, b, s);
  }
}
