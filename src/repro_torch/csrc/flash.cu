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
// dtype, so a fully masked row is 0.  Given a pointer (training), each
// kernel also writes the row log-sum-exp L = m + ln l in float32, [B, H,
// Sq], -inf for a row that sees no key: flash_bwd.cu recomputes the
// probabilities from it.  Serving passes none.
//
// What bounds it on an H100.  Two matrix products of 2·D flops per visible
// (query, key) pair each, against reading q, k, v and writing the output
// once: at D = 64 and thousands of keys that is hundreds of flops per byte,
// above the card's ~295 bf16 flops per byte, so the tensor cores bound it
// (989 TFLOP/s bf16).  Float32 runs on them too, as 3xTF32: plain TF32
// keeps 10 mantissa bits (about 1e-3), so each operand x is split into
// hi = tf32(x) and lo = tf32(x - hi) and a·b is taken as hi·hi + hi·lo +
// lo·hi in float32 accumulators, about 2^-21 relative (bound: 3x the
// operations at 495 TFLOP/s, against 67 TFLOP/s of scalar float32 FMAs).
//
// Design, shared.  The TPU kernel walks a sequential (head, q-block,
// k-block) grid and keeps the running state in VMEM scratch between grid
// steps.  Here one block owns (batch, head, a tile of queries) and loops
// over key tiles itself, keeping the state in registers.  The block reads
// its query head's KV head h / (H/KH) in place: GQA costs no repeated K/V.
// Key tiles wholly above the causal diagonal, wholly before the window, or
// past kv_len are skipped: their p would be 0 and their correction 1, so
// skipping is exact.  Query tiles are issued latest first, so the longest
// causal rows start first (the wgmma kernels: across all heads and
// batches).
//
// bf16 (warp-specialised, 384 threads, 128 queries per block; the Hopper
// helpers, mbarriers, TMA, descriptors and wgmma, are hopper.cuh's, shared
// with flash_bwd.cu):
//  * Warpgroup 2 is the producer: one thread loads the block's Q tile once
//    and then keeps a ring of K/V stages in flight with TMA
//    (cp.async.bulk.tensor, 4-d tensor maps over [B, S, heads, D] built on
//    the host and passed as __grid_constant__ parameters).  Each stage has
//    a full mbarrier (the TMA's transaction bytes) and an empty mbarrier
//    (one arrival per consumer thread); a thread's phase parity is its
//    tile count over the ring depth, so any depth fits any tile count.
//    TMA zero-fills rows past the sequence and columns past D, so no
//    bounds checks and no padding.
//  * Warpgroups 0 and 1 are consumers, 64 query rows each (wgmma's M), and
//    take the registers the producer gives up (setmaxnreg).  S = Q·Kᵀ is
//    wgmma m64nNk16 (N = 128 or 64 keys) with Q and K read from shared
//    memory, both K-major; the online softmax runs on the float32
//    accumulator fragments in the log2 domain (one FMA and one ex2 per
//    score, D^-1/2·log2 e folded into the scale); the visibility predicate
//    runs only on tiles that straddle the diagonal, the window edge or
//    kv_len.  P, packed to bf16 from those fragments, is the register A
//    operand of O += P·V, whose B operand is V read in place from the TMA
//    stage as an MN-major matrix (the transpose bit).
//  * Each consumer takes one tile at a time (S, softmax, P·V, release the
//    stage); the two run unsynchronised, so one's softmax overlaps the
//    other's products.  Explicit turns between them (named barriers),
//    overlapping a tile's softmax with the previous tile's P·V inside one
//    consumer, and a third consumer warpgroup were tried and measured no
//    faster (PERF.md, Findings).
//  * Shared-memory tiles are stored in panels of min(DP, 64) columns, each
//    row of a panel one swizzle span (32, 64 or 128 bytes for DP = 16, 32,
//    >= 64), so the TMA swizzle mode and the wgmma descriptors' layout
//    agree per width; a P·V wgmma covers one panel (N <= 64).  Key tiles
//    are 128 keys for DP <= 64 and 64 above, in a ring of 3 stages (2 for
//    DP >= 128, measured faster there): Bf16Geometry, mirrored for the
//    tests in kernels/flash.py.
//  * Each consumer sums l across the four threads of a row at the end,
//    divides and stores bf16 rows below Sq.
//
// float32 at DP <= 128 (3xTF32 on wgmma; the hi / lo planes and the
// products on them, split_planes and Tf32Ops, are hopper.cuh's, shared
// with flash_bwd.cu's float32 backward):
//  * The TF32 wgmma reads both operands K-major only (its transpose
//    immediates exist for 16-bit types alone), and O += P·V contracts over
//    the keys, V's non-contiguous dimension.  So a pre-pass
//    (fwd_split_kernel, three launches) writes into the caller's workspace
//    the hi / lo planes of Q and K, natural [B·heads, S, d], and of V,
//    transposed [B·KH, d, S8] with the keys permuted within each 8: P, the
//    register A operand, holds a thread's accumulator columns (2t4,
//    2t4 + 1) as k = t4 and t4 + 4.  The workspace (fwd_planes,
//    flash_f32_workspace floats) is written in full before it is read.
//  * The main kernel (flash_tf32_kernel) has the bf16 kernel's shape, with
//    a producer warp in place of a warpgroup (288 threads: every thread
//    holds 168 registers either way).  One producer thread loads both
//    consumers' Q hi / lo once and then each key tile's K hi / lo and Vᵀ
//    hi / lo by TMA (128-byte swizzled panels of 32 float32 columns or
//    keys, 64-byte at DP = 16), K and Vᵀ on their own full / empty
//    mbarriers, so the next K tile loads while this one's P·V runs; two
//    consumer warpgroups of 64 queries.  S = Q Kᵀ is three shared-memory
//    products a k-step of 8; the online softmax runs on the fragments as
//    in bf16; P is split in registers, and O += P·V is three register-A
//    products a k-step, 32 keys at a time, into a fresh accumulator that
//    is added to O in float32 (O·corr + P·V): the tensor cores'
//    accumulation rounds toward zero, and summed in them over thousands
//    of keys it would drift.
//  * A consumer skips, still waiting on and releasing each tile, the key
//    tiles that none of its 64 rows can see (under causal masking the
//    block's last tile for the first warpgroup; every tile for a second
//    warpgroup whose rows lie past Sq, whose Q is then not loaded).
//  * hi and lo double every tile: 128 queries' resident Q takes 64 KiB at
//    DP = 64 and 128 KiB at 128, so a key tile is 64 keys, 32 at DP = 128
//    (Tf32FwdGeometry, mirrored in kernels/flash.py's f32_geometry;
//    flash_f32_geometry reports it).  Choices measured with
//    tools/flash_variants.py --dtype float32 are in PERF.md (Findings).
// float32 at DP = 256 (no config has that width): scalar FMAs, 4 warps, 64
// queries per block, two threads per query row, 32-key tiles; each thread
// forms 16 scores with float4 dot products and owns half of the row's
// output columns; p goes through shared memory between the two products.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;        // queries per scalar float32 block
constexpr int kThreads = 128;  // 4 warps (scalar float32)
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;  // [B, Sq, H, D]
  const void* k;  // [B, Sk, KH, D]
  const void* v;  // [B, Sk, KH, D]
  void* out;      // [B, Sq, H, D]
  float* lse;     // [B, H, Sq] row log-sum-exp, or null (serving)
  int sq, sk, h, kh, d, causal, window, kv_len;
  float scale;
};

__device__ __forceinline__ bool visible(const Args& a, int i, int j) {
  return j < a.kv_len && (!a.causal || j <= i) &&
         (a.window <= 0 || j > i - a.window);
}

// key tiles [*first, *last) that can hold a visible key for queries
// [q0, q0 + bq)
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int bk,
                                          int* first, int* last,
                                          int bq = kBQ) {
  int end = a.kv_len;
  if (a.causal) end = min(end, min(q0 + bq, a.sq));
  int begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  *first = begin / bk;
  *last = end > begin ? (end + bk - 1) / bk : *first;
}

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed stages, one producer and two consumer warpgroups
// ---------------------------------------------------------------------------

// (the 128-query block of two consumer warpgroups is the 3xTF32 kernel's too)
constexpr int kBQ16 = 128;            // queries per block
constexpr int kRowsWG = 64;           // queries per consumer warpgroup
constexpr int kConsumers = 256;       // two consumer warpgroups
constexpr int kThreads16 = 384;       // + one producer warpgroup
// setmaxnreg moves registers within the block: the launch gives every
// thread 168 (64 K / 384, rounded down to 8); the producer warpgroup drops
// to 24, so the consumers can rise to 240 (128·24 + 256·240 = 384·168)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the instantiation for padded width DP; flash_bf16_geometry reports it
template <int DP>
struct Bf16Geometry {
  static constexpr int kPanel = DP < 64 ? DP : 64;  // columns per panel
  static constexpr int kSwizzle = kPanel * 2;       // bytes per panel row
  static constexpr int kPanels = DP / kPanel;
  static constexpr int kBK = DP >= 128 ? 64 : 128;  // keys per tile
  static constexpr int kStages = DP >= 128 ? 2 : 3;
  static constexpr int kQBytes = kBQ16 * DP * 2;
  static constexpr int kTileBytes = kBK * DP * 2;   // one K or one V tile
  static constexpr int kBarBytes = (2 * kStages + 1) * 8;
  // + 1024: the base is rounded up to the 128-byte swizzle's 1 KiB repeat
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kTileBytes + kBarBytes;
  static_assert(kSmem <= 232448, "over the block's shared memory");
  static_assert((kBK == 64 || kBK == 128) && DP % kPanel == 0, "tile shape");
};

// every key of [k0, k0 + bk) visible to every query of [r0, r0 + rows): the
// tile needs no mask
__device__ __forceinline__ bool tile_interior(const Args& a, int r0, int rows,
                                              int k0, int bk) {
  return k0 + bk <= a.kv_len && (!a.causal || k0 + bk - 1 <= r0) &&
         (a.window <= 0 || k0 > r0 + rows - 1 - a.window);
}

// the online-softmax step of one consumer warpgroup on a key tile of BK
// keys, on the S accumulator fragments (element 4j + 2rr + e is query
// row0 + 8rr, key k0 + 8j + 2t4 + e: wgmma's layout, g = lane / 4 and
// t4 = lane % 4 within each warp's 16 rows): scores (masked when the tile
// straddles an edge) become p = exp2(s·scale2 - m), m kept in the log2
// domain; m and l move on; corr is the factor for O
template <int BK>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], float (&m_row)[2],
                                               float (&l_row)[2], float (&corr)[2],
                                               const Args& a, int r0, int row0, int t4,
                                               int k0, float scale2) {
  if (!tile_interior(a, r0, kRowsWG, k0, BK)) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!visible(a, row0 + 8 * (e >> 1), k0 + j * 8 + t4 * 2 + (e & 1)))
          sc[j * 4 + e] = -INFINITY;
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[j * 4 + rr * 2], sc[j * 4 + rr * 2 + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m_row[rr], mx * scale2);  // scale2 > 0
    // a row with no visible key so far keeps m = -inf; subtracting 0 then
    // gives p = 2^-inf = 0 exactly (never exp(-inf - -inf) = 1)
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    corr[rr] = exp2_ftz(m_row[rr] - m_use);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[j * 4 + rr * 2 + e];
        x = exp2_ftz(fmaf(x, scale2, -m_use));
        sum += x;
      }
    // l stays a per-thread partial over its columns; the four threads of
    // a row are summed once at the end
    l_row[rr] = l_row[rr] * corr[rr] + sum;
    m_row[rr] = m_new;
  }
}

// one consumer warpgroup's work on a key tile, on register fragments:
// score element 4j + 2rr + e is query row0 + 8rr, key k0 + 8j + 2t4 + e
// (wgmma's accumulator layout, g = lane / 4 and t4 = lane % 4 within each
// warp's 16 rows)
template <int DP>
struct TileOps {
  using G = Bf16Geometry<DP>;
  static constexpr int kPanel = G::kPanel, kSw = G::kSwizzle, kBK = G::kBK;
  typedef float Scores[kBK / 2];
  typedef float Out[G::kPanels][kPanel / 2];
  typedef uint32_t Probs[kBK / 16][4];

  // S = Q Kᵀ, 64 rows x kBK keys (issued, not waited)
  __device__ __forceinline__ static void issue_qk(Scores& sc, uint32_t q_wg,
                                                  uint32_t k_s) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int p = kk * 16 / kPanel, col_bytes = (kk * 16 % kPanel) * 2;
      const uint64_t da = smem_desc<kSw>(q_wg + p * kBQ16 * kSw + col_bytes, 1);
      const uint64_t db = smem_desc<kSw>(k_s + p * kBK * kSw + col_bytes, 1);
      WgmmaSS<kBK>::run(sc, da, db, kk > 0);
    }
  }

  // O += P V: 16 keys a step, one wgmma per panel, V read MN-major from
  // the stage (issued, not waited).  One panel is one swizzle span wide, so
  // the leading offset (the next span along N) is never used; both offsets
  // name the 8-row step.
  __device__ __forceinline__ static void issue_pv(Out& o, const Probs& pa,
                                                  uint32_t v_s) {
#pragma unroll
    for (int kt = 0; kt < kBK / 16; ++kt)
#pragma unroll
      for (int p = 0; p < G::kPanels; ++p) {
        const uint64_t db = smem_desc<kSw>(
            v_s + p * kBK * kSw + kt * 16 * kSw, 8 * kSw / 16);
        WgmmaRS<kPanel>::run(o[p], pa[kt], db);
      }
  }

  __device__ __forceinline__ static void rescale(Out& o,
                                                 const float (&corr)[2]) {
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p)
#pragma unroll
      for (int j = 0; j < kPanel / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[p][j * 4 + e] *= corr[e >> 1];
  }

  // P rounded to bf16 from the score fragments: the A fragment of 16 keys
  // holds rows g, g + 8 and keys 2t4, 2t4 + 8 (two 8-key blocks)
  __device__ __forceinline__ static void pack(const Scores& sc, Probs& pa) {
#pragma unroll
    for (int kt = 0; kt < kBK / 16; ++kt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kt][r] = pack_bf16(sc[kt * 8 + 2 * r], sc[kt * 8 + 2 * r + 1]);
  }
};

template <int DP>
__global__ void __launch_bounds__(kThreads16, 1)
    flash_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, Args a) {
  using G = Bf16Geometry<DP>;
  constexpr int kPanel = G::kPanel, kSw = G::kSwizzle, kBK = G::kBK;
  constexpr int kStages = G::kStages;
  extern __shared__ unsigned char smem[];
  // shared-space addresses: Q panels, then per stage a K and a V tile (each
  // its panels one after another), then the barriers
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = q_s + G::kQBytes;
  const uint32_t bars = kv_s + 2 * kStages * G::kTileBytes;
  const uint32_t q_bar = bars + 16 * kStages;  // full: bars + 8s, empty: + 8(S + s)

  // blocks start in index order, x fastest: every (batch, head) of the
  // last query tile, then of the one before, so the longest causal rows
  // start first across all heads
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ16;
  const int head = blockIdx.x % a.h, batch = blockIdx.x / a.h;
  int first, last;
  key_tiles(a, q0, kBK, &first, &last, kBQ16);
  const int n_tiles = last - first;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers && n_tiles > 0) {
      const int kv_head = head / (a.h / a.kh);
      mbar_expect_tx(q_bar, G::kQBytes);
#pragma unroll
      for (int p = 0; p < G::kPanels; ++p)
        tma_load(q_s + p * kBQ16 * kSw, &q_map, q_bar, p * kPanel, head, q0,
                 batch);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(bars + 8 * (kStages + s), ((i / kStages) & 1) ^ 1);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, 2 * G::kTileBytes);
        const uint32_t k_s = kv_s + 2 * s * G::kTileBytes;
        const uint32_t v_s = k_s + G::kTileBytes;
        const int k0 = (first + i) * kBK;
#pragma unroll
        for (int p = 0; p < G::kPanels; ++p) {
          tma_load(k_s + p * kBK * kSw, &k_map, full, p * kPanel, kv_head, k0,
                   batch);
          tma_load(v_s + p * kBK * kSw, &v_map, full, p * kPanel, kv_head, k0,
                   batch);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  using T = TileOps<DP>;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + wg * kRowsWG;
  const int row0 = r0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const uint32_t q_wg = q_s + wg * kRowsWG * kSw;
  const float scale2 = a.scale * kLog2e;  // scores in the log2 domain

  typename T::Out o;
#pragma unroll
  for (int p = 0; p < G::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < kPanel / 2; ++i) o[p][i] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    typename T::Scores sc;
    typename T::Probs pa;
    float corr[2];
    mbar_wait(q_bar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      mbar_wait(bars + 8 * s, (i / kStages) & 1);
      wg_fence();
      T::issue_qk(sc, q_wg, kv_s + 2 * s * G::kTileBytes);
      wg_commit();
      wg_wait_all();
      fence_regs(sc);
      online_softmax<kBK>(sc, m_row, l_row, corr, a, r0, row0, t4,
                          (first + i) * kBK, scale2);
      T::rescale(o, corr);
      T::pack(sc, pa);
      fence_regs(o);
      fence_regs(pa);
      wg_fence();
      T::issue_pv(o, pa, kv_s + (2 * s + 1) * G::kTileBytes);
      wg_commit();
      wg_wait_all();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(bars + 8 * (kStages + s));  // done with stage s
    }
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out) +
                      ((int64_t)batch * a.sq * a.h + head) * a.d;
  const int64_t q_stride = (int64_t)a.h * a.d;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_row[rr];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    const float denom = fmaxf(l, 1e-30f);
    const int qi = row0 + 8 * rr;
    if (qi >= a.sq) continue;
    // L = ln Σ exp(s·scale) = (m + log2 l)·ln 2 (m in the log2 domain); a
    // row that saw no key gets -inf
    if (a.lse != nullptr && t4 == 0)
      a.lse[((int64_t)batch * a.h + head) * a.sq + qi] =
          l > 0.f ? (m_row[rr] + log2f(l)) * kLn2 : -INFINITY;
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p)
#pragma unroll
      for (int j = 0; j < kPanel / 8; ++j) {
        const int col = p * kPanel + j * 8 + t4 * 2;
        if (col < a.d)
          *reinterpret_cast<__nv_bfloat162*>(og + qi * q_stride + col) =
              __floats2bfloat162_rn(o[p][j * 4 + rr * 2] / denom,
                                    o[p][j * 4 + rr * 2 + 1] / denom);
      }
  }
}

// ---------------------------------------------------------------------------
// float32 at DP <= 128: 3xTF32 wgmma on TMA-fed K and Vᵀ tiles, a producer
// warp and two consumer warpgroups
// ---------------------------------------------------------------------------

// the float32 instantiation for padded width DP; flash_f32_geometry reports
// it
template <int DP>
struct Tf32FwdGeometry {
  static constexpr int kPanel = Tf32Ops<DP>::kP;  // floats a natural panel row
  static constexpr int kSwizzle = kPanel * 4;     // bytes a natural panel row
  // keys a tile: at DP = 128 the resident Q takes 128 KiB
  static constexpr int kBK = DP >= 128 ? 32 : 64;
  static constexpr int kPanelV = kBK < 32 ? kBK : 32;  // keys a Vᵀ panel row
  static constexpr int kQTile = kRowsWG * DP * 4;  // a warpgroup's hi or lo Q
  static constexpr int kKTile = kBK * DP * 4;      // a hi or lo K (or Vᵀ) tile
  // + 1024: the base rounded up to the 1 KiB swizzle repeat; then both
  // warpgroups' Q hi and lo, K hi and lo, Vᵀ hi and lo, five mbarriers
  static constexpr int kSmem = 1024 + 4 * kQTile + 4 * kKTile + 5 * 8;
  static_assert(kSmem <= 232448, "over the block's shared memory");
  static_assert(DP % kPanel == 0 && kBK % kPanelV == 0 && kRowsWG == Tf32Ops<DP>::kM,
                "tile shape");
};

// [0] hi, [1] lo of each plane the kernel reads by TMA
struct Tf32Maps {
  CUtensorMap q[2], k[2], v[2];  // v: the transposed plane
};

// two consumer warpgroups and one producer warp.  Nine or twelve warps put
// three on an SM sub-partition (16,384 registers), so ptxas holds every
// thread to 168 either way, and setmaxnreg's move of registers from a
// producer warpgroup to the consumers bought nothing (PERF.md, Findings):
// a warp does the producer's work without it.
constexpr int kThreadsTf32 = kConsumers + 32;

template <int DP>
__global__ void __launch_bounds__(kThreadsTf32, 1)
    flash_tf32_kernel(const __grid_constant__ Tf32Maps maps, Args a) {
  using G = Tf32FwdGeometry<DP>;
  using O = Tf32Ops<DP>;
  constexpr int kP = G::kPanel, kSw = G::kSwizzle, kBK = G::kBK;
  constexpr int kPV = G::kPanelV;
  // keys of P a P·V chunk (one Vᵀ panel): its hi and lo fragments, in
  // registers until the chunk's products end, are 32 registers where a
  // 64-key tile's would be 64, and the kernel holds 168 a thread (see
  // kThreadsTf32)
  constexpr int kPC = kPV;
  extern __shared__ unsigned char smem[];
  // shared-space addresses: warpgroup w's Q hi and lo at q_s + 2w·kQTile,
  // K hi and lo at k_s, Vᵀ hi and lo at v_s (each tile its panels one
  // after another); then the barriers: K full and empty, V full and empty,
  // Q.  K and V each ride their own pair, so the next K tile loads while
  // this one's P·V runs and the next Vᵀ tile while the next S = Q Kᵀ runs
  // (a ring of two 64-key stages measured slower: PERF.md, Findings)
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + 4 * G::kQTile;
  const uint32_t v_s = k_s + 2 * G::kKTile;
  const uint32_t k_full = v_s + 2 * G::kKTile, k_empty = k_full + 8;
  const uint32_t v_full = k_full + 16, v_empty = k_full + 24, q_bar = k_full + 32;

  // blocks start in index order, x fastest: every (batch, head) of the
  // last query tile, then of the one before
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ16;
  const int head = blockIdx.x % a.h, batch = blockIdx.x / a.h;
  int first, last;
  key_tiles(a, q0, kBK, &first, &last, kBQ16);
  const int n_tiles = last - first;
  const int q_wgs = q0 + kRowsWG < a.sq ? 2 : 1;  // warpgroups with rows below Sq

  if (threadIdx.x == 0) {
    mbar_init(k_full, 1);
    mbar_init(k_empty, kConsumers);
    mbar_init(v_full, 1);
    mbar_init(v_empty, kConsumers);
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp: one thread issues every load ----
    if (threadIdx.x == kConsumers && n_tiles > 0) {
      const int q_mat = batch * a.h + head;
      const int kv_mat = batch * a.kh + head / (a.h / a.kh);
      mbar_expect_tx(q_bar, 2 * q_wgs * G::kQTile);
      for (int w = 0; w < q_wgs; ++w)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int p = 0; p < DP / kP; ++p)
            tma_load3(q_s + (2 * w + t) * G::kQTile + p * kRowsWG * kSw, &maps.q[t],
                      q_bar, p * kP, q0 + w * kRowsWG, q_mat);
      for (int i = 0; i < n_tiles; ++i) {
        const uint32_t parity = (i & 1) ^ 1;  // tile i - 1 released
        const int k0 = (first + i) * kBK;
        mbar_wait(k_empty, parity);
        mbar_expect_tx(k_full, 2 * G::kKTile);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int p = 0; p < DP / kP; ++p)
            tma_load3(k_s + t * G::kKTile + p * kBK * kSw, &maps.k[t], k_full, p * kP, k0,
                      kv_mat);
        mbar_wait(v_empty, parity);
        mbar_expect_tx(v_full, 2 * G::kKTile);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int p = 0; p < kBK / kPV; ++p)
            tma_load3(v_s + t * G::kKTile + p * DP * kPV * 4, &maps.v[t], v_full,
                      k0 + p * kPV, 0, kv_mat);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + wg * kRowsWG;
  const int row0 = r0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const uint32_t q_wg = q_s + 2 * wg * G::kQTile;
  const float scale2 = a.scale * kLog2e;  // scores in the log2 domain
  // the key tiles this warpgroup's rows can see; none past Sq
  int wfirst, wlast;
  key_tiles(a, r0, kBK, &wfirst, &wlast, kRowsWG);
  if (wg >= q_wgs) wlast = wfirst;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.f, 0.f};

  if (n_tiles > 0) mbar_wait(q_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const uint32_t parity = i & 1;
    const int tile = first + i;
    const bool live = tile >= wfirst && tile < wlast;
    float sc[kBK / 2];
    mbar_wait(k_full, parity);
    if (live) {  // S = Q Kᵀ
      wg_fence();
      O::template issue_d<kBK>(sc, q_wg, G::kQTile, k_s, G::kKTile);
      wg_commit();
      wg_wait_all();
      fence_regs(sc);
    }
    mbar_arrive(k_empty);  // done with K
    if (live) {
      float corr[2];
      online_softmax<kBK>(sc, m_row, l_row, corr, a, r0, row0, t4, tile * kBK, scale2);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j * 4 + e] *= corr[e >> 1];
    }
    mbar_wait(v_full, parity);
    if (live) {  // O = O·corr + P V, kPC keys of P's fragments at a time
#pragma unroll
      for (int c = 0; c < kBK / kPC; ++c) {
        uint32_t hi[kPC / 8][4], lo[kPC / 8][4];
        O::template frags<kPC / 8>(
            *reinterpret_cast<const float(*)[kPC / 2]>(sc + c * kPC / 2), hi, lo);
        O::template add_s<kPC / 8, kPV>(
            o, hi, lo,
            v_s + (c * kPC / kPV) * DP * kPV * 4 + (c * kPC % kPV) * 4,
            G::kKTile);
      }
    }
    mbar_arrive(v_empty);  // done with Vᵀ
  }

  float* og = static_cast<float*>(a.out) + ((int64_t)batch * a.sq * a.h + head) * a.d;
  const int64_t q_stride = (int64_t)a.h * a.d;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_row[rr];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    const float denom = fmaxf(l, 1e-30f);
    const int qi = row0 + 8 * rr;
    if (qi >= a.sq) continue;
    // L = (m + log2 l)·ln 2 (m in the log2 domain); -inf for a row that
    // saw no key
    if (a.lse != nullptr && t4 == 0)
      a.lse[((int64_t)batch * a.h + head) * a.sq + qi] =
          l > 0.f ? (m_row[rr] + log2f(l)) * kLn2 : -INFINITY;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + t4 * 2;
      if (col < a.d)
        *reinterpret_cast<float2*>(og + qi * q_stride + col) =
            make_float2(o[j * 4 + rr * 2] / denom, o[j * 4 + rr * 2 + 1] / denom);
    }
  }
}

// the forward's pre-pass: x [B, S, heads, d] into its 3xTF32 planes
// (split_planes in hopper.cuh)
__global__ void __launch_bounds__(256)
    fwd_split_kernel(const float* x, int seq, int heads, int d, float* n_hi,
                     float* n_lo, float* t_hi, float* t_lo) {
  split_planes(x, seq, heads, d, n_hi, n_lo, t_hi, t_lo);
}

// the float32 workspace at DP <= 128, [0] hi and [1] lo of each plane, one
// after another: Q and K natural [B·heads, S, d], V transposed [B·KH, d,
// S8] (the keys permuted within each 8)
struct FwdPlanes {
  float *qn[2], *kn[2], *vt[2];
};

// the workspace's floats at DP <= 128; given work, the planes' addresses
// in it into *t
__host__ __forceinline__ long long fwd_planes(int b, int sq, int sk, int h, int kh,
                                              int d, float* work = nullptr,
                                              FwdPlanes* t = nullptr) {
  const long long n[3] = {(long long)b * h * sq * d, (long long)b * kh * sk * d,
                          (long long)b * kh * d * round8(sk)};
  long long off = 0;
  for (int p = 0; p < 3; ++p)
    for (int i = 0; i < 2; ++i) {
      if (t != nullptr) (p == 0 ? t->qn : p == 1 ? t->kn : t->vt)[i] = work + off;
      off += n[p];
    }
  return off;
}

// ---------------------------------------------------------------------------
// float32 at DP = 256: scalar FMAs (two threads per query row)
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
  if (a.lse != nullptr && half == 0)  // a row that saw no key: -inf
    a.lse[((int64_t)batch * a.h + head) * a.sq + qi] =
        l > 0.f ? m_row + logf(l) : -INFINITY;
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
  using G = Bf16Geometry<DP>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // with Sk = 0 no key tile is ever loaded; the K/V maps then describe q
  // only because a map needs a non-empty tensor
  const bool keys = a.sk > 0;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(encode, &q_map, a.q, b, a.sq, a.h, a.d, G::kPanel, kBQ16,
                  G::kSwizzle) ||
      !encode_map(encode, &k_map, keys ? a.k : a.q, b, keys ? a.sk : a.sq,
                  keys ? a.kh : a.h, a.d, G::kPanel, G::kBK, G::kSwizzle) ||
      !encode_map(encode, &v_map, keys ? a.v : a.q, b, keys ? a.sk : a.sq,
                  keys ? a.kh : a.h, a.d, G::kPanel, G::kBK, G::kSwizzle))
    return cudaErrorInvalidValue;
  static unsigned long long opted_in = 0;
  const cudaError_t err = opt_in(flash_bf16_kernel<DP>, G::kSmem, &opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * a.h, (a.sq + kBQ16 - 1) / kBQ16);
  flash_bf16_kernel<DP><<<grid, kThreads16, G::kSmem, stream>>>(q_map, k_map,
                                                                 v_map, a);
  return cudaGetLastError();
}

template <int DP>
void bf16_geometry(int* out) {
  using G = Bf16Geometry<DP>;
  const int g[] = {DP, G::kPanel, G::kSwizzle, kBQ16, G::kBK, G::kStages,
                   G::kSmem};
  for (int i = 0; i < 7; ++i) out[i] = g[i];
}

// the 3xTF32 path (float32, DP <= 128): three plane splits, the main kernel
template <int DP>
cudaError_t launch_tf32(const Args& a, int b, float* work, cudaStream_t stream) {
  using G = Tf32FwdGeometry<DP>;
  FwdPlanes t;
  fwd_planes(b, a.sq, a.sk, a.h, a.kh, a.d, work, &t);
  // with Sk = 0 no key tile is ever loaded: K and V are not split, and
  // their maps describe Q's planes only because a map needs a non-empty
  // tensor
  const bool keys = a.sk > 0;
  cudaError_t err;
  if ((err = launch_split(fwd_split_kernel, a.q, b, a.sq, a.h, a.d, t.qn[0], t.qn[1],
                          nullptr, nullptr, stream)) != cudaSuccess)
    return err;
  if (keys &&
      ((err = launch_split(fwd_split_kernel, a.k, b, a.sk, a.kh, a.d, t.kn[0], t.kn[1],
                           nullptr, nullptr, stream)) != cudaSuccess ||
       (err = launch_split(fwd_split_kernel, a.v, b, a.sk, a.kh, a.d, nullptr, nullptr,
                           t.vt[0], t.vt[1], stream)) != cudaSuccess))
    return err;

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // a natural plane [mats, seq, d] in boxes of `panel` columns x `rows`;
  // the transposed plane [mats, d, S8] in boxes of kPanelV keys x DP rows
  auto nat = [&](CUtensorMap* m, const float* p, int mats, int seq, int panel, int rows) {
    const long long dims[3] = {a.d, seq, mats};
    const long long strides[2] = {4LL * a.d, 4LL * seq * a.d};
    return encode_map_f32(encode, m, p, dims, strides, panel, rows);
  };
  auto trn = [&](CUtensorMap* m, const float* p) {
    const long long s8 = round8(a.sk);
    const long long dims[3] = {s8, a.d, b * a.kh};
    const long long strides[2] = {4 * s8, 4 * s8 * a.d};
    return encode_map_f32(encode, m, p, dims, strides, G::kPanelV, DP);
  };
  const int qm = b * a.h, km = b * a.kh;
  Tf32Maps maps;
  for (int i = 0; i < 2; ++i)
    if (!nat(&maps.q[i], t.qn[i], qm, a.sq, G::kPanel, kRowsWG) ||
        !(keys ? nat(&maps.k[i], t.kn[i], km, a.sk, G::kPanel, G::kBK)
               : nat(&maps.k[i], t.qn[i], qm, a.sq, G::kPanel, G::kBK)) ||
        !(keys ? trn(&maps.v[i], t.vt[i])
               : nat(&maps.v[i], t.qn[i], qm, a.sq, G::kPanelV, DP)))
      return cudaErrorInvalidValue;
  static unsigned long long opted_in = 0;
  if ((err = opt_in(flash_tf32_kernel<DP>, G::kSmem, &opted_in)) != cudaSuccess)
    return err;
  const dim3 grid(b * a.h, (a.sq + kBQ16 - 1) / kBQ16);
  flash_tf32_kernel<DP><<<grid, kThreadsTf32, G::kSmem, stream>>>(maps, a);
  return cudaGetLastError();
}

template <int DP>
void tf32_geometry(int* out) {
  using G = Tf32FwdGeometry<DP>;
  const int g[] = {DP, G::kPanel, G::kSwizzle, kBQ16, G::kBK, G::kSmem, 1};
  for (int i = 0; i < 7; ++i) out[i] = g[i];
}

// the scalar kernel (float32 at DP = 256)
constexpr int kSmemF32 = ((kBQ + 2 * kBK32) * (256 + 4) + kBQ * kLDP) * 4;  // bytes

cudaError_t launch_f32(const Args& a, int b, cudaStream_t stream) {
  static unsigned long long opted_in = 0;
  const cudaError_t err = opt_in(flash_f32_kernel<256>, kSmemF32, &opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, b);
  flash_f32_kernel<256><<<grid, kThreads, kSmemF32, stream>>>(a);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, void* out,
               void* lse, int sq, int sk, int h, int kh, int d, int causal,
               int window, int kv_len) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.lse = static_cast<float*>(lse);
  a.sq = sq; a.sk = sk; a.h = h; a.kh = kh; a.d = d;
  a.causal = causal; a.window = window; a.kv_len = kv_len;
  a.scale = (float)pow((double)d, -0.5);  // D^-1/2 rounded once to float
  return a;
}

bool bad_shape(int b, int sq, int sk, int h, int kh, int d, int kv_len) {
  return b < 1 || sq < 1 || sk < 0 || kh < 1 || h % kh != 0 || d % 8 != 0 ||
         padded_dim(d) == 0 || kv_len < 0 || kv_len > sk;
}

bool bad_dim(int d) { return d < 8 || d % 8 != 0 || padded_dim(d) == 0; }

}  // namespace

// q [B, Sq, H, D], k / v [B, Sk, KH, D], out [B, Sq, H, D], all contiguous
// and 16-byte aligned; lse a float32 [B, H, Sq] for the row log-sum-exp (the
// backward's input) or null; window <= 0 means none.  Returns a cudaError_t.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* out, void* lse, int b, int sq, int sk, int h,
                                    int kh, int d, int causal, int window,
                                    int kv_len, void* stream) {
  if (bad_shape(b, sq, sk, h, kh, d, kv_len)) return (int)cudaErrorInvalidValue;
  const Args a =
      make_args(q, k, v, out, lse, sq, sk, h, kh, d, causal, window, kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_dim(d)) {
    case 16: return (int)launch_bf16<16>(a, b, s);
    case 32: return (int)launch_bf16<32>(a, b, s);
    case 64: return (int)launch_bf16<64>(a, b, s);
    case 128: return (int)launch_bf16<128>(a, b, s);
    default: return (int)launch_bf16<256>(a, b, s);
  }
}

// the bf16 instantiation for head dim d, as seven ints: padded width, panel
// columns, swizzle bytes, queries per block, keys per tile, stages, dynamic
// shared-memory bytes.  Returns a cudaError_t.
extern "C" int flash_bf16_geometry(int d, int* out) {
  if (bad_dim(d)) return (int)cudaErrorInvalidValue;
  switch (padded_dim(d)) {
    case 16: bf16_geometry<16>(out); break;
    case 32: bf16_geometry<32>(out); break;
    case 64: bf16_geometry<64>(out); break;
    case 128: bf16_geometry<128>(out); break;
    default: bf16_geometry<256>(out); break;
  }
  return 0;
}

// as flash_attention_bf16, in float32, with work a float32 workspace of the
// floats flash_f32_workspace names (written in full before it is read; none
// at head dims over 128).  Four launches at head dims up to 128 (three
// plane splits and the main kernel; two with Sk = 0), one above.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, void* lse, void* work, int b, int sq,
                                   int sk, int h, int kh, int d, int causal,
                                   int window, int kv_len, void* stream) {
  if (bad_shape(b, sq, sk, h, kh, d, kv_len)) return (int)cudaErrorInvalidValue;
  const Args a =
      make_args(q, k, v, out, lse, sq, sk, h, kh, d, causal, window, kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  switch (padded_dim(d)) {
    case 16: return (int)launch_tf32<16>(a, b, w, s);
    case 32: return (int)launch_tf32<32>(a, b, w, s);
    case 64: return (int)launch_tf32<64>(a, b, w, s);
    case 128: return (int)launch_tf32<128>(a, b, w, s);
    default: return (int)launch_f32(a, b, s);
  }
}

// the float32 instantiation for head dim d, as seven ints: padded width,
// natural panel columns, swizzle bytes, queries per block, keys per tile,
// dynamic shared-memory bytes, and 1 for the 3xTF32 path (DP <= 128); at
// DP = 256 the scalar kernel: 256, 0, 0, 64, 32, its shared memory, 0.
// Returns a cudaError_t.
extern "C" int flash_f32_geometry(int d, int* out) {
  if (bad_dim(d)) return (int)cudaErrorInvalidValue;
  switch (padded_dim(d)) {
    case 16: tf32_geometry<16>(out); break;
    case 32: tf32_geometry<32>(out); break;
    case 64: tf32_geometry<64>(out); break;
    case 128: tf32_geometry<128>(out); break;
    default: {
      const int g[] = {256, 0, 0, kBQ, kBK32, kSmemF32, 0};
      for (int i = 0; i < 7; ++i) out[i] = g[i];
    }
  }
  return 0;
}

// the floats of the workspace flash_attention_f32 takes, into *out: the hi
// and lo planes (FwdPlanes) at head dims up to 128, none above.  Returns a
// cudaError_t.
extern "C" int flash_f32_workspace(int b, int sq, int sk, int h, int kh, int d,
                                   long long* out) {
  if (bad_dim(d)) return (int)cudaErrorInvalidValue;
  *out = padded_dim(d) == 256 ? 0 : fwd_planes(b, sq, sk, h, kh, d);
  return 0;
}
