// Grouped Gram kernels for Hopper (sm_90a): per-group cofactor blocks
// out[g] = Σ_{seg[m] = g} x_m x_mᵀ, for one or several segment-id columns.
//
// Replaces the TPU kernels of src/repro/kernels/segment_gram.py:
//   segment_gram_kernel_call       (_segment_gram_kernel)       -> segment_gram_*
//   multi_segment_gram_kernel_call (_multi_segment_gram_kernel) -> multi_segment_gram_*
//
// What they compute.  x is a row-major [M, K] matrix (callers put a column of
// ones first, so each block carries count, sums and Gram at once) and segs a
// row-major [M, n_seg] int32 matrix of group ids.  Column c's ids index its
// own band of G_c groups; the bands lie side by side in one [ΣG, K, K]
// output (offset_c = G_0 + ... + G_{c-1}).  An id outside [0, G_c) — padding,
// negative — adds nothing, as the TPU kernel's all-zero one-hot row does.
// segment_gram is the case n_seg = 1.
//
// What bounds them on an H100 (3.35 TB/s).  Each row is read once (K values
// and n_seg ids) and costs K(K+1)/2 products, added to n_seg groups: a few
// flops per byte, so the bound is bytes (Favorita's 18.6 M rows: 522 MB at
// K = 6, n_seg = 1; 447 MB at K = 4, n_seg = 2 — 0.13 to 0.16 ms).  What
// limits a design is the adds: 373 M to 391 M on the main path's shapes,
// into an accumulator of ΣG·K(K+1)/2 values (344,400 bytes at G = 4,100)
// that has to live in shared memory.  sm_90 has no shared-memory float add:
// atomicAdd and red.shared.add.f32 compile to a compare-and-swap loop
// (ATOMS.CAST.SPIN), and every form of add is bounded by the shared
// memory's banks, which lanes of random groups hit several at a time
// (tools/segment_gram_variants.py measures the rates and shows the SASS).
//
// Design.  The TPU kernel adds rows with a one-hot matmul into a VMEM-resident
// [G, K, K] accumulator; the H100 has no use for that O(M·G) product.
//
//  * One launch reads x and the ids once.  The accumulator is split by
//    triangle entries over a crew of C = `split` CTAs, C the least that
//    holds it (plan(); kernels/segment_gram.py:plan mirrors it): CTA b
//    (of crew b / C, rank r = b % C) owns entries [r·E, (r+1)·E) of every
//    group, E = ceil(K(K+1)/2 / C), so a skewed key weighs on every CTA
//    alike.  Each CTA reads every row of its crew's tiles and adds its own
//    products only: the CTAs exchange nothing, so a plain grid launches
//    them, all resident at once, and L2 serves a tile's second read (a
//    thread-block cluster that co-schedules each crew is no faster:
//    tools/segment_gram_variants.py, arm cluster_launch).  An accumulator
//    that one CTA holds takes a split of one; one that no split of 8 holds
//    is chunked by the caller.
//  * Rows stream through shared memory.  The CTA's 1024 threads form S
//    teams, each with one stage of R rows (x and ids) that cp.async.bulk
//    fills on an mbarrier; the team's first thread refills it as soon as the
//    team is done with it, and while one team waits the others add.
//  * Each band (the groups of one id column) has its own region.  A hot
//    band (at most 256 groups, such as Favorita's 54 stores) is where the
//    lanes of a CTA meet: 32 warps adding random rows to 54 groups lose
//    many of their compare-and-swaps.  It is kept in up to 16 copies, lane
//    l adding to copy l % 16, interleaved so that the copies of an entry
//    lie side by side (entry t of group g, copy q at (g·E' + t)·16 + q, E'
//    = E made odd): lanes then rarely share an address and mostly hit
//    banks of their own.  The plan keeps as many copies (16, 8, 4, 2) as
//    fit beside the rest, and the flush sums them.  A band of more groups
//    (Favorita's 4,100 items) is one copy: its lanes rarely meet.
//  * Every lane adds its own products: merging the lanes of a group first
//    (__match_any_sync and a shuffle tree) costs more than the copies leave
//    it to save, on random ids and on the join's order alike
//    (tools/segment_gram_variants.py, arm merge_hot).  A lane adds
//    one entry at a time, a shared load and a compare-and-swap (two or
//    four in flight only add registers: arms batch2, batch4); a swap that
//    lost a race goes through atomicAdd's own loop.  Rows of K <= 8 keep
//    their values in registers; wider rows read them from the stage.
//  * A band of one copy keeps each group's E entries rotated by a few
//    slots (Args::rot_shift), so that where E is even the groups of a
//    warp's lanes still start on all 32 banks (arm no_rotation).
//  * The group counts travel as kernel arguments (no copy to the device),
//    and the scratch of crew sums is zeroed on the stream inside the C
//    function.  Each CTA then adds its slab [ΣG, E] of sums (contiguous in
//    the compact result [C, ΣG, E], copies summed) to global memory with
//    vector atomics (float4; double adds one value at a time), and a last
//    small kernel expands the compact sums into the symmetric [ΣG, K, K]
//    output.
//
// float inputs accumulate in float, double in double.  The adds land in an
// order that changes from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kSmemBlock = 232448;  // what one block may have on sm_90
constexpr int kBarBytes = 128;      // the stages' mbarriers
constexpr int kRingBytes = 48000;   // the stages hold at most this
constexpr int kMaxSplit = 8;        // the most CTAs a tile's entries split over
constexpr int kMaxStages = 8;       // teams (one stage each) a CTA
constexpr int kMaxRows = 128;       // rows a stage
constexpr int kCacheK = 8;          // rows up to this width live in registers
constexpr int kBatch = 1;           // compare-and-swaps in flight a thread
constexpr int kMaxBands = 32;       // id columns one launch takes
constexpr int kHotGroups = 256;     // a band this small is hot
constexpr int kMaxCopies = 16;      // copies of the hot bands, at most
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int64_t tri(int i, int j, int k) {
  return (int64_t)i * k - (int64_t)i * (i - 1) / 2 + (j - i);
}

// row and column of triangle entry t (the inverse of tri)
__host__ __device__ constexpr int tri_row(int t, int k) {
  int i = 0;
  while (i < k && t >= k - i) t -= k - i++;
  return i;
}
__host__ __device__ constexpr int tri_col(int t, int k) {
  int i = 0;
  while (i < k && t >= k - i) t -= k - i++;
  return i + t;
}

struct Plan {
  int split;     // CTAs a crew: they read the same tiles
  int entries;   // triangle entries a CTA owns (E)
  int stages;    // teams, each with one stage, a CTA
  int rows;      // rows a stage
  int copies;    // copies of each hot band (1: none)
  int64_t most;    // groups (ΣG) one launch holds
  int64_t chunks;  // launches the caller makes (ceil(ΣG / most), at least 1)
  int64_t smem;    // dynamic shared memory of a CTA
};

__host__ __device__ __forceinline__ bool hot(int64_t groups) {
  return groups <= kHotGroups;
}

// the accumulator's values: each band's groups at e entries a group; a hot
// band in `copies` copies, its groups at an odd stride where copies > 1
int64_t acc_len(const int64_t* groups, int n_seg, int64_t e, int copies) {
  int64_t n = 0;
  for (int c = 0; c < n_seg; ++c)
    n += hot(groups[c]) && copies > 1 ? groups[c] * (e | 1) * copies
                                      : groups[c] * e;
  return n;
}

// The launch of a [M, k] grouped Gram over n_seg id columns of groups[c]
// groups of elem-byte values: the least split whose CTAs hold their entries
// of every group (ΣG = total) beside the stages, else the widest one,
// chunked; in one launch, the most copies of the hot bands that still fit.
// kernels/segment_gram.py:plan is its mirror.
Plan plan(int k, int n_seg, const int64_t* groups, int elem) {
  const int64_t nt = (int64_t)k * (k + 1) / 2;
  const int64_t row_bytes = (int64_t)k * elem + 4LL * n_seg;
  int64_t total = 0;
  bool any_hot = false;
  for (int c = 0; c < n_seg; ++c) {
    total += groups[c];
    any_hot = any_hot || hot(groups[c]);
  }
  Plan p{0, 0, 0, 0, 0, 0, 0, 0};
  for (int c = 1; c <= kMaxSplit; ++c) {
    const int64_t e = (nt + c - 1) / c;
    int stages = kMaxStages;
    int64_t rows = 0;
    for (; stages >= 1; stages /= 2) {
      rows = kRingBytes / stages / row_bytes / 4 * 4;
      if (rows > kMaxRows) rows = kMaxRows;
      if (rows >= 4) break;
    }
    if (rows < 4) continue;  // a row wider than the ring
    const int64_t ring = stages * rows * row_bytes;
    const int64_t avail = (kSmemBlock - kBarBytes - ring) / elem;
    const int64_t most = (avail - 3) / (e > 0 ? e : 1);
    if (most < 1) continue;
    int copies = 1;
    int64_t len = (total < most ? total : most) * e;
    if (total <= most) {
      for (copies = any_hot ? kMaxCopies : 1;
           copies > 1 && acc_len(groups, n_seg, e, copies) + 3 > avail;
           copies /= 2) {
      }
      len = acc_len(groups, n_seg, e, copies);
    }
    p = Plan{c, (int)e, stages, (int)rows, copies, most,
             total > most ? (total + most - 1) / most : 1,
             kBarBytes + ring + (len + 3) / 4 * 4 * elem};
    if (total <= most) break;
  }
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 22)) __trap();  // a lost phase: fail, never hang
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// bytes (a multiple of 16, both ends 16-byte aligned) from global memory to
// this CTA's shared memory, counted on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void team_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using U = unsigned;
  __device__ static U of(float v) { return __float_as_uint(v); }
  __device__ static float to(U u) { return __uint_as_float(u); }
};
template <>
struct Bits<double> {
  using U = unsigned long long;
  __device__ static U of(double v) { return __double_as_longlong(v); }
  __device__ static double to(U u) { return __longlong_as_double(u); }
};

// acc[at[u]] += p[u] for each u of `pend`: the shared loads, then the
// compare-and-swaps, in flight together; an add whose swap lost a race goes
// through atomicAdd's own loop (a hot group's adds retry there far faster
// than by swapping again)
template <typename T>
__device__ __forceinline__ void cas_add(T* acc, const int (&at)[kBatch],
                                        const T (&p)[kBatch], unsigned pend) {
  using U = typename Bits<T>::U;
  U* a = reinterpret_cast<U*>(acc);
  U old[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    old[u] = (pend >> u & 1) ? reinterpret_cast<volatile U*>(a)[at[u]] : U(0);
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    if ((pend >> u & 1) &&
        atomicCAS(a + at[u], old[u], Bits<T>::of(Bits<T>::to(old[u]) + p[u])) ==
            old[u])
      pend &= ~(1u << u);
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    if (pend >> u & 1) atomicAdd(acc + at[u], p[u]);
}

// Band c (id column c) in a CTA's accumulator: entry t of its group g lies
// at base[c] + (g * stride[c] + slot) * step + copy.  A hot band kept in
// copies has step = copies, copy = the adding lane % copies and slot =
// t - t0; a band of one copy has step 1, copy 0 and its slots rotated
// (rot_shift below).
template <typename T>
struct Args {
  const T* x;
  const int32_t* segs;
  T* compact;  // [C, slab] zeroed: CTA r's [ΣG, E] sums, padded
  int64_t m, slab;
  int k, n_seg, nt, entries, split, stages, rows, copies, acc_len;
  // a one-copy band's group g keeps its E entries rotated by (g >> rot_shift)
  // & rot_mask slots, so that the groups of a warp's lanes start on all 32
  // banks where E is even (E = 10 alone would start them on 16)
  int rot_shift, rot_mask;
  uint32_t hot;  // bit c: band c is hot
  int32_t groups[kMaxBands], first[kMaxBands], base[kMaxBands],
      stride[kMaxBands];  // first: the band's offset in the ΣG groups
};

// A lane's row in one id column: entry t0 of its group lies at acc[base],
// entry t at acc[base + (t - t0) * step]; valid false where the id is
// outside the band (the row adds nothing there).
struct Lane {
  int base, step;
  int rot, e;  // entry t lies at slot (t - t0 + rot) mod e of the group
  bool valid;
};

// slot (t - t0 + rot) mod e of entry t, 0 <= t - t0 < e
__device__ __forceinline__ int slot(const Lane& ln, int t) {
  const int q = t + ln.rot;
  return q >= ln.e ? q - ln.e : q;
}

// One batch of products p of entries at[u] (on: those of this CTA) added
template <typename T>
__device__ __forceinline__ void add_batch(T* acc, const Lane& ln,
                                          const int (&at)[kBatch],
                                          const T (&p)[kBatch], unsigned on) {
  unsigned pend = 0;
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    if ((on >> u & 1) && p[u] != T(0)) pend |= 1u << u;
  cas_add(acc, at, p, pend);
}

// Entries [t0, t1) of a row whose K = KC values are v; entry t goes to
// acc[base + (t - t0) * step], in batches of kBatch consecutive entries.  Every index
// is a compile-time constant, so v and the batch stay in registers; t0 and
// t1 are the same for the whole CTA, so the skipped batches cost no
// divergence.
template <typename T, int KC>
__device__ __forceinline__ void add_cached(T* acc, const Lane& ln,
                                           const T (&v)[kCacheK], int t0,
                                           int t1) {
  constexpr int kNT = KC * (KC + 1) / 2;
  int at[kBatch];
  T p[kBatch];
  unsigned on = 0;
#pragma unroll
  for (int i = 0; i < KC; ++i) {
#pragma unroll
    for (int j = i; j < KC; ++j) {
      const int t = (int)tri(i, j, KC), u = t % kBatch;
      at[u] = ln.base + slot(ln, t - t0) * ln.step;
      p[u] = ln.valid ? v[i] * v[j] : T(0);
      if (t >= t0 && t < t1) on |= 1u << u;
      if (u == kBatch - 1 || t == kNT - 1) {  // a batch is complete
        if (on) add_batch<T>(acc, ln, at, p, on);
        on = 0;
#pragma unroll
        for (int w = 0; w < kBatch; ++w) p[w] = T(0);
      }
    }
  }
}

// The same for a row of any width, its values read where they lie;
// (i0, j0) is entry t0's place
template <typename T>
__device__ __forceinline__ void add_wide(T* acc, const Lane& ln,
                                         const T* xr, int k, int t0, int t1,
                                         int i0, int j0) {
  int i = i0, j = j0;
  for (int tb = t0; tb < t1; tb += kBatch) {
    int at[kBatch];
    T p[kBatch];
    unsigned on = 0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      at[u] = ln.base + slot(ln, tb + u - t0) * ln.step;
      p[u] = T(0);
      if (tb + u < t1) {
        if (ln.valid) p[u] = xr[i] * xr[j];
        on |= 1u << u;
        if (++j == k) j = ++i;
      }
    }
    add_batch<T>(acc, ln, at, p, on);
  }
}

// A warp's rows (values xr, ids ids; `in` false past the last row) added to
// every group they belong to.  All 32 lanes call it together.
template <typename T, int KC>
__device__ __forceinline__ void add_rows(const Args<T>& a, T* acc,
                                         const T* xr, const int32_t* ids,
                                         bool in, int t0, int t1, int i0,
                                         int j0) {
  T v[kCacheK];
  if constexpr (KC > 0) {
#pragma unroll
    for (int i = 0; i < KC; ++i) v[i] = in ? xr[i] : T(0);
  }
  Lane ln;
  ln.e = a.entries;
  for (int c = 0; c < a.n_seg; ++c) {  // warp-uniform
    const int s = in ? ids[c] : -1;
    ln.valid = (unsigned)s < (unsigned)a.groups[c];
    if (!__any_sync(kFull, ln.valid)) continue;
    int copy = 0;
    ln.step = 1;
    ln.rot = ln.valid ? (s >> a.rot_shift) & a.rot_mask : 0;
    if (a.hot >> c & 1 && a.copies > 1) {  // lane l adds to copy l % copies
      ln.step = a.copies;                   // (a power of two)
      ln.rot = 0;
      copy = threadIdx.x & (a.copies - 1);
    }
    ln.base = a.base[c] + (ln.valid ? s : 0) * a.stride[c] * ln.step + copy;
    if constexpr (KC > 0)
      add_cached<T, KC>(acc, ln, v, t0, t1);
    else
      add_wide<T>(acc, ln, xr, a.k, t0, t1, i0, j0);
  }
}

// The sum over its copies of compact entry e (group e / E of ΣG, its entry
// t0 + e % E); 0 past the last group
template <typename T>
__device__ __forceinline__ T entry_sum(const Args<T>& a, const T* acc,
                                       int64_t e, int64_t filled) {
  if (e >= filled) return T(0);
  int g = (int)(e / a.entries);
  const int t = (int)(e % a.entries);
  int c = 0;
  while (g >= a.first[c] + a.groups[c]) ++c;
  g -= a.first[c];
  const int step = (a.hot >> c & 1) ? a.copies : 1;
  int q = t;
  if (step == 1) {  // the group's entries rotated (Lane::rot)
    q += (g >> a.rot_shift) & a.rot_mask;
    if (q >= a.entries) q -= a.entries;
  }
  const T* src = acc + a.base[c] + ((int64_t)g * a.stride[c] + q) * step;
  T sum = src[0];
  for (int q = 1; q < step; ++q) sum += src[q];
  return sum;
}

// A persistent crew walks tiles cr, cr + n_cr, ... of R rows; each team of
// the CTA takes every S-th of them through its own stage.  The rows after
// the last whole tile, fewer than a stage holds, are read from global
// memory by the first crew.
template <typename T, int KC>
__global__ void __launch_bounds__(kThreads, 1)
    gram_rows(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rank = blockIdx.x % a.split;
  const int64_t cr = blockIdx.x / a.split, n_cr = gridDim.x / a.split;
  const int t0 = rank * a.entries;
  const int t1 = min(a.nt, t0 + a.entries);
  const int i0 = tri_row(t0, a.k), j0 = tri_col(t0, a.k);
  const int x_bytes = a.rows * a.k * (int)sizeof(T);
  const int stage_bytes = x_bytes + a.rows * a.n_seg * 4;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kBarBytes;
  T* acc = reinterpret_cast<T*>(ring + a.stages * stage_bytes);
  const int team_size = kThreads / a.stages;
  const int team = threadIdx.x / team_size, tid = threadIdx.x % team_size;
  const uint32_t full = smem_u32(bars + team);
  unsigned char* stage = ring + team * stage_bytes;

  for (int e = threadIdx.x; e < a.acc_len; e += kThreads) acc[e] = T(0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(smem_u32(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int64_t n_full = a.m / a.rows;
  const int64_t step = n_cr * a.stages;  // tiles between a team's turns
  auto load = [&](int64_t tile) {
    mbar_expect_tx(full, stage_bytes);
    bulk_load(smem_u32(stage), a.x + tile * a.rows * a.k, x_bytes, full);
    bulk_load(smem_u32(stage + x_bytes), a.segs + tile * a.rows * a.n_seg,
              stage_bytes - x_bytes, full);
  };
  int64_t tile = cr + n_cr * team;
  if (tid == 0 && tile < n_full) load(tile);
  for (uint32_t turn = 0; tile < n_full; ++turn, tile += step) {
    mbar_wait(full, turn & 1);
    const T* xs = reinterpret_cast<const T*>(stage);
    const int32_t* ids = reinterpret_cast<const int32_t*>(stage + x_bytes);
    for (int r0 = 0; r0 < a.rows; r0 += team_size) {  // team-uniform
      const int r = r0 + tid < a.rows ? r0 + tid : 0;
      add_rows<T, KC>(a, acc, xs + r * a.k, ids + r * a.n_seg,
                      r0 + tid < a.rows, t0, t1, i0, j0);
    }
    team_sync(1 + team, team_size);  // the team is done with the stage
    if (tid == 0 && tile + step < n_full) load(tile + step);
  }
  if (cr == 0) {
    for (int64_t r0 = n_full * a.rows; r0 < a.m; r0 += kThreads) {
      const bool in = r0 + threadIdx.x < a.m;
      const int64_t row = in ? r0 + threadIdx.x : 0;
      add_rows<T, KC>(a, acc, a.x + row * a.k, a.segs + row * a.n_seg, in,
                      t0, t1, i0, j0);
    }
  }
  __syncthreads();

  // compact[rank][(first[c] + g) E + t - t0] += the copies' sums of entry t
  // of group g of band c
  T* dst = a.compact + rank * a.slab;
  const int64_t filled = (int64_t)(a.first[a.n_seg - 1] + a.groups[a.n_seg - 1]) *
                         a.entries;
  for (int64_t e0 = 4 * threadIdx.x; e0 < a.slab; e0 += 4 * kThreads) {
    T v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = entry_sum(a, acc, e0 + q, filled);
    if constexpr (sizeof(T) == 4) {
      if (v[0] != 0.f || v[1] != 0.f || v[2] != 0.f || v[3] != 0.f)
        atomicAdd(reinterpret_cast<float4*>(dst + e0),
                  make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (v[q] != T(0)) atomicAdd(dst + e0 + q, v[q]);
    }
  }
}

// out[g, i, j] = the sum of entry t = tri(min(i, j), max(i, j)) of group g,
// held by CTA t / E of a crew
template <typename T>
__global__ void __launch_bounds__(256)
expand_sym(const T* __restrict__ compact, int64_t total, int k, int e,
           int64_t slab, T* __restrict__ out) {
  const int64_t n = total * k * k;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t g = idx / ((int64_t)k * k);
    const int r = (int)(idx % ((int64_t)k * k));
    const int i = r / k, j = r % k;
    const int t = (int)(i <= j ? tri(i, j, k) : tri(j, i, k));
    out[idx] = compact[(t / e) * slab + g * e + t % e];
  }
}

template <typename T, int KC>
int launch_rows(const Args<T>& a, const Plan& p, cudaStream_t s) {
  auto kern = gram_rows<T, KC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  // as many whole crews as run at once, and no more than there are tiles
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, (size_t)p.smem)) != cudaSuccess)
    return (int)err;
  int64_t n_cr = (int64_t)sms * per_sm / p.split;
  if (n_cr < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t tiles = a.m / p.rows;
  if (n_cr > tiles) n_cr = tiles > 1 ? tiles : 1;
  kern<<<(unsigned)(n_cr * p.split), kThreads, (size_t)p.smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* x, const int32_t* segs, int64_t m, int k, int n_seg,
           const int64_t* groups, int split, T* compact, T* out,
           cudaStream_t s) {
  if (k <= 0 || n_seg <= 0 || n_seg > kMaxBands)
    return (int)cudaErrorInvalidValue;
  int64_t total = 0;
  for (int c = 0; c < n_seg; ++c) {
    if (groups[c] < 0) return (int)cudaErrorInvalidValue;
    total += groups[c];
  }
  if (total <= 0 || total > INT32_MAX) return (int)cudaErrorInvalidValue;
  const Plan p = plan(k, n_seg, groups, (int)sizeof(T));
  // the caller's plan (the mirror's) sized ``compact``: it must be this one
  if (p.split != split || p.chunks != 1) return (int)cudaErrorInvalidValue;
  const int64_t slab = (total * p.entries + 3) / 4 * 4;
  cudaError_t err =
      cudaMemsetAsync(compact, 0, (size_t)(p.split * slab) * sizeof(T), s);
  if (err != cudaSuccess) return (int)err;
  if (m > 0) {
    // d = gcd(E, 32): groups g and g + 32 / d start on the same bank
    int d = 1;
    while (d < 32 && p.entries % (2 * d) == 0) d *= 2;
    int shift = 0;
    while ((1 << shift) < 32 / d) ++shift;
    Args<T> a{x, segs, compact, m, slab, k, n_seg, k * (k + 1) / 2, p.entries,
              p.split, p.stages, p.rows, p.copies, 0, shift, d - 1, 0u,
              {}, {}, {}, {}};
    int64_t first = 0, base = 0;
    for (int c = 0; c < n_seg; ++c) {
      const bool h = hot(groups[c]);
      const int step = h ? p.copies : 1;
      a.groups[c] = (int32_t)groups[c];
      a.first[c] = (int32_t)first;
      a.base[c] = (int32_t)base;
      a.stride[c] = step > 1 ? (p.entries | 1) : p.entries;
      if (h) a.hot |= 1u << c;
      first += groups[c];
      base += groups[c] * a.stride[c] * step;
    }
    a.acc_len = (int)base;
    int e;
    switch (k) {
      case 1: e = launch_rows<T, 1>(a, p, s); break;
      case 2: e = launch_rows<T, 2>(a, p, s); break;
      case 3: e = launch_rows<T, 3>(a, p, s); break;
      case 4: e = launch_rows<T, 4>(a, p, s); break;
      case 5: e = launch_rows<T, 5>(a, p, s); break;
      case 6: e = launch_rows<T, 6>(a, p, s); break;
      case 7: e = launch_rows<T, 7>(a, p, s); break;
      case 8: e = launch_rows<T, 8>(a, p, s); break;
      default: e = launch_rows<T, 0>(a, p, s); break;
    }
    if (e != 0) return e;
  }
  const int64_t n = total * k * k;
  int64_t blocks = (n + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  expand_sym<T><<<(unsigned)blocks, 256, 0, s>>>(compact, total, k, p.entries,
                                                   slab, out);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  ``x`` is a contiguous [m, k] matrix, ``segs`` a
// contiguous [m, n_seg] int32 matrix, both 16-byte aligned device memory;
// ``groups`` (host memory) the n_seg <= 32 columns' group counts, total =
// their sum; ``split`` the caller's plan; ``compact`` a [split, slab]
// scratch buffer (zeroed here), slab = total · entries rounded up to 4;
// ``out`` the [total, k, k] result (every entry written).  The plan must
// hold all groups in one launch (chunks 1).  Runs on the caller's stream;
// returns a cudaError_t.
#define SEGMENT_GRAM_API(T, SUFFIX)                                          \
  extern "C" int segment_gram_##SUFFIX(const T* x, const int32_t* seg,       \
                                       int64_t m, int k, int64_t g,          \
                                       int split, T* compact, T* out,        \
                                       void* stream) {                       \
    return launch<T>(x, seg, m, k, 1, &g, split, compact, out,               \
                     (cudaStream_t)stream);                                  \
  }                                                                          \
  extern "C" int multi_segment_gram_##SUFFIX(                                \
      const T* x, const int32_t* segs, int64_t m, int k, int n_seg,          \
      const int64_t* groups, int split, T* compact, T* out, void* stream) {  \
    return launch<T>(x, segs, m, k, n_seg, groups, split, compact, out,      \
                     (cudaStream_t)stream);                                  \
  }

SEGMENT_GRAM_API(float, f32)
SEGMENT_GRAM_API(double, f64)

// The launch plan of a grouped Gram: out = {split, entries a CTA, stages
// (teams) a CTA, rows a stage, copies of each hot band, groups one launch
// holds, launches, dynamic shared memory bytes} for width k, n_seg id
// columns of groups[c] groups (host memory) and elem-byte values.
extern "C" int segment_gram_plan(int k, int n_seg, const int64_t* groups,
                                 int elem, int64_t* out) {
  if (k < 0 || n_seg < 1 || (elem != 4 && elem != 8))
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < n_seg; ++c)
    if (groups[c] < 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan(k, n_seg, groups, elem);
  out[0] = p.split;
  out[1] = p.entries;
  out[2] = p.stages;
  out[3] = p.rows;
  out[4] = p.copies;
  out[5] = p.most;
  out[6] = p.chunks;
  out[7] = p.smem;
  return 0;
}
