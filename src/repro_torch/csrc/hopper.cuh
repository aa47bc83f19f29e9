// Hopper (sm_90a) building blocks shared by flash.cu and flash_bwd.cu:
// mbarriers, TMA loads (tensor tiles and 1-d bulk copies), wgmma shared-
// memory descriptors and the wgmma products (bf16, and TF32 with its 3xTF32
// split), exp2 and bf16 packing on register fragments, the 3xTF32 hi / lo
// planes (the pre-pass body) and the products on them (Tf32Ops), and on
// the host the shared-memory opt-in and the TMA maps over a bf16 [B, S,
// heads, D] tensor and a float32 3-d one.
//
// Tiles live in shared memory in panels whose rows are one swizzle span
// (32, 64 or 128 bytes: min(DP, 64) bf16 or min(DP, 32) float32 columns),
// so the TMA swizzle mode and the wgmma descriptor layout agree per width.  Each source that includes
// this header is one translation unit: everything here has internal
// linkage.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed (a fresh barrier counts
// its phase before 0, of parity 1, as completed)
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

// rows [c1, c1 + box rows) and columns [c0, c0 + panel) of matrix c2 of a
// 3-d map, into a swizzled panel at dst; completion counted on bar
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// rows [c2, c2 + box rows) and columns [c0, c0 + panel) of head c1, batch
// c3, into a swizzled panel at dst; completion counted on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; completion counted on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bar, int bytes) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a swizzled panel (rows of `swizzle`
// bytes, 8-row groups 8·swizzle bytes apart): start address, leading and
// stride byte offsets in 16-byte units, layout 1 / 2 / 3 = 128 / 64 / 32-byte
// swizzle.  The panel base is 1 KiB aligned, so the base offset is 0.
template <int kSwizzle>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : kSwizzle == 64 ? 2 : 3;
  constexpr uint64_t kSbo = 8 * kSwizzle / 16;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo & 0x3FFF) << 16) |
         (kSbo << 32) | (kLayout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(float (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+f"(r[i][j])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define FLASH_ACC8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x N] (+)= A[64 x 16] · B[16 x N], A and B in shared memory: both
// K-major (kTrans 0), or both MN-major (kTrans 1, the transpose bits)
template <int N, int kTrans = 0>
struct WgmmaSS;

template <int kTrans>
struct WgmmaSS<16, kTrans> {
  __device__ __forceinline__ static void run(float (&d)[8], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %11;\n}\n"
        : FLASH_ACC8(d, 0)
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTrans));
  }
};

template <int kTrans>
struct WgmmaSS<32, kTrans> {
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p, 1, 1, %19, %19;\n}\n"
        : FLASH_ACC8(d, 0), FLASH_ACC8(d, 8)
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTrans));
  }
};

template <int kTrans>
struct WgmmaSS<64, kTrans> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
        "%29, %30, %31}, %32, %33, p, 1, 1, %35, %35;\n}\n"
        : FLASH_ACC8(d, 0), FLASH_ACC8(d, 8), FLASH_ACC8(d, 16),
          FLASH_ACC8(d, 24)
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTrans));
  }
};

template <int kTrans>
struct WgmmaSS<128, kTrans> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
        "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %67;\n}\n"
        : FLASH_ACC8(d, 0), FLASH_ACC8(d, 8), FLASH_ACC8(d, 16),
          FLASH_ACC8(d, 24), FLASH_ACC8(d, 32), FLASH_ACC8(d, 40),
          FLASH_ACC8(d, 48), FLASH_ACC8(d, 56)
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTrans));
  }
};

// d[64 x N] += A[64 x 16] · B[16 x N]: A bf16 fragments in registers, B
// MN-major in shared memory (transpose bit set)
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<16> {
  __device__ __forceinline__ static void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, "
        "p, 1, 1, 1;\n}\n"
        : FLASH_ACC8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
};

template <>
struct WgmmaRS<32> {
  __device__ __forceinline__ static void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : FLASH_ACC8(d, 0), FLASH_ACC8(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
};

template <>
struct WgmmaRS<64> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
        "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : FLASH_ACC8(d, 0), FLASH_ACC8(d, 8), FLASH_ACC8(d, 16),
          FLASH_ACC8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
};

// d[64 x N] (+)= A[64 x 8] · B[8 x N] in TF32 (float32 accumulators), A
// and B in shared memory, both K-major: the TF32 wgmma has no transpose
// immediates (they exist for 16-bit types only), so an operand that
// contracts along its non-contiguous dimension must be laid out
// transposed before the product reads it
template <int N>
struct WgmmaTf32SS;

template <>
struct WgmmaTf32SS<16> {
  __device__ __forceinline__ static void run(float (&d)[8], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : FLASH_ACC8(d, 0)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaTf32SS<32> {
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
        : FLASH_ACC8(d, 0), FLASH_ACC8(d, 8)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaTf32SS<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
        : FLASH_ACC8(d, 0), FLASH_ACC8(d, 8), FLASH_ACC8(d, 16), FLASH_ACC8(d, 24)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaTf32SS<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
        : FLASH_ACC8(d, 0), FLASH_ACC8(d, 8), FLASH_ACC8(d, 16), FLASH_ACC8(d, 24),
          FLASH_ACC8(d, 32), FLASH_ACC8(d, 40), FLASH_ACC8(d, 48), FLASH_ACC8(d, 56)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

// d[64 x N] (+)= A[64 x 8] · B[8 x N] in TF32: A four .b32 TF32 registers a
// thread (row g / g + 8 of its warp's 16, column t4 / t4 + 4), B K-major
// in shared memory
template <int N>
struct WgmmaTf32RS;

template <>
struct WgmmaTf32RS<16> {
  __device__ __forceinline__ static void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : FLASH_ACC8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaTf32RS<32> {
  __device__ __forceinline__ static void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : FLASH_ACC8(d, 0), FLASH_ACC8(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaTf32RS<64> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : FLASH_ACC8(d, 0), FLASH_ACC8(d, 8), FLASH_ACC8(d, 16), FLASH_ACC8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaTf32RS<128> {
  __device__ __forceinline__ static void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : FLASH_ACC8(d, 0), FLASH_ACC8(d, 8), FLASH_ACC8(d, 16), FLASH_ACC8(d, 24),
          FLASH_ACC8(d, 32), FLASH_ACC8(d, 40), FLASH_ACC8(d, 48), FLASH_ACC8(d, 56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

#undef FLASH_ACC8

// 2^x, subnormal results flushed to 0 (one MUFU op; exp2f adds range
// handling for subnormals, which a p below 2^-126 of the row's largest does
// not need); 2^-inf = 0 exactly
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x rounded to TF32 (nearest, ties away: cvt.rna), as a .b32 whose low 13
// mantissa bits are 0
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// the 3xTF32 split of x: hi = tf32(x), lo = tf32(x - hi), so that
// a·b ≈ hi_a·hi_b + hi_a·lo_b + lo_a·hi_b to about 2^-21 relative
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// ---------------------------------------------------------------------------
// 3xTF32: hi / lo planes and the products on them (flash.cu's float32
// forward, flash_bwd.cu's float32 backward)
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int round8(int s) { return (s + 7) / 8 * 8; }

// One 32 x 32 tile (block (x, y, z): positions / 32, columns / 32, matrix)
// of x [B, S, heads, d] float32 into its 3xTF32 planes: where n_hi is
// given, natural hi / lo [B·heads, S, d]; where t_hi is given, transposed
// hi / lo [B·heads, d, S8] (S8 = S rounded up to 8), zeros past S.  The
// transposed planes hold the sequence permuted within each 8: position
// 8u + k holds element 8u + 2k for k < 4 and 8u + 2k - 7 for k >= 4, the
// order in which a thread's accumulator columns (2t4, 2t4 + 1) enter a TF32
// A fragment as k = t4 and t4 + 4 (Tf32Ops::frags).  256 threads.  Each
// source wraps it in a kernel of its own name, so that a trace tells the
// forward's pre-pass from the backward's.
__device__ __forceinline__ void split_planes(const float* x, int seq, int heads, int d,
                                             float* n_hi, float* n_lo, float* t_hi,
                                             float* t_lo) {
  __shared__ float hi_s[32][33], lo_s[32][33];
  const int mat = blockIdx.z, batch = mat / heads, head = mat % heads;
  const int s0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int r = ty; r < 32; r += 8) {
    const int s = s0 + r, c = c0 + tx;
    const bool in = s < seq && c < d;
    const float val =
        in ? x[(((int64_t)batch * seq + s) * heads + head) * d + c] : 0.f;
    uint32_t hi, lo;
    split_tf32(val, hi, lo);
    if (in && n_hi != nullptr) {
      const int64_t at = ((int64_t)mat * seq + s) * d + c;
      n_hi[at] = __uint_as_float(hi);
      n_lo[at] = __uint_as_float(lo);
    }
    hi_s[r][tx] = __uint_as_float(hi);
    lo_s[r][tx] = __uint_as_float(lo);
  }
  if (t_hi == nullptr) return;
  __syncthreads();
  const int seq8 = round8(seq);
  for (int r = ty; r < 32; r += 8) {
    const int c = c0 + r, pos = s0 + tx;
    if (c >= d || pos >= seq8) continue;
    const int k = pos & 7;
    const int src = (pos & ~7) + (k < 4 ? 2 * k : 2 * k - 7) - s0;
    const int64_t at = ((int64_t)mat * d + c) * seq8 + pos;
    t_hi[at] = hi_s[src][r];
    t_lo[at] = lo_s[src][r];
  }
}

// a kernel that wraps split_planes
typedef void (*SplitKernel)(const float*, int, int, int, float*, float*, float*,
                            float*);

// x [B, S, heads, d] into its natural planes (n_hi, n_lo), its transposed
// ones (t_hi, t_lo), or both, by `kernel`
cudaError_t launch_split(SplitKernel kernel, const void* x, int b, int seq, int heads,
                         int d, float* n_hi, float* n_lo, float* t_hi, float* t_lo,
                         cudaStream_t stream) {
  const dim3 grid((round8(seq) + 31) / 32, (d + 31) / 32, b * heads);
  kernel<<<grid, 256, 0, stream>>>(static_cast<const float*>(x), seq, heads, d, n_hi,
                                   n_lo, t_hi, t_lo);
  return cudaGetLastError();
}

// The 3xTF32 products on wgmma for one warpgroup at padded width DP, on
// tiles in panels of kP float32 columns (natural planes; one swizzle span a
// panel row).  Accumulator element 4j + 2rr + e of a 64 x N tile is row
// (warp·16 + g + 8rr), column 8j + 2t4 + e (g = lane / 4, t4 = lane % 4).
template <int DP>
struct Tf32Ops {
  static constexpr int kP = DP < 32 ? DP : 32;  // floats a natural panel row
  static constexpr int kSw = kP * 4;            // bytes a natural panel row
  static constexpr int kM = 64;                 // rows of an A tile (wgmma's M)

  // acc (=)+= A Bᵀ over the head dim: A a natural 64-row tile (hi at a_s,
  // lo at a_s + a_tile), B a natural tile of N rows (hi at b_s, lo at
  // b_s + b_tile); both K-major along D (issued, not waited).  The first
  // product of the first k-step overwrites acc; the small terms go first.
  template <int N>
  __device__ __forceinline__ static void issue_d(float (&acc)[N / 2], uint32_t a_s,
                                                 int a_tile, uint32_t b_s, int b_tile) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const int p = kk * 8 / kP, col = (kk * 8 % kP) * 4;
      const uint32_t a = a_s + p * kM * kSw + col;
      const uint32_t b = b_s + p * N * kSw + col;
      const uint64_t ah = smem_desc<kSw>(a, 1), al = smem_desc<kSw>(a + a_tile, 1);
      const uint64_t bh = smem_desc<kSw>(b, 1), bl = smem_desc<kSw>(b + b_tile, 1);
      WgmmaTf32SS<N>::run(acc, al, bh, kk > 0);
      WgmmaTf32SS<N>::run(acc, ah, bl, 1);
      WgmmaTf32SS<N>::run(acc, ah, bh, 1);
    }
  }

  // A fragments (hi, lo) of a 64 x 8J accumulator tile t: k-step j takes
  // the thread's columns 8j + 2t4 and 8j + 2t4 + 1 of rows g and g + 8 as
  // k = t4 and t4 + 4, the order the transposed planes hold
  template <int J>
  __device__ __forceinline__ static void frags(const float (&t)[4 * J],
                                               uint32_t (&hi)[J][4],
                                               uint32_t (&lo)[J][4]) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      split_tf32(t[4 * j], hi[j][0], lo[j][0]);
      split_tf32(t[4 * j + 2], hi[j][1], lo[j][1]);
      split_tf32(t[4 * j + 1], hi[j][2], lo[j][2]);
      split_tf32(t[4 * j + 3], hi[j][3], lo[j][3]);
    }
  }

  // acc[64 x DP] += A B, waited: A the fragments (64 rows x 8J of a
  // sequence), B a transposed tile [DP rows x 8J] (hi at b_s, lo at
  // b_s + b_tile), K-major along the sequence in panels of PT columns.  The
  // products of a tile go into a fresh accumulator, 64 columns at a time,
  // that is then added to acc in float32: the tensor cores' accumulation
  // rounds toward zero, so summing every tile in them would drift with the
  // sequence's length (about 1e-4 of dK at 4,096 tokens and 3 heads)
  template <int J, int PT>
  __device__ __forceinline__ static void add_s(float (&acc)[DP / 2],
                                               uint32_t (&hi)[J][4],
                                               uint32_t (&lo)[J][4],
                                               uint32_t b_s, int b_tile) {
    constexpr int kSwT = PT * 4, kN = DP < 64 ? DP : 64;
#pragma unroll
    for (int c = 0; c < DP / kN; ++c) {
      float part[kN / 2];
      fence_regs(hi);
      fence_regs(lo);
      wg_fence();
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const uint32_t b =
            b_s + (j * 8 / PT) * DP * kSwT + (j * 8 % PT) * 4 + c * kN * kSwT;
        const uint64_t bh = smem_desc<kSwT>(b, 1), bl = smem_desc<kSwT>(b + b_tile, 1);
        WgmmaTf32RS<kN>::run(part, lo[j], bh, j > 0);
        WgmmaTf32RS<kN>::run(part, hi[j], bl, 1);
        WgmmaTf32RS<kN>::run(part, hi[j], bh, 1);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(part);
      fence_regs(hi);
      fence_regs(lo);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[c * kN / 2 + i] += part[i];
    }
  }
};

// ---------------------------------------------------------------------------
// host: the shared-memory opt-in, TMA maps
// ---------------------------------------------------------------------------

// the dynamic shared-memory opt-in of kernel, once per device (a bit each,
// up to 64)
template <typename K>
cudaError_t opt_in(K kernel, int bytes, unsigned long long* opted_in) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (*opted_in & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *opted_in |= bit;
  return err;
}

// cuTensorMapEncodeTiled, taken from the driver at run time so that the
// library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 [batch, seq, heads, d] tensor as 4-d (d, heads, seq, batch), boxes
// of `panel` columns x 1 head x `rows` rows x 1 batch into one swizzled
// panel; elements past d or seq read as 0
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                int batch, int seq, int heads, int d, int panel, int rows,
                int swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)seq * heads * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)panel, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle mode = swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, mode,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a float32 tensor of up to three dims (innermost first, dims[0]
// contiguous; strides of dims 1 and 2 in bytes, multiples of 16), boxes of
// `panel` x `rows` x 1 into one swizzled panel whose rows are panel·4
// bytes (the swizzle span); elements past a dim read as 0
bool encode_map_f32(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                    const long long (&dims)[3], const long long (&strides)[2],
                    int panel, int rows) {
  const cuuint64_t gdims[3] = {(cuuint64_t)dims[0], (cuuint64_t)dims[1],
                               (cuuint64_t)dims[2]};
  const cuuint64_t gstrides[2] = {(cuuint64_t)strides[0], (cuuint64_t)strides[1]};
  const cuuint32_t box[3] = {(cuuint32_t)panel, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const int swizzle = panel * 4;
  const CUtensorMapSwizzle mode = swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
                gdims, gstrides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, mode,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the instantiation width for head dim d: the least of 16, 32, 64, 128, 256
// that holds it (0 if none does)
int padded_dim(int d) {
  for (int dp = 16; dp <= 256; dp *= 2)
    if (d <= dp) return dp;
  return 0;
}

}  // namespace
