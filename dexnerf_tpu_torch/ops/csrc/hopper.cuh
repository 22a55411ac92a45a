// Hopper (sm_90a) primitives shared by the tensor-core kernels
// (fused_render_bf16.cu, fused_train_loss_bf16.cu, fused_render.cu): mbarriers, TMA and
// bulk copies, shared-memory accesses by address, wgmma descriptors and the
// wgmma wrappers.
#pragma once

#include <cuda.h>  // CUtensorMap
#include <stdint.h>

#include <type_traits>

namespace {

// ---- the wide routes' column blocks (mlp_wide_bf16.cuh, mlp_wide_tf32.cuh)
// The width of the column block at c0 of an n-wide output (n a multiple of
// 16): bmax (128 or 64) while at least bmax remain, else the rest, split
// where it is not a wgmma width the kernels instantiate (80 = 64 + 16, 112 =
// 64 + 48). Every block starts at a multiple of 64.
__host__ __device__ inline int column_block(int n, int c0, int bmax) {
  const int r = n - c0;
  if (r >= bmax) return bmax;
  return (r == 80 || r == 112) ? 64 : r;
}

// f(BN) with BN a compile-time wgmma width for the run-time block width bn.
template <class F>
__device__ __forceinline__ void with_bn(int bn, F&& f) {
  switch (bn) {
    case 128: f(std::integral_constant<int, 128>{}); break;
    case 96: f(std::integral_constant<int, 96>{}); break;
    case 64: f(std::integral_constant<int, 64>{}); break;
    case 48: f(std::integral_constant<int, 48>{}); break;
    case 32: f(std::integral_constant<int, 32>{}); break;
    default: f(std::integral_constant<int, 16>{}); break;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ---- TMA and bulk copies
// box (c0 = feature column, c1 = sample row) of the tensor map into dst,
// completing on the mbarrier bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, int c0, int c1,
                                             uint32_t src) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(src)
               : "memory");
}
// `bytes` (a multiple of 16) contiguous bytes from src (16-byte aligned)
// into dst, completing on the mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
// `bytes` (a multiple of 16) contiguous bytes from shared src (16-byte
// aligned) to dst in device memory, in the open bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// thread writes to shared memory, made visible to wgmma and TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// shared-memory loads and stores at a shared address
__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v));
}
__device__ __forceinline__ uint32_t lds16(uint32_t a) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts16(uint32_t a, unsigned short v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(a), "h"(v));
}
__device__ __forceinline__ float4 lds128(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t a, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}
// barrier `id` over the 128 threads of one warpgroup
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ---- wgmma descriptors
// 128 B-swizzled, MN-major (transposed) operand starting at addr
// (1024-aligned atoms of 8 K rows x 128 B): the stride between 8-row K
// groups (SBO) is 1024 B; one 64-wide MN atom per instruction, so the
// MN-atom stride (LBO) is never used and is set alike.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// The same for an 8-wide, unswizzled MN-major A box ([64 K rows][16 B]):
// core matrices of 8 K rows x 16 B, the next 8 K rows 128 B on. The 8
// columns fill the first of the 8 M groups of the instruction; the others
// alias later K rows (both strides 128 B, whichever field the hardware
// reads for which), and their output rows (>= 8) are never written.
__device__ __forceinline__ uint64_t small_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}
// K-major, 128 B-swizzled operand at addr: rows of 64 K (128 B), 8-row
// atoms 1024 B apart; a k16 step adds 32 B.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// ---- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin registers that wgmma reads or writes: the compiler may not move
// their definitions past this point (before wgmma_fence) or their uses
// before it (after wgmma_wait0).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Register lists of the N / 2 f32 accumulators, 8 at a time.
#define WG_ACC8(i)                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_ACC16(i) WG_ACC8(i), WG_ACC8(i + 8)
#define WG_R0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_R16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define WG_R24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_R32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define WG_R40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define WG_R48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define WG_R56 ", %56, %57, %58, %59, %60, %61, %62, %63"
// A and B from shared memory. Operands: the accumulators, then da, db, the
// scale-d flag (0: d = A B, 1: d += A B), TA, TB.
#define WG_MMA(N, REGS, DA, DB, SC, TA_, TB_, ...)                                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #SC ", 0;\n"                          \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS "}, %" #DA \
               ", %" #DB ", p, 1, 1, %" #TA_ ", %" #TB_ ";\n}\n"                           \
               : __VA_ARGS__                                                             \
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
// A from registers (four bf16x2 of the thread's fragment), B from shared
// memory, K-major. Operands: the accumulators, a0..a3, db, scale-d.
#define WG_MMA_RS(N, REGS, A0, A1, A2, A3, DB, SC, ...)                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #SC ", 0;\n"                            \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS "}, {%" #A0 \
               ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DB ", p, 1, 1, 0;\n}\n"                 \
               : __VA_ARGS__                                                               \
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d))

// d[64 x N] (+)= A B for one k16 step, bf16 in, f32 accumulate, A ([64][K])
// and B ([N][K]) in shared memory, each K-major (TA, TB = 0) or MN-major
// (1: the transpose bit; the dW kernel's sample-major scratch boxes).
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db,
                                           int scale_d = 1) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64 || N == 96 || N == 128,
                "the kernels' wgmma widths");
  if constexpr (N == 16) {
    WG_MMA(16, WG_R0, 8, 9, 10, 11, 12, WG_ACC8(0));
  } else if constexpr (N == 32) {
    WG_MMA(32, WG_R0 WG_R8, 16, 17, 18, 19, 20, WG_ACC16(0));
  } else if constexpr (N == 48) {
    WG_MMA(48, WG_R0 WG_R8 WG_R16, 24, 25, 26, 27, 28, WG_ACC16(0), WG_ACC8(16));
  } else if constexpr (N == 64) {
    WG_MMA(64, WG_R0 WG_R8 WG_R16 WG_R24, 32, 33, 34, 35, 36, WG_ACC16(0), WG_ACC16(16));
  } else if constexpr (N == 96) {
    WG_MMA(96, WG_R0 WG_R8 WG_R16 WG_R24 WG_R32 WG_R40, 48, 49, 50, 51, 52, WG_ACC16(0),
           WG_ACC16(16), WG_ACC16(32));
  } else {
    WG_MMA(128, WG_R0 WG_R8 WG_R16 WG_R24 WG_R32 WG_R40 WG_R48 WG_R56, 64, 65, 66, 67, 68,
           WG_ACC16(0), WG_ACC16(16), WG_ACC16(32), WG_ACC16(48));
  }
}

// The same with A from registers: the thread's part of the [64][16] A
// block as wgmma's (and mma.sync's m16n8k16) fragment, rows 16 w + g and
// 16 w + g + 8 of warp w (g = lane / 4), columns 2 q, 2 q + 1 (a0, a1) and
// 8 + 2 q, 9 + 2 q (a2, a3), q = lane % 4; low half the lower column. That
// is the layout in which an m64nN f32 accumulator holds a 16-column block,
// so a layer's output is the next layer's A without leaving registers.
template <int N>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[N / 2], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t db,
                                              int scale_d) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64 || N == 96 || N == 128,
                "the kernels' wgmma widths");
  if constexpr (N == 16) {
    WG_MMA_RS(16, WG_R0, 8, 9, 10, 11, 12, 13, WG_ACC8(0));
  } else if constexpr (N == 32) {
    WG_MMA_RS(32, WG_R0 WG_R8, 16, 17, 18, 19, 20, 21, WG_ACC16(0));
  } else if constexpr (N == 48) {
    WG_MMA_RS(48, WG_R0 WG_R8 WG_R16, 24, 25, 26, 27, 28, 29, WG_ACC16(0), WG_ACC8(16));
  } else if constexpr (N == 64) {
    WG_MMA_RS(64, WG_R0 WG_R8 WG_R16 WG_R24, 32, 33, 34, 35, 36, 37, WG_ACC16(0), WG_ACC16(16));
  } else if constexpr (N == 96) {
    WG_MMA_RS(96, WG_R0 WG_R8 WG_R16 WG_R24 WG_R32 WG_R40, 48, 49, 50, 51, 52, 53, WG_ACC16(0),
              WG_ACC16(16), WG_ACC16(32));
  } else {
    WG_MMA_RS(128, WG_R0 WG_R8 WG_R16 WG_R24 WG_R32 WG_R40 WG_R48 WG_R56, 64, 65, 66, 67, 68,
              69, WG_ACC16(0), WG_ACC16(16), WG_ACC16(32), WG_ACC16(48));
  }
}
#undef WG_MMA_RS
#undef WG_MMA
#undef WG_R56
#undef WG_R48
#undef WG_R40
#undef WG_R32
#undef WG_R24
#undef WG_R16
#undef WG_R8
#undef WG_R0
#undef WG_ACC16
#undef WG_ACC8

}  // namespace
