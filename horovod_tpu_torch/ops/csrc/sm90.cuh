// Hopper (sm_90a) building blocks shared by the tensor-core flash kernels:
// mbarriers, TMA tile and bulk loads, wgmma shared-memory descriptors for
// 128-byte-swizzled bf16 tiles, the m64n64k16 bf16 wgmma in its two forms
// (A from shared memory, A from registers), its fence/commit/wait, and the
// host-side tensor-map encoder fetched from the driver at run time (so the
// libraries need no -lcuda).
//
// Tile convention. Every bf16 tile in shared memory is stored as chunks of
// 64 columns (128 bytes a row, the span of the 128-byte swizzle): chunk c
// holds columns [64c, 64c + 64) of all ROWS rows, rows 128 bytes apart,
// swizzled by TMA (CU_TENSOR_MAP_SWIZZLE_128B). Each chunk starts on a
// 1024-byte boundary, so the descriptors' base offset stays 0.
//
// Fragments. A wgmma m64nN f32 accumulator gives thread t of the warpgroup
// (warp w = t / 32, lane l) the elements d[i], i < N / 2, at
//   row = 16 w + l / 4 + 8 ((i / 2) % 2),  col = 8 (i / 4) + 2 (l % 4) + i % 2,
// and the register A operand of m64k16 takes, per 16-column k step kk of
// the same rows, the bf16 pairs d[8kk + {0,1}], {2,3}, {4,5}, {6,7} — so
// an accumulator converts to the next product's A operand in registers.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int CHUNK_COLS = 64;                       // bf16 columns a chunk
constexpr int ROW_BYTES = CHUNK_COLS * 2;            // 128
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the completion of the barrier's phase of this parity. A wait that
// never ends (a lost TMA transaction, a miscounted arrival) traps after
// ~2^26 polls, so a fault surfaces as a launch error instead of a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// -- TMA ----------------------------------------------------------------------

// One box of a 4-D tensor map (dims innermost first) into shared memory;
// completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A contiguous run of bytes (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// -- wgmma --------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at shared address `addr`. Both
// byte offsets are the 1024-byte stride between 8-row groups: with N = 64
// and k = 16 a single swizzle atom spans the other dimension, so whichever
// of the two fields the layout reads (K-major: SBO; MN-major: SBO across
// k, LBO across 64-column blocks, unused at N = 64) is right.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  constexpr uint64_t stride = 1024 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (stride << 16) |
         (stride << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HVT_WGMMA_D32                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]; A and B from shared memory, both
// K-major (the 16-wide k run contiguous in each row of A and of B's N rows).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HVT_WGMMA_D32
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]; A from registers (four bf16 pairs a
// thread), B from shared memory MN-major: B's 16 k rows each hold its 64 N
// columns contiguous (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HVT_WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef HVT_WGMMA_D32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An m64n64 f32 accumulator as the bf16 A operand of four k16 steps.
__device__ __forceinline__ void acc_to_a(const float (&d)[32],
                                         uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

// The same as a bf16 hi + lo pair (hi = bf16(x), lo = bf16(x - hi)): two
// products against the same B carry x to ~16 significant bits.
__device__ __forceinline__ void acc_to_a_split(const float (&d)[32],
                                               uint32_t (&hi)[16],
                                               uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(d[2 * i], d[2 * i + 1]);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(d[2 * i] - __low2float(h), d[2 * i + 1] - __high2float(h));
  }
}

// -- host: tensor maps --------------------------------------------------------

// A tensor described by the caller as int64 [ptr, dim0..3, stride1..3 (bytes),
// box0..3]: dims innermost first, dim 0 contiguous.
constexpr int TENSOR_DESC_LEN = 12;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 4-D tiled map with 128-byte swizzle; out-of-bounds boxes zero-fill.
inline cudaError_t make_map(CUtensorMap* map, const long long* desc) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = static_cast<cuuint64_t>(desc[1 + i]);
    box[i] = static_cast<cuuint32_t>(desc[8 + i]);
  }
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(desc[5 + i]);
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  reinterpret_cast<void*>(desc[0]), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
