// Split-bf16 products on Hopper's tensor cores (sm_90a), shared by the
// chunkwise-mLSTM forward (mlstm_chunk.cu) and backward (mlstm_chunk_bwd.cu).
//
// Both keep fp32's accuracy on the tensor cores: every fp32 operand is split
// into three bf16 pieces, x = x1 + x2 + x3 (24 significant bits), and of the
// nine products of two split operands the six that fp32 needs are summed in
// fp32 wgmma accumulators (tests/test_torch_mlstm_precision.py emulates it).
// The operands are (3 BH, rows, Dp) bf16 arrays, piece p of (b h) at slab
// p BH + bh, Dp the head dim rounded up to 64 (the pad is 0), brought in by
// TMA as 64-column tiles of 128-byte swizzled rows, 1 KiB aligned.

#pragma once

#include "hopper.cuh"

namespace {

constexpr int PIECES = 3;          // bf16 pieces of a split fp32 operand

__host__ __device__ inline int padded(int Dh) { return (Dh + 63) / 64 * 64; }

// x = x1 + x2 + x3 to fp32's 24 significant bits, each piece a bf16 (8): x1
// = x rounded, x2 = the rest rounded, x3 = what remains of that, rounded.
__device__ __forceinline__ void split3(float x, __nv_bfloat16 (&p)[PIECES]) {
  p[0] = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r);
  p[2] = __float2bfloat16_rn(r - __bfloat162float(p[1]));
}

// The pieces of two adjacent fp32 values as three packed bf16 pairs: the A
// fragments of a product whose A is a wgmma accumulator tile.
__device__ __forceinline__ void split3_pair(float x0, float x1, uint32_t& a1, uint32_t& a2,
                                            uint32_t& a3) {
  const __nv_bfloat162 p1 = __floats2bfloat162_rn(x0, x1);
  const float2 f1 = __bfloat1622float2(p1);
  const float r0 = x0 - f1.x, r1 = x1 - f1.y;
  const __nv_bfloat162 p2 = __floats2bfloat162_rn(r0, r1);
  const float2 f2 = __bfloat1622float2(p2);
  const __nv_bfloat162 p3 = __floats2bfloat162_rn(r0 - f2.x, r1 - f2.y);
  a1 = *reinterpret_cast<const uint32_t*>(&p1);
  a2 = *reinterpret_cast<const uint32_t*>(&p2);
  a3 = *reinterpret_cast<const uint32_t*>(&p3);
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptors of 64-column bf16 tiles of 128-byte swizzled rows, 1 KiB
// aligned: K-major (a row per M or N index; a k-step is 32 bytes along the
// row), and MN-major (a row per k; a k-step is 16 rows, 2 KiB).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + 32 * kk, 16);
}
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + 2048 * kk, 8192);
}

#define WGMMA_D32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WGMMA_D32_OUT(d)                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64, fp32) += A (64 x 16, bf16 fragments in registers) * B (16 x 64),
// B K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_k(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WGMMA_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16) * B (16 x 64), both in shared memory; A
// MN-major (transposed by the descriptor), B K-major (TB = 0) or MN-major (1).
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 1, %35;\n}\n"
      : WGMMA_D32_OUT(d)
      : "l"(a), "l"(b), "r"(1), "n"(TB));
}

// The products of split operands that fp32 needs, A1 B1 + A1 B2 + A2 B1 +
// A1 B3 + A2 B2 + A3 B1, issued smallest first (the three dropped are below
// 2^-25 of the product). A from registers (pieces a1, a2, a3) or shared
// memory; B's pieces in shared memory.
__device__ __forceinline__ void wgmma_rs6(float (&d)[32], const uint32_t (&a1)[4],
                                          const uint32_t (&a2)[4], const uint32_t (&a3)[4],
                                          const uint64_t (&b)[PIECES]) {
  wgmma_rs_k(d, a3, b[0]);
  wgmma_rs_k(d, a2, b[1]);
  wgmma_rs_k(d, a1, b[2]);
  wgmma_rs_k(d, a2, b[0]);
  wgmma_rs_k(d, a1, b[1]);
  wgmma_rs_k(d, a1, b[0]);
}
template <int TB>
__device__ __forceinline__ void wgmma_ss6(float (&d)[32], const uint64_t (&a)[PIECES],
                                          const uint64_t (&b)[PIECES]) {
  wgmma_ss<TB>(d, a[2], b[0]);
  wgmma_ss<TB>(d, a[1], b[1]);
  wgmma_ss<TB>(d, a[0], b[2]);
  wgmma_ss<TB>(d, a[1], b[0]);
  wgmma_ss<TB>(d, a[0], b[1]);
  wgmma_ss<TB>(d, a[0], b[0]);
}

// The tensor map of a contiguous (n2, n1, n0) bf16 array, boxes of 64
// values x `rows` rows of one slab, 128-byte swizzled. Three dimensions, so a
// box that overhangs n1 or n0 is zero-filled instead of reading the next
// slab. TMA needs a 16-byte aligned base (the scratch buffers are 256-byte
// aligned) and strides of a multiple of 16 bytes (n0 is a multiple of 64).
inline bool tensor_map_pieces(CUtensorMap* map, const __nv_bfloat16* ptr, int n0, int n1,
                              int n2, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)n0, (cuuint64_t)n1, (cuuint64_t)n2};
  const cuuint64_t strides[2] = {(cuuint64_t)n0 * 2, (cuuint64_t)n0 * n1 * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<__nv_bfloat16*>(ptr),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
