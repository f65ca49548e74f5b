// GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py:25, launched by `flash_attention`
// at :73 through `pl.pallas_call` at :94). It computes
//     O = softmax(Q K^T * Dh^-0.5 [+ causal mask]) V
// with q (B, H, Sq, Dh), k and v (B, KH, Sk, Dh), H = KH * G: q head h reads
// kv head h / G, so a kv tile serves every q head of its group without a
// copy of K or V. Beyond the TPU kernel it takes a query offset (query row i
// sits at position q_offset + i under the causal mask), any Sq and Sk (the
// ragged edge is masked here, where the Pallas kernel asserted S % block == 0
// and Sq == Sk), Dh of 32, 64 or 128, and bf16 or fp32 inputs. Sums are fp32.
//
// The Pallas grid walks the kv blocks of one q block in order and carries
// (m, l, acc) in VMEM scratch between grid steps; CUDA blocks run in no
// order, so here a loop inside a CTA walks the kv tiles of one (b*h, q
// tile), with (m, l, acc) in registers and the score tile never in device
// memory. Under the causal mask the loop stops at the last kv tile
// that a row of the q tile can see (the Pallas kernel's `pl.when` skip at
// :61). A row whose every score is masked gets p = 0 and l floored at 1e-30,
// so it yields 0 rather than NaN, as the Pallas kernel (:50-51) does.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): the causal prefill
// does 2*B*H*S^2*Dh operations on 2*(2*B*H + 2*B*KH)*S*Dh bytes, so at the
// qwen3-8b prefill shape (H=32, KH=8, Dh=128, S=4096) it is bound by the
// operations: 0.139 ms against 0.025 ms for the bytes. Only wgmma reaches
// the tensor cores' full rate; it wants its operands in shared memory ahead
// of time, and the softmax's exponentials, on units with 1/256 of the
// tensor cores' rate (3.9 against 989 TFLOP/s, per the FlashAttention-3
// paper), have to hide under the products. The bf16 kernel is built for
// that:
//
//   * Warp specialisation. A CTA is three warpgroups over 128 q rows: a
//     producer (setmaxnreg down to 40 registers) and two consumers of 64
//     rows each (up to 232). One producer thread loads Q once per q tile and
//     each kv tile's K and V by TMA into a ring of STAGES stages (3 at every
//     Dh: Q 32 KiB + 3 x (K 32 KiB + V 32 KiB) at Dh = 128). Each stage has
//     a full barrier for K and one for V (mbarrier transaction counts) and
//     an empty one that the consumers' eight warps arrive on when done with
//     it; Q has a full and an empty barrier likewise.
//   * The tensor maps are 3-D, (Dh, S, B*heads): a tile that overhangs Sq or
//     Sk is zero-filled by the TMA and never reads the next head's rows; the
//     masks still decide what counts. Rows land in 128-byte swizzled column
//     blocks (64-byte for Dh = 32), the layout the wgmma descriptors name.
//   * S = Q K^T is wgmma m64n128k16 with both operands in shared memory,
//     K-major as they lie. O += P V is wgmma m64nDhk16 with P in registers:
//     the fp32 score accumulator's layout is the A-fragment layout, so P is
//     rounded to bf16 in place (as the JAX model's flash rounds P to v's
//     dtype, src/repro/models/attention.py:113), and V is read MN-major
//     through the descriptor's transpose.
//   * Overlap inside a consumer: tile j's Q K^T is issued before tile j-1's
//     P V, and tile j's softmax runs while P V is on the tensor cores.
//     Overlap across consumers (ping-pong): they take turns to issue their
//     products (named barriers), so one's softmax runs under the other's.
//   * Masks only where needed: kv tiles wholly below a consumer's diagonal
//     and inside Sk take no per-element mask; the diagonal and ragged-edge
//     tiles take the causal, q_offset and Sk masks.
//   * Persistent: one CTA an SM walks (b*h, q tile) items, heaviest causal
//     q tile first, in a zigzag over the CTAs that balances the causal work.
//     The producer loads the next item's Q as soon as both consumers have
//     issued their last Q K^T, and its K and V into the ring as stages free
//     up, so one item's last products, epilogue and the next item's loads
//     overlap, where a CTA an item paid its fill and drain each time.
//   * fp32: no tensor-core path keeps fp32 exact, so 256 threads work in
//     CUDA-core FMAs, four threads to a q row; P goes through shared memory.
//
// For training, both paths can also write each row's log-sum-exp,
// lse = m + log(max(l, 1e-30)) in the units of the scaled scores (m taken as
// 0 for a row that sees no key), which flash_attention_bwd.cu reads to
// recompute P. With lse == nullptr nothing is written and the kernels do what
// they did without it.

#include <cuda.h>               // CUtensorMap and its enums (header only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // q rows per CTA (fp32 kernel)
constexpr int BKF = 32;      // kv rows per shared-memory tile (fp32 kernel)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                // (B, H, Sq) or nullptr
  int H, KH, Sq, Sk, q_offset, causal;
  float scale;
};

// Number of kv positions that some row of q tile [q0, q0 + BQ) can see.
__device__ __forceinline__ int kv_extent(const Params& p, int q0) {
  if (!p.causal) return p.Sk;
  const int q_last = min(p.Sq, q0 + BQ) - 1;
  return max(0, min(p.Sk, p.q_offset + q_last + 1));
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int col) {
  return col < p.Sk && (!p.causal || col <= qpos);
}

// ------------------------------------------------------------------ bf16

constexpr int WG = 128;      // threads in a warpgroup
constexpr int BM = 128;      // q rows per CTA: two consumer warpgroups of 64
constexpr int BN = 128;      // kv rows per tile
constexpr int THREADS = 3 * WG;
constexpr int PRODUCER_REGS = 40;   // setmaxnreg: 128 x 40 + 256 x 232 <= 64K
constexpr int CONSUMER_REGS = 232;

template <int DH>
struct Tile {
  static constexpr int SW = DH >= 64 ? 128 : 64;     // swizzle span, bytes
  static constexpr int ATOM = SW / 2;                // bf16 columns per span
  static constexpr int STAGES = 3;                   // K/V ring depth
  static constexpr int Q_BYTES = BM * DH * 2;
  static constexpr int KV_BYTES = BN * DH * 2;       // one K or V tile
  static constexpr int BAR_BYTES = 1024;             // barriers, then 1 KiB-aligned tiles
  // 1 KiB of slack to align the dynamic shared memory, then barriers and tiles
  static constexpr int SMEM = 1024 + BAR_BYTES + Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;   // wgmma descriptor swizzle
  static_assert(SMEM <= 232448, "over the 227 KiB a CTA may use");
};

struct BfArgs {
  __nv_bfloat16* o;
  float* lse;                // (B, H, Sq) or nullptr
  int B, H, KH, Sq, Sk, q_offset, causal;
  float scale_log2;          // Dh^-0.5 * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait for the phase of parity `parity` to complete. The spin is inside the
// PTX, so the compiler sees no divergent branch around the wgmma that
// follow. A wrong transaction count or phase would spin forever; after 2^32
// clocks (seconds) the kernel traps instead, so the launch fails rather
// than hangs the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 4294967296;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// Arrive on `bar` from the threads where `pred` holds, without a branch.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      :: "r"(bar), "r"((int)pred) : "memory");
}

// Named barriers 1 and 2 order the two consumers' wgmma issues.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// One TMA box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode.
template <int DH>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | Tile<DH>::LAYOUT << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Pin registers that an asynchronous wgmma reads or writes at this point
// of the instruction order.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {        // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 128, fp32) = A (64 x 16) * B (16 x 128), A and B from shared memory
// (both K-major, per their descriptors); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 32, fp32) += A (64 x 16, bf16 fragments in registers) * B (16 x 32),
// B from shared memory, MN-major (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 fragments in registers) * B (16 x 64),
// B from shared memory, MN-major (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 fragments in registers) * B (16 x 128),
// B from shared memory, MN-major (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


// Online softmax of one 64 x BN score tile in the wgmma accumulator layout:
// this thread holds rows r (s[4j], s[4j+1]) and r + 8 (s[4j+2], s[4j+3]) at
// columns col0 + 8j + 2t + {0, 1}. Turns s into p = exp(s*scale - m) in
// place, updates the running max m (log2 units) and this thread's share of
// the row sums l, and sets corr, the factor that rescales the old output.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             const BfArgs& a, int col0,
                                             const int (&qpos)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK) {
        const int col = col0 + 8 * j + (e & 1);
        if (col >= a.Sk || (a.causal && col > qpos[e >> 1])) s[4 * j + e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  }
  float neg_base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * a.scale_log2);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    corr[r] = ex2(m[r] - base);                 // ex2(-inf) = 0
    m[r] = m_new;
    l[r] *= corr[r];
    neg_base[r] = -base;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = ex2(fmaf(s[4 * j + e], a.scale_log2, neg_base[e >> 1]));
      s[4 * j + e] = pe;
      l[e >> 1] += pe;
    }
  }
}

// The probabilities of a score tile as the A fragments of P V, rounded to
// bf16: k-step kk covers columns [16kk, 16kk + 16), i.e. accumulator
// blocks 2kk and 2kk + 1.
__device__ __forceinline__ void to_fragments(const float (&s)[BN / 2],
                                             uint32_t (&p)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  }
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (DH == 128) wgmma_rs_n128(o, a, desc_b);
  else if constexpr (DH == 64) wgmma_rs_n64(o, a, desc_b);
  else wgmma_rs_n32(o, a, desc_b);
}

// The work of a CTA: one (b*h, 128-row q tile) after another. Items are
// numbered heaviest causal q tile first, every head of a q tile before the
// next; CTA c of G takes item r*G + c in even rounds r and r*G + G-1-c in
// odd ones, which balances the causal work as well as first-come dispatch.
struct Item {
  int bh, q0;
};

__device__ __forceinline__ bool next_item(int r, int n_qt, int BH, Item& it) {
  const int G = gridDim.x, c = blockIdx.x;
  const int i = r * G + ((r & 1) ? G - 1 - c : c);
  if (i >= n_qt * BH) return false;
  it.bh = i % BH;
  it.q0 = (n_qt - 1 - i / BH) * BM;
  return true;
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const BfArgs a) {
  using T = Tile<DH>;
  constexpr int STAGES = T::STAGES, SW = T::SW, ATOM = T::ATOM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 1 KiB alignment: the swizzle pattern repeats every 1024 (512) bytes, and
  // TMA and wgmma agree on it only from such a boundary
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q = base;                          // Q landed
  const uint32_t bar_qe = base + 8;                     // Q free
  const uint32_t bar_k = base + 16;                     // [STAGES] K landed
  const uint32_t bar_v = bar_k + 8 * STAGES;            // [STAGES] V landed
  const uint32_t bar_e = bar_v + 8 * STAGES;            // [STAGES] stage free
  const uint32_t sq = base + T::BAR_BYTES;              // Q: DH/ATOM blocks of BM x SW bytes
  const uint32_t sk = sq + T::Q_BYTES;                  // K stages, BN x SW-byte blocks
  const uint32_t sv = sk + STAGES * T::KV_BYTES;        // V stages

  const int Sq = a.Sq, Sk = a.Sk, q_offset = a.q_offset, causal = a.causal;
  const int BH = a.B * a.H, n_qt = (Sq + BM - 1) / BM;
  // kv positions that some row of [q0, q_end) can see
  auto extent = [&](int q_end) {
    if (!causal) return Sk;
    return max(0, min(Sk, q_offset + min(Sq, q_end)));
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_qe, 2 * WG / 32);                     // every consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 2 * WG / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so the compiler knows it is uniform
  const int wg = __shfl_sync(0xffffffff, static_cast<int>(threadIdx.x) / WG, 0);
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      Item it;
      for (int r = 0, t = 0; next_item(r, n_qt, BH, it); ++r) {
        const int h = it.bh % a.H;
        const int kv_slab = (it.bh / a.H) * a.KH + h / (a.H / a.KH);
        mbar_wait(bar_qe, (r & 1) ^ 1);                 // round 0 passes
        mbar_expect_tx(bar_q, T::Q_BYTES);
        for (int c = 0; c < DH / ATOM; ++c)
          tma_load_3d(sq + c * BM * SW, &tm_q, c * ATOM, it.q0, it.bh, bar_q);
        const int n_tiles = (extent(it.q0 + BM) + BN - 1) / BN;
        for (int j = 0; j < n_tiles; ++j, ++t) {
          const int s = t % STAGES;
          mbar_wait(bar_e + 8 * s, ((t / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_k + 8 * s, T::KV_BYTES);
          for (int c = 0; c < DH / ATOM; ++c)
            tma_load_3d(sk + s * T::KV_BYTES + c * BN * SW, &tm_k, c * ATOM, j * BN,
                        kv_slab, bar_k + 8 * s);
          mbar_expect_tx(bar_v + 8 * s, T::KV_BYTES);
          for (int c = 0; c < DH / ATOM; ++c)
            tma_load_3d(sv + s * T::KV_BYTES + c * BN * SW, &tm_v, c * ATOM, j * BN,
                        kv_slab, bar_v + 8 * s);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int w = wg - 1;                               // which 64 rows
    const int tid = threadIdx.x % WG, lane = tid & 31;
    const int r0 = w * 64 + (tid >> 5) * 16 + (lane >> 2);   // rows r0, r0 + 8
    const int t2 = 2 * (lane & 3);                      // column pair in a block of 8

    // descriptors: Q and K K-major (8-row groups SW * 8 bytes apart); V
    // MN-major (column blocks BN * SW bytes apart, 8-row groups SW * 8)
    auto desc_q = [&](int kk) {
      return desc<DH>(sq + (kk * 16 / ATOM) * BM * SW + w * 64 * SW + (kk * 16 % ATOM) * 2,
                      16, 8 * SW);
    };
    auto desc_k = [&](int s, int kk) {
      return desc<DH>(sk + s * T::KV_BYTES + (kk * 16 / ATOM) * BN * SW + (kk * 16 % ATOM) * 2,
                      16, 8 * SW);
    };
    auto desc_v = [&](int s, int kk) {
      return desc<DH>(sv + s * T::KV_BYTES + kk * 16 * SW, BN * SW, 8 * SW);
    };
    auto release = [&](uint32_t bar) { mbar_arrive_if(bar, lane == 0); };
    // Ping-pong: the consumers take turns to issue their wgmma (one turn is
    // a tile's Q K^T and the previous tile's P V), so one's softmax runs
    // while the other's products hold the tensor cores. Consumer 1 lets 0
    // go first; both take n_tiles + 1 turns an item.
    auto turn_begin = [&] { bar_sync(1 + w, 2 * WG); };
    auto turn_end = [&] { bar_arrive(2 - w, 2 * WG); };
    if (w == 1) bar_arrive(1, 2 * WG);

    float o[DH / 2];
    float s[BN / 2];
    uint32_t p[BN / 16][4];
    float m[2], l[2], corr[2];
    auto issue_qk = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss_n128(s, desc_q(kk), desc_k(st, kk), kk > 0);
      wgmma_commit();
    };
    auto issue_pv = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_pv<DH>(o, p[kk], desc_v(st, kk));
      wgmma_commit();
    };

    Item it;
    for (int r = 0, t = 0; next_item(r, n_qt, BH, it); ++r) {
      const int q0 = it.q0;
      const int qpos[2] = {q_offset + q0 + r0, q_offset + q0 + r0 + 8};
      const int n_tiles = (extent(q0 + BM) + BN - 1) / BN;
      // this consumer's tiles (n_mine >= 1 as Sk >= 1), and of them the
      // leading ones that need no mask
      const int n_mine = (extent(q0 + 64 * (w + 1)) + BN - 1) / BN;
      const int first = q_offset + q0 + 64 * w;         // the smallest q position
      const int n_open = min(n_mine, (causal ? max(0, min(Sk, first + 1)) : Sk) / BN);
      auto softmax = [&](int j) {
        if (j < n_open) softmax_tile<false>(s, m, l, corr, a, j * BN + t2, qpos);
        else softmax_tile<true>(s, m, l, corr, a, j * BN + t2, qpos);
      };
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;

      mbar_wait(bar_q, r & 1);
      // tile 0: S = Q K0^T, then its softmax
      mbar_wait(bar_k + 8 * (t % STAGES), (t / STAGES) & 1);
      pin(s);
      turn_begin();
      wgmma_fence();
      issue_qk(t % STAGES);
      turn_end();
      wgmma_wait<0>();
      pin(s);
      if (n_mine == 1) release(bar_qe);                 // Q read for the last time
      softmax(0);
      to_fragments(s, p);
      for (int j = 1; j < n_mine; ++j) {
        const int st = (t + j) % STAGES, prev = (t + j - 1) % STAGES;
        // S_j = Q K_j^T is issued first and P_{j-1} V_{j-1} behind it: the
        // softmax of tile j runs while P V is on the tensor cores
        mbar_wait(bar_k + 8 * st, ((t + j) / STAGES) & 1);
        pin(s);
        pin(o);
        pin(p);
        turn_begin();
        wgmma_fence();
        issue_qk(st);
        mbar_wait(bar_v + 8 * prev, ((t + j - 1) / STAGES) & 1);
        issue_pv(prev);
        turn_end();
        wgmma_wait<1>();                                // S_j is in
        pin(s);
        if (j == n_mine - 1) release(bar_qe);
        softmax(j);
        wgmma_wait<0>();                                // so is P_{j-1} V_{j-1}
        pin(o);
        pin(p);
        release(bar_e + 8 * prev);
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          o[4 * n] *= corr[0];
          o[4 * n + 1] *= corr[0];
          o[4 * n + 2] *= corr[1];
          o[4 * n + 3] *= corr[1];
        }
        to_fragments(s, p);
      }
      {
        const int last = (t + n_mine - 1) % STAGES;
        mbar_wait(bar_v + 8 * last, ((t + n_mine - 1) / STAGES) & 1);
        pin(o);
        pin(p);
        turn_begin();
        wgmma_fence();
        issue_pv(last);
        turn_end();
        wgmma_wait<0>();
        pin(o);
        release(bar_e + 8 * last);
      }
      // a tile that the other consumer's rows see and these do not: free it
      // (and pass its turn)
      for (int j = n_mine; j < n_tiles; ++j) {
        const int st = (t + j) % STAGES, ph = ((t + j) / STAGES) & 1;
        mbar_wait(bar_k + 8 * st, ph);
        mbar_wait(bar_v + 8 * st, ph);
        release(bar_e + 8 * st);
        turn_begin();
        turn_end();
      }
      t += n_tiles;

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffff, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffff, l[i], 2);
        const int row = q0 + r0 + 8 * i;
        if (a.lse != nullptr && (lane & 3) == 0 && row < Sq) {
          // m is in log2 units of the scaled scores
          const float base = m[i] == -INFINITY ? 0.f : m[i];
          a.lse[(size_t)it.bh * Sq + row] =
              (base + log2f(fmaxf(l[i], 1e-30f))) * 0.6931471805599453f;
        }
        l[i] = 1.f / fmaxf(l[i], 1e-30f);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + r0 + 8 * i;
        if (row >= Sq) continue;
        __nv_bfloat16* orow = a.o + ((size_t)it.bh * Sq + row) * DH + t2;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + 8 * n) =
              pack_bf16(o[4 * n + 2 * i] * l[i], o[4 * n + 2 * i + 1] * l[i]);
      }
    }
    if (w == 0) bar_sync(1, 2 * WG);                  // consumer 1's last arrive
  }
}

// ------------------------------------------------------------------ fp32

template <int DH>
__global__ void __launch_bounds__(256) flash_fwd_f32(Params p) {
  constexpr int LDQ = DH + 1, LDK = DH + 1, LDP = BKF + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // BQ x LDQ
  float* Ks = Qs + BQ * LDQ;                        // BKF x LDK
  float* Vs = Ks + BKF * LDK;                       // BKF x DH
  float* Ps = Vs + BKF * DH;                        // BQ x LDP

  const int row = threadIdx.x >> 2, sub = threadIdx.x & 3;   // 4 threads a row
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const float* qg = static_cast<const float*>(p.q) + (size_t)bh * p.Sq * DH;
  const size_t kv_off = ((size_t)b * p.KH + kvh) * p.Sk * DH;
  const float* kg = static_cast<const float*>(p.k) + kv_off;
  const float* vg = static_cast<const float*>(p.v) + kv_off;
  float* og = static_cast<float*>(p.o) + (size_t)bh * p.Sq * DH;

  for (int i = threadIdx.x; i < BQ * DH; i += 256) {
    const int r = i / DH, d = i % DH;
    Qs[r * LDQ + d] = q0 + r < p.Sq ? qg[(size_t)(q0 + r) * DH + d] : 0.f;
  }

  float o[DH / 4];
#pragma unroll
  for (int i = 0; i < DH / 4; ++i) o[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int qpos = p.q_offset + q0 + row;
  const int kv_end = kv_extent(p, q0);

  for (int k0 = 0; k0 < kv_end; k0 += BKF) {
    __syncthreads();
    for (int i = threadIdx.x; i < BKF * DH; i += 256) {
      const int r = i / DH, d = i % DH;
      const bool in = k0 + r < p.Sk;
      Ks[r * LDK + d] = in ? kg[(size_t)(k0 + r) * DH + d] : 0.f;
      Vs[r * DH + d] = in ? vg[(size_t)(k0 + r) * DH + d] : 0.f;
    }
    __syncthreads();

    float s[BKF / 4];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKF / 4; ++j) {
      const int c = sub + 4 * j;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) acc = fmaf(Qs[row * LDQ + d], Ks[c * LDK + d], acc);
      s[j] = visible(p, qpos, k0 + c) ? acc * p.scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    const float corr = m == -INFINITY ? 0.f : expf(m - base);
    m = m_new;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < BKF / 4; ++j) {
      const float pj = expf(s[j] - base);
      Ps[row * LDP + sub + 4 * j] = pj;
      ls += pj;
    }
    l = l * corr + ls;
#pragma unroll
    for (int i = 0; i < DH / 4; ++i) o[i] *= corr;
    __syncwarp();                           // a row's P is written within its warp
#pragma unroll 4
    for (int c = 0; c < BKF; ++c) {
      const float pc = Ps[row * LDP + c];
#pragma unroll
      for (int i = 0; i < DH / 4; ++i) o[i] = fmaf(pc, Vs[c * DH + sub + 4 * i], o[i]);
    }
  }

  l += __shfl_xor_sync(0xffffffff, l, 1);
  l += __shfl_xor_sync(0xffffffff, l, 2);
  const float inv = 1.f / fmaxf(l, 1e-30f);
  if (q0 + row < p.Sq) {
#pragma unroll
    for (int i = 0; i < DH / 4; ++i)
      og[(size_t)(q0 + row) * DH + sub + 4 * i] = o[i] * inv;
    if (p.lse != nullptr && sub == 0)
      p.lse[(size_t)bh * p.Sq + q0 + row] = (m == -INFINITY ? 0.f : m) + logf(fmaxf(l, 1e-30f));
  }
}

// Every row of a call with Sk == 0 sees no key: lse = log(1e-30).
__global__ void fill_lse(float* lse, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) lse[i] = -69.07755278982137f;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int B, int threads,
                   size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, B * p.H);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled is a driver-API function: reached through the
// runtime's entry-point query, so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                  cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// The tensor map of a contiguous (slabs, rows, DH) bf16 array, boxes of
// (ATOM columns, box_rows rows, one slab). Three dimensions, so a box that
// overhangs `rows` is zero-filled instead of reading the next slab. TMA needs
// a 16-byte aligned base and outer strides of a multiple of 16 bytes: the
// wrapper takes only contiguous, 16-byte aligned tensors with DH in {32, 64,
// 128}, so the strides are multiples of DH * 2 >= 64 bytes.
template <int DH>
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int slabs, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)DH, (cuuint64_t)rows, (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {(cuuint64_t)DH * 2, (cuuint64_t)rows * DH * 2};
  const cuuint32_t box[3] = {(cuuint32_t)Tile<DH>::ATOM, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                Tile<DH>::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  if (p.Sk == 0) {                        // every score masked: O = 0
    const long long rows = (long long)B * p.H * p.Sq;
    if (p.lse != nullptr && rows > 0) {
      fill_lse<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(p.lse, rows);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    return cudaMemsetAsync(p.o, 0, (size_t)rows * DH * 2, stream);
  }
  CUtensorMap tq, tk, tv;
  if (!tensor_map<DH>(&tq, p.q, p.Sq, B * p.H, BM) ||
      !tensor_map<DH>(&tk, p.k, p.Sk, B * p.KH, BN) ||
      !tensor_map<DH>(&tv, p.v, p.Sk, B * p.KH, BN))
    return cudaErrorInvalidValue;
  static const cudaError_t set = cudaFuncSetAttribute(
      flash_fwd_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<DH>::SMEM);
  if (set != cudaSuccess) return set;
  int dev, n_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const BfArgs a{static_cast<__nv_bfloat16*>(p.o), p.lse, B, p.H, p.KH, p.Sq, p.Sk, p.q_offset,
                 p.causal, p.scale * 1.4426950408889634f};
  // persistent: at most one CTA an SM, each walking items (next_item)
  const long long n_items = (long long)B * p.H * ((p.Sq + BM - 1) / BM);
  const int grid = (int)(n_items < n_sm ? n_items : n_sm);
  flash_fwd_bf16<DH><<<grid, THREADS, Tile<DH>::SMEM, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

template <int DH>
cudaError_t dispatch(const Params& p, int B, int is_bf16, cudaStream_t stream) {
  if (is_bf16) return launch_bf16<DH>(p, B, stream);
  return launch(flash_fwd_f32<DH>, p, B, 256,
                (size_t)(BQ * (DH + 1) + BKF * (DH + 1) + BKF * DH + BQ * (BKF + 1)) *
                    sizeof(float),
                stream);
}

}  // namespace

// q (B, H, Sq, Dh), k and v (B, KH, Sk, Dh), o (B, H, Sq, Dh): contiguous,
// 16-byte aligned, on the current device, all bf16 (is_bf16 = 1) or all
// fp32. H % KH == 0. lse, (B, H, Sq) fp32, receives each row's log-sum-exp
// where it is not nullptr. Launches on `stream` and does not synchronise. Returns
// the cudaError_t of the launch (0 on success); Dh outside {32, 64, 128}, or
// a bf16 array that no TMA tensor map can describe, returns
// cudaErrorInvalidValue.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int B, int H, int KH, int Sq, int Sk, int Dh,
                                   int q_offset, int causal, float scale, int is_bf16,
                                   void* stream) {
  const Params p{q, k, v, o, lse, H, KH, Sq, Sk, q_offset, causal, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32: return dispatch<32>(p, B, is_bf16, st);
    case 64: return dispatch<64>(p, B, is_bf16, st);
    case 128: return dispatch<128>(p, B, is_bf16, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
