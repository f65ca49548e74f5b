// GQA flash attention, backward, for Hopper (sm_90a).
//
// The gradient of flash_attention_fwd (flash_attention.cu). It has no TPU
// kernel to replace: the JAX model trains through the XLA online-softmax scan
// of src/repro/models/attention.py:70 under jax.checkpoint (:120), and JAX's
// autodiff of that scan is the reference. With q (B, H, Sq, Dhk), k (B, KH,
// Sk, Dhk) and v (B, KH, Sk, Dhv), H = KH * G (q head h reads kv head h / G),
// the forward's output o (B, H, Sq, Dhv) and its row log-sum-exp lse (B, H,
// Sq), and the output's gradient dO, it computes dQ, dK and dV in the inputs'
// dtype with fp32 sums, for a causal mask or none, any q_offset (query row i
// at position q_offset + i), any Sq and Sk, (Dhk, Dhv) of (16, 16), (32, 32),
// (64, 64), (128, 128) or MLA's (192, 128) (the wrapper zero-pads other
// widths and passes the scale of the unpadded one), bf16 or fp32. The
// FlashAttention-2
// scheme, in three passes that recompute P = exp(S - lse) tile by tile and
// never hold a score matrix in device memory:
//
//   1. delta: D = rowsum(dO o O), fp32, one warp a row;
//   2. dkdv: one CTA per (b, kv head, key tile) holds its tile's dK and dV
//      in registers and loops over the query tiles of all G q heads of its
//      group that can see the tile: dV += P^T dO, dK += dS^T Q with
//      dS = P o (dO V^T - D), scaled by Dhk^-0.5 at the end;
//   3. dq: one CTA per (b, q head, query tile) holds its dQ and loops over
//      the key tiles its rows can see: dQ += dS K.
//
// Every output element is written once by one CTA, and each CTA sums in a
// fixed order: no atomics, so two calls give the same bits. Masked scores get
// P = 0 directly, so a row that sees no key (Sk == 0; the forward's output
// there is 0 and its lse log(1e-30)) has no gradient.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): five products of
// 2*Sq*Sk*Dh operations per head, halved by a causal mask: at the qwen3-8b
// training shape (B=1, H=32, KH=8, S=4096, Dh=128) 343.6 GFLOP, 0.347 ms,
// against ~168 MB of inputs and outputs, 0.05 ms: bound by the operations.
// The two passes do seven products, since the dQ pass recomputes S and dP:
// 0.486 ms is the bound of this design. A single pass that adds dQ with
// fp32 atomics would do five, but no longer repeat bit for bit. With Dhk !=
// Dhv the five products are B*H*S^2*(3*Dhk + 2*Dhv) and the seven
// B*H*S^2*(4*Dhk + 3*Dhv): 0.2258 and 0.3127 ms at deepseek-v2-lite's
// training shape (H = KH = 16, S = 4096, (192, 128)).
//
// The bf16 passes are built for the tensor cores' rate, after the
// FlashAttention-3 backward made deterministic:
//
//   * Warp specialisation, as in the forward: a producer warpgroup
//     (setmaxnreg down to 24 registers) starts TMA loads into an mbarrier
//     ring; two consumer warpgroups of 64 rows each (up to 240 registers)
//     run every product on wgmma. A CTA an SM walks work items heaviest
//     causal tile first in the forward's zigzag, and the producer loads the
//     next item's tiles while the consumers finish this item's products and
//     write its outputs.
//   * dK/dV pass, keys as rows: an item is a 128-key tile of one (b, kv
//     head); K and V stay in shared memory, and the producer streams the
//     visible 64-row query steps of all G q heads of the group (Q and dO by
//     TMA, lse and delta by one warp's plain loads) through a 3-stage ring.
//     At (192, 128) a step is 32 rows: dK and dV of 64 keys then take 96 +
//     64 fp32 registers a thread, and a 64-row step's S^T, dP^T and their
//     bf16 fragments (96 more) would not fit the consumers' 240.
//     S^T = K Q^T and dP^T = V dO^T take both operands K-major as they lie;
//     P^T and dS^T are formed in the accumulators and rounded to bf16 in
//     place as the A fragments of dV += P^T dO and dK += dS^T Q, which read dO
//     and Q MN-major through the descriptor's transpose.
//   * dQ pass, the forward's structure plus one product: an item is a
//     128-row query tile of one (b, q head) with Q and dO resident and lse
//     and delta in registers; K and V stream in 64-key tiles through a
//     3-stage ring; S = Q K^T and dP = dO V^T, then dQ += dS K with K read
//     MN-major (m64n192k16 at Dhk = 192).
//   * One layout for TMA and wgmma (hopper.cuh): 128-byte swizzle (64-byte
//     at Dh = 32, 32-byte at Dh = 16), 1 KiB-aligned tiles, 3-D tensor maps (Dh, S, B*heads), so
//     a tile that overhangs Sq or Sk is zero-filled and never reads the next
//     head's rows. A zero-filled query row (lse = delta = 0) adds exactly 0 to
//     dK and dV, and a zero-filled key row adds 0 to dQ; the causal mask,
//     q_offset and the Sk edge of the dQ pass are masked explicitly.
//   * fp32: no tensor-core path keeps fp32 exact, so both passes run on CUDA
//     cores, 256 threads, 8 to a row.

#include <math.h>

#include "hopper.cuh"           // mbarriers, TMA, wgmma, tensor maps

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;          // (B, H, Sq)
  float* delta;              // (B, H, Sq) scratch
  void* dq;
  void* dk;
  void* dv;
  int B, H, KH, Sq, Sk, q_offset, causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool visible(const Args& a, int qrow, int col) {
  return qrow < a.Sq && col < a.Sk && (!a.causal || col <= a.q_offset + qrow);
}

// The first query row that can see key `k0`, rounded down to a tile of `bq`.
__device__ __forceinline__ int first_q_tile(const Args& a, int k0, int bq) {
  if (!a.causal) return 0;
  return max(0, k0 - a.q_offset) / bq * bq;
}

// Keys [0, end) that some row of query tile [q0, q0 + bq) can see.
__device__ __forceinline__ int kv_end(const Args& a, int q0, int bq) {
  if (!a.causal) return a.Sk;
  return max(0, min(a.Sk, a.q_offset + min(a.Sq, q0 + bq)));
}

// ------------------------------------------------------------ pass 1: delta

// DH is the value head dim, the width of o and dO
template <typename T, int DH>
__global__ void __launch_bounds__(256) flash_bwd_delta(const Args a) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)a.B * a.H * a.Sq) return;
  const T* o = static_cast<const T*>(a.o) + row * DH;
  const T* d = static_cast<const T*>(a.dout) + row * DH;
  float acc = 0.f;
#pragma unroll
  for (int i = lane; i < DH; i += 32) acc = fmaf(to_f32(d[i]), to_f32(o[i]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffff, acc, off);
  if (lane == 0) a.delta[row] = acc;
}

// ------------------------------------------------------------------ fp32

constexpr int F_BN = 32;     // key rows of a tile
constexpr int F_BQ = 32;     // query rows of a tile

// dK and dV of F_BN keys of one (b, kv head); 256 threads, 8 to a key row,
// each holding DHK / 8 columns of its row's dK and DHV / 8 of its dV. Loops
// over both head dims run to the wider, each column guarded: the guards are
// compile-time, and nothing changes, where DHK = DHV.
template <int DHK, int DHV>
__global__ void __launch_bounds__(256) flash_bwd_dkdv_f32(const Args a) {
  constexpr int LDK = DHK + 1, LDV = DHV + 1, LDP = F_BQ + 1;
  constexpr int DW = DHK > DHV ? DHK : DHV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // F_BN x LDK
  float* Vs = Ks + F_BN * LDK;                      // F_BN x LDV
  float* Qs = Vs + F_BN * LDV;                      // F_BQ x LDK
  float* Ds = Qs + F_BQ * LDK;                      // dO, F_BQ x LDV
  float* Ps = Ds + F_BQ * LDV;                      // P^T, F_BN x LDP
  float* Ss = Ps + F_BN * LDP;                      // dS^T, F_BN x LDP
  float* Ls = Ss + F_BN * LDP;                      // lse, F_BQ
  float* Es = Ls + F_BQ;                            // delta, F_BQ

  const int r = threadIdx.x >> 3, sub = threadIdx.x & 7;
  const int n_kt = (a.Sk + F_BN - 1) / F_BN;
  const int kt = blockIdx.x % n_kt, bkv = blockIdx.x / n_kt;   // bkv = b * KH + kv head
  const int b = bkv / a.KH, kvh = bkv % a.KH, G = a.H / a.KH;
  const int k0 = kt * F_BN;
  const float* kg = static_cast<const float*>(a.k) + (size_t)bkv * a.Sk * DHK;
  const float* vg = static_cast<const float*>(a.v) + (size_t)bkv * a.Sk * DHV;

  for (int i = threadIdx.x; i < F_BN * DW; i += 256) {
    const int rr = i / DW, d = i % DW;
    const bool in = k0 + rr < a.Sk;
    if (DHK == DW || d < DHK) Ks[rr * LDK + d] = in ? kg[(size_t)(k0 + rr) * DHK + d] : 0.f;
    if (DHV == DW || d < DHV) Vs[rr * LDV + d] = in ? vg[(size_t)(k0 + rr) * DHV + d] : 0.f;
  }
  float dk[DHK / 8], dv[DHV / 8];
#pragma unroll
  for (int i = 0; i < DW / 8; ++i) {
    if (i < DHK / 8) dk[i] = 0.f;
    if (i < DHV / 8) dv[i] = 0.f;
  }

  for (int g = 0; g < G; ++g) {
    const int bh = b * a.H + kvh * G + g;
    const float* qg = static_cast<const float*>(a.q) + (size_t)bh * a.Sq * DHK;
    const float* dg = static_cast<const float*>(a.dout) + (size_t)bh * a.Sq * DHV;
    for (int q0 = first_q_tile(a, k0, F_BQ); q0 < a.Sq; q0 += F_BQ) {
      __syncthreads();
      for (int i = threadIdx.x; i < F_BQ * DW; i += 256) {
        const int rr = i / DW, d = i % DW;
        const bool in = q0 + rr < a.Sq;
        if (DHK == DW || d < DHK) Qs[rr * LDK + d] = in ? qg[(size_t)(q0 + rr) * DHK + d] : 0.f;
        if (DHV == DW || d < DHV) Ds[rr * LDV + d] = in ? dg[(size_t)(q0 + rr) * DHV + d] : 0.f;
      }
      if (threadIdx.x < F_BQ) {
        const bool in = q0 + threadIdx.x < a.Sq;
        Ls[threadIdx.x] = in ? a.lse[(size_t)bh * a.Sq + q0 + threadIdx.x] : 0.f;
        Es[threadIdx.x] = in ? a.delta[(size_t)bh * a.Sq + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < F_BQ / 8; ++j) {
        const int c = sub + 8 * j;
        float s = 0.f, dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < DW; ++d) {
          if (DHK == DW || d < DHK) s = fmaf(Ks[r * LDK + d], Qs[c * LDK + d], s);
          if (DHV == DW || d < DHV) dp = fmaf(Vs[r * LDV + d], Ds[c * LDV + d], dp);
        }
        const float p = visible(a, q0 + c, k0 + r) ? expf(s * a.scale - Ls[c]) : 0.f;
        Ps[r * LDP + c] = p;
        Ss[r * LDP + c] = p * (dp - Es[c]);
      }
      __syncwarp();                         // a key row's 8 threads share a warp
#pragma unroll 4
      for (int c = 0; c < F_BQ; ++c) {
        const float p = Ps[r * LDP + c], ds = Ss[r * LDP + c];
#pragma unroll
        for (int i = 0; i < DW / 8; ++i) {
          if (i < DHV / 8) dv[i] = fmaf(p, Ds[c * LDV + sub + 8 * i], dv[i]);
          if (i < DHK / 8) dk[i] = fmaf(ds, Qs[c * LDK + sub + 8 * i], dk[i]);
        }
      }
    }
  }
  if (k0 + r < a.Sk) {
    float* dkg = static_cast<float*>(a.dk) + ((size_t)bkv * a.Sk + k0 + r) * DHK;
    float* dvg = static_cast<float*>(a.dv) + ((size_t)bkv * a.Sk + k0 + r) * DHV;
#pragma unroll
    for (int i = 0; i < DW / 8; ++i) {
      if (i < DHK / 8) dkg[sub + 8 * i] = dk[i] * a.scale;
      if (i < DHV / 8) dvg[sub + 8 * i] = dv[i];
    }
  }
}

// dQ of F_BQ query rows of one (b, q head); 256 threads, 8 to a row. Loops
// over both head dims as in flash_bwd_dkdv_f32.
template <int DHK, int DHV>
__global__ void __launch_bounds__(256) flash_bwd_dq_f32(const Args a) {
  constexpr int LDK = DHK + 1, LDV = DHV + 1, LDS = F_BN + 1;
  constexpr int DW = DHK > DHV ? DHK : DHV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // F_BQ x LDK
  float* Ds = Qs + F_BQ * LDK;                      // dO, F_BQ x LDV
  float* Ks = Ds + F_BQ * LDV;                      // F_BN x LDK
  float* Vs = Ks + F_BN * LDK;                      // F_BN x LDV
  float* Ss = Vs + F_BN * LDV;                      // dS, F_BQ x LDS

  const int r = threadIdx.x >> 3, sub = threadIdx.x & 7;
  const int n_qt = (a.Sq + F_BQ - 1) / F_BQ;
  const int qt = blockIdx.x % n_qt, bh = blockIdx.x / n_qt;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = qt * F_BQ;
  const size_t kv_slab = (size_t)b * a.KH + h / (a.H / a.KH);
  const float* qg = static_cast<const float*>(a.q) + (size_t)bh * a.Sq * DHK;
  const float* dg = static_cast<const float*>(a.dout) + (size_t)bh * a.Sq * DHV;
  const float* kg = static_cast<const float*>(a.k) + kv_slab * a.Sk * DHK;
  const float* vg = static_cast<const float*>(a.v) + kv_slab * a.Sk * DHV;

  for (int i = threadIdx.x; i < F_BQ * DW; i += 256) {
    const int rr = i / DW, d = i % DW;
    const bool in = q0 + rr < a.Sq;
    if (DHK == DW || d < DHK) Qs[rr * LDK + d] = in ? qg[(size_t)(q0 + rr) * DHK + d] : 0.f;
    if (DHV == DW || d < DHV) Ds[rr * LDV + d] = in ? dg[(size_t)(q0 + rr) * DHV + d] : 0.f;
  }
  const bool row_in = q0 + r < a.Sq;
  const float lse = row_in ? a.lse[(size_t)bh * a.Sq + q0 + r] : 0.f;
  const float delta = row_in ? a.delta[(size_t)bh * a.Sq + q0 + r] : 0.f;
  float dq[DHK / 8];
#pragma unroll
  for (int i = 0; i < DHK / 8; ++i) dq[i] = 0.f;

  const int end = kv_end(a, q0, F_BQ);
  for (int k0 = 0; k0 < end; k0 += F_BN) {
    __syncthreads();
    for (int i = threadIdx.x; i < F_BN * DW; i += 256) {
      const int rr = i / DW, d = i % DW;
      const bool in = k0 + rr < a.Sk;
      if (DHK == DW || d < DHK) Ks[rr * LDK + d] = in ? kg[(size_t)(k0 + rr) * DHK + d] : 0.f;
      if (DHV == DW || d < DHV) Vs[rr * LDV + d] = in ? vg[(size_t)(k0 + rr) * DHV + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < F_BN / 8; ++j) {
      const int c = sub + 8 * j;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < DW; ++d) {
        if (DHK == DW || d < DHK) s = fmaf(Qs[r * LDK + d], Ks[c * LDK + d], s);
        if (DHV == DW || d < DHV) dp = fmaf(Ds[r * LDV + d], Vs[c * LDV + d], dp);
      }
      const float p = visible(a, q0 + r, k0 + c) ? expf(s * a.scale - lse) : 0.f;
      Ss[r * LDS + c] = p * (dp - delta);
    }
    __syncwarp();                           // a row's 8 threads share a warp
#pragma unroll 4
    for (int c = 0; c < F_BN; ++c) {
      const float ds = Ss[r * LDS + c];
#pragma unroll
      for (int i = 0; i < DHK / 8; ++i) dq[i] = fmaf(ds, Ks[c * LDK + sub + 8 * i], dq[i]);
    }
  }
  if (row_in) {
    float* dqg = static_cast<float*>(a.dq) + ((size_t)bh * a.Sq + q0 + r) * DHK;
#pragma unroll
    for (int i = 0; i < DHK / 8; ++i) dqg[sub + 8 * i] = dq[i] * a.scale;
  }
}

// ------------------------------------------------------------------ bf16
//
// Two passes, each a persistent kernel of three warpgroups: a producer
// (setmaxnreg down to PRODUCER_REGS) whose first warp loads tiles by TMA into
// mbarrier rings, and two consumers of 64 rows each (up to CONSUMER_REGS)
// that run every product on wgmma. Tiles land 128-byte swizzled (64-byte at
// Dh = 32, 32-byte at Dh = 16) through 3-D tensor maps (Dh, S, B*heads), so a box that overhangs
// Sq or Sk is zero-filled and never reads the next head's rows; the masks
// decide what counts. The fp32 accumulator of a product is the A-fragment
// layout of the next one, so P and dS are rounded to bf16 in registers and
// never touch shared memory; the second operand of dV += P^T dO, dK += dS^T Q
// and dQ += dS K is read MN-major through the descriptor's transpose.

constexpr int THREADS = 3 * WG;
constexpr int PRODUCER_REGS = 24;   // setmaxnreg: 128 x 24 + 256 x 240 <= 64K
constexpr int CONSUMER_REGS = 240;

// dK/dV pass: an item is (b, kv head, BK-key tile); each consumer holds the
// dK and dV of its 64 keys in registers and steps over BQ query rows at a
// time through every q head of the group. The producer streams each step's
// Q and dO tiles by TMA, and its lse (times log2 e) and delta rows by plain
// loads, into a ring of STAGES stages; the key tile's K and V stay resident.
// Q and K tiles are DHK wide, V and dO tiles DHV.
template <int DHK, int DHV>
struct KvTile {
  static constexpr int SWK = Swizzle<DHK>::SW, ATOMK = Swizzle<DHK>::ATOM;   // Q and K
  static constexpr int SWV = Swizzle<DHV>::SW, ATOMV = Swizzle<DHV>::ATOM;   // V and dO
  static constexpr int BK = 128;                 // keys of an item: two consumers of 64
  // query rows of a step: 64, or 32 where dK and dV of 64 keys hold more
  // than 128 fp32 registers a thread ((192, 128): 160), so that S^T, dP^T
  // and their bf16 fragments still fit beside them
  static constexpr int BQ = DHK + DHV > 256 ? 32 : 64;
  static constexpr int STAGES = 3;               // Q/dO ring depth
  static constexpr int K_BYTES = BK * DHK * 2;   // the K tile
  static constexpr int V_BYTES = BK * DHV * 2;   // the V tile
  static constexpr int Q_BYTES = BQ * DHK * 2;   // one Q tile
  static constexpr int DO_BYTES = BQ * DHV * 2;  // one dO tile
  static constexpr int ROWS = 2 * BQ;            // floats of a stage: lse * log2(e), delta
  // barriers (256 bytes) and the rows, then 1 KiB-aligned tiles
  static constexpr int HEAD = 1024 * ((256 + STAGES * ROWS * 4 + 1023) / 1024);
  static constexpr int SMEM = 1024 + HEAD + K_BYTES + V_BYTES + STAGES * (Q_BYTES + DO_BYTES);
  static_assert(SMEM <= 232448, "over the 227 KiB a CTA may use");
  static_assert(BQ % 32 == 0, "a producer lane loads rows lane + 32 i of a step");
};

// dQ pass: an item is (b, q head, BM-row tile), heaviest causal tile first;
// Q and dO stay resident, each consumer holds the dQ of its 64 rows, and the
// producer streams K and V in BN-key tiles through a ring of STAGES stages.
template <int DHK, int DHV>
struct QTile {
  static constexpr int SWK = Swizzle<DHK>::SW, ATOMK = Swizzle<DHK>::ATOM;   // Q and K
  static constexpr int SWV = Swizzle<DHV>::SW, ATOMV = Swizzle<DHV>::ATOM;   // V and dO
  static constexpr int BM = 128;                 // q rows of an item: two consumers of 64
  static constexpr int BN = 64;                  // keys of a step
  static constexpr int STAGES = 3;               // K/V ring depth
  static constexpr int Q_BYTES = BM * DHK * 2;   // the Q tile
  static constexpr int DO_BYTES = BM * DHV * 2;  // the dO tile
  static constexpr int K_BYTES = BN * DHK * 2;   // one K tile
  static constexpr int V_BYTES = BN * DHV * 2;   // one V tile
  static constexpr int HEAD = 1024;              // barriers, then 1 KiB-aligned tiles
  static constexpr int SMEM = 1024 + HEAD + Q_BYTES + DO_BYTES + STAGES * (K_BYTES + V_BYTES);
  static_assert(SMEM <= 232448, "over the 227 KiB a CTA may use");
};

template <int DHK, int DHV>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const Args a) {
  using T = KvTile<DHK, DHV>;
  constexpr int BK = T::BK, BQ = T::BQ, STAGES = T::STAGES;
  constexpr int SWK = T::SWK, ATOMK = T::ATOMK, SWV = T::SWV, ATOMV = T::ATOMV;
  // column blocks of the wider tile: one loop issues both tiles' boxes
  constexpr int NCK = DHK / ATOMK, NCV = DHV / ATOMV, NC = NCK > NCV ? NCK : NCV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 1 KiB alignment: the swizzle pattern repeats every 1024 (512, 256)
  // bytes, and TMA and wgmma agree on it only from such a boundary
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  const uint32_t bar_kv = base;                         // K and V landed
  const uint32_t bar_kve = base + 8;                    // K and V free
  const uint32_t bar_f = base + 16;                     // [STAGES] step landed
  const uint32_t bar_e = bar_f + 8 * STAGES;            // [STAGES] stage free
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + 256);  // [STAGES][ROWS]
  const uint32_t sk = base + T::HEAD;                   // K: NCK blocks of BK x SWK bytes
  const uint32_t sv = sk + T::K_BYTES;                  // V: NCV blocks of BK x SWV bytes
  const uint32_t sq = sv + T::V_BYTES;                  // Q stages, BQ x SWK-byte blocks
  const uint32_t sdo = sq + STAGES * T::Q_BYTES;        // dO stages, BQ x SWV-byte blocks

  const int G = a.H / a.KH, BKV = a.B * a.KH;
  const int n_items = (a.Sk + BK - 1) / BK * BKV;       // key tile 0 first: the heaviest
  // the first query tile with a row that sees some key of [k0, k0 + BK)
  auto q_first = [&](int k0) { return a.causal ? max(0, k0 - a.q_offset) / BQ * BQ : 0; };

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_kve, 2 * WG / 32);                    // every consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_f + 8 * s, 1);
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
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int t = 0;
      for (int r = 0, i; (i = zigzag_item(r, n_items)) >= 0; ++r) {
        const int bkv = i % BKV, k0 = i / BKV * BK;
        mbar_wait(bar_kve, (r & 1) ^ 1);                // round 0 passes
        if (lane == 0) {
          mbar_expect_tx(bar_kv, T::K_BYTES + T::V_BYTES);
          for (int c = 0; c < NC; ++c) {
            if (c < NCK) tma_load_3d(sk + c * BK * SWK, &tm_k, c * ATOMK, k0, bkv, bar_kv);
            if (c < NCV) tma_load_3d(sv + c * BK * SWV, &tm_v, c * ATOMV, k0, bkv, bar_kv);
          }
        }
        for (int g = 0; g < G; ++g) {
          const int bh = (bkv / a.KH) * a.H + (bkv % a.KH) * G + g;
          const float* lse = a.lse + (size_t)bh * a.Sq;
          const float* dl = a.delta + (size_t)bh * a.Sq;
          for (int q0 = q_first(k0); q0 < a.Sq; q0 += BQ, ++t) {
            const int s = t % STAGES;
            // rows past Sq get lse = delta = 0: their Q and dO are zero-filled,
            // so they add exactly 0 to dK and dV
            float l[BQ / 32], d[BQ / 32];
#pragma unroll
            for (int i = 0; i < BQ / 32; ++i) {
              const int ri = q0 + lane + 32 * i;
              l[i] = ri < a.Sq ? lse[ri] * LOG2E : 0.f;
            }
#pragma unroll
            for (int i = 0; i < BQ / 32; ++i) {
              const int ri = q0 + lane + 32 * i;
              d[i] = ri < a.Sq ? dl[ri] : 0.f;
            }
            mbar_wait(bar_e + 8 * s, ((t / STAGES) & 1) ^ 1);
            float* row = rows + s * T::ROWS;
#pragma unroll
            for (int i = 0; i < BQ / 32; ++i) row[lane + 32 * i] = l[i];
#pragma unroll
            for (int i = 0; i < BQ / 32; ++i) row[BQ + lane + 32 * i] = d[i];
            __syncwarp();                               // the rows before lane 0's arrive
            if (lane == 0) {
              mbar_expect_tx(bar_f + 8 * s, T::Q_BYTES + T::DO_BYTES);
              for (int c = 0; c < NC; ++c) {
                if (c < NCK)
                  tma_load_3d(sq + s * T::Q_BYTES + c * BQ * SWK, &tm_q, c * ATOMK, q0, bh,
                              bar_f + 8 * s);
                if (c < NCV)
                  tma_load_3d(sdo + s * T::DO_BYTES + c * BQ * SWV, &tm_do, c * ATOMV, q0, bh,
                              bar_f + 8 * s);
              }
            }
          }
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int w = wg - 1;                               // which 64 keys
    const int tid = threadIdx.x % WG, lane = tid & 31;
    const int r0 = w * 64 + (tid >> 5) * 16 + (lane >> 2);   // key rows r0, r0 + 8
    const int t2 = 2 * (lane & 3);                      // column pair in a block of 8
    const float scale_log2 = a.scale * LOG2E;
    auto release = [&](uint32_t bar) { mbar_arrive_if(bar, lane == 0); };

    float dk[DHK / 2], dv[DHV / 2];
    float s[BQ / 2], dp[BQ / 2];                        // S^T, then P^T; dP^T, then dS^T
    uint32_t pf[BQ / 16][4], df[BQ / 16][4];            // P^T and dS^T in bf16
    int t = 0;
    for (int r = 0, i; (i = zigzag_item(r, n_items)) >= 0; ++r) {
      const int bkv = i % BKV, k0 = i / BKV * BK;
      const int key[2] = {k0 + r0, k0 + r0 + 8};
      const int key_last = k0 + w * 64 + 63;            // this consumer's last key
#pragma unroll
      for (int n = 0; n < DHK / 2; ++n) dk[n] = 0.f;
#pragma unroll
      for (int n = 0; n < DHV / 2; ++n) dv[n] = 0.f;
      mbar_wait(bar_kv, r & 1);
      for (int g = 0; g < G; ++g) {
        for (int q0 = q_first(k0); q0 < a.Sq; q0 += BQ, ++t) {
          const int st = t % STAGES;
          const uint32_t q_t = sq + st * T::Q_BYTES, do_t = sdo + st * T::DO_BYTES;
          const float* row = rows + st * T::ROWS;
          mbar_wait(bar_f + 8 * st, (t / STAGES) & 1);
          // S^T = K Q^T and dP^T = V dO^T, both operands K-major as they lie
          wgmma_fence();
          wgmma_ss_kmajor<BQ, true>(s, desc_kmajor<DHK>(sk, BK, 64 * w, 0),
                                    desc_kmajor<DHK>(q_t, BQ, 0, 0));
#pragma unroll
          for (int kk = 1; kk < DHK / 16; ++kk)
            wgmma_ss_kmajor<BQ, false>(s, desc_kmajor<DHK>(sk, BK, 64 * w, kk),
                                       desc_kmajor<DHK>(q_t, BQ, 0, kk));
          wgmma_commit();
          wgmma_ss_kmajor<BQ, true>(dp, desc_kmajor<DHV>(sv, BK, 64 * w, 0),
                                    desc_kmajor<DHV>(do_t, BQ, 0, 0));
#pragma unroll
          for (int kk = 1; kk < DHV / 16; ++kk)
            wgmma_ss_kmajor<BQ, false>(dp, desc_kmajor<DHV>(sv, BK, 64 * w, kk),
                                       desc_kmajor<DHV>(do_t, BQ, 0, kk));
          wgmma_commit();
          // P^T = exp2(S^T scale log2 e - lse log2 e), while dP^T is on the
          // tensor cores; masked only where some query precedes some key
          const bool masked = a.causal && a.q_offset + q0 < key_last;
          wgmma_wait<1>();
          pin(s);
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
            const float2 l = *reinterpret_cast<const float2*>(row + 8 * j + t2);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = ex2(fmaf(s[4 * j + e], scale_log2, -((e & 1) ? l.y : l.x)));
              const int qpos = a.q_offset + q0 + 8 * j + t2 + (e & 1);
              s[4 * j + e] = masked && key[e >> 1] > qpos ? 0.f : p;
            }
          }
          wgmma_wait<0>();
          pin(dp);
          // dS^T = P^T o (dP^T - delta)
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
            const float2 d = *reinterpret_cast<const float2*>(row + BQ + 8 * j + t2);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d.y : d.x));
          }
          to_fragments<BQ>(s, pf);
          to_fragments<BQ>(dp, df);
          // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            wgmma_rs<DHV>(dv, pf[kk], desc_mnmajor<DHV>(do_t, BQ, kk));
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            wgmma_rs<DHK>(dk, df[kk], desc_mnmajor<DHK>(q_t, BQ, kk));
          wgmma_commit();
          wgmma_wait<0>();
          pin(dv);
          pin(dk);
          pin(pf);
          pin(df);
          release(bar_e + 8 * st);
        }
      }
      release(bar_kve);                                 // K and V read for the last time
      __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(a.dk) + (size_t)bkv * a.Sk * DHK;
      __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(a.dv) + (size_t)bkv * a.Sk * DHV;
      constexpr int DW = DHK > DHV ? DHK : DHV;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (key[h] >= a.Sk) continue;
#pragma unroll
        for (int n = 0; n < DW / 8; ++n) {
          if (n < DHK / 8)
            *reinterpret_cast<uint32_t*>(dkg + (size_t)key[h] * DHK + 8 * n + t2) =
                pack_bf16(dk[4 * n + 2 * h] * a.scale, dk[4 * n + 2 * h + 1] * a.scale);
          if (n < DHV / 8)
            *reinterpret_cast<uint32_t*>(dvg + (size_t)key[h] * DHV + 8 * n + t2) =
                pack_bf16(dv[4 * n + 2 * h], dv[4 * n + 2 * h + 1]);
        }
      }
    }
  }
}

template <int DHK, int DHV>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const Args a) {
  using T = QTile<DHK, DHV>;
  constexpr int BM = T::BM, BN = T::BN, STAGES = T::STAGES;
  constexpr int SWK = T::SWK, ATOMK = T::ATOMK, SWV = T::SWV, ATOMV = T::ATOMV;
  constexpr int NCK = DHK / ATOMK, NCV = DHV / ATOMV, NC = NCK > NCV ? NCK : NCV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q = base;                          // Q and dO landed
  const uint32_t bar_qe = base + 8;                     // Q and dO free
  const uint32_t bar_f = base + 16;                     // [STAGES] K and V landed
  const uint32_t bar_e = bar_f + 8 * STAGES;            // [STAGES] stage free
  const uint32_t sq = base + T::HEAD;                   // Q: NCK blocks of BM x SWK bytes
  const uint32_t sdo = sq + T::Q_BYTES;                 // dO: NCV blocks of BM x SWV bytes
  const uint32_t sk = sdo + T::DO_BYTES;                // K stages, BN x SWK-byte blocks
  const uint32_t sv = sk + STAGES * T::K_BYTES;         // V stages, BN x SWV-byte blocks

  const int Sq = a.Sq, Sk = a.Sk, q_offset = a.q_offset, causal = a.causal;
  const int BH = a.B * a.H, n_qt = (Sq + BM - 1) / BM, n_items = n_qt * BH;
  // keys that some row of [q0, q_end) can see: [0, extent)
  auto extent = [&](int q_end) {
    if (!causal) return Sk;
    return max(0, min(Sk, q_offset + min(Sq, q_end)));
  };
  // item i: every head of a q tile before the next, the last (heaviest) tile first
  auto item_q0 = [&](int i) { return (n_qt - 1 - i / BH) * BM; };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_qe, 2 * WG / 32);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_f + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 2 * WG / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffff, static_cast<int>(threadIdx.x) / WG, 0);
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int t = 0;
      for (int r = 0, i; (i = zigzag_item(r, n_items)) >= 0; ++r) {
        const int bh = i % BH, q0 = item_q0(i);
        const int h = bh % a.H;
        const int kv_slab = (bh / a.H) * a.KH + h / (a.H / a.KH);
        mbar_wait(bar_qe, (r & 1) ^ 1);                 // round 0 passes
        mbar_expect_tx(bar_q, T::Q_BYTES + T::DO_BYTES);
        for (int c = 0; c < NC; ++c) {
          if (c < NCK) tma_load_3d(sq + c * BM * SWK, &tm_q, c * ATOMK, q0, bh, bar_q);
          if (c < NCV) tma_load_3d(sdo + c * BM * SWV, &tm_do, c * ATOMV, q0, bh, bar_q);
        }
        const int n_tiles = (extent(q0 + BM) + BN - 1) / BN;
        for (int j = 0; j < n_tiles; ++j, ++t) {
          const int s = t % STAGES;
          mbar_wait(bar_e + 8 * s, ((t / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_f + 8 * s, T::K_BYTES + T::V_BYTES);
          for (int c = 0; c < NC; ++c) {
            if (c < NCK)
              tma_load_3d(sk + s * T::K_BYTES + c * BN * SWK, &tm_k, c * ATOMK, j * BN, kv_slab,
                          bar_f + 8 * s);
            if (c < NCV)
              tma_load_3d(sv + s * T::V_BYTES + c * BN * SWV, &tm_v, c * ATOMV, j * BN, kv_slab,
                          bar_f + 8 * s);
          }
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int w = wg - 1;                               // which 64 rows
    const int tid = threadIdx.x % WG, lane = tid & 31;
    const int r0 = w * 64 + (tid >> 5) * 16 + (lane >> 2);   // rows r0, r0 + 8
    const int t2 = 2 * (lane & 3);
    const float scale_log2 = a.scale * LOG2E;
    auto release = [&](uint32_t bar) { mbar_arrive_if(bar, lane == 0); };

    float dq[DHK / 2];
    float s[BN / 2], dp[BN / 2];                        // S, then P; dP, then dS
    uint32_t df[BN / 16][4];                            // dS in bf16
    int t = 0;
    for (int r = 0, i; (i = zigzag_item(r, n_items)) >= 0; ++r) {
      const int bh = i % BH, q0 = item_q0(i);
      float lse2[2], delta[2];
      int qpos[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + r0 + 8 * h;
        lse2[h] = row < Sq ? a.lse[(size_t)bh * Sq + row] * LOG2E : 0.f;
        delta[h] = row < Sq ? a.delta[(size_t)bh * Sq + row] : 0.f;
        qpos[h] = q_offset + row;
      }
#pragma unroll
      for (int n = 0; n < DHK / 2; ++n) dq[n] = 0.f;
      const int n_tiles = (extent(q0 + BM) + BN - 1) / BN;
      // this consumer's tiles (n_mine >= 1 as Sk >= 1), and of them the
      // leading ones that need no mask
      const int n_mine = (extent(q0 + 64 * (w + 1)) + BN - 1) / BN;
      const int first = q_offset + q0 + 64 * w;         // the smallest q position
      const int n_open = min(n_mine, (causal ? max(0, min(Sk, first + 1)) : Sk) / BN);
      mbar_wait(bar_q, r & 1);
      for (int j = 0; j < n_mine; ++j) {
        const int st = (t + j) % STAGES;
        const uint32_t k_t = sk + st * T::K_BYTES, v_t = sv + st * T::V_BYTES;
        mbar_wait(bar_f + 8 * st, ((t + j) / STAGES) & 1);
        // S = Q K^T and dP = dO V^T, both operands K-major as they lie
        wgmma_fence();
        wgmma_ss_n64<true>(s, desc_kmajor<DHK>(sq, BM, 64 * w, 0), desc_kmajor<DHK>(k_t, BN, 0, 0));
#pragma unroll
        for (int kk = 1; kk < DHK / 16; ++kk)
          wgmma_ss_n64<false>(s, desc_kmajor<DHK>(sq, BM, 64 * w, kk),
                              desc_kmajor<DHK>(k_t, BN, 0, kk));
        wgmma_commit();
        wgmma_ss_n64<true>(dp, desc_kmajor<DHV>(sdo, BM, 64 * w, 0),
                           desc_kmajor<DHV>(v_t, BN, 0, 0));
#pragma unroll
        for (int kk = 1; kk < DHV / 16; ++kk)
          wgmma_ss_n64<false>(dp, desc_kmajor<DHV>(sdo, BM, 64 * w, kk),
                              desc_kmajor<DHV>(v_t, BN, 0, kk));
        wgmma_commit();
        wgmma_wait<1>();
        pin(s);
        const bool masked = j >= n_open;
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[4 * jj + e], scale_log2, -lse2[e >> 1]));
            const int col = j * BN + 8 * jj + t2 + (e & 1);
            s[4 * jj + e] =
                masked && (col >= Sk || (causal && col > qpos[e >> 1])) ? 0.f : p;
          }
        }
        wgmma_wait<0>();
        pin(dp);
        if (j == n_mine - 1) release(bar_qe);           // Q and dO read for the last time
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * jj + e] = s[4 * jj + e] * (dp[4 * jj + e] - delta[e >> 1]);
        to_fragments<BN>(dp, df);
        // dQ += dS K, K read MN-major
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<DHK>(dq, df[kk], desc_mnmajor<DHK>(k_t, BN, kk));
        wgmma_commit();
        wgmma_wait<0>();
        pin(dq);
        pin(df);
        release(bar_e + 8 * st);
      }
      // a tile that the other consumer's rows see and these do not: free it
      for (int j = n_mine; j < n_tiles; ++j) {
        const int st = (t + j) % STAGES;
        mbar_wait(bar_f + 8 * st, ((t + j) / STAGES) & 1);
        release(bar_e + 8 * st);
      }
      t += n_tiles;
      __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(a.dq) + (size_t)bh * Sq * DHK;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + r0 + 8 * h;
        if (row >= Sq) continue;
#pragma unroll
        for (int n = 0; n < DHK / 8; ++n)
          *reinterpret_cast<uint32_t*>(dqg + (size_t)row * DHK + 8 * n + t2) =
              pack_bf16(dq[4 * n + 2 * h] * a.scale, dq[4 * n + 2 * h + 1] * a.scale);
      }
    }
  }
}

// ------------------------------------------------------------------ launch

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Args& a, long long blocks, int threads, int smem,
                   cudaStream_t stream) {
  if (blocks <= 0) return cudaSuccess;       // nothing to write
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t zero(void* ptr, size_t bytes, cudaStream_t stream) {
  return bytes == 0 ? cudaSuccess : cudaMemsetAsync(ptr, 0, bytes, stream);
}

template <int DHK, int DHV>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  using KV = KvTile<DHK, DHV>;
  using Q = QTile<DHK, DHV>;
  const long long rows = (long long)a.B * a.H * a.Sq;
  cudaError_t e = launch(flash_bwd_delta<__nv_bfloat16, DHV>, a, (rows + 7) / 8, 256, 0, stream);
  if (e != cudaSuccess) return e;
  if (a.B == 0 || a.Sq == 0 || a.Sk == 0) {  // no score at all: every gradient is 0
    const size_t kv = (size_t)a.B * a.KH * a.Sk * 2;
    e = zero(a.dq, (size_t)rows * DHK * 2, stream);
    if (e == cudaSuccess) e = zero(a.dk, kv * DHK, stream);
    if (e == cudaSuccess) e = zero(a.dv, kv * DHV, stream);
    return e;
  }
  const int BH = a.B * a.H, BKV = a.B * a.KH;
  CUtensorMap kv_q, kv_do, kv_k, kv_v, q_q, q_do, q_k, q_v;
  if (!tensor_map<DHK>(&kv_q, a.q, a.Sq, BH, KV::BQ) ||
      !tensor_map<DHV>(&kv_do, a.dout, a.Sq, BH, KV::BQ) ||
      !tensor_map<DHK>(&kv_k, a.k, a.Sk, BKV, KV::BK) ||
      !tensor_map<DHV>(&kv_v, a.v, a.Sk, BKV, KV::BK) ||
      !tensor_map<DHK>(&q_q, a.q, a.Sq, BH, Q::BM) ||
      !tensor_map<DHV>(&q_do, a.dout, a.Sq, BH, Q::BM) ||
      !tensor_map<DHK>(&q_k, a.k, a.Sk, BKV, Q::BN) ||
      !tensor_map<DHV>(&q_v, a.v, a.Sk, BKV, Q::BN))
    return cudaErrorInvalidValue;
  static const cudaError_t set = [] {
    const cudaError_t e1 = cudaFuncSetAttribute(
        flash_bwd_dkdv_bf16<DHK, DHV>, cudaFuncAttributeMaxDynamicSharedMemorySize, KV::SMEM);
    return e1 != cudaSuccess ? e1 : cudaFuncSetAttribute(
        flash_bwd_dq_bf16<DHK, DHV>, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::SMEM);
  }();
  if (set != cudaSuccess) return set;
  int n_sm;
  e = sm_count(&n_sm);
  if (e != cudaSuccess) return e;
  // persistent: at most one CTA an SM, each walking items (zigzag_item)
  const long long kv_items = (long long)BKV * ((a.Sk + KV::BK - 1) / KV::BK);
  const long long q_items = (long long)BH * ((a.Sq + Q::BM - 1) / Q::BM);
  flash_bwd_dkdv_bf16<DHK, DHV><<<(unsigned)(kv_items < n_sm ? kv_items : n_sm), THREADS,
                                  KV::SMEM, stream>>>(kv_q, kv_do, kv_k, kv_v, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_bf16<DHK, DHV><<<(unsigned)(q_items < n_sm ? q_items : n_sm), THREADS,
                                Q::SMEM, stream>>>(q_q, q_do, q_k, q_v, a);
  return cudaGetLastError();
}

template <int DHK, int DHV>
cudaError_t dispatch(const Args& a, int is_bf16, cudaStream_t stream) {
  if (is_bf16) return launch_bf16<DHK, DHV>(a, stream);
  const long long rows = (long long)a.B * a.H * a.Sq;
  constexpr int LDK = DHK + 1, LDV = DHV + 1;
  cudaError_t e = launch(flash_bwd_delta<float, DHV>, a, (rows + 7) / 8, 256, 0, stream);
  if (e == cudaSuccess)
    e = launch(flash_bwd_dkdv_f32<DHK, DHV>, a,
               (long long)a.B * a.KH * ((a.Sk + F_BN - 1) / F_BN), 256,
               (int)(((F_BN + F_BQ) * (LDK + LDV) + 2 * F_BN * (F_BQ + 1) + 2 * F_BQ) *
                     sizeof(float)),
               stream);
  if (e == cudaSuccess)
    e = launch(flash_bwd_dq_f32<DHK, DHV>, a, (long long)a.B * a.H * ((a.Sq + F_BQ - 1) / F_BQ),
               256, (int)(((F_BQ + F_BN) * (LDK + LDV) + F_BQ * (F_BN + 1)) * sizeof(float)),
               stream);
  return e;
}

}  // namespace

// q, dq (B, H, Sq, Dh); dout, o (B, H, Sq, Dhv); k, dk (B, KH, Sk, Dh); v, dv
// (B, KH, Sk, Dhv): contiguous, 16-byte aligned, on the current device, all
// bf16 (is_bf16 = 1) or all fp32; H % KH == 0. lse (B, H, Sq) fp32 from
// flash_attention_fwd; delta (B, H, Sq) fp32 scratch. Launches three kernels
// on `stream` and does not synchronise. Returns the first cudaError_t (0 on
// success); (Dh, Dhv) other than (16, 16), (32, 32), (64, 64), (128, 128)
// and (192, 128) returns cudaErrorInvalidValue.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int B, int H, int KH, int Sq, int Sk,
                                   int Dh, int Dhv, int q_offset, int causal, float scale,
                                   int is_bf16, void* stream) {
  const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KH, Sq, Sk, q_offset, causal,
               scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 192 && Dhv == 128) return dispatch<192, 128>(a, is_bf16, st);
  if (Dh != Dhv) return cudaErrorInvalidValue;
  switch (Dh) {
    case 16: return dispatch<16, 16>(a, is_bf16, st);
    case 32: return dispatch<32, 32>(a, is_bf16, st);
    case 64: return dispatch<64, 64>(a, is_bf16, st);
    case 128: return dispatch<128, 128>(a, is_bf16, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
