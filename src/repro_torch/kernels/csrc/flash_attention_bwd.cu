// GQA flash attention, backward, for Hopper (sm_90a).
//
// The gradient of flash_attention_fwd (flash_attention.cu). It has no TPU
// kernel to replace: the JAX model trains through the XLA online-softmax scan
// of src/repro/models/attention.py:70 under jax.checkpoint (:120), and JAX's
// autodiff of that scan is the reference. With q (B, H, Sq, Dh), k and v
// (B, KH, Sk, Dh), H = KH * G (q head h reads kv head h / G), the forward's
// output o and its row log-sum-exp lse (B, H, Sq), and the output's gradient
// dO, it computes dQ, dK and dV in the inputs' dtype with fp32 sums, for a
// causal mask or none, any q_offset (query row i at position q_offset + i),
// any Sq and Sk, Dh of 32, 64 or 128, bf16 or fp32. The FlashAttention-2
// scheme, in three passes that recompute P = exp(S - lse) tile by tile and
// never hold a score matrix in device memory:
//
//   1. delta: D = rowsum(dO o O), fp32, one warp a row;
//   2. dkdv: one CTA per (b, kv head, key tile) holds its tile's dK and dV
//      in registers and loops over the query tiles of all G q heads of its
//      group that can see the tile: dV += P^T dO, dK += dS^T Q with
//      dS = P o (dO V^T - D), scaled by Dh^-0.5 at the end;
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
// fp32 atomics would do five, but no longer repeat bit for bit.
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
//     S^T = K Q^T and dP^T = V dO^T take both operands K-major as they lie;
//     P^T and dS^T are formed in the accumulators and rounded to bf16 in
//     place as the A fragments of dV += P^T dO and dK += dS^T Q, which read dO
//     and Q MN-major through the descriptor's transpose.
//   * dQ pass, the forward's structure plus one product: an item is a
//     128-row query tile of one (b, q head) with Q and dO resident and lse
//     and delta in registers; K and V stream in 64-key tiles through a
//     3-stage ring; S = Q K^T and dP = dO V^T, then dQ += dS K with K read
//     MN-major.
//   * One layout for TMA and wgmma (hopper.cuh): 128-byte swizzle (64-byte
//     at Dh = 32), 1 KiB-aligned tiles, 3-D tensor maps (Dh, S, B*heads), so
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
// each holding DH / 8 columns of its row's dK and dV.
template <int DH>
__global__ void __launch_bounds__(256) flash_bwd_dkdv_f32(const Args a) {
  constexpr int LD = DH + 1, LDP = F_BQ + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // F_BN x LD
  float* Vs = Ks + F_BN * LD;                       // F_BN x LD
  float* Qs = Vs + F_BN * LD;                       // F_BQ x LD
  float* Ds = Qs + F_BQ * LD;                       // dO, F_BQ x LD
  float* Ps = Ds + F_BQ * LD;                       // P^T, F_BN x LDP
  float* Ss = Ps + F_BN * LDP;                      // dS^T, F_BN x LDP
  float* Ls = Ss + F_BN * LDP;                      // lse, F_BQ
  float* Es = Ls + F_BQ;                            // delta, F_BQ

  const int r = threadIdx.x >> 3, sub = threadIdx.x & 7;
  const int n_kt = (a.Sk + F_BN - 1) / F_BN;
  const int kt = blockIdx.x % n_kt, bkv = blockIdx.x / n_kt;   // bkv = b * KH + kv head
  const int b = bkv / a.KH, kvh = bkv % a.KH, G = a.H / a.KH;
  const int k0 = kt * F_BN;
  const size_t kv_off = (size_t)bkv * a.Sk * DH;
  const float* kg = static_cast<const float*>(a.k) + kv_off;
  const float* vg = static_cast<const float*>(a.v) + kv_off;

  for (int i = threadIdx.x; i < F_BN * DH; i += 256) {
    const int rr = i / DH, d = i % DH;
    const bool in = k0 + rr < a.Sk;
    Ks[rr * LD + d] = in ? kg[(size_t)(k0 + rr) * DH + d] : 0.f;
    Vs[rr * LD + d] = in ? vg[(size_t)(k0 + rr) * DH + d] : 0.f;
  }
  float dk[DH / 8], dv[DH / 8];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) dk[i] = dv[i] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int bh = b * a.H + kvh * G + g;
    const float* qg = static_cast<const float*>(a.q) + (size_t)bh * a.Sq * DH;
    const float* dg = static_cast<const float*>(a.dout) + (size_t)bh * a.Sq * DH;
    for (int q0 = first_q_tile(a, k0, F_BQ); q0 < a.Sq; q0 += F_BQ) {
      __syncthreads();
      for (int i = threadIdx.x; i < F_BQ * DH; i += 256) {
        const int rr = i / DH, d = i % DH;
        const bool in = q0 + rr < a.Sq;
        Qs[rr * LD + d] = in ? qg[(size_t)(q0 + rr) * DH + d] : 0.f;
        Ds[rr * LD + d] = in ? dg[(size_t)(q0 + rr) * DH + d] : 0.f;
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
        for (int d = 0; d < DH; ++d) {
          s = fmaf(Ks[r * LD + d], Qs[c * LD + d], s);
          dp = fmaf(Vs[r * LD + d], Ds[c * LD + d], dp);
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
        for (int i = 0; i < DH / 8; ++i) {
          dv[i] = fmaf(p, Ds[c * LD + sub + 8 * i], dv[i]);
          dk[i] = fmaf(ds, Qs[c * LD + sub + 8 * i], dk[i]);
        }
      }
    }
  }
  if (k0 + r < a.Sk) {
    float* dkg = static_cast<float*>(a.dk) + kv_off + (size_t)(k0 + r) * DH;
    float* dvg = static_cast<float*>(a.dv) + kv_off + (size_t)(k0 + r) * DH;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      dkg[sub + 8 * i] = dk[i] * a.scale;
      dvg[sub + 8 * i] = dv[i];
    }
  }
}

// dQ of F_BQ query rows of one (b, q head); 256 threads, 8 to a row.
template <int DH>
__global__ void __launch_bounds__(256) flash_bwd_dq_f32(const Args a) {
  constexpr int LD = DH + 1, LDS = F_BN + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // F_BQ x LD
  float* Ds = Qs + F_BQ * LD;                       // dO, F_BQ x LD
  float* Ks = Ds + F_BQ * LD;                       // F_BN x LD
  float* Vs = Ks + F_BN * LD;                       // F_BN x LD
  float* Ss = Vs + F_BN * LD;                       // dS, F_BQ x LDS

  const int r = threadIdx.x >> 3, sub = threadIdx.x & 7;
  const int n_qt = (a.Sq + F_BQ - 1) / F_BQ;
  const int qt = blockIdx.x % n_qt, bh = blockIdx.x / n_qt;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = qt * F_BQ;
  const size_t q_off = (size_t)bh * a.Sq * DH;
  const size_t kv_off = ((size_t)b * a.KH + h / (a.H / a.KH)) * a.Sk * DH;
  const float* qg = static_cast<const float*>(a.q) + q_off;
  const float* dg = static_cast<const float*>(a.dout) + q_off;
  const float* kg = static_cast<const float*>(a.k) + kv_off;
  const float* vg = static_cast<const float*>(a.v) + kv_off;

  for (int i = threadIdx.x; i < F_BQ * DH; i += 256) {
    const int rr = i / DH, d = i % DH;
    const bool in = q0 + rr < a.Sq;
    Qs[rr * LD + d] = in ? qg[(size_t)(q0 + rr) * DH + d] : 0.f;
    Ds[rr * LD + d] = in ? dg[(size_t)(q0 + rr) * DH + d] : 0.f;
  }
  const bool row_in = q0 + r < a.Sq;
  const float lse = row_in ? a.lse[(size_t)bh * a.Sq + q0 + r] : 0.f;
  const float delta = row_in ? a.delta[(size_t)bh * a.Sq + q0 + r] : 0.f;
  float dq[DH / 8];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) dq[i] = 0.f;

  const int end = kv_end(a, q0, F_BQ);
  for (int k0 = 0; k0 < end; k0 += F_BN) {
    __syncthreads();
    for (int i = threadIdx.x; i < F_BN * DH; i += 256) {
      const int rr = i / DH, d = i % DH;
      const bool in = k0 + rr < a.Sk;
      Ks[rr * LD + d] = in ? kg[(size_t)(k0 + rr) * DH + d] : 0.f;
      Vs[rr * LD + d] = in ? vg[(size_t)(k0 + rr) * DH + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < F_BN / 8; ++j) {
      const int c = sub + 8 * j;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) {
        s = fmaf(Qs[r * LD + d], Ks[c * LD + d], s);
        dp = fmaf(Ds[r * LD + d], Vs[c * LD + d], dp);
      }
      const float p = visible(a, q0 + r, k0 + c) ? expf(s * a.scale - lse) : 0.f;
      Ss[r * LDS + c] = p * (dp - delta);
    }
    __syncwarp();                           // a row's 8 threads share a warp
#pragma unroll 4
    for (int c = 0; c < F_BN; ++c) {
      const float ds = Ss[r * LDS + c];
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) dq[i] = fmaf(ds, Ks[c * LD + sub + 8 * i], dq[i]);
    }
  }
  if (row_in) {
    float* dqg = static_cast<float*>(a.dq) + q_off + (size_t)(q0 + r) * DH;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) dqg[sub + 8 * i] = dq[i] * a.scale;
  }
}

// ------------------------------------------------------------------ bf16
//
// Two passes, each a persistent kernel of three warpgroups: a producer
// (setmaxnreg down to PRODUCER_REGS) whose first warp loads tiles by TMA into
// mbarrier rings, and two consumers of 64 rows each (up to CONSUMER_REGS)
// that run every product on wgmma. Tiles land 128-byte swizzled (64-byte at
// Dh = 32) through 3-D tensor maps (Dh, S, B*heads), so a box that overhangs
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
template <int DH>
struct KvTile {
  static constexpr int SW = Swizzle<DH>::SW, ATOM = Swizzle<DH>::ATOM;
  static constexpr int BK = 128;                 // keys of an item: two consumers of 64
  static constexpr int BQ = 64;                  // query rows of a step
  static constexpr int STAGES = 3;               // Q/dO ring depth
  static constexpr int K_BYTES = BK * DH * 2;    // one K or V tile
  static constexpr int Q_BYTES = BQ * DH * 2;    // one Q or dO tile
  static constexpr int ROWS = 2 * BQ;            // floats of a stage: lse * log2(e), delta
  // barriers (256 bytes) and the rows, then 1 KiB-aligned tiles
  static constexpr int HEAD = 1024 * ((256 + STAGES * ROWS * 4 + 1023) / 1024);
  static constexpr int SMEM = 1024 + HEAD + 2 * K_BYTES + 2 * STAGES * Q_BYTES;
  static_assert(SMEM <= 232448, "over the 227 KiB a CTA may use");
  static_assert(BQ == 64, "a producer lane loads rows lane and lane + 32 of a step");
};

// dQ pass: an item is (b, q head, BM-row tile), heaviest causal tile first;
// Q and dO stay resident, each consumer holds the dQ of its 64 rows, and the
// producer streams K and V in BN-key tiles through a ring of STAGES stages.
template <int DH>
struct QTile {
  static constexpr int SW = Swizzle<DH>::SW, ATOM = Swizzle<DH>::ATOM;
  static constexpr int BM = 128;                 // q rows of an item: two consumers of 64
  static constexpr int BN = 64;                  // keys of a step
  static constexpr int STAGES = 3;               // K/V ring depth
  static constexpr int Q_BYTES = BM * DH * 2;    // one Q or dO tile
  static constexpr int K_BYTES = BN * DH * 2;    // one K or V tile
  static constexpr int HEAD = 1024;              // barriers, then 1 KiB-aligned tiles
  static constexpr int SMEM = 1024 + HEAD + 2 * Q_BYTES + 2 * STAGES * K_BYTES;
  static_assert(SMEM <= 232448, "over the 227 KiB a CTA may use");
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const Args a) {
  using T = KvTile<DH>;
  constexpr int BK = T::BK, BQ = T::BQ, STAGES = T::STAGES, SW = T::SW, ATOM = T::ATOM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 1 KiB alignment: the swizzle pattern repeats every 1024 (512) bytes, and
  // TMA and wgmma agree on it only from such a boundary
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  const uint32_t bar_kv = base;                         // K and V landed
  const uint32_t bar_kve = base + 8;                    // K and V free
  const uint32_t bar_f = base + 16;                     // [STAGES] step landed
  const uint32_t bar_e = bar_f + 8 * STAGES;            // [STAGES] stage free
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + 256);  // [STAGES][ROWS]
  const uint32_t sk = base + T::HEAD;                   // K: DH/ATOM blocks of BK x SW bytes
  const uint32_t sv = sk + T::K_BYTES;                  // V
  const uint32_t sq = sv + T::K_BYTES;                  // Q stages, BQ x SW-byte blocks
  const uint32_t sdo = sq + STAGES * T::Q_BYTES;        // dO stages

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
          mbar_expect_tx(bar_kv, 2 * T::K_BYTES);
          for (int c = 0; c < DH / ATOM; ++c) {
            tma_load_3d(sk + c * BK * SW, &tm_k, c * ATOM, k0, bkv, bar_kv);
            tma_load_3d(sv + c * BK * SW, &tm_v, c * ATOM, k0, bkv, bar_kv);
          }
        }
        for (int g = 0; g < G; ++g) {
          const int bh = (bkv / a.KH) * a.H + (bkv % a.KH) * G + g;
          const float* lse = a.lse + (size_t)bh * a.Sq;
          const float* dl = a.delta + (size_t)bh * a.Sq;
          for (int q0 = q_first(k0); q0 < a.Sq; q0 += BQ, ++t) {
            const int s = t % STAGES, r0 = q0 + lane, r1 = r0 + 32;
            // rows past Sq get lse = delta = 0: their Q and dO are zero-filled,
            // so they add exactly 0 to dK and dV
            const float l0 = r0 < a.Sq ? lse[r0] * LOG2E : 0.f;
            const float l1 = r1 < a.Sq ? lse[r1] * LOG2E : 0.f;
            const float d0 = r0 < a.Sq ? dl[r0] : 0.f;
            const float d1 = r1 < a.Sq ? dl[r1] : 0.f;
            mbar_wait(bar_e + 8 * s, ((t / STAGES) & 1) ^ 1);
            float* row = rows + s * T::ROWS;
            row[lane] = l0;
            row[lane + 32] = l1;
            row[BQ + lane] = d0;
            row[BQ + lane + 32] = d1;
            __syncwarp();                               // the rows before lane 0's arrive
            if (lane == 0) {
              mbar_expect_tx(bar_f + 8 * s, 2 * T::Q_BYTES);
              for (int c = 0; c < DH / ATOM; ++c) {
                tma_load_3d(sq + s * T::Q_BYTES + c * BQ * SW, &tm_q, c * ATOM, q0, bh,
                            bar_f + 8 * s);
                tma_load_3d(sdo + s * T::Q_BYTES + c * BQ * SW, &tm_do, c * ATOM, q0, bh,
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

    float dk[DH / 2], dv[DH / 2];
    float s[BQ / 2], dp[BQ / 2];                        // S^T, then P^T; dP^T, then dS^T
    uint32_t pf[BQ / 16][4], df[BQ / 16][4];            // P^T and dS^T in bf16
    int t = 0;
    for (int r = 0, i; (i = zigzag_item(r, n_items)) >= 0; ++r) {
      const int bkv = i % BKV, k0 = i / BKV * BK;
      const int key[2] = {k0 + r0, k0 + r0 + 8};
      const int key_last = k0 + w * 64 + 63;            // this consumer's last key
#pragma unroll
      for (int n = 0; n < DH / 2; ++n) dk[n] = dv[n] = 0.f;
      mbar_wait(bar_kv, r & 1);
      for (int g = 0; g < G; ++g) {
        for (int q0 = q_first(k0); q0 < a.Sq; q0 += BQ, ++t) {
          const int st = t % STAGES;
          const uint32_t q_t = sq + st * T::Q_BYTES, do_t = sdo + st * T::Q_BYTES;
          const float* row = rows + st * T::ROWS;
          mbar_wait(bar_f + 8 * st, (t / STAGES) & 1);
          // S^T = K Q^T and dP^T = V dO^T, both operands K-major as they lie
          wgmma_fence();
          wgmma_ss_n64<true>(s, desc_kmajor<DH>(sk, BK, 64 * w, 0), desc_kmajor<DH>(q_t, BQ, 0, 0));
#pragma unroll
          for (int kk = 1; kk < DH / 16; ++kk)
            wgmma_ss_n64<false>(s, desc_kmajor<DH>(sk, BK, 64 * w, kk),
                                desc_kmajor<DH>(q_t, BQ, 0, kk));
          wgmma_commit();
          wgmma_ss_n64<true>(dp, desc_kmajor<DH>(sv, BK, 64 * w, 0),
                             desc_kmajor<DH>(do_t, BQ, 0, 0));
#pragma unroll
          for (int kk = 1; kk < DH / 16; ++kk)
            wgmma_ss_n64<false>(dp, desc_kmajor<DH>(sv, BK, 64 * w, kk),
                                desc_kmajor<DH>(do_t, BQ, 0, kk));
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
            wgmma_rs<DH>(dv, pf[kk], desc_mnmajor<DH>(do_t, BQ, kk));
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            wgmma_rs<DH>(dk, df[kk], desc_mnmajor<DH>(q_t, BQ, kk));
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
      __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(a.dk) + (size_t)bkv * a.Sk * DH;
      __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(a.dv) + (size_t)bkv * a.Sk * DH;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (key[h] >= a.Sk) continue;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          const size_t at = (size_t)key[h] * DH + 8 * n + t2;
          *reinterpret_cast<uint32_t*>(dkg + at) =
              pack_bf16(dk[4 * n + 2 * h] * a.scale, dk[4 * n + 2 * h + 1] * a.scale);
          *reinterpret_cast<uint32_t*>(dvg + at) = pack_bf16(dv[4 * n + 2 * h], dv[4 * n + 2 * h + 1]);
        }
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const Args a) {
  using T = QTile<DH>;
  constexpr int BM = T::BM, BN = T::BN, STAGES = T::STAGES, SW = T::SW, ATOM = T::ATOM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q = base;                          // Q and dO landed
  const uint32_t bar_qe = base + 8;                     // Q and dO free
  const uint32_t bar_f = base + 16;                     // [STAGES] K and V landed
  const uint32_t bar_e = bar_f + 8 * STAGES;            // [STAGES] stage free
  const uint32_t sq = base + T::HEAD;                   // Q: DH/ATOM blocks of BM x SW bytes
  const uint32_t sdo = sq + T::Q_BYTES;                 // dO
  const uint32_t sk = sdo + T::Q_BYTES;                 // K stages, BN x SW-byte blocks
  const uint32_t sv = sk + STAGES * T::K_BYTES;         // V stages

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
        mbar_expect_tx(bar_q, 2 * T::Q_BYTES);
        for (int c = 0; c < DH / ATOM; ++c) {
          tma_load_3d(sq + c * BM * SW, &tm_q, c * ATOM, q0, bh, bar_q);
          tma_load_3d(sdo + c * BM * SW, &tm_do, c * ATOM, q0, bh, bar_q);
        }
        const int n_tiles = (extent(q0 + BM) + BN - 1) / BN;
        for (int j = 0; j < n_tiles; ++j, ++t) {
          const int s = t % STAGES;
          mbar_wait(bar_e + 8 * s, ((t / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_f + 8 * s, 2 * T::K_BYTES);
          for (int c = 0; c < DH / ATOM; ++c) {
            tma_load_3d(sk + s * T::K_BYTES + c * BN * SW, &tm_k, c * ATOM, j * BN, kv_slab,
                        bar_f + 8 * s);
            tma_load_3d(sv + s * T::K_BYTES + c * BN * SW, &tm_v, c * ATOM, j * BN, kv_slab,
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

    float dq[DH / 2];
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
      for (int n = 0; n < DH / 2; ++n) dq[n] = 0.f;
      const int n_tiles = (extent(q0 + BM) + BN - 1) / BN;
      // this consumer's tiles (n_mine >= 1 as Sk >= 1), and of them the
      // leading ones that need no mask
      const int n_mine = (extent(q0 + 64 * (w + 1)) + BN - 1) / BN;
      const int first = q_offset + q0 + 64 * w;         // the smallest q position
      const int n_open = min(n_mine, (causal ? max(0, min(Sk, first + 1)) : Sk) / BN);
      mbar_wait(bar_q, r & 1);
      for (int j = 0; j < n_mine; ++j) {
        const int st = (t + j) % STAGES;
        const uint32_t k_t = sk + st * T::K_BYTES, v_t = sv + st * T::K_BYTES;
        mbar_wait(bar_f + 8 * st, ((t + j) / STAGES) & 1);
        // S = Q K^T and dP = dO V^T, both operands K-major as they lie
        wgmma_fence();
        wgmma_ss_n64<true>(s, desc_kmajor<DH>(sq, BM, 64 * w, 0), desc_kmajor<DH>(k_t, BN, 0, 0));
#pragma unroll
        for (int kk = 1; kk < DH / 16; ++kk)
          wgmma_ss_n64<false>(s, desc_kmajor<DH>(sq, BM, 64 * w, kk),
                              desc_kmajor<DH>(k_t, BN, 0, kk));
        wgmma_commit();
        wgmma_ss_n64<true>(dp, desc_kmajor<DH>(sdo, BM, 64 * w, 0), desc_kmajor<DH>(v_t, BN, 0, 0));
#pragma unroll
        for (int kk = 1; kk < DH / 16; ++kk)
          wgmma_ss_n64<false>(dp, desc_kmajor<DH>(sdo, BM, 64 * w, kk),
                              desc_kmajor<DH>(v_t, BN, 0, kk));
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
          wgmma_rs<DH>(dq, df[kk], desc_mnmajor<DH>(k_t, BN, kk));
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
      __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(a.dq) + (size_t)bh * Sq * DH;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + r0 + 8 * h;
        if (row >= Sq) continue;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n)
          *reinterpret_cast<uint32_t*>(dqg + (size_t)row * DH + 8 * n + t2) =
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

template <int DH>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.H * a.Sq;
  cudaError_t e = launch(flash_bwd_delta<__nv_bfloat16, DH>, a, (rows + 7) / 8, 256, 0, stream);
  if (e != cudaSuccess) return e;
  if (a.B == 0 || a.Sq == 0 || a.Sk == 0) {  // no score at all: every gradient is 0
    const size_t kv = (size_t)a.B * a.KH * a.Sk * DH * 2;
    e = zero(a.dq, (size_t)rows * DH * 2, stream);
    if (e == cudaSuccess) e = zero(a.dk, kv, stream);
    if (e == cudaSuccess) e = zero(a.dv, kv, stream);
    return e;
  }
  const int BH = a.B * a.H, BKV = a.B * a.KH;
  CUtensorMap kv_q, kv_do, kv_k, kv_v, q_q, q_do, q_k, q_v;
  if (!tensor_map<DH>(&kv_q, a.q, a.Sq, BH, KvTile<DH>::BQ) ||
      !tensor_map<DH>(&kv_do, a.dout, a.Sq, BH, KvTile<DH>::BQ) ||
      !tensor_map<DH>(&kv_k, a.k, a.Sk, BKV, KvTile<DH>::BK) ||
      !tensor_map<DH>(&kv_v, a.v, a.Sk, BKV, KvTile<DH>::BK) ||
      !tensor_map<DH>(&q_q, a.q, a.Sq, BH, QTile<DH>::BM) ||
      !tensor_map<DH>(&q_do, a.dout, a.Sq, BH, QTile<DH>::BM) ||
      !tensor_map<DH>(&q_k, a.k, a.Sk, BKV, QTile<DH>::BN) ||
      !tensor_map<DH>(&q_v, a.v, a.Sk, BKV, QTile<DH>::BN))
    return cudaErrorInvalidValue;
  static const cudaError_t set = [] {
    const cudaError_t e1 = cudaFuncSetAttribute(
        flash_bwd_dkdv_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, KvTile<DH>::SMEM);
    return e1 != cudaSuccess ? e1 : cudaFuncSetAttribute(
        flash_bwd_dq_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, QTile<DH>::SMEM);
  }();
  if (set != cudaSuccess) return set;
  int n_sm;
  e = sm_count(&n_sm);
  if (e != cudaSuccess) return e;
  // persistent: at most one CTA an SM, each walking items (zigzag_item)
  const long long kv_items = (long long)BKV * ((a.Sk + KvTile<DH>::BK - 1) / KvTile<DH>::BK);
  const long long q_items = (long long)BH * ((a.Sq + QTile<DH>::BM - 1) / QTile<DH>::BM);
  flash_bwd_dkdv_bf16<DH><<<(unsigned)(kv_items < n_sm ? kv_items : n_sm), THREADS,
                            KvTile<DH>::SMEM, stream>>>(kv_q, kv_do, kv_k, kv_v, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_bf16<DH><<<(unsigned)(q_items < n_sm ? q_items : n_sm), THREADS,
                          QTile<DH>::SMEM, stream>>>(q_q, q_do, q_k, q_v, a);
  return cudaGetLastError();
}

template <int DH>
cudaError_t dispatch(const Args& a, int is_bf16, cudaStream_t stream) {
  if (is_bf16) return launch_bf16<DH>(a, stream);
  const long long rows = (long long)a.B * a.H * a.Sq;
  constexpr int LD = DH + 1;
  cudaError_t e = launch(flash_bwd_delta<float, DH>, a, (rows + 7) / 8, 256, 0, stream);
  if (e == cudaSuccess)
    e = launch(flash_bwd_dkdv_f32<DH>, a, (long long)a.B * a.KH * ((a.Sk + F_BN - 1) / F_BN),
               256, (int)(((2 * F_BN + 2 * F_BQ) * LD + 2 * F_BN * (F_BQ + 1) + 2 * F_BQ) *
                          sizeof(float)),
               stream);
  if (e == cudaSuccess)
    e = launch(flash_bwd_dq_f32<DH>, a, (long long)a.B * a.H * ((a.Sq + F_BQ - 1) / F_BQ), 256,
               (int)(((2 * F_BQ + 2 * F_BN) * LD + F_BQ * (F_BN + 1)) * sizeof(float)), stream);
  return e;
}

}  // namespace

// q, dout, o, dq (B, H, Sq, Dh); k, v, dk, dv (B, KH, Sk, Dh): contiguous,
// 16-byte aligned, on the current device, all bf16 (is_bf16 = 1) or all fp32;
// H % KH == 0. lse (B, H, Sq) fp32 from flash_attention_fwd; delta (B, H, Sq)
// fp32 scratch. Launches three kernels on `stream` and does not synchronise.
// Returns the first cudaError_t (0 on success); Dh outside {32, 64, 128}
// returns cudaErrorInvalidValue.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int B, int H, int KH, int Sq, int Sk,
                                   int Dh, int q_offset, int causal, float scale, int is_bf16,
                                   void* stream) {
  const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KH, Sq, Sk, q_offset, causal,
               scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32: return dispatch<32>(a, is_bf16, st);
    case 64: return dispatch<64>(a, is_bf16, st);
    case 128: return dispatch<128>(a, is_bf16, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
