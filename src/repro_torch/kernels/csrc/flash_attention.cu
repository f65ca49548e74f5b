// GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py:25, launched by `flash_attention`
// at :73 through `pl.pallas_call` at :94). It computes
//     O = softmax(Q K^T * Dhk^-0.5 [+ causal mask]) V
// with q (B, H, Sq, Dhk), k (B, KH, Sk, Dhk) and v (B, KH, Sk, Dhv), H = KH *
// G: q head h reads kv head h / G, so a kv tile serves every q head of its
// group without a copy of K or V. Beyond the TPU kernel it takes a query
// offset (query row i sits at position q_offset + i under the causal mask),
// any Sq and Sk (the ragged edge is masked here, where the Pallas kernel
// asserted S % block == 0 and Sq == Sk), head dims (Dhk, Dhv) of (16, 16),
// (32, 32), (64, 64), (128, 128) or MLA's (192, 128) (a key head of 128 + 64
// rope dims over a value head of 128, as the JAX model's flash takes them at
// src/repro/models/attention.py:70; the Pallas kernel takes one Dh), and
// bf16 or fp32 inputs. Sums are fp32. The softmax scale is an argument: the
// wrapper zero-pads other widths to an instantiation and passes the scale of
// the unpadded width.
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
// operations: 0.139 ms against 0.025 ms for the bytes. With Dhk != Dhv the
// products are B*H*S^2*(Dhk + Dhv): 85.9 GFLOP, 0.0869 ms at deepseek-v2-lite's
// training shape (H = KH = 16, S = 4096, (192, 128)). Only wgmma reaches
// the tensor cores' full rate; it wants its operands in shared memory ahead
// of time, and the softmax's exponentials, on units with 1/256 of the
// tensor cores' rate (3.9 against 989 TFLOP/s, per the FlashAttention-3
// paper), have to hide under the products. The bf16 kernel is built for
// that:
//
//   * Warp specialisation. A CTA is three warpgroups over 128 q rows: a
//     producer (setmaxnreg down to 40 registers) and two consumers of 64
//     rows each (up to 232). One producer thread loads Q once per q tile and
//     each kv tile's K and V by TMA into a ring of STAGES stages (3 where
//     Dhk = Dhv: Q 32 KiB + 3 x (K 32 KiB + V 32 KiB) at Dh = 128; 2 at
//     (192, 128): Q 48 KiB + 2 x (K 48 KiB + V 32 KiB), as three stages would
//     take 288 KiB of the 227 a CTA may use). Each stage has
//     a full barrier for K and one for V (mbarrier transaction counts) and
//     an empty one that the consumers' eight warps arrive on when done with
//     it; Q has a full and an empty barrier likewise.
//   * The tensor maps are 3-D, (Dh, S, B*heads): a tile that overhangs Sq or
//     Sk is zero-filled by the TMA and never reads the next head's rows; the
//     masks still decide what counts. Rows land in 128-byte swizzled column
//     blocks (64-byte for Dh = 32, 32-byte for Dh = 16), the layout the
//     wgmma descriptors name.
//   * S = Q K^T is wgmma m64n128k16 with both operands in shared memory,
//     K-major as they lie, Dhk / 16 k-steps (one at Dh = 16). O += P V is
//     wgmma m64nDhvk16
//     with P in registers:
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

#include <math.h>

#include "hopper.cuh"           // mbarriers, TMA, wgmma, tensor maps

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

constexpr int BM = 128;      // q rows per CTA: two consumer warpgroups of 64
constexpr int BN = 128;      // kv rows per tile
constexpr int THREADS = 3 * WG;
constexpr int PRODUCER_REGS = 40;   // setmaxnreg: 128 x 40 + 256 x 232 <= 64K
constexpr int CONSUMER_REGS = 232;

template <int DHK, int DHV>
struct Tile {
  static constexpr int Q_BYTES = BM * DHK * 2;
  static constexpr int K_BYTES = BN * DHK * 2;       // one K tile
  static constexpr int V_BYTES = BN * DHV * 2;       // one V tile
  static constexpr int BAR_BYTES = 1024;             // barriers, then 1 KiB-aligned tiles
  // 1 KiB of slack to align the dynamic shared memory, then barriers and
  // Q, then the K/V ring: 3 stages where they fit (every Dhk = Dhv), else 2
  static constexpr int FIXED = 1024 + BAR_BYTES + Q_BYTES;
  static constexpr int STAGES = FIXED + 3 * (K_BYTES + V_BYTES) <= 232448 ? 3 : 2;
  static constexpr int SMEM = FIXED + STAGES * (K_BYTES + V_BYTES);
  static_assert(SMEM <= 232448, "over the 227 KiB a CTA may use");
};

struct BfArgs {
  __nv_bfloat16* o;
  float* lse;                // (B, H, Sq) or nullptr
  int B, H, KH, Sq, Sk, q_offset, causal;
  float scale_log2;          // Dhk^-0.5 * log2(e)
};

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

// The work of a CTA: one (b*h, 128-row q tile) after another. Items are
// numbered heaviest causal q tile first, every head of a q tile before the
// next; CTA c of G takes item r*G + c in even rounds r and r*G + G-1-c in
// odd ones, which balances the causal work as well as first-come dispatch.
struct Item {
  int bh, q0;
};

__device__ __forceinline__ bool next_item(int r, int n_qt, int BH, Item& it) {
  const int i = zigzag_item(r, n_qt * BH);
  if (i < 0) return false;
  it.bh = i % BH;
  it.q0 = (n_qt - 1 - i / BH) * BM;
  return true;
}

template <int DHK, int DHV>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const BfArgs a) {
  using T = Tile<DHK, DHV>;
  constexpr int STAGES = T::STAGES;
  constexpr int SWK = Swizzle<DHK>::SW, ATOMK = Swizzle<DHK>::ATOM;   // Q and K
  constexpr int SWV = Swizzle<DHV>::SW, ATOMV = Swizzle<DHV>::ATOM;   // V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 1 KiB alignment: the swizzle pattern repeats every 1024 (512, 256)
  // bytes, and TMA and wgmma agree on it only from such a boundary
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q = base;                          // Q landed
  const uint32_t bar_qe = base + 8;                     // Q free
  const uint32_t bar_k = base + 16;                     // [STAGES] K landed
  const uint32_t bar_v = bar_k + 8 * STAGES;            // [STAGES] V landed
  const uint32_t bar_e = bar_v + 8 * STAGES;            // [STAGES] stage free
  const uint32_t sq = base + T::BAR_BYTES;              // Q: DHK/ATOMK blocks of BM x SWK bytes
  const uint32_t sk = sq + T::Q_BYTES;                  // K stages, BN x SWK-byte blocks
  const uint32_t sv = sk + STAGES * T::K_BYTES;         // V stages, BN x SWV-byte blocks

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
        for (int c = 0; c < DHK / ATOMK; ++c)
          tma_load_3d(sq + c * BM * SWK, &tm_q, c * ATOMK, it.q0, it.bh, bar_q);
        const int n_tiles = (extent(it.q0 + BM) + BN - 1) / BN;
        for (int j = 0; j < n_tiles; ++j, ++t) {
          const int s = t % STAGES;
          mbar_wait(bar_e + 8 * s, ((t / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_k + 8 * s, T::K_BYTES);
          for (int c = 0; c < DHK / ATOMK; ++c)
            tma_load_3d(sk + s * T::K_BYTES + c * BN * SWK, &tm_k, c * ATOMK, j * BN,
                        kv_slab, bar_k + 8 * s);
          mbar_expect_tx(bar_v + 8 * s, T::V_BYTES);
          for (int c = 0; c < DHV / ATOMV; ++c)
            tma_load_3d(sv + s * T::V_BYTES + c * BN * SWV, &tm_v, c * ATOMV, j * BN,
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
    auto desc_q = [&](int kk) { return desc_kmajor<DHK>(sq, BM, w * 64, kk); };
    auto desc_k = [&](int s, int kk) { return desc_kmajor<DHK>(sk + s * T::K_BYTES, BN, 0, kk); };
    auto desc_v = [&](int s, int kk) { return desc_mnmajor<DHV>(sv + s * T::V_BYTES, BN, kk); };
    auto release = [&](uint32_t bar) { mbar_arrive_if(bar, lane == 0); };
    // Ping-pong: the consumers take turns to issue their wgmma (one turn is
    // a tile's Q K^T and the previous tile's P V), so one's softmax runs
    // while the other's products hold the tensor cores. Consumer 1 lets 0
    // go first; both take n_tiles + 1 turns an item.
    auto turn_begin = [&] { bar_sync(1 + w, 2 * WG); };
    auto turn_end = [&] { bar_arrive(2 - w, 2 * WG); };
    if (w == 1) bar_arrive(1, 2 * WG);

    float o[DHV / 2];
    float s[BN / 2];
    uint32_t p[BN / 16][4];
    float m[2], l[2], corr[2];
    auto issue_qk = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < DHK / 16; ++kk) wgmma_ss_n128(s, desc_q(kk), desc_k(st, kk), kk > 0);
      wgmma_commit();
    };
    auto issue_pv = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<DHV>(o, p[kk], desc_v(st, kk));
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
      for (int i = 0; i < DHV / 2; ++i) o[i] = 0.f;
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
      to_fragments<BN>(s, p);
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
        for (int n = 0; n < DHV / 8; ++n) {
          o[4 * n] *= corr[0];
          o[4 * n + 1] *= corr[0];
          o[4 * n + 2] *= corr[1];
          o[4 * n + 3] *= corr[1];
        }
        to_fragments<BN>(s, p);
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
        __nv_bfloat16* orow = a.o + ((size_t)it.bh * Sq + row) * DHV + t2;
#pragma unroll
        for (int n = 0; n < DHV / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + 8 * n) =
              pack_bf16(o[4 * n + 2 * i] * l[i], o[4 * n + 2 * i + 1] * l[i]);
      }
    }
    if (w == 0) bar_sync(1, 2 * WG);                  // consumer 1's last arrive
  }
}

// ------------------------------------------------------------------ fp32

template <int DHK, int DHV>
__global__ void __launch_bounds__(256) flash_fwd_f32(Params p) {
  constexpr int LDQ = DHK + 1, LDK = DHK + 1, LDP = BKF + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // BQ x LDQ
  float* Ks = Qs + BQ * LDQ;                        // BKF x LDK
  float* Vs = Ks + BKF * LDK;                       // BKF x DHV
  float* Ps = Vs + BKF * DHV;                       // BQ x LDP

  const int row = threadIdx.x >> 2, sub = threadIdx.x & 3;   // 4 threads a row
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const float* qg = static_cast<const float*>(p.q) + (size_t)bh * p.Sq * DHK;
  const size_t kv_slab = (size_t)b * p.KH + kvh;
  const float* kg = static_cast<const float*>(p.k) + kv_slab * p.Sk * DHK;
  const float* vg = static_cast<const float*>(p.v) + kv_slab * p.Sk * DHV;
  float* og = static_cast<float*>(p.o) + (size_t)bh * p.Sq * DHV;

  for (int i = threadIdx.x; i < BQ * DHK; i += 256) {
    const int r = i / DHK, d = i % DHK;
    Qs[r * LDQ + d] = q0 + r < p.Sq ? qg[(size_t)(q0 + r) * DHK + d] : 0.f;
  }

  float o[DHV / 4];
#pragma unroll
  for (int i = 0; i < DHV / 4; ++i) o[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int qpos = p.q_offset + q0 + row;
  const int kv_end = kv_extent(p, q0);

  for (int k0 = 0; k0 < kv_end; k0 += BKF) {
    __syncthreads();
    // one loop over the wider of K and V rows, each column guarded
    // (compile-time where Dhk = Dhv)
    constexpr int DW = DHK > DHV ? DHK : DHV;
    for (int i = threadIdx.x; i < BKF * DW; i += 256) {
      const int r = i / DW, d = i % DW;
      const bool in = k0 + r < p.Sk;
      if (DHK == DW || d < DHK) Ks[r * LDK + d] = in ? kg[(size_t)(k0 + r) * DHK + d] : 0.f;
      if (DHV == DW || d < DHV) Vs[r * DHV + d] = in ? vg[(size_t)(k0 + r) * DHV + d] : 0.f;
    }
    __syncthreads();

    float s[BKF / 4];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKF / 4; ++j) {
      const int c = sub + 4 * j;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < DHK; ++d) acc = fmaf(Qs[row * LDQ + d], Ks[c * LDK + d], acc);
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
    for (int i = 0; i < DHV / 4; ++i) o[i] *= corr;
    __syncwarp();                           // a row's P is written within its warp
#pragma unroll 4
    for (int c = 0; c < BKF; ++c) {
      const float pc = Ps[row * LDP + c];
#pragma unroll
      for (int i = 0; i < DHV / 4; ++i) o[i] = fmaf(pc, Vs[c * DHV + sub + 4 * i], o[i]);
    }
  }

  l += __shfl_xor_sync(0xffffffff, l, 1);
  l += __shfl_xor_sync(0xffffffff, l, 2);
  const float inv = 1.f / fmaxf(l, 1e-30f);
  if (q0 + row < p.Sq) {
#pragma unroll
    for (int i = 0; i < DHV / 4; ++i)
      og[(size_t)(q0 + row) * DHV + sub + 4 * i] = o[i] * inv;
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

template <int DHK, int DHV>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  if (p.Sk == 0) {                        // every score masked: O = 0
    const long long rows = (long long)B * p.H * p.Sq;
    if (p.lse != nullptr && rows > 0) {
      fill_lse<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(p.lse, rows);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    return cudaMemsetAsync(p.o, 0, (size_t)rows * DHV * 2, stream);
  }
  CUtensorMap tq, tk, tv;
  if (!tensor_map<DHK>(&tq, p.q, p.Sq, B * p.H, BM) ||
      !tensor_map<DHK>(&tk, p.k, p.Sk, B * p.KH, BN) ||
      !tensor_map<DHV>(&tv, p.v, p.Sk, B * p.KH, BN))
    return cudaErrorInvalidValue;
  static const cudaError_t set = cudaFuncSetAttribute(
      flash_fwd_bf16<DHK, DHV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<DHK, DHV>::SMEM);
  if (set != cudaSuccess) return set;
  int n_sm;
  const cudaError_t e = sm_count(&n_sm);
  if (e != cudaSuccess) return e;
  const BfArgs a{static_cast<__nv_bfloat16*>(p.o), p.lse, B, p.H, p.KH, p.Sq, p.Sk, p.q_offset,
                 p.causal, p.scale * 1.4426950408889634f};
  // persistent: at most one CTA an SM, each walking items (next_item)
  const long long n_items = (long long)B * p.H * ((p.Sq + BM - 1) / BM);
  const int grid = (int)(n_items < n_sm ? n_items : n_sm);
  flash_fwd_bf16<DHK, DHV><<<grid, THREADS, Tile<DHK, DHV>::SMEM, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

template <int DHK, int DHV>
cudaError_t dispatch(const Params& p, int B, int is_bf16, cudaStream_t stream) {
  if (is_bf16) return launch_bf16<DHK, DHV>(p, B, stream);
  return launch(flash_fwd_f32<DHK, DHV>, p, B, 256,
                (size_t)(BQ * (DHK + 1) + BKF * (DHK + 1) + BKF * DHV + BQ * (BKF + 1)) *
                    sizeof(float),
                stream);
}

}  // namespace

// q (B, H, Sq, Dh), k (B, KH, Sk, Dh), v (B, KH, Sk, Dhv), o (B, H, Sq, Dhv):
// contiguous, 16-byte aligned, on the current device, all bf16 (is_bf16 = 1)
// or all fp32. H % KH == 0. lse, (B, H, Sq) fp32, receives each row's
// log-sum-exp where it is not nullptr. Launches on `stream` and does not
// synchronise. Returns the cudaError_t of the launch (0 on success); (Dh, Dhv)
// other than (16, 16), (32, 32), (64, 64), (128, 128) and (192, 128), or a
// bf16 array that no TMA tensor map can describe, returns
// cudaErrorInvalidValue.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int B, int H, int KH, int Sq, int Sk, int Dh,
                                   int Dhv, int q_offset, int causal, float scale, int is_bf16,
                                   void* stream) {
  const Params p{q, k, v, o, lse, H, KH, Sq, Sk, q_offset, causal, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 192 && Dhv == 128) return dispatch<192, 128>(p, B, is_bf16, st);
  if (Dh != Dhv) return cudaErrorInvalidValue;
  switch (Dh) {
    case 16: return dispatch<16, 16>(p, B, is_bf16, st);
    case 32: return dispatch<32, 32>(p, B, is_bf16, st);
    case 64: return dispatch<64, 64>(p, B, is_bf16, st);
    case 128: return dispatch<128, 128>(p, B, is_bf16, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
