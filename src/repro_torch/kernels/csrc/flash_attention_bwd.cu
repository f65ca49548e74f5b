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
// This first kernel is simple and right rather than fast: bf16 products run
// on mma.sync m16n8k16 (fragments loaded from padded shared memory with
// plain loads, the transposed operands element by element), fp32 on CUDA
// cores; no TMA, no wgmma, no pipelining of the tile loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// mma.sync m16n8k16, bf16 operands, fp32 sums. With lane = 4 g + t, a warp
// holds A (16 x 16) as a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 =
// A[g][2t+8..], a3 = A[g+8][2t+8..]; B (16 x 8, k x n) as b0 = B[2t..2t+1][g],
// b1 = B[2t+8..2t+9][g]; C (16 x 8) as c0, c1 = C[g][2t..2t+1], c2, c3 =
// C[g+8][2t..2t+1]. So the C fragments of two neighbouring 8-column blocks
// are the A fragment of one 16-deep step: P and dS go from the score
// products into the next products without leaving registers.

constexpr int WARPS = 4;
constexpr int B_BN = 64;     // dkdv: key rows of a CTA, 16 a warp
constexpr int B_BQ = 32;     // dkdv: query rows of a step
constexpr int D_BQ = 64;     // dq: query rows of a CTA, 16 a warp
constexpr int D_BN = 64;     // dq: key rows of a step
constexpr int PAD = 8;       // bf16 padding of a shared-memory row

template <int DH>
constexpr int smem_dkdv_bf16() { return (2 * B_BN + 2 * B_BQ) * (DH + PAD) * 2 + 2 * B_BQ * 4; }
template <int DH>
constexpr int smem_dq_bf16() { return (2 * D_BQ + 2 * D_BN) * (DH + PAD) * 2; }

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH>
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* s, int row, int col) {
  return *reinterpret_cast<const uint32_t*>(s + row * (DH + PAD) + col);
}

// A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a tile.
template <int DH>
__device__ __forceinline__ void frag_a(uint32_t (&f)[4], const __nv_bfloat16* s, int r0,
                                       int c0, int g, int t) {
  f[0] = ld32<DH>(s, r0 + g, c0 + 2 * t);
  f[1] = ld32<DH>(s, r0 + g + 8, c0 + 2 * t);
  f[2] = ld32<DH>(s, r0 + g, c0 + 2 * t + 8);
  f[3] = ld32<DH>(s, r0 + g + 8, c0 + 2 * t + 8);
}

// B fragment with B[k][n] = tile[n0 + n][k0 + k] (rows of the tile are n).
template <int DH>
__device__ __forceinline__ void frag_b_rows(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* s,
                                            int n0, int k0, int g, int t) {
  b0 = ld32<DH>(s, n0 + g, k0 + 2 * t);
  b1 = ld32<DH>(s, n0 + g, k0 + 2 * t + 8);
}

// B fragment with B[k][n] = tile[k0 + k][n0 + n] (rows of the tile are k).
template <int DH>
__device__ __forceinline__ void frag_b_cols(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* s,
                                            int k0, int n0, int g, int t) {
  const __nv_bfloat16* p = s + (k0 + 2 * t) * (DH + PAD) + n0 + g;
  b0 = pack_raw(p[0], p[DH + PAD]);
  b1 = pack_raw(p[8 * (DH + PAD)], p[9 * (DH + PAD)]);
}

// The A fragment of columns [16 kk, 16 kk + 16) of a 16-row C tile.
__device__ __forceinline__ void c_to_a(uint32_t (&f)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  f[0] = pack_bf16(lo[0], lo[1]);
  f[1] = pack_bf16(lo[2], lo[3]);
  f[2] = pack_bf16(hi[0], hi[1]);
  f[3] = pack_bf16(hi[2], hi[3]);
}

// Rows [r0, r0 + n) of a (rows, DH) bf16 slab into a padded tile, zero past
// `rows`; 16-byte copies.
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g, int r0,
                                          int n, int rows) {
  constexpr int V = DH / 8;                  // 16-byte vectors a row
  for (int i = threadIdx.x; i < n * V; i += WARPS * 32) {
    const int rr = i / V, c = (i % V) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r0 + rr < rows) x = *reinterpret_cast<const uint4*>(g + (size_t)(r0 + rr) * DH + c);
    *reinterpret_cast<uint4*>(s + rr * (DH + PAD) + c) = x;
  }
}

// dK and dV of B_BN keys of one (b, kv head); warp w holds keys
// [16 w, 16 w + 16) of the tile: S^T = K Q^T and dP^T = V dO^T per step of
// B_BQ queries, then dV += P^T dO and dK += dS^T Q.
template <int DH>
__global__ void __launch_bounds__(WARPS * 32) flash_bwd_dkdv_bf16(const Args a) {
  constexpr int NQ = B_BQ / 8, ND = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + B_BN * (DH + PAD);
  __nv_bfloat16* Qs = Vs + B_BN * (DH + PAD);
  __nv_bfloat16* Ds = Qs + B_BQ * (DH + PAD);
  float* Ls = reinterpret_cast<float*>(Ds + B_BQ * (DH + PAD));   // lse * log2(e)
  float* Es = Ls + B_BQ;                                           // delta

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int n_kt = (a.Sk + B_BN - 1) / B_BN;
  const int kt = blockIdx.x % n_kt, bkv = blockIdx.x / n_kt;
  const int b = bkv / a.KH, kvh = bkv % a.KH, G = a.H / a.KH;
  const int k0 = kt * B_BN, kw = 16 * w;
  const size_t kv_off = (size_t)bkv * a.Sk * DH;
  const float scale_log2 = a.scale * LOG2E;
  load_tile<DH>(Ks, static_cast<const __nv_bfloat16*>(a.k) + kv_off, k0, B_BN, a.Sk);
  load_tile<DH>(Vs, static_cast<const __nv_bfloat16*>(a.v) + kv_off, k0, B_BN, a.Sk);

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const int bh = b * a.H + kvh * G + gi;
    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + (size_t)bh * a.Sq * DH;
    const __nv_bfloat16* dg = static_cast<const __nv_bfloat16*>(a.dout) + (size_t)bh * a.Sq * DH;
    for (int q0 = first_q_tile(a, k0, B_BQ); q0 < a.Sq; q0 += B_BQ) {
      __syncthreads();
      load_tile<DH>(Qs, qg, q0, B_BQ, a.Sq);
      load_tile<DH>(Ds, dg, q0, B_BQ, a.Sq);
      if (threadIdx.x < B_BQ) {
        const bool in = q0 + threadIdx.x < a.Sq;
        Ls[threadIdx.x] = in ? a.lse[(size_t)bh * a.Sq + q0 + threadIdx.x] * LOG2E : 0.f;
        Es[threadIdx.x] = in ? a.delta[(size_t)bh * a.Sq + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();

      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t fk[4], fv[4];
        frag_a<DH>(fk, Ks, kw, 16 * kk, g, t);
        frag_a<DH>(fv, Vs, kw, 16 * kk, g, t);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          uint32_t b0, b1;
          frag_b_rows<DH>(b0, b1, Qs, 8 * n, 16 * kk, g, t);
          mma_bf16_16816(s[n], fk, b0, b1);
          frag_b_rows<DH>(b0, b1, Ds, 8 * n, 16 * kk, g, t);
          mma_bf16_16816(dp[n], fv, b0, b1);
        }
      }
      // s becomes P^T and dp becomes dS^T; rows are keys, columns queries
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kw + g + 8 * (e >> 1), c = 8 * n + 2 * t + (e & 1);
          const float p = visible(a, q0 + c, key) ? exp2f(s[n][e] * scale_log2 - Ls[c]) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - Es[c]);
        }
#pragma unroll
      for (int kk = 0; kk < B_BQ / 16; ++kk) {
        uint32_t fp[4], fs[4];
        c_to_a(fp, s[2 * kk], s[2 * kk + 1]);
        c_to_a(fs, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t b0, b1;
          frag_b_cols<DH>(b0, b1, Ds, 16 * kk, 8 * n, g, t);
          mma_bf16_16816(dv[n], fp, b0, b1);
          frag_b_cols<DH>(b0, b1, Qs, 16 * kk, 8 * n, g, t);
          mma_bf16_16816(dk[n], fs, b0, b1);
        }
      }
    }
  }
  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(a.dk) + kv_off;
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(a.dv) + kv_off;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + kw + g + 8 * half;
    if (key >= a.Sk) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const size_t at = (size_t)key * DH + 8 * n + 2 * t;
      *reinterpret_cast<uint32_t*>(dkg + at) =
          pack_bf16(dk[n][2 * half] * a.scale, dk[n][2 * half + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvg + at) = pack_bf16(dv[n][2 * half], dv[n][2 * half + 1]);
    }
  }
}

// dQ of D_BQ query rows of one (b, q head); warp w holds rows
// [16 w, 16 w + 16): S = Q K^T and dP = dO V^T per step of D_BN keys, then
// dQ += dS K.
template <int DH>
__global__ void __launch_bounds__(WARPS * 32) flash_bwd_dq_bf16(const Args a) {
  constexpr int NK = D_BN / 8, ND = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ds = Qs + D_BQ * (DH + PAD);
  __nv_bfloat16* Ks = Ds + D_BQ * (DH + PAD);
  __nv_bfloat16* Vs = Ks + D_BN * (DH + PAD);

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int n_qt = (a.Sq + D_BQ - 1) / D_BQ;
  const int qt = blockIdx.x % n_qt, bh = blockIdx.x / n_qt;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = qt * D_BQ, qw = 16 * w;
  const size_t q_off = (size_t)bh * a.Sq * DH;
  const size_t kv_off = ((size_t)b * a.KH + h / (a.H / a.KH)) * a.Sk * DH;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + kv_off;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + kv_off;
  const float scale_log2 = a.scale * LOG2E;
  load_tile<DH>(Qs, static_cast<const __nv_bfloat16*>(a.q) + q_off, q0, D_BQ, a.Sq);
  load_tile<DH>(Ds, static_cast<const __nv_bfloat16*>(a.dout) + q_off, q0, D_BQ, a.Sq);

  float lse2[2], delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + qw + g + 8 * half;
    const bool in = row < a.Sq;
    lse2[half] = in ? a.lse[(size_t)bh * a.Sq + row] * LOG2E : 0.f;
    delta[half] = in ? a.delta[(size_t)bh * a.Sq + row] : 0.f;
  }
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  const int end = kv_end(a, q0, D_BQ);
  for (int k0 = 0; k0 < end; k0 += D_BN) {
    __syncthreads();
    load_tile<DH>(Ks, kg, k0, D_BN, a.Sk);
    load_tile<DH>(Vs, vg, k0, D_BN, a.Sk);
    __syncthreads();

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t fq[4], fd[4];
      frag_a<DH>(fq, Qs, qw, 16 * kk, g, t);
      frag_a<DH>(fd, Ds, qw, 16 * kk, g, t);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t b0, b1;
        frag_b_rows<DH>(b0, b1, Ks, 8 * n, 16 * kk, g, t);
        mma_bf16_16816(s[n], fq, b0, b1);
        frag_b_rows<DH>(b0, b1, Vs, 8 * n, 16 * kk, g, t);
        mma_bf16_16816(dp[n], fd, b0, b1);
      }
    }
    // dp becomes dS; rows are queries, columns keys
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + qw + g + 8 * (e >> 1), key = k0 + 8 * n + 2 * t + (e & 1);
        const float p = visible(a, row, key) ? exp2f(s[n][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        dp[n][e] = p * (dp[n][e] - delta[e >> 1]);
      }
#pragma unroll
    for (int kk = 0; kk < D_BN / 16; ++kk) {
      uint32_t fs[4];
      c_to_a(fs, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t b0, b1;
        frag_b_cols<DH>(b0, b1, Ks, 16 * kk, 8 * n, g, t);
        mma_bf16_16816(dq[n], fs, b0, b1);
      }
    }
  }
  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(a.dq) + q_off;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + qw + g + 8 * half;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dqg + (size_t)row * DH + 8 * n + 2 * t) =
          pack_bf16(dq[n][2 * half] * a.scale, dq[n][2 * half + 1] * a.scale);
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

template <int DH>
cudaError_t dispatch(const Args& a, int is_bf16, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.H * a.Sq;
  cudaError_t e;
  if (is_bf16) {
    e = launch(flash_bwd_delta<__nv_bfloat16, DH>, a, (rows + 7) / 8, 256, 0, stream);
    if (e == cudaSuccess)
      e = launch(flash_bwd_dkdv_bf16<DH>, a,
                 (long long)a.B * a.KH * ((a.Sk + B_BN - 1) / B_BN), WARPS * 32,
                 smem_dkdv_bf16<DH>(), stream);
    if (e == cudaSuccess)
      e = launch(flash_bwd_dq_bf16<DH>, a,
                 (long long)a.B * a.H * ((a.Sq + D_BQ - 1) / D_BQ), WARPS * 32,
                 smem_dq_bf16<DH>(), stream);
    return e;
  }
  constexpr int LD = DH + 1;
  e = launch(flash_bwd_delta<float, DH>, a, (rows + 7) / 8, 256, 0, stream);
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
